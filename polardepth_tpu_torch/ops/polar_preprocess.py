"""Fused polar preprocess: 4 captures -> XOLP (..., 2) + Fresnel priors (..., 9).

The counterpart of polardepth_tpu/ops/pallas/polar_preprocess.py
(fused_polar_preprocess).  On a CUDA tensor the wrapper launches the
hand-written kernel of csrc/polar_preprocess.cu; on a CPU tensor it runs the
plain torch version below, which computes the same function with the same
table and the same order of operations.
"""

from __future__ import annotations

import torch

from polardepth_tpu_torch.ops import build
from polardepth_tpu_torch.ops.fresnel import normal_priors_from_xolp, tables_on
from polardepth_tpu_torch.ops.xolp import PINV_F32, xolp_from_pol

_NAME = "polar_preprocess"
_MAX_BINS = 128  # per curve section (csrc/polar_preprocess.cu)


def polar_preprocess_plain(pol: torch.Tensor, n: float = 1.5,
                           prune_tol: float | None = 1e-5):
    """The kernel's function in torch ops: (xolp (..., 2), priors (..., 9))."""
    xolp = xolp_from_pol(pol)
    return xolp, normal_priors_from_xolp(xolp, n, prune_tol)


def fused_polar_preprocess(pol: torch.Tensor, n: float = 1.5,
                           prune_tol: float | None = 1e-5):
    """pol (..., 4) float32 0..255-scale grays at 0/45/90/135 degrees ->
    (xolp (..., 2), priors (..., 9)), float32, channels last.

    A CPU tensor takes the plain version.  A CUDA tensor launches the kernel
    on the current stream, or raises.
    """
    if pol.dtype != torch.float32:
        raise TypeError(f"pol must be float32, got {pol.dtype}")
    if pol.dim() < 1 or pol.shape[-1] != 4:
        raise ValueError(f"pol must be (..., 4), got {tuple(pol.shape)}")
    if pol.device.type == "cpu":
        return polar_preprocess_plain(pol, n, prune_tol)
    if pol.device.type != "cuda":
        raise ValueError(f"no kernel for device {pol.device}")
    if not pol.is_contiguous():
        raise ValueError("pol must be contiguous")
    if pol.data_ptr() % 16:
        raise ValueError("pol must be 16-byte aligned")
    shape = pol.shape[:-1]
    xolp = torch.empty(*shape, 2, dtype=torch.float32, device=pol.device)
    priors = torch.empty(*shape, 9, dtype=torch.float32, device=pol.device)
    n_pix = pol.numel() // 4
    if n_pix == 0:
        return xolp, priors
    ck, rows, offsets = tables_on(pol.device, float(n), prune_tol)
    if max(b - a for a, b in zip(offsets, offsets[1:])) > _MAX_BINS:
        raise ValueError(f"the kernel takes at most {_MAX_BINS} coarse bins "
                         f"per curve; the table of n={n}, prune_tol="
                         f"{prune_tol} has sections {offsets}")
    lib = build.library(_NAME)
    with torch.cuda.device(pol.device):
        stream = torch.cuda.current_stream(pol.device).cuda_stream
        code = lib.polar_preprocess_launch(
            pol.data_ptr(), xolp.data_ptr(), priors.data_ptr(), n_pix,
            ck.data_ptr(), rows.data_ptr(), offsets[3], offsets[1],
            offsets[2], PINV_F32.ctypes.data, stream)
    build.check(_NAME, code)
    build.launch_counts[_NAME] += 1
    return xolp, priors
