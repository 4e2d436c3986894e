"""XOLP: degree (DoLP) and angle (AoLP) of linear polarization from 4 captures.

A torch copy of polardepth_tpu/ops/xolp.py.  The reference fits the Stokes
model I(t) = a + b cos(2t) + c sin(2t) over polarizer angles [0, 45, 90, 135]
degrees per pixel with ``np.linalg.lstsq`` (reference polarisation/xolp.py).
The design matrix is constant, so the fit is the fixed 3x4 pseudoinverse
applied to each pixel's four grays.

The fit is written out as sums taken left to right, in the order the CUDA
kernel (csrc/polar_preprocess.cu) takes them, so that both round alike.
"""

from __future__ import annotations

import numpy as np
import torch

_ANGLES_DEG = np.array([0.0, 45.0, 90.0, 135.0])


def _design_matrix_pinv() -> np.ndarray:
    """pinv of the 4x3 design matrix in float64, built as the reference
    builds it, ~1e-16 trig residues of cos(pi) and the like included
    (polardepth_tpu/ops/xolp.py:31-42)."""
    angles = _ANGLES_DEG * np.pi / 180.0
    A = np.zeros((4, 3))
    A[:, 0] = 1.0
    A[:, 1] = np.cos(2.0 * angles)
    A[:, 2] = np.sin(2.0 * angles)
    return np.linalg.pinv(A)  # (3, 4)


_PINV = _design_matrix_pinv()
# The float32 coefficients both the plain version and the kernel use.
PINV_F32 = _PINV.astype(np.float32)


def stokes(pol: torch.Tensor):
    """(..., 4) float32 grays -> (a, b, c), each (...,)."""
    p = [pol[..., k] for k in range(4)]
    w = PINV_F32.tolist()
    a, b, c = (p[0] * w[r][0] + p[1] * w[r][1] + p[2] * w[r][2]
               + p[3] * w[r][3] for r in range(3))
    return a, b, c


def iun_and_xolp(pol: torch.Tensor):
    """Stokes fit over the trailing 4-channel axis.

    pol: (..., 4) float32 intensities at [0, 45, 90, 135] degrees, on any
    scale (the reference feeds 0..255 grays).  Returns (iun, rho, phi), each
    (...,): iun = a, rho = DoLP = |(b, c)| / a with inf and NaN set to 0
    (reference xolp.py:26-29), phi = AoLP = atan2(c, b) / 2.
    """
    a, b, c = stokes(pol)
    rho = torch.sqrt(b * b + c * c) / a
    rho = torch.where(torch.isfinite(rho), rho, torch.zeros_like(rho))
    phi = 0.5 * torch.atan2(c, b)
    return a, rho, phi


def xolp_from_pol(pol: torch.Tensor) -> torch.Tensor:
    """(..., 4) captures -> (..., 2) XOLP map stacked (DoLP, AoLP)."""
    _, rho, phi = iun_and_xolp(pol)
    return torch.stack([rho, phi], dim=-1)
