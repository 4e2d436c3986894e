"""Banded bilinear warp: ``grid_sample(padding_mode="border")`` whose source
rows are clamped into a K-row band, differentiable with respect to the grid
and the image.

The counterpart of polardepth_tpu/ops/pallas/band_warp.py:band_warp (:431).
The coordinate arithmetic of that module (``_prep`` :295-323, ``_base_of``
:326-336, and the k, step, hx and rp rounding of ``band_warp`` :455-471) is
copied here in plain, differentiable torch.  On the clamped coordinates the
TPU kernels reduce to plain bilinear sampling (forward, kernel K2) and its
gradient with respect to (ix, iy) in the TPU's own conventions (kernel K3);
csrc/band_warp.cu states them.  The gradient with respect to the image is
kernel K4, the scatter that transposes K2, which the JAX package does not
have: its custom VJP gives the image a zero cotangent, where its exact routes
("patch", "flat4") give the true one, as K4 does.  ``_BandWarp`` launches
those kernels for CUDA tensors, and runs the plain torch versions below for
CPU tensors.

The JAX package's ``fast=True`` only rounded the TPU's MXU operands to
bf16, and its interpret mode ignores it; the port has no such flag and
computes the exact form for every ``_fast`` name of ops/warp.py.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from polardepth_tpu_torch.ops import build
from polardepth_tpu_torch.ops.clip import clip

_LIB = "band_warp"
_TX = 128  # the TPU kernel's output-column tile of the hx window


# --- the plain versions of the kernels --------------------------------------

def tap_index(h: int, w: int, ix: torch.Tensor, iy: torch.Tensor):
    """(fx, fy, i00, i01, i10, i11): the fractions (B, OH, OW, 1) and the
    flat source indices y * W + x (B, OH, OW) of the four taps at
    x0 = floor(ix), x1 = min(x0+1, W-1) and likewise in y, as the kernels
    take them."""
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    fx, fy = (ix - x0f)[..., None], (iy - y0f)[..., None]
    x0 = x0f.long().clamp(0, w - 1)
    y0 = y0f.long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    return fx, fy, y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1


def _taps(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor):
    """(fx, fy, v00, v01, v10, v11): the fractions (B, OH, OW, 1) and the four
    source taps (B, OH, OW, C) of ``tap_index``."""
    b, h, w, c = img.shape
    fx, fy, *index = tap_index(h, w, ix, iy)
    flat = img.reshape(b, h * w, c)

    def tap(i):
        idx = i.reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*ix.shape, c)

    return (fx, fy, *map(tap, index))


def band_warp_fwd_plain(img, ix, iy) -> torch.Tensor:
    """K2's function: bilinear taps of img (B, H, W, C) at (ix, iy)
    (B, OH, OW) -> (B, OH, OW, C)."""
    fx, fy, v00, v01, v10, v11 = _taps(img, ix, iy)
    t0 = (1.0 - fx) * v00 + fx * v01
    t1 = (1.0 - fx) * v10 + fx * v11
    return (1.0 - fy) * t0 + fy * t1


def band_warp_bwd_plain(img, ix, iy, g):
    """K3's function: the cotangent g (B, OH, OW, C) -> (dix, diy), each
    (B, OH, OW).  dix is the one-hot difference at x0 = floor(ix); diy is
    sum_c g (t1 - t0) where fy > 0 and 0 where iy is an integer."""
    fx, fy, v00, v01, v10, v11 = _taps(img, ix, iy)
    dix = (g * ((1.0 - fy) * (v01 - v00) + fy * (v11 - v10))).sum(-1)
    t0 = (1.0 - fx) * v00 + fx * v01
    t1 = (1.0 - fx) * v10 + fx * v11
    diy = torch.where(fy[..., 0] > 0, (g * (t1 - t0)).sum(-1), 0.0)
    return dix, diy


def band_warp_img_grad_plain(img, ix, iy, g) -> torch.Tensor:
    """K4's function, the gradient of ``band_warp_fwd_plain`` with respect to
    the image: the cotangent g (B, OH, OW, C) times each of the four bilinear
    weights, (1-fx)(1-fy), fx(1-fy), (1-fx)fy and fx fy, added into its tap
    -> (B, H, W, C).  img gives only the shape."""
    b, h, w, c = img.shape
    fx, fy, *index = tap_index(h, w, ix, iy)
    weights = ((1.0 - fx) * (1.0 - fy), fx * (1.0 - fy), (1.0 - fx) * fy,
               fx * fy)
    grad = torch.zeros(b, h * w, c, dtype=g.dtype, device=g.device)
    for i, wt in zip(index, weights):
        grad.scatter_add_(1, i.reshape(b, -1, 1).expand(-1, -1, c),
                          (wt * g).reshape(b, -1, c))
    return grad.reshape(b, h, w, c)


# --- the kernels' wrappers ---------------------------------------------------

def _check(img, ix, iy, g=None):
    tensors = (img, ix, iy) + ((g,) if g is not None else ())
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("band_warp takes float32 tensors, got "
                        f"{[t.dtype for t in tensors]}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"band_warp tensors lie on several devices: "
                         f"{sorted(map(str, devices))}")
    if img.dim() != 4 or ix.dim() != 3 or ix.shape != iy.shape or \
            ix.shape[0] != img.shape[0]:
        raise ValueError(f"band_warp shapes: img {tuple(img.shape)} must be "
                         f"(B, H, W, C), ix {tuple(ix.shape)} and iy "
                         f"{tuple(iy.shape)} (B, OH, OW)")
    if g is not None and g.shape != (*ix.shape, img.shape[3]):
        raise ValueError(f"band_warp cotangent {tuple(g.shape)} must be "
                         f"{(*ix.shape, img.shape[3])}")
    device = img.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no band_warp kernel for device {device}")
    if device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("band_warp kernels take contiguous tensors")
    if device.type == "cuda" and img.shape[3] % 4 == 0 and \
            img.data_ptr() % 16:
        raise ValueError("band_warp kernels read an image of 4k channels as "
                         "float4: it must be 16-byte aligned")
    return device


def _launch(fn, *ptrs_and_ints, device):
    lib = build.library(_LIB)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(_LIB, getattr(lib, fn)(*ptrs_and_ints, stream))


def band_warp_fwd(img, ix, iy) -> torch.Tensor:
    """K2: img (B, H, W, C), ix, iy (B, OH, OW) float32, coordinates already
    clamped (``_prep``) -> (B, OH, OW, C).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel on the current stream, or
    raises."""
    device = _check(img, ix, iy)
    if device.type == "cpu":
        return band_warp_fwd_plain(img, ix, iy)
    _, h, w, c = img.shape
    out = torch.empty(*ix.shape, c, dtype=torch.float32, device=device)
    ran_lanes = ctypes.c_int(0)
    _launch("band_warp_fwd_launch", img.data_ptr(), ix.data_ptr(),
            iy.data_ptr(), out.data_ptr(), h, w, c,
            ix.shape[1] * ix.shape[2], ix.numel(), ctypes.byref(ran_lanes),
            device=device)
    build.launch_counts["band_warp_fwd"] += 1
    build.launch_counts["band_warp_fwd_lanes"] += ran_lanes.value
    return out


def band_warp_bwd(img, ix, iy, g):
    """K3: as ``band_warp_fwd`` plus the cotangent g (B, OH, OW, C) ->
    (dix, diy), each (B, OH, OW)."""
    device = _check(img, ix, iy, g)
    if device.type == "cpu":
        return band_warp_bwd_plain(img, ix, iy, g)
    _, h, w, c = img.shape
    dix = torch.empty_like(ix)
    diy = torch.empty_like(iy)
    _launch("band_warp_bwd_launch", img.data_ptr(), ix.data_ptr(),
            iy.data_ptr(), g.data_ptr(), dix.data_ptr(), diy.data_ptr(), h, w,
            c, ix.shape[1] * ix.shape[2], ix.numel(), device=device)
    build.launch_counts["band_warp_bwd"] += 1
    return dix, diy


def band_warp_img_grad(img, ix, iy, g) -> torch.Tensor:
    """K4: as ``band_warp_bwd`` -> the image's gradient (B, H, W, C).  On the
    card the sums are formed in shared memory and with atomics, so their
    order, and the last bits, change from run to run."""
    device = _check(img, ix, iy, g)
    if device.type == "cpu":
        return band_warp_img_grad_plain(img, ix, iy, g)
    return _img_grad(img, ix, iy, g, None)


IMG_GRAD_COUNTS = ("taps", "spilled", "window_floats")


def band_warp_img_grad_counted(img, ix, iy, g):
    """K4's counting build, for measurement: as ``band_warp_img_grad`` ->
    (grad, counts), counts {"taps": taps of nonzero weight, "spilled": those
    of them that went past the block's window to device memory,
    "window_floats": the floats of the windows opened}.  Card only: a
    count of the kernel's routes has no plain version, so a CPU tensor
    raises."""
    device = _check(img, ix, iy, g)
    if device.type != "cuda":
        raise ValueError("band_warp_img_grad_counted counts K4's routes on "
                         "the card; it takes CUDA tensors")
    counts = torch.empty(len(IMG_GRAD_COUNTS), dtype=torch.int64,
                         device=device)
    grad = _img_grad(img, ix, iy, g, counts)
    return grad, dict(zip(IMG_GRAD_COUNTS, counts.tolist()))


def _img_grad(img, ix, iy, g, counts):
    b, h, w, c = img.shape
    grad = torch.empty_like(img)
    _launch("band_warp_img_grad_launch", ix.data_ptr(), iy.data_ptr(),
            g.data_ptr(), grad.data_ptr(), h, w, c, b, ix.shape[1],
            ix.shape[2], None if counts is None else counts.data_ptr(),
            device=img.device)
    build.launch_counts["band_warp_img_grad"] += 1
    return grad


class _BandWarp(torch.autograd.Function):
    """K2 forward; K3 backward for the coordinates and K4 for the image, each
    only where its input needs a gradient."""

    @staticmethod
    def forward(ctx, img, ix, iy):
        ctx.save_for_backward(img, ix, iy)
        return band_warp_fwd(img, ix, iy)

    @staticmethod
    def backward(ctx, g):
        img, ix, iy = ctx.saved_tensors
        g = g.contiguous()
        d_img = dix = diy = None
        if ctx.needs_input_grad[0]:
            d_img = band_warp_img_grad(img, ix, iy, g)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dix, diy = band_warp_bwd(img, ix, iy, g)
        return d_img, dix, diy


# --- the coordinate arithmetic of the JAX package's band_warp ----------------

def _hx_start(t0: int, tw: int, hx: int, wp: int) -> int:
    return min(max(t0 + tw // 2 - hx // 2, 0), wp - hx)


def _base_of(iy: torch.Tensor, h: int, k: int, step: int, rp: int = 1):
    """Per-row-group band start (B, OH/rp): the group's min floor(iy),
    rounded down to a multiple of step, clipped into [0, H-K]."""
    ymin = torch.floor(iy).long().amin(dim=2)
    if rp > 1:
        ymin = ymin.reshape(ymin.shape[0], -1, rp).amin(dim=2)
    return ((ymin // step) * step).clamp(0, max(h - k, 0))


def band_geometry(h: int, w: int, c: int, oh: int, k: int = 32, hx: int = 0,
                  rp: int = 1) -> dict:
    """The band's k, step, padded width wp, hx and rp as the JAX package
    derives them from the requested ones (band_warp.py:455-471)."""
    if rp > 1 and oh % rp != 0:
        rp = 1
    k = min(k + (rp - 1), h)
    step = 8 // math.gcd(c, 8)
    k = min(((k + step - 1) // step) * step, (h // step) * step)
    wp = ((w + 1 + 127) // 128) * 128
    if hx:
        hx = max(((hx + 127) // 128) * 128, 256)
        if hx >= wp:
            hx = 0
    return {"k": k, "step": step, "wp": wp, "hx": hx, "rp": rp}


def prep(img_shape, grid: torch.Tensor, k: int, step: int,
         align_corners: bool, wp: int = 0, hx: int = 0, rp: int = 1):
    """grid (B, OH, OW, 2) -> (ix, iy, base): the source coordinates clipped
    into the image, into each tile's hx window and into the band, with
    ``jnp.clip``'s gradient (band_warp.py:_prep)."""
    _, h, w, _ = img_shape
    ow = grid.shape[2]
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        ix = (gx + 1.0) * 0.5 * (w - 1)
        iy = (gy + 1.0) * 0.5 * (h - 1)
    else:
        ix = ((gx + 1.0) * w - 1.0) * 0.5
        iy = ((gy + 1.0) * h - 1.0) * 0.5
    ix = clip(ix, 0.0, w - 1)
    if hx:
        lo = np.zeros((ow,), np.float32)
        for t0 in range(0, ow, _TX):
            tw = min(_TX, ow - t0)
            lo[t0:t0 + tw] = _hx_start(t0, tw, hx, wp)
        lo_t = torch.from_numpy(lo).to(ix.device)
        ix = clip(ix, lo_t, lo_t + (hx - 2))
    iy = clip(iy, 0.0, h - 1)
    base = _base_of(iy.detach(), h, k, step, rp)
    rows = base.repeat_interleave(rp, dim=1) if rp > 1 else base
    lo = rows[..., None].to(iy.dtype)
    iy = clip(iy, lo, lo + (k - 1))
    return ix, iy, base


def band_warp(img: torch.Tensor, grid: torch.Tensor, *, k: int = 32,
              align_corners: bool = True, hx: int = 0,
              rp: int = 1) -> torch.Tensor:
    """grid_sample(padding_mode='border') of img (B, H, W, C) float32 at grid
    (B, OH, OW, 2) -> (B, OH, OW, C), through kernels K2, K3 and K4 on the
    card.

    Exact bilinear wherever each output row's source rows fit the K-row
    band; beyond it the source row is clamped to the band's edge.  hx > 0
    also clamps each 128-column output tile's source columns into an
    hx-wide window, and rp > 1 shares one band between rp output rows, as
    in the JAX package.  Differentiable with respect to grid (K3) and img
    (K4).
    """
    _, h, w, c = img.shape
    geo = band_geometry(h, w, c, grid.shape[1], k, hx, rp)
    ix, iy, _ = prep(img.shape, grid, geo["k"], geo["step"], align_corners,
                     geo["wp"], geo["hx"], geo["rp"])
    return _BandWarp.apply(img, ix, iy)
