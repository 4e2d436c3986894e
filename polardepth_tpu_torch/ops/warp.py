"""Differentiable bilinear grid sampling with torch ``F.grid_sample``'s
coordinate convention (polardepth_tpu/ops/warp.py:1-180).

``grid_sample`` has three routes, chosen by ``impl``:

  flat4    four corner gathers (plain torch), border or zeros padding;
  xla      the JAX package's name of the plane sweep's exact sampler
           (polardepth_tpu/models/cost_volume.py:148-152): flat4, which
           the sweep calls with zeros padding;
  patch    one (2, 2, C) window per pixel from a padded copy, with the
           position-rebased weights max(0, 1 - |f - j|) (plain torch),
           border or zeros padding;
  pallas*  the banded warp of ops/band_warp.py (kernels K2, K3 and K4 on
           the card), border padding; the name is parsed as the JAX package
           parses it: "pallas[<k>][_fast][_hx[<n>]][_r<rp>]".

Each route reproduces its JAX function's gradients, ties included: the
clips split the cotangent at a bound as ``jnp.clip`` does, and the patch
weights use ``torch.maximum`` as ``jnp.maximum`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from polardepth_tpu_torch.ops.band_warp import band_warp
from polardepth_tpu_torch.ops.clip import clip


def resolve_warp_impl(impl: str, cv: bool = False) -> str:
    """"auto" -> the JAX package's production choice on the TPU, on every
    device: "pallas_fast" for the photometric warps, "pallas8_fast" for a
    plane sweep (cv=True).  So "auto" means kernel K2 on the card and K2's
    plain version on the CPU.  This differs from the JAX package off the
    TPU, where "auto" is "patch" (or "xla" for cv).  Any other name passes
    through."""
    if impl != "auto":
        return impl
    return "pallas8_fast" if cv else "pallas_fast"


def parse_pallas_impl(impl: str, default_k: int = 32) -> dict:
    """"pallas32_fast_hx384_r2" -> {"k": 32, "hx": 384, "rp": 2}
    (ops/warp.py:73-85 of the JAX package); k is default_k where the name
    gives none (8 for the plane sweep, polardepth_tpu/models/
    cost_volume.py:138-144).  "_fast" is accepted and changes nothing: the
    band warp computes the exact form for it too."""
    spec = impl[len("pallas"):]
    rp = 1
    if "_r" in spec and not spec.rpartition("_r")[2].startswith("hx") \
            and spec.rpartition("_r")[2].isdigit():
        spec, _, rps = spec.rpartition("_r")
        rp = int(rps)
    hx = 0
    if "_hx" in spec:
        spec, _, hxs = spec.rpartition("_hx")
        hx = int(hxs) if hxs else 256
    spec = spec.removesuffix("_fast")
    return {"k": int(spec) if spec else default_k, "hx": hx, "rp": rp}


def _source_coords(grid, h: int, w: int, align_corners: bool):
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        return (gx + 1.0) * 0.5 * (w - 1), (gy + 1.0) * 0.5 * (h - 1)
    return ((gx + 1.0) * w - 1.0) * 0.5, ((gy + 1.0) * h - 1.0) * 0.5


def _gather(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (B, N, C), idx (B, OH, OW) -> (B, OH, OW, C)."""
    b, _, c = flat.shape
    out = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "border", align_corners: bool = True,
                impl: str = "flat4") -> torch.Tensor:
    """Sample img (B, H, W, C) at the normalised coordinates grid
    (B, OH, OW, 2) (x over width, y over height, in [-1, 1]) ->
    (B, OH, OW, C)."""
    impl = resolve_warp_impl(impl)
    if impl == "patch":
        return _grid_sample_patch(img, grid, padding_mode, align_corners)
    if impl.startswith("pallas"):
        if padding_mode != "border":
            raise ValueError("impl='pallas*' supports padding_mode='border'")
        return band_warp(img, grid, align_corners=align_corners,
                         **parse_pallas_impl(impl))
    if impl not in ("flat4", "xla"):
        raise ValueError(f"unknown grid_sample impl {impl!r}")
    b, h, w, c = img.shape
    ix, iy = _source_coords(grid, h, w, align_corners)
    if padding_mode == "border":
        ix = clip(ix, 0.0, w - 1)
        iy = clip(iy, 0.0, h - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    x0f, y0f = torch.floor(ix), torch.floor(iy)
    lx = (ix - x0f)[..., None]
    ly = (iy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = x0 + 1, y0 + 1
    w00 = (1 - lx) * (1 - ly)
    w01 = lx * (1 - ly)
    w10 = (1 - lx) * ly
    w11 = lx * ly
    if padding_mode == "zeros":
        vx0 = ((x0 >= 0) & (x0 <= w - 1))[..., None]
        vx1 = ((x1 >= 0) & (x1 <= w - 1))[..., None]
        vy0 = ((y0 >= 0) & (y0 <= h - 1))[..., None]
        vy1 = ((y1 >= 0) & (y1 <= h - 1))[..., None]
        w00 = w00 * (vx0 & vy0)
        w01 = w01 * (vx1 & vy0)
        w10 = w10 * (vx0 & vy1)
        w11 = w11 * (vx1 & vy1)
    x0c, x1c = x0.clamp(0, w - 1), x1.clamp(0, w - 1)
    y0c, y1c = y0.clamp(0, h - 1), y1.clamp(0, h - 1)
    flat = img.reshape(b, h * w, c)
    return (_gather(flat, y0c * w + x0c) * w00
            + _gather(flat, y0c * w + x1c) * w01
            + _gather(flat, y1c * w + x0c) * w10
            + _gather(flat, y1c * w + x1c) * w11)


def _grid_sample_patch(img, grid, padding_mode: str, align_corners: bool):
    """One (2, 2, C) window per output pixel from the image padded by one
    row and column (edge or zero), weighted by max(0, 1 - |f - j|) on the
    clipped window start (ops/warp.py:_grid_sample_patch)."""
    b, h, w, c = img.shape
    ix, iy = _source_coords(grid, h, w, align_corners)
    nchw = img.permute(0, 3, 1, 2)
    if padding_mode == "border":
        ix = clip(ix, 0.0, w - 1)
        iy = clip(iy, 0.0, h - 1)
        padded = F.pad(nchw, (0, 1, 0, 1), mode="replicate")
    elif padding_mode == "zeros":
        padded = F.pad(nchw, (0, 1, 0, 1))
    else:
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    flat = padded.permute(0, 2, 3, 1).reshape(b, (h + 1) * (w + 1), c)
    x0 = torch.floor(ix).clamp(0, w - 1)
    y0 = torch.floor(iy).clamp(0, h - 1)
    fx, fy = ix - x0, iy - y0
    zero = torch.zeros((), dtype=fx.dtype, device=fx.device)

    def weight(f, j):
        return torch.maximum(zero, 1.0 - torch.abs(f - j))[..., None]

    wx0, wx1, wy0, wy1 = weight(fx, 0.0), weight(fx, 1.0), weight(fy, 0.0), \
        weight(fy, 1.0)
    start = y0.long() * (w + 1) + x0.long()
    return (_gather(flat, start) * (wy0 * wx0)
            + _gather(flat, start + 1) * (wy0 * wx1)
            + _gather(flat, start + w + 1) * (wy1 * wx0)
            + _gather(flat, start + w + 2) * (wy1 * wx1))
