"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need a CUDA card and skip without one; they import no JAX, so
they also run on the card's machine:
``python -m pytest tests/test_torch_kernels.py -m gpu -q``.  Limits of the
preprocess kernel are the JAX package's own for the TPU kernel
(tests/test_pallas_preprocess.py): 2e-6 on XOLP with phi compared modulo pi,
5e-5 on the priors.  The band-warp kernels K2 and K3: 1e-6 absolute on the
forward (images in [0, 1]), 1e-5 of each one's max abs on dix and diy.
K4 (the image gradient): each pixel within 2 (n - 1) 2^-24 times the sum
of the magnitudes of its n contributions (the same products, summed in
shared memory and by atomics in another order), on the main grids and on
edge cases of its tiles, windows and spills.  Each test also holds the
launch counts: one per kernel call.  K4's counting build (its spill
share) is held on the card to the same limit and to the tap count of
``chip_smoke.img_grad_live_taps``, which is checked on the CPU.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from polardepth_tpu_torch.ops import band_warp, build
from polardepth_tpu_torch.ops.polar_preprocess import (
    fused_polar_preprocess, polar_preprocess_plain)

XOLP_TOL = 2e-6
PRIORS_TOL = 5e-5


def _pol(kind):
    rng = np.random.default_rng(0)
    if kind == "wild":       # DoLP up to ~2: deep extrapolation
        return rng.integers(0, 256, (2, 64, 96, 4)).astype(np.float32)
    if kind == "odd":
        return rng.integers(0, 256, (3, 7, 11, 4)).astype(np.float32)
    shape = (2, 64, 96)
    iun = rng.uniform(30, 220, shape)
    rho = rng.uniform(0, 0.9, shape)
    phi = rng.uniform(-np.pi / 2, np.pi / 2, shape)
    pol = np.stack([iun * (1 + rho * np.cos(2 * a - 2 * phi)) / 2
                    for a in np.deg2rad([0, 45, 90, 135])], axis=-1)
    if kind == "zeros":
        pol[:, ::3, ::2] = 0.0
    return pol.astype(np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["physical", "wild", "zeros", "odd"])
def test_polar_preprocess_kernel_matches_plain_version(card, kind):
    pol = torch.from_numpy(_pol(kind)).to(card)
    before = build.launch_counts["polar_preprocess"]
    xo, pr = fused_polar_preprocess(pol)
    torch.cuda.synchronize()
    assert build.launch_counts["polar_preprocess"] == before + 1
    xo_p, pr_p = polar_preprocess_plain(pol)
    xo, pr, xo_p, pr_p = (t.cpu().numpy() for t in (xo, pr, xo_p, pr_p))
    assert np.isfinite(xo).all() and np.isfinite(pr).all()
    np.testing.assert_allclose(xo[..., 0], xo_p[..., 0], atol=XOLP_TOL)
    d = np.remainder(xo[..., 1].astype(np.float64) - xo_p[..., 1], np.pi)
    assert np.minimum(d, np.pi - d).max() <= XOLP_TOL
    np.testing.assert_allclose(pr, pr_p, atol=PRIORS_TOL)


def _pol_pixels(kind, shape):
    """physical, zero-intensity or wild captures of any pixel shape"""
    rng = np.random.default_rng(sum(shape))
    if kind == "wild":
        return rng.integers(0, 256, (*shape, 4)).astype(np.float32)
    iun = rng.uniform(30, 220, shape)
    rho = rng.uniform(0, 0.9, shape)
    phi = rng.uniform(-np.pi / 2, np.pi / 2, shape)
    pol = np.stack([iun * (1 + rho * np.cos(2 * a - 2 * phi)) / 2
                    for a in np.deg2rad([0, 45, 90, 135])], axis=-1)
    if kind == "zeros":
        pol.reshape(-1, 4)[::3] = 0.0
    return pol.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["physical", "wild", "zeros"])
@pytest.mark.parametrize("shape", [(255,), (256,), (257,), (256 * 3 + 1,),
                                   (3, 7, 11)])
def test_polar_preprocess_kernel_at_the_tile_edges(card, kind, shape):
    """Pixel counts around the kernel's 256-pixel tile and 32-pixel warp
    tiles: every pixel written once, none beyond the end."""
    pol = torch.from_numpy(_pol_pixels(kind, shape)).to(card)
    before = build.launch_counts["polar_preprocess"]
    xo, pr = fused_polar_preprocess(pol)
    torch.cuda.synchronize()
    assert build.launch_counts["polar_preprocess"] == before + 1
    assert xo.shape == (*shape, 2) and pr.shape == (*shape, 9)
    xo_p, pr_p = polar_preprocess_plain(pol)
    xo, pr, xo_p, pr_p = (t.cpu().numpy() for t in (xo, pr, xo_p, pr_p))
    assert np.isfinite(xo).all() and np.isfinite(pr).all()
    np.testing.assert_allclose(xo[..., 0], xo_p[..., 0], atol=XOLP_TOL)
    d = np.remainder(xo[..., 1].astype(np.float64) - xo_p[..., 1], np.pi)
    assert np.minimum(d, np.pi - d).max() <= XOLP_TOL
    np.testing.assert_allclose(pr, pr_p, atol=PRIORS_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,prune_tol", [(1.3, None), (1.5, None),
                                         (1.05, 1e-5)])
def test_polar_preprocess_kernel_with_wide_table_sections(card, n,
                                                          prune_tol):
    """Tables whose curves hold more than 64 coarse bins (every knot kept:
    125; n = 1.05 pruned: 71), which the kernel searches in sections padded
    to 128 rather than 64."""
    pol = torch.from_numpy(_pol_pixels("wild", (4, 33, 35))).to(card)
    xo, pr = fused_polar_preprocess(pol, n, prune_tol)
    xo_p, pr_p = polar_preprocess_plain(pol, n, prune_tol)
    torch.cuda.synchronize()
    assert float((xo - xo_p).abs().max()) <= XOLP_TOL
    assert float((pr - pr_p).abs().max()) <= PRIORS_TOL


@pytest.mark.gpu
def test_polar_preprocess_wrapper_checks_its_input(card):
    with pytest.raises(ValueError, match="contiguous"):
        fused_polar_preprocess(torch.zeros(4, 8, 4, device=card)[:, ::2])
    xo, pr = fused_polar_preprocess(torch.zeros(0, 4, device=card))
    assert xo.shape == (0, 2) and pr.shape == (0, 9)


WARP_TOL = 1e-6
WARP_GRAD_RTOL = 1e-5


def _warp_inputs(card, c, kind, b=2, h=64, w=96):
    """img (B, H, W, C), grid and cotangent; "parallax" keeps rows inside
    the band, "shear" leaves it, "edges" samples integer and border
    coordinates."""
    gen = torch.Generator().manual_seed(c)
    img = torch.rand(b, h, w, c, generator=gen)
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, h), torch.linspace(-1, 1, w),
                            indexing="ij")
    grid = torch.stack([xs, ys], -1).expand(b, h, w, 2).clone()
    if kind == "parallax":
        grid += 0.05 * (torch.rand(b, h, w, 2, generator=gen) - 0.5)
    elif kind == "shear":
        grid[..., 1] += 0.9 * grid[..., 0]
    else:
        grid[..., 0] = torch.where(grid[..., 0] > 0.5, 1.0, grid[..., 0] * 1.5)
    g = torch.randn(b, h, w, c, generator=gen)
    return img.to(card), grid.to(card), g.to(card)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 3, 4, 8, 64])
@pytest.mark.parametrize("kind", ["parallax", "shear", "edges"])
def test_band_warp_kernels_match_plain_versions(card, c, kind):
    img, grid, g = _warp_inputs(card, c, kind)
    geo = band_warp.band_geometry(64, 96, c, 64)
    ix, iy, _ = band_warp.prep(img.shape, grid, geo["k"], geo["step"], True,
                               geo["wp"])
    before = dict(build.launch_counts)
    out = band_warp.band_warp_fwd(img, ix, iy)
    dix, diy = band_warp.band_warp_bwd(img, ix, iy, g)
    torch.cuda.synchronize()
    assert build.launch_counts["band_warp_fwd"] == before["band_warp_fwd"] + 1
    assert build.launch_counts["band_warp_bwd"] == before["band_warp_bwd"] + 1
    out_p = band_warp.band_warp_fwd_plain(img, ix, iy)
    dix_p, diy_p = band_warp.band_warp_bwd_plain(img, ix, iy, g)
    assert float((out - out_p).abs().max()) <= WARP_TOL
    assert float((dix - dix_p).abs().max()) <= \
        WARP_GRAD_RTOL * float(dix_p.abs().max())
    assert float((diy - diy_p).abs().max()) <= \
        WARP_GRAD_RTOL * float(diy_p.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8, 12, 64])
@pytest.mark.parametrize("b,h,w,oh", [(3, 20, 37, 60), (2, 9, 50, 4),
                                      (1, 33, 7, 33)])
def test_band_warp_kernels_at_other_shapes(card, c, b, h, w, oh):
    """Output heights other than H (the plane sweep stacks its depth bins on
    rows), widths that are no multiple of 32, odd batches, and channel
    counts of every K2 layout: compiled (1, 3, 4, 64) and read at run time
    (2, 5 one thread per pixel; 8, 12 lanes over channels)."""
    gen = torch.Generator().manual_seed(b * 1000 + c)
    img = torch.rand(b, h, w, c, generator=gen).to(card)
    grid = (2.4 * torch.rand(b, oh, w, 2, generator=gen) - 1.2).to(card)
    g = torch.randn(b, oh, w, c, generator=gen).to(card)
    geo = band_warp.band_geometry(h, w, c, oh, k=8)
    ix, iy, _ = band_warp.prep(img.shape, grid, geo["k"], geo["step"], True,
                               geo["wp"])
    before = dict(build.launch_counts)
    out = band_warp.band_warp_fwd(img, ix, iy)
    dix, diy = band_warp.band_warp_bwd(img, ix, iy, g)
    torch.cuda.synchronize()
    assert build.launch_counts["band_warp_fwd"] == before["band_warp_fwd"] + 1
    assert build.launch_counts["band_warp_bwd"] == before["band_warp_bwd"] + 1
    assert out.shape == (b, oh, w, c)
    out_p = band_warp.band_warp_fwd_plain(img, ix, iy)
    dix_p, diy_p = band_warp.band_warp_bwd_plain(img, ix, iy, g)
    assert float((out - out_p).abs().max()) <= WARP_TOL
    assert float((dix - dix_p).abs().max()) <= \
        WARP_GRAD_RTOL * float(dix_p.abs().max())
    assert float((diy - diy_p).abs().max()) <= \
        WARP_GRAD_RTOL * float(diy_p.abs().max())


def _chip_smoke():
    root = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _img_grad_limit(img, ix, iy, g):
    """chip_smoke.py's per-pixel limit of K4 against its plain version."""
    return _chip_smoke().img_grad_limit(img, ix, iy, g)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 3, 5])
@pytest.mark.parametrize("kind", ["parallax", "shear", "edges"])
def test_band_warp_img_grad_kernel_matches_plain_version(card, c, kind):
    """K4 (the image gradient) against its plain version, one launch per
    call, through its compiled channel count (3) and its run-time one (1,
    5); the buffer is zeroed by the launcher, so a second call gives the
    same."""
    img, grid, g = _warp_inputs(card, c, kind)
    geo = band_warp.band_geometry(64, 96, c, 64)
    ix, iy, _ = band_warp.prep(img.shape, grid, geo["k"], geo["step"], True,
                               geo["wp"])
    before = dict(build.launch_counts)
    grad = band_warp.band_warp_img_grad(img, ix, iy, g)
    again = band_warp.band_warp_img_grad(img, ix, iy, g)
    torch.cuda.synchronize()
    assert build.launch_counts["band_warp_img_grad"] == \
        before["band_warp_img_grad"] + 2
    plain = band_warp.band_warp_img_grad_plain(img, ix, iy, g)
    limit = _img_grad_limit(img, ix, iy, g)
    assert float(plain.abs().max()) > 0
    for got in (grad, again):
        assert bool(((got - plain).abs() <= limit).all())


def _img_grad_case(kind):
    """(B, H, W, C, ix, iy) of K4's edge cases: coordinates in the image,
    as the band's clamp leaves them, on the CPU."""
    gen = torch.Generator().manual_seed(11)
    shapes = {"batch 1": (1, 64, 96, 3, 64, 96),
              "batch 3": (3, 64, 96, 3, 64, 96),
              "ragged": (2, 29, 37, 3, 13, 50),
              "c 1": (2, 64, 96, 1, 64, 96),
              "c 5": (2, 64, 96, 5, 64, 96),
              "one border pixel": (2, 40, 70, 3, 40, 70),
              "spread and clamped": (2, 40, 300, 3, 16, 64),
              "last row and column": (2, 33, 41, 3, 33, 41),
              "output larger": (2, 20, 30, 3, 70, 130),
              "output smaller": (2, 90, 140, 3, 9, 17),
              "integer": (2, 64, 96, 3, 64, 96),
              "no window": (1, 6, 7, 7000, 9, 11)}
    b, h, w, c, oh, ow = shapes[kind]
    ys, xs = torch.meshgrid(torch.linspace(0, h - 1, oh),
                            torch.linspace(0, w - 1, ow), indexing="ij")
    ix, iy = xs.expand(b, oh, ow).clone(), ys.expand(b, oh, ow).clone()
    ix += torch.rand(b, oh, ow, generator=gen) - 0.5
    iy += torch.rand(b, oh, ow, generator=gen) - 0.5
    if kind == "one border pixel":        # every pixel onto one tap
        ix.fill_(w - 1)
        iy.fill_(h - 1)
    elif kind == "spread and clamped":    # half over the image, half onto
        ix = torch.rand(b, oh, ow, generator=gen) * (w - 1)   # one border
        iy = torch.rand(b, oh, ow, generator=gen) * (h - 1)   # pixel
        ix[..., 1::2] = w - 1
        iy[..., 1::2] = h - 1
    elif kind == "last row and column":   # taps at x = W-1 and y = H-1
        ix[..., ::3] = w - 1
        iy[:, ::2] = h - 1
        ix[..., 1::3] = w - 1.25
        iy[:, 1::4] = h - 1.75
    elif kind == "integer":               # fx = 0 and fy = 0 exactly
        ix, iy = ix.round(), iy.round()
    ix, iy = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
    return b, h, w, c, ix, iy


@pytest.mark.parametrize("kind,per_pixel", [
    ("integer", 1), ("integer columns", 2), ("integer rows", 2),
    ("fractional", 4)])
def test_img_grad_live_taps_on_the_cpu(kind, per_pixel):
    """chip_smoke's count of K4's taps of nonzero weight: a pixel at integer
    coordinates has one, one integer coordinate two, none four."""
    b, h, w, c, ix, iy = _img_grad_case("batch 3")
    ix = (ix.floor() + 0.5).clamp(max=w - 1.5)
    iy = (iy.floor() + 0.25).clamp(max=h - 1.75)
    if kind in ("integer", "integer columns"):
        ix = ix.floor()
    if kind in ("integer", "integer rows"):
        iy = iy.floor()
    assert _chip_smoke().img_grad_live_taps(ix, iy) == per_pixel * ix.numel()


def test_k4_counting_build_refuses_cpu_tensors():
    """The spill count has no plain version: a CPU tensor raises."""
    b, h, w, c, ix, iy = _img_grad_case("batch 1")
    img = torch.zeros(b, h, w, c)
    with pytest.raises(ValueError, match="CUDA tensors"):
        band_warp.band_warp_img_grad_counted(img, ix, iy,
                                             torch.ones(*ix.shape, c))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["batch 1", "batch 3", "ragged", "c 1",
                                  "c 5", "one border pixel",
                                  "spread and clamped",
                                  "last row and column", "output larger",
                                  "output smaller", "integer", "no window"])
def test_band_warp_img_grad_kernel_edge_cases(card, kind):
    """K4 against its plain version, each pixel within its limit, on tiles
    cut by the output's edges, batches of 1 and 3, its run-time channel
    counts, taps clamped onto one pixel (inside the window: shared-memory
    atomics on one cell) or spread wider than the window with every other
    lane clamped onto one border pixel (the spill route, lanes combined),
    taps at x = W-1 and y = H-1 (x1 = x0, y1 = y0), outputs larger and
    smaller than the source, integer coordinates (zero weights) and a C
    for which no window fits (every tap spills)."""
    b, h, w, c, ix, iy = _img_grad_case(kind)
    gen = torch.Generator().manual_seed(12)
    img = torch.zeros(b, h, w, c, device=card)
    g = torch.randn(*ix.shape, c, generator=gen).to(card)
    ix, iy = ix.to(card), iy.to(card)
    before = build.launch_counts["band_warp_img_grad"]
    grad = band_warp.band_warp_img_grad(img, ix, iy, g)
    counted, n = band_warp.band_warp_img_grad_counted(img, ix, iy, g)
    torch.cuda.synchronize()
    assert build.launch_counts["band_warp_img_grad"] == before + 2
    plain = band_warp.band_warp_img_grad_plain(img, ix, iy, g)
    limit = _img_grad_limit(img, ix, iy, g)
    assert float(plain.abs().max()) > 0
    for got in (grad, counted):
        assert bool(torch.isfinite(got).all())
        assert bool(((got - plain).abs() <= limit).all())
        if kind == "integer":
            assert bool((got[plain == 0] == 0).all())
    # the share of taps that spill, counted by the kernel: a smaller output
    # spreads its tiles' taps wider than a window
    assert n["taps"] == _chip_smoke().img_grad_live_taps(ix, iy)
    spill = n["spilled"] / n["taps"]
    assert {"spread and clamped": spill > 0.25, "output smaller": spill > 0,
            "no window": spill == 1.0}.get(kind, spill == 0.0)
    # a C above the window's floats opens none; taps on one pixel open a
    # window of one cell a tile
    tiles = b * -(-ix.shape[1] // 8) * -(-ix.shape[2] // 32)
    if kind == "no window":
        assert n["window_floats"] == 0
    elif kind == "one border pixel":
        assert n["window_floats"] == tiles * c


@pytest.mark.gpu
def test_band_warp_autograd_launches_k4_for_the_image(card):
    """An image that needs a gradient gets it through K4 (and the grid
    through K3), equal to the CPU's plain versions."""
    img, grid, g = _warp_inputs(card, 3, "parallax")
    img.requires_grad_(True)
    grid.requires_grad_(True)
    before = dict(build.launch_counts)
    (band_warp.band_warp(img, grid) * g).sum().backward()
    torch.cuda.synchronize()
    for name in ("band_warp_fwd", "band_warp_bwd", "band_warp_img_grad"):
        assert build.launch_counts[name] == before[name] + 1
    ref_img = img.detach().cpu().requires_grad_(True)
    ref_grid = grid.detach().cpu().requires_grad_(True)
    (band_warp.band_warp(ref_img, ref_grid) * g.cpu()).sum().backward()
    geo = band_warp.band_geometry(64, 96, 3, 64)
    ix, iy, _ = band_warp.prep(img.shape, grid.detach(), geo["k"],
                               geo["step"], True, geo["wp"])
    limit = _img_grad_limit(img.detach(), ix, iy, g).cpu()
    assert bool(((img.grad.cpu() - ref_img.grad).abs() <= limit).all())
    gmax = float(ref_grid.grad.abs().max())
    assert float((grid.grad.cpu() - ref_grid.grad).abs().max()) <= \
        1e-4 * gmax


@pytest.mark.gpu
def test_band_warp_autograd_launches_both_kernels(card):
    img, grid, g = _warp_inputs(card, 3, "parallax")
    grid.requires_grad_(True)
    before = dict(build.launch_counts)
    out = band_warp.band_warp(img, grid)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert build.launch_counts["band_warp_fwd"] == before["band_warp_fwd"] + 1
    assert build.launch_counts["band_warp_bwd"] == before["band_warp_bwd"] + 1
    ref = grid.detach().cpu().requires_grad_(True)
    out_cpu = band_warp.band_warp(img.cpu(), ref)
    (out_cpu * g.cpu()).sum().backward()
    assert float((out.detach().cpu() - out_cpu.detach()).abs().max()) <= \
        WARP_TOL
    gmax = float(ref.grad.abs().max())
    assert float((grid.grad.cpu() - ref.grad).abs().max()) <= 1e-4 * gmax


@pytest.mark.gpu
def test_band_warp_wrappers_check_their_inputs(card):
    img = torch.rand(1, 8, 8, 3, device=card)
    ix = torch.rand(1, 8, 8, device=card)
    with pytest.raises(TypeError, match="float32"):
        band_warp.band_warp_fwd(img.double(), ix, ix)
    with pytest.raises(ValueError, match="several devices"):
        band_warp.band_warp_fwd(img, ix.cpu(), ix)
    with pytest.raises(ValueError, match="contiguous"):
        band_warp.band_warp_fwd(img.permute(0, 2, 1, 3), ix, ix)
    with pytest.raises(ValueError, match="contiguous"):
        band_warp.band_warp_bwd(img, ix, ix,
                                torch.rand(1, 8, 8, 6, device=card)[..., ::2])
    img4 = torch.rand(2 * 8 * 8 * 4 + 1, device=card)[1:].view(2, 8, 8, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        band_warp.band_warp_fwd(img4, torch.rand(2, 8, 8, device=card),
                                torch.rand(2, 8, 8, device=card))
    out = band_warp.band_warp_fwd(torch.rand(0, 8, 8, 3, device=card),
                                  torch.rand(0, 8, 8, device=card),
                                  torch.rand(0, 8, 8, device=card))
    assert out.shape == (0, 8, 8, 3)
