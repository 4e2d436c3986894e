"""The port's banded warp (ops/band_warp.py, plain versions of kernels K2 and
K3 on the CPU) and its grid_sample routes (ops/warp.py) against the JAX
package: ``band_warp(..., interpret=True)`` runs the Pallas kernels in
interpret mode, as tests/test_band_warp.py runs them.

Limits: the forward within 1e-6 absolute (images in [0, 1]); gradients with
respect to the grid within 1e-5 of max|g| (the TPU kernel sums its band
products in another order).  The cases are those of tests/test_band_warp.py
(rotated grid, integer identity grid, out-of-band shear, border column) and
the integer-coordinate gradient conventions of K3.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from polardepth_tpu.ops import warp as jwarp  # noqa: E402
from polardepth_tpu.ops.pallas.band_warp import band_warp as jband  # noqa: E402

from polardepth_tpu_torch.ops import band_warp as tband  # noqa: E402
from polardepth_tpu_torch.ops import warp as twarp  # noqa: E402
from polardepth_tpu_torch.ops.clip import clip  # noqa: E402

FWD_ATOL = 1e-6
GRAD_RTOL = 1e-5


def _identity_grid(b, h, w):
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    return np.broadcast_to(np.stack([xs, ys], -1), (b, h, w, 2)).astype(
        np.float32)


def _grid(kind, b, h, w, rng):
    g = _identity_grid(b, h, w).astype(np.float64)
    if kind == "rotated":          # a small rotation and shift
        a = 0.05
        x, y = g[..., 0], g[..., 1]
        g = np.stack([np.cos(a) * x - np.sin(a) * y + 0.03,
                      np.sin(a) * x + np.cos(a) * y - 0.02], -1)
    elif kind == "identity":       # integer source coordinates
        pass
    elif kind == "shear":          # rows leave the band
        g[..., 1] += 0.9 * g[..., 0]
    elif kind == "border":         # columns at and beyond the edges
        g[..., 0] = np.where(g[..., 0] > 0.5, 1.0, g[..., 0] * 1.5)
    elif kind == "parallax":       # random per-pixel parallax
        g = g + rng.uniform(-0.08, 0.08, g.shape)
    return g.astype(np.float32)


def _jax_warp(img, grid, impl_kw, cot):
    def f(gr):
        out = jband(jnp.asarray(img), gr, interpret=True, **impl_kw)
        return jnp.sum(out * jnp.asarray(cot)), out
    (_, out), dg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(grid))
    return np.asarray(out), np.asarray(dg)


def _torch_warp(fn, img, grid, cot):
    g = torch.from_numpy(grid).requires_grad_(True)
    out = fn(torch.from_numpy(img), g)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), g.grad.numpy()


def _compare(img, grid, cot, jax_kw, torch_fn):
    ref_out, ref_dg = _jax_warp(img, grid, jax_kw, cot)
    out, dg = _torch_warp(torch_fn, img, grid, cot)
    assert out.shape == ref_out.shape
    np.testing.assert_allclose(out, ref_out, rtol=0, atol=FWD_ATOL)
    scale = max(np.abs(ref_dg).max(), 1e-30)
    np.testing.assert_allclose(dg, ref_dg, rtol=0, atol=GRAD_RTOL * scale)
    return out, dg


@pytest.mark.parametrize("kind", ["rotated", "identity", "shear", "border",
                                  "parallax"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("k,rp", [(32, 1), (8, 1), (8, 2)])
@pytest.mark.parametrize("align_corners", [True, False])
def test_band_warp_matches_pallas_interpret(kind, c, k, rp, align_corners):
    rng = np.random.default_rng(0)
    b, h, w = 2, 64, 96
    img = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    grid = _grid(kind, b, h, w, rng)
    cot = rng.normal(size=(b, h, w, c)).astype(np.float32)
    kw = dict(k=k, rp=rp, align_corners=align_corners)
    _compare(img, grid, cot, dict(kw, fast=True),
             lambda i, g: tband.band_warp(i, g, **kw))


@pytest.mark.parametrize("kind", ["rotated", "shear", "border", "parallax"])
def test_band_warp_plane_sweep_shape_matches_pallas_interpret(kind):
    """The plane sweep's shape class (polardepth_tpu/models/cost_volume.py:
    134-147): 64 feature channels, k = 8, and OH = 4 H, the output rows
    holding one grid per depth bin, each bin's grid shifted a little more."""
    rng = np.random.default_rng(5)
    b, h, w, c, bins = 2, 16, 24, 64, 4
    img = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    grid = np.concatenate([_grid(kind, b, h, w, rng) + np.float32(0.04 * d)
                           for d in range(bins)], axis=1)
    assert grid.shape == (b, bins * h, w, 2)
    cot = rng.normal(size=(b, bins * h, w, c)).astype(np.float32)
    out, _ = _compare(img, grid, cot, dict(k=8),
                      lambda i, g: tband.band_warp(i, g, k=8))
    assert out.shape == (b, bins * h, w, c)


@pytest.mark.parametrize("kind", ["rotated", "border", "parallax"])
@pytest.mark.parametrize("hx", [0, 256])
def test_band_warp_horizontal_window(kind, hx):
    """hx=256 is a real window only where the padded width exceeds it, so
    this runs at W = 384 (at W = 96 the JAX package turns hx off)."""
    rng = np.random.default_rng(1)
    b, h, w, c = 1, 16, 384, 3
    img = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    grid = _grid(kind, b, h, w, rng)
    if kind == "parallax":         # columns that leave the window
        grid[..., 0] += np.where(np.arange(w) % 128 < 8, 0.6, 0.0)
    cot = rng.normal(size=(b, h, w, c)).astype(np.float32)
    assert tband.band_geometry(h, w, c, h, 8, hx)["hx"] == hx
    kw = dict(k=8, hx=hx)
    _compare(img, grid, cot, kw, lambda i, g: tband.band_warp(i, g, **kw))


def test_band_clamp_is_exercised_by_the_shear():
    """The shear grid leaves a 32-row band, so K2 clamps there and differs
    from the exact border warp; the parallax grid stays inside."""
    rng = np.random.default_rng(0)
    b, h, w = 2, 64, 96
    img = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32))
    for kind, clamps in (("shear", True), ("parallax", False)):
        g = torch.from_numpy(_grid(kind, b, h, w, rng))
        band = tband.band_warp(img, g, k=32)
        exact = twarp.grid_sample(img, g, impl="flat4")
        assert bool((band - exact).abs().max() > 1e-3) == clamps


def test_integer_coordinate_gradient_conventions():
    """K3's conventions at integer coordinates: d/dix is the right
    difference, 0 at ix = W-1; d/diy is 0 where iy is an integer."""
    rng = np.random.default_rng(3)
    b, h, w, c = 1, 8, 6, 2
    img = torch.from_numpy(rng.uniform(0, 1, (b, h, w, c)).astype(np.float32))
    ix = torch.tensor([[[0.0, 2.0, 5.0, 2.5]]])
    iy = torch.tensor([[[3.0, 3.0, 3.0, 3.25]]])
    g = torch.ones(b, 1, 4, c)
    dix, diy = tband.band_warp_bwd(img, ix, iy, g)
    im = img[0].numpy()
    want_dx = [(im[3, 1] - im[3, 0]).sum(), (im[3, 3] - im[3, 2]).sum(), 0.0,
               0.75 * (im[3, 3] - im[3, 2]).sum()
               + 0.25 * (im[4, 3] - im[4, 2]).sum()]
    np.testing.assert_allclose(dix[0, 0].numpy(), want_dx, rtol=1e-6,
                               atol=1e-7)
    t = lambda y: (0.5 * im[y, 2] + 0.5 * im[y, 3]).sum()  # noqa: E731
    np.testing.assert_allclose(diy[0, 0].numpy(), [0, 0, 0, t(4) - t(3)],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("impl", ["flat4", "patch"])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("kind", ["rotated", "identity", "border",
                                  "parallax"])
def test_grid_sample_plain_routes_match_jax(impl, padding_mode, kind):
    rng = np.random.default_rng(2)
    b, h, w, c = 2, 16, 24, 3
    img = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    grid = _grid(kind, b, h, w, rng) * np.float32(1.1)  # some out of range
    cot = rng.normal(size=(b, h, w, c)).astype(np.float32)

    def jf(gr):
        out = jwarp.grid_sample(jnp.asarray(img), gr, padding_mode, True,
                                impl)
        return jnp.sum(out * jnp.asarray(cot)), out
    (_, ref), ref_dg = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(grid))
    out, dg = _torch_warp(
        lambda i, g: twarp.grid_sample(i, g, padding_mode, True, impl),
        img, grid, cot)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=FWD_ATOL)
    ref_dg = np.asarray(ref_dg)
    np.testing.assert_allclose(dg, ref_dg, rtol=0,
                               atol=GRAD_RTOL * np.abs(ref_dg).max())


def test_clip_splits_the_gradient_at_a_bound_as_jax_does():
    x = torch.tensor([0.0, 0.5, 1.0, 1.5], requires_grad=True)
    clip(x, 0.0, 1.0).sum().backward()
    ref = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(
        jnp.asarray([0.0, 0.5, 1.0, 1.5], jnp.float32))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ref))


def test_warp_impl_names():
    assert twarp.resolve_warp_impl("auto") == "pallas_fast"
    assert twarp.resolve_warp_impl("auto", cv=True) == "pallas8_fast"
    assert twarp.resolve_warp_impl("patch") == "patch"
    assert twarp.parse_pallas_impl("pallas") == {"k": 32, "hx": 0, "rp": 1}
    assert twarp.parse_pallas_impl("pallas16_fast_hx_r2") == {
        "k": 16, "hx": 256, "rp": 2}
    assert twarp.parse_pallas_impl("pallas8_hx384") == {
        "k": 8, "hx": 384, "rp": 1}
    with pytest.raises(ValueError, match="border"):
        twarp.grid_sample(torch.zeros(1, 4, 4, 1), torch.zeros(1, 4, 4, 2),
                          padding_mode="zeros", impl="pallas")


def test_wrappers_check_their_inputs_on_the_cpu():
    img = torch.zeros(1, 4, 4, 3)
    ix = torch.zeros(1, 4, 4)
    with pytest.raises(TypeError, match="float32"):
        tband.band_warp_fwd(img.double(), ix, ix)
    with pytest.raises(ValueError, match="shapes"):
        tband.band_warp_fwd(img, ix[0], ix[0])
    with pytest.raises(ValueError, match="cotangent"):
        tband.band_warp_bwd(img, ix, ix, torch.zeros(1, 4, 4, 1))


def test_band_warp_refuses_an_image_that_requires_a_gradient():
    """The kernels give the image no gradient, so band_warp refuses an image
    that needs one rather than drop it (ROADMAP Queue 2 item c)."""
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.uniform(0, 1, (1, 16, 24, 3)).astype(
        np.float32)).requires_grad_(True)
    grid = torch.from_numpy(_grid("parallax", 1, 16, 24, rng)).requires_grad_(
        True)
    with pytest.raises(RuntimeError, match="image requires a gradient"):
        tband.band_warp(img, grid, k=8)
    with pytest.raises(RuntimeError, match="Queue 2 item c"):
        twarp.grid_sample(img, grid, impl="pallas_fast")
    with torch.no_grad():          # no gradient is asked for: nothing lost
        assert tband.band_warp(img, grid, k=8).shape == (1, 16, 24, 3)


def test_band_warp_on_a_data_image_passes_the_grid_gradient():
    """The same call on a data image gives the grid K3's gradient, equal to
    the JAX package's in interpret mode."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (1, 16, 24, 3)).astype(np.float32)
    grid = _grid("parallax", 1, 16, 24, rng)
    cot = rng.normal(size=(1, 16, 24, 3)).astype(np.float32)
    _, dg = _compare(img, grid, cot, dict(k=8),
                     lambda i, g: tband.band_warp(i, g, k=8))
    assert np.abs(dg).max() > 0
