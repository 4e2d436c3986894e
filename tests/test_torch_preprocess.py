"""The port's polar preprocess (polardepth_tpu_torch/ops) against the JAX
package: the Stokes fit, the Fresnel tables, and the plain version of the CUDA
kernel against the Pallas kernel (interpret mode) and against the exact
searchsorted path.

Limits are the JAX package's own for its kernel (tests/test_pallas_preprocess):
2e-6 on XOLP, with phi compared modulo pi (AoLP is defined mod pi, and two
valid summation orders can land on either side of the cut), and 5e-5 on the
priors.  Inputs are float32 numpy arrays handed to both frameworks.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from polardepth_tpu.ops import fresnel as jax_fresnel  # noqa: E402
from polardepth_tpu.ops import xolp as jax_xolp  # noqa: E402
from polardepth_tpu.ops.pallas.polar_preprocess import (  # noqa: E402
    fused_polar_preprocess as pallas_preprocess)

from polardepth_tpu_torch.ops import build, fresnel, xolp  # noqa: E402
from polardepth_tpu_torch.ops.polar_preprocess import (  # noqa: E402
    fused_polar_preprocess, polar_preprocess_plain)

XOLP_TOL = 2e-6
PRIORS_TOL = 5e-5


def _physical_pol(shape, seed):
    """I(a) = Iun (1 + rho cos(2a - 2phi)) / 2 with DoLP in [0, 0.9), as
    tests/test_pallas_preprocess.py makes it."""
    rng = np.random.default_rng(seed)
    iun = rng.uniform(30, 220, shape)
    rho = rng.uniform(0, 0.9, shape)
    phi = rng.uniform(-np.pi / 2, np.pi / 2, shape)
    angs = np.deg2rad([0, 45, 90, 135])
    return np.stack([iun * (1 + rho * np.cos(2 * a - 2 * phi)) / 2
                     for a in angs], axis=-1).astype(np.float32)


def _inputs(kind):
    rng = np.random.default_rng(3)
    if kind == "physical":
        return _physical_pol((2, 16, 24), seed=0)
    if kind == "wild":       # DoLP up to ~2: deep extrapolation
        return rng.integers(0, 256, (2, 16, 24, 4)).astype(np.float32)
    if kind == "zeros":
        pol = _physical_pol((1, 8, 64), seed=1)
        pol[:, ::3, ::2] = 0.0
        return pol
    if kind == "odd":        # P = 231 pixels, no multiple of any tile
        return rng.integers(0, 256, (3, 7, 11, 4)).astype(np.float32)
    raise ValueError(kind)


def _phi_err(a, b):
    d = np.remainder(np.asarray(a, np.float64) - np.asarray(b, np.float64),
                     np.pi)
    return np.minimum(d, np.pi - d)


def _port(pol):
    xo, pr = polar_preprocess_plain(torch.from_numpy(pol))
    return xo.numpy(), pr.numpy()


def test_pinv_is_the_jax_packages():
    np.testing.assert_array_equal(xolp._PINV, jax_xolp._PINV)


def test_tables_equal_the_jax_packages():
    ours = fresnel.HierarchicalInterp(1.5, prune_tol=1e-5)
    ref = jax_fresnel.HierarchicalInterp(1.5, prune_tol=1e-5)
    assert ours.sect_sizes == ref.sect_sizes == [60, 42, 19]
    np.testing.assert_array_equal(ours._cknots, ref._cknots)
    np.testing.assert_array_equal(ours._table, ref._table)
    ck, rows, offsets = ours.device_tables()
    assert rows.shape == (121, 32) and offsets.tolist() == [0, 60, 102, 121]
    for ci in range(3):
        lo, hi = offsets[ci], offsets[ci + 1]
        np.testing.assert_array_equal(
            rows[lo:hi, :31], ref._table[lo:hi, 31 * ci:31 * ci + 31]
            .astype(np.float32))


def test_prune_knots_equal_the_jax_packages():
    xp, fp = fresnel._diffuse_curve(1.5)
    for got, want in zip(fresnel.prune_knots(xp, fp, 1e-5),
                         jax_fresnel.prune_knots(xp, fp, 1e-5)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["physical", "wild", "zeros", "odd"])
def test_iun_and_xolp_match_jax(kind):
    pol = _inputs(kind)
    a, rho, phi = (t.numpy() for t in xolp.iun_and_xolp(torch.from_numpy(pol)))
    ja, jrho, jphi = (np.asarray(t) for t in
                      jax_xolp.iun_and_xolp(jnp.asarray(pol)))
    np.testing.assert_allclose(a, ja, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(rho, jrho, atol=XOLP_TOL)
    assert _phi_err(phi, jphi).max() <= XOLP_TOL


@pytest.mark.parametrize("kind", ["physical", "wild", "zeros", "odd"])
def test_plain_version_matches_pallas_kernel(kind):
    """Both read the same pruned two-level table in float32."""
    pol = _inputs(kind)
    xo, pr = _port(pol)
    jxo, jpr = (np.asarray(t) for t in
                pallas_preprocess(jnp.asarray(pol), interpret=True))
    assert xo.shape == jxo.shape and pr.shape == jpr.shape
    assert np.isfinite(xo).all() and np.isfinite(pr).all()
    np.testing.assert_allclose(xo[..., 0], jxo[..., 0], atol=XOLP_TOL)
    assert _phi_err(xo[..., 1], jxo[..., 1]).max() <= XOLP_TOL
    np.testing.assert_allclose(pr, jpr, atol=PRIORS_TOL)


@pytest.mark.parametrize("kind", ["physical", "wild", "zeros", "odd"])
def test_plain_version_matches_exact_path(kind):
    """Against searchsorted on the unpruned 1000-point curves (scipy
    interp1d semantics).  Beyond DoLP 0.95 the Brewster extrapolation
    amplifies any float32 order of evaluation, as the JAX package's own test
    of its kernel notes, so wild data is compared below it."""
    pol = _inputs(kind)
    xo, pr = _port(pol)
    jxo = np.asarray(jax_xolp.xolp_from_pol(jnp.asarray(pol)))
    jpr = np.asarray(jax_fresnel.normal_priors_from_xolp(
        jnp.asarray(jxo), 1.5, method="exact"))
    mask = jxo[..., 0] <= 0.95
    assert mask.mean() > 0.25
    np.testing.assert_allclose(pr[mask], jpr[mask], atol=PRIORS_TOL)
    if kind == "zeros":
        assert (xo[:, ::3, ::2, 0] == 0.0).all()   # DoLP 0/0 -> 0


def test_atan2_signed_zeros():
    """phi of every sign combination of zero and small captures agrees with
    IEEE atan2 on the same float32 Stokes sums: sign bits exactly, values to
    an ulp (torch's and numpy's atan2 are different implementations), and
    with the Pallas kernel's signbit/copysign atan2 modulo pi."""
    vals = np.array([0.0, -0.0, 1.0, 2.0], np.float32)
    grid = np.stack(np.meshgrid(vals, vals, vals, vals, indexing="ij"),
                    axis=-1).reshape(1, 16, 16, 4)
    _, _, phi = xolp.iun_and_xolp(torch.from_numpy(grid))
    w = xolp.PINV_F32
    p = [grid[..., k] for k in range(4)]
    b = ((p[0] * w[1, 0] + p[1] * w[1, 1]) + p[2] * w[1, 2]) + p[3] * w[1, 3]
    c = ((p[0] * w[2, 0] + p[1] * w[2, 1]) + p[2] * w[2, 2]) + p[3] * w[2, 3]
    want = np.float32(0.5) * np.arctan2(c, b)
    np.testing.assert_allclose(phi.numpy(), want, rtol=2e-7, atol=0)
    np.testing.assert_array_equal(np.signbit(phi.numpy()), np.signbit(want))
    assert (np.signbit(b) & (b == 0)).any() and (np.signbit(c) & (c == 0)).any()
    jxo, _ = pallas_preprocess(jnp.asarray(grid), interpret=True)
    assert _phi_err(phi.numpy(), np.asarray(jxo)[..., 1]).max() <= XOLP_TOL


def test_wrapper_takes_plain_version_on_cpu():
    pol = torch.from_numpy(_inputs("physical"))
    before = dict(build.launch_counts)
    xo, pr = fused_polar_preprocess(pol)
    xo_p, pr_p = polar_preprocess_plain(pol)
    assert torch.equal(xo, xo_p) and torch.equal(pr, pr_p)
    assert build.launch_counts == before


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        fused_polar_preprocess(torch.zeros(2, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        fused_polar_preprocess(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="no kernel"):
        fused_polar_preprocess(torch.zeros(2, 4, device="meta"))
