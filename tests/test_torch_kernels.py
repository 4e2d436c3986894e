"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need a CUDA card and skip without one; they import no JAX, so
they also run on the card's machine:
``python -m pytest tests/test_torch_kernels.py -m gpu -q``.  Limits are the
JAX package's own for the TPU kernel (tests/test_pallas_preprocess.py): 2e-6
on XOLP with phi compared modulo pi, 5e-5 on the priors.
"""

import numpy as np
import pytest
import torch

from polardepth_tpu_torch.ops import build
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


@pytest.mark.gpu
def test_polar_preprocess_wrapper_checks_its_input(card):
    with pytest.raises(ValueError, match="contiguous"):
        fused_polar_preprocess(torch.zeros(4, 8, 4, device=card)[:, ::2])
    xo, pr = fused_polar_preprocess(torch.zeros(0, 4, device=card))
    assert xo.shape == (0, 2) and pr.shape == (0, 9)
