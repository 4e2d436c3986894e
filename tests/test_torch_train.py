"""One whole train step of the port against the JAX package's, from the same
weights, batch and random draws: the self-supervised + depth-supervised step
(``make_selfsup_train_step``, with and without pose supervision) and the
published supervised step (``make_train_step``).

Both sides run the published widths at batch 2, 64x96, with dropout 0 (as
tests/test_selfsup.py runs the JAX step).  The JAX package's colour-jitter
factors and automask noise are drawn with its own calls
(data/augment.py:62-90, train/selfsup.py:469-470) and handed to the port.
The self-supervised steps warp with ``warp_impl="pallas_fast"`` on both
sides, so that the JAX package runs its band-warp kernels K2 and K3 in
interpret mode and the port their plain versions.  The JAX gradients are
read from Adam's first moment after the step (mu = 0.1 g).

The JAX side runs in float32 (x64 off), as the port does.  Both sides take
the JAX package's polarization preprocess (its CPU path: ``xolp_from_pol``
and the compare-matrix Fresnel LUT of ``normal_priors_from_xolp``).  The
port's own preprocess (the two-level table of kernel K1) differs from that
LUT by up to ~3e-5 in the priors (tests/test_torch_preprocess.py holds it
against the JAX kernel and the exact path), and train-mode BatchNorm over
the 12 values per channel of the 1/32 feature maps at batch 2, 64x96
amplifies such a difference far beyond these limits in the coarse-scale
disparities.  With the same priors the two steps are compared as steps.

Limits.  The loss and every log term within 1e-5 relative, except the
photometric terms reproj_loss/s, within 1e-3: a one-ulp move of the sampling
grid moves them by more than 1e-5 through the automask's hard threshold
(test_reproj_terms_resolve_to_the_rounding_of_the_grid).  The batch
statistics after the step within 1e-5.  Every gradient within 1e-4 of its
tensor's max abs plus four times the port's own float32 spread there: the
largest change of that gradient between the port's step and the same step
from the weights scaled by 1 +- 2^-20.  At batch 2, 64x96 that spread is
a sizeable fraction of the max for some tensors (the encoder layers behind
train-mode BatchNorm over 12 values per channel, where the gradient is a
small difference of large terms, and the conv biases before a BatchNorm,
whose gradient is zero in exact arithmetic), and small elsewhere.  The parameters after the Adam step
within 1e-6 absolute plus the spread of Adam's first update, lr g/(|g|+eps),
over that gradient limit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from polardepth_tpu import config as jconfig  # noqa: E402
from polardepth_tpu.data.synthetic import SyntheticHammer  # noqa: E402
from polardepth_tpu.train import selfsup as jselfsup  # noqa: E402

from polardepth_tpu_torch import config  # noqa: E402
from polardepth_tpu_torch.train import selfsup  # noqa: E402

from torch_step_parity import (  # noqa: E402,F401
    B, H, W, LOSS_RTOL, REPROJ_RTOL, _float32_jax, _jitter_draws, _run_pair,
    _same_preprocess)


@pytest.mark.parametrize("supervise_pose", [False, True])
def test_selfsup_step_matches_jax(supervise_pose):
    over = dict(height=H, width=W, batch_size=B, dropout_rate=0.0,
                depth_supervision_only=False, supervise_pose=supervise_pose,
                warp_impl="pallas_fast")
    jcfg = jconfig.PUBLISHED.replace(**over)
    tcfg = config.PUBLISHED.replace(**over)
    jmodel = jselfsup.SelfSupModel.from_config(jcfg)
    example = {"color_frames": jnp.zeros((1, 3, H, W, 3), jnp.float32),
               "pol": jnp.zeros((1, H, W, 4), jnp.float32)}
    batch = SyntheticHammer(H, W, seed=2).batch_frames(
        B, frame_ids=tuple(jcfg.frame_ids), offset=2)

    def draws_of(rng):
        k_jit, k_noise, _, _ = jax.random.split(rng, 4)
        key_jit, _ = jax.random.split(k_jit)
        noise = np.asarray(jax.random.normal(jax.random.fold_in(k_noise, 0),
                                             (B, H, W, 1)))
        return {"jitter": _jitter_draws(key_jit, B),
                "noise": {0: torch.from_numpy(noise)}}

    logs = _run_pair(jcfg, jmodel,
                     jselfsup.make_selfsup_train_step(jmodel, jcfg), example,
                     selfsup.SelfSupModel.from_config,
                     selfsup.make_selfsup_train_step, tcfg, batch, draws_of)
    assert ("r_loss" in logs) == supervise_pose
    assert "supervised_depth_loss/3" in logs and "reproj_loss/0" in logs


def test_reproj_terms_resolve_to_the_rounding_of_the_grid(monkeypatch):
    """Why reproj_loss/s is held to REPROJ_RTOL and not LOSS_RTOL: moving
    the port's own sampling grid by one float32 ulp (a relative 2^-23, the
    rounding two frameworks' project_3d differ by) moves the photometric
    terms by more than LOSS_RTOL, through the automask's hard threshold
    (reproj < identity + 1e-5 noise), while the total loss stays within
    LOSS_RTOL and every term within REPROJ_RTOL."""
    cfg = config.PUBLISHED.replace(height=H, width=W, batch_size=B,
                                   dropout_rate=0.0,
                                   depth_supervision_only=False)
    batch = SyntheticHammer(H, W, seed=2).batch_frames(
        B, frame_ids=tuple(cfg.frame_ids), offset=2)
    torch.manual_seed(0)
    model = selfsup.SelfSupModel.from_config(cfg)
    model.train()
    cf = torch.from_numpy(batch["color_frames"].astype(np.float32) / 255)
    pb = {"color": cf[:, 0], "color_frames": cf,
          "K": torch.from_numpy(batch["K"]),
          "depth": torch.from_numpy(batch["depth"])}
    noise = {0: torch.randn(B, H, W, 1,
                            generator=torch.Generator().manual_seed(1))}
    project = selfsup.project_3d
    with torch.no_grad():
        disps, poses = model(cf, torch.from_numpy(
            batch["pol"].astype(np.float32)))
        runs = []
        for eps in (0.0, 2.0 ** -23, -2.0 ** -23, 2.0 ** -22):
            monkeypatch.setattr(
                selfsup, "project_3d",
                lambda *a, e=eps: project(*a) * (1.0 + e))
            warped, depths = selfsup.generate_images_pred(
                cfg, disps, poses, cf, pb["K"],
                torch.from_numpy(batch["inv_K"]))
            _, logs = selfsup.selfsup_losses(cfg, disps, warped, depths, pb,
                                             noise)
            runs.append({k: float(v) for k, v in logs.items()})
    rel = {k: max(abs(r[k] / runs[0][k] - 1) for r in runs[1:])
           for k in runs[0]}
    reproj = [v for k, v in rel.items() if k.startswith("reproj_loss/")]
    assert max(reproj) > LOSS_RTOL
    assert max(reproj) < REPROJ_RTOL
    assert rel["loss"] < LOSS_RTOL
