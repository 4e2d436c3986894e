"""The published supervised train step of the port (``make_train_step``)
against the JAX package's, from the same weights, batch and jitter factors,
at batch 2, 64x96 and the published widths.  The comparison and its limits
are those of test_torch_train.py (tests/torch_step_parity.py).
"""

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from polardepth_tpu import config as jconfig  # noqa: E402
from polardepth_tpu.data.synthetic import SyntheticHammer  # noqa: E402
from polardepth_tpu.train import trainer as jtrainer  # noqa: E402

from polardepth_tpu_torch import config  # noqa: E402
from polardepth_tpu_torch.train import trainer  # noqa: E402

from torch_step_parity import (  # noqa: E402,F401
    B, H, W, _float32_jax, _jitter_draws, _run_pair, _same_preprocess)


def test_supervised_step_matches_jax():
    over = dict(height=H, width=W, batch_size=B, dropout_rate=0.0)
    jcfg = jconfig.PUBLISHED.replace(**over)
    tcfg = config.PUBLISHED.replace(**over)
    jmodel = jtrainer.build_model(jcfg)
    example = {"color": jnp.zeros((1, H, W, 3), jnp.float32),
               "pol": jnp.zeros((1, H, W, 4), jnp.float32)}
    batch = SyntheticHammer(H, W, seed=3).batch(B)
    batch = {k: batch[k] for k in ("color", "pol", "depth", "K")}

    def draws_of(rng):
        k_aug, _, _ = jax.random.split(rng, 3)
        return {"jitter": _jitter_draws(k_aug, B)}

    logs = _run_pair(jcfg, jmodel, jtrainer.make_train_step(jmodel, jcfg),
                     example, trainer.build_model, trainer.make_train_step,
                     tcfg, batch, draws_of)
    assert "normals_loss/0" in logs and "smooth_loss/3" in logs
