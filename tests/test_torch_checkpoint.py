"""The port's checkpoints: the whole train state round trip, bit for bit,
and the per-component .npz exports crossing to the JAX package and back
for fused and separate modality encoders."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from polardepth_tpu import config as jconfig  # noqa: E402
from polardepth_tpu.data.synthetic import SyntheticHammer  # noqa: E402
from polardepth_tpu.ops.fresnel import normal_priors_from_xolp  # noqa: E402
from polardepth_tpu.ops.xolp import xolp_from_pol  # noqa: E402
from polardepth_tpu.train import checkpoint as jckpt  # noqa: E402
from polardepth_tpu.train import trainer as jtrainer  # noqa: E402
from polardepth_tpu.train.state import create_train_state  # noqa: E402

from polardepth_tpu_torch import config  # noqa: E402
from polardepth_tpu_torch.models import network  # noqa: E402
from polardepth_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from polardepth_tpu_torch.train import trainer  # noqa: E402

H, W, B = 32, 32, 2
# the same depth from the same weights in the two packages: float32
# convolutions summed in another order (the JAX package's own limit for
# fused against separate encoders)
DEPTH_RTOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside the
    other test workers torch's default of a thread per core oversubscribes
    the machine, where its thread barriers stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(height=H, width=W, batch_size=B, num_epochs=2)
    base.update(kw)
    return config.PUBLISHED.replace(**base)


def _batch(seed=0):
    return SyntheticHammer(H, W, seed=seed).batch(B)


def _trained(cfg, steps=2):
    t = trainer.Trainer(cfg, steps_per_epoch=1, device="cpu",
                        log_fn=lambda *_: None)
    for i in range(steps):
        t.train_step(_batch(i))
    return t


def test_checkpoint_round_trip_bit_exact(tmp_path):
    cfg = _cfg()
    live = _trained(cfg)
    extra = {"data": {"seed": 42, "epoch": 1, "cursor": 3}}
    path = ckpt.save(str(tmp_path), live.state, cfg, extra=extra)
    assert path == os.path.join(str(tmp_path), "step_2")
    assert ckpt.latest_step_dir(str(tmp_path)) == path
    assert config.Config.from_json(
        (tmp_path / "config.json").read_text()) == cfg

    fresh = trainer.Trainer(cfg, steps_per_epoch=1, device="cpu",
                            log_fn=lambda *_: None)
    _, got_extra = ckpt.restore(path, fresh.state, extra={"data": None})
    assert got_extra == extra and fresh.state.step == 2
    for (k, a), (k2, b) in zip(live.model.state_dict().items(),
                               fresh.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    live_opt = live.state.optimizer.state_dict()
    fresh_opt = fresh.state.optimizer.state_dict()
    assert live_opt["param_groups"] == fresh_opt["param_groups"]
    for i, s in live_opt["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[name], fresh_opt["state"][i][name])
    assert live.state.scheduler.state_dict() == \
        fresh.state.scheduler.state_dict()
    batch = _batch(5)
    np.testing.assert_array_equal(live.predict(batch), fresh.predict(batch))
    # the two go on alike
    for t in (live, fresh):
        t.train_step(_batch(6))
    for a, b in zip(live.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)


def test_restore_without_extra_keeps_the_template(tmp_path):
    cfg = _cfg()
    live = _trained(cfg, steps=1)
    path = ckpt.save(str(tmp_path), live.state)
    assert not (tmp_path / "config.json").exists()
    fresh = trainer.Trainer(cfg, steps_per_epoch=1, device="cpu")
    _, extra = ckpt.restore(path, fresh.state, extra={"data": "template"})
    assert extra == {"data": "template"} and fresh.state.step == 1
    assert ckpt.latest_step_dir(str(tmp_path / "none")) is None


@pytest.fixture(autouse=True)
def _float32_jax(monkeypatch):
    """The JAX functions in float32 (tests/conftest.py turns on x64), and
    the JAX package's CPU preprocess in the port's network, so that the
    depths differ only by the weights' transfer and float32 sums."""
    def jax_preprocess(pol, n=1.5):
        xolp = xolp_from_pol(jnp.asarray(pol.detach().numpy()))
        priors = normal_priors_from_xolp(xolp, n)
        return (torch.from_numpy(np.array(xolp)),
                torch.from_numpy(np.array(priors)))

    monkeypatch.setattr(network, "fused_polar_preprocess", jax_preprocess)
    with jax.enable_x64(False):
        yield


_JAX = {}


def _jax_side():
    """(jitted infer step, fresh state) of the JAX model with the
    reference's separate modality encoders (the exports' layout)."""
    if not _JAX:
        jcfg = jconfig.PUBLISHED.replace(height=H, width=W, batch_size=B,
                                         fused_encoders=False)
        jmodel = jtrainer.build_model(jcfg)
        example = {"color": jnp.zeros((1, H, W, 3), jnp.float32),
                   "pol": jnp.zeros((1, H, W, 4), jnp.float32)}
        rng = jax.random.PRNGKey(1)
        state = create_train_state(jmodel, {"params": rng, "dropout": rng},
                                   example, jcfg.learning_rate)
        _JAX["infer"] = jax.jit(jtrainer.make_infer_step(jmodel, jcfg))
        _JAX["state"] = state
    return _JAX["infer"], _JAX["state"]


def _port_model(fused, seed):
    """The port's model with seeded weights and BatchNorm statistics."""
    cfg = _cfg(fused_encoders=fused)
    t = trainer.Trainer(cfg.replace(seed=seed), 1, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for k, v in t.model.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                v.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, v.shape).astype(np.float32)))
    return t


@pytest.mark.parametrize("port_fused", [True, False])
def test_components_cross_between_the_packages(tmp_path, port_fused):
    """The port's export -> the JAX package's import and depth -> the JAX
    package's export -> the port's import, for a port model with fused and
    with separate modality encoders."""
    batch = _batch(7)
    src = _port_model(port_fused, seed=3)
    depth = src.predict(batch)
    files = ckpt.export_components(str(tmp_path / "port"), src.state)
    assert sorted(os.path.basename(f) for f in files) == [
        "joint_encoder.npz", "mono_depth.npz", "normals_encoder.npz",
        "rgb_encoder.npz", "xolp_encoder.npz"]

    infer, jstate = _jax_side()
    jstate = jckpt.import_components(str(tmp_path / "port"), jstate)
    jdepth = np.asarray(infer(jstate, {k: jnp.asarray(batch[k])
                                       for k in ("color", "pol")}))
    np.testing.assert_allclose(jdepth, depth, rtol=DEPTH_RTOL, atol=0)

    jckpt.export_components(str(tmp_path / "jax"), jstate)
    back = _port_model(port_fused, seed=4)
    ckpt.import_components(str(tmp_path / "jax"), back.state)
    for (k, a), b in zip(src.model.state_dict().items(),
                         back.model.state_dict().values()):
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k
    np.testing.assert_array_equal(back.predict(batch), depth)


def test_import_components_checks_names_and_shapes(tmp_path):
    src = _port_model(False, seed=5)
    ckpt.export_components(str(tmp_path / "all"), src.state)
    rgb_only = trainer.Trainer(
        _cfg(augment_xolp=False, augment_normals=False), 1, device="cpu")
    with pytest.raises(ValueError, match="joint_encoder.*shape"):
        ckpt.import_components(str(tmp_path / "all"), rgb_only.state)
    os.makedirs(tmp_path / "xolp")
    os.replace(tmp_path / "all" / "xolp_encoder.npz",
               tmp_path / "xolp" / "xolp_encoder.npz")
    with pytest.raises(KeyError, match="not in the model"):
        ckpt.import_components(str(tmp_path / "xolp"), rgb_only.state)
    fused = _port_model(True, seed=6)
    with pytest.raises(FileNotFoundError, match="both modality encoders"):
        ckpt.import_components(str(tmp_path / "xolp"), fused.state)
