"""The arch1++_attention variant of the port (models/attention.py,
PolarDepthNet with ``use_attention``) against the JAX package's
(polardepth_tpu/models/attention.py, models/network.py:115-126), with the
weights carried across by models/convert.py.

Limits: the position encoding equal to the bit; linear attention, the
LoFTR layer and CrossModalAttention within 2e-6 of each output's max abs (float32 products summed in other orders over up to
256 terms, and flax's LayerNorm variance E[x^2] - E[x]^2 against torch's);
the network in eval mode, from the same XOLP and Fresnel priors: the
attention's output within 1e-5 of its max abs and the disparities within
1e-5 relative (the float32 convolutions and the attention's sums in other
orders).  One published supervised step with the attention
against the JAX package's at the limits of tests/test_torch_train.py
(tests/torch_step_parity.py).  The components' .npz files cross between the
packages bit for bit; the exported program equals ``Predictor`` within
1e-6 relative (chip_smoke.py's limit).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from polardepth_tpu import config as jconfig  # noqa: E402
from polardepth_tpu.data.synthetic import SyntheticHammer  # noqa: E402
from polardepth_tpu.models import attention as jatt  # noqa: E402
from polardepth_tpu.ops.fresnel import normal_priors_from_xolp  # noqa: E402
from polardepth_tpu.ops.xolp import xolp_from_pol  # noqa: E402
from polardepth_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from polardepth_tpu.train import trainer as jtrainer  # noqa: E402

from polardepth_tpu_torch import cli, config  # noqa: E402
from polardepth_tpu_torch.eval.export import (  # noqa: E402
    load_artifact, make_export, preprocess_nodes)
from polardepth_tpu_torch.models import attention, network  # noqa: E402
from polardepth_tpu_torch.models.convert import (  # noqa: E402
    jax_from_state_dict, state_dict_from_jax)
from polardepth_tpu_torch.models.reference_import import (  # noqa: E402
    load_reference_components)
from polardepth_tpu_torch.train import checkpoint, state, trainer  # noqa: E402

from torch_step_parity import (  # noqa: E402,F401
    B, H, W, _float32_jax, _jax_preprocess, _jitter_draws, _run_pair)

ATT_RTOL = 2e-6
DISP_RTOL = 1e-5
EXPORT_RTOL = 1e-6
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: beside the other test workers, torch's default
    of a thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=ATT_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _port(module, variables):
    """module with the JAX variables, in eval mode."""
    module.load_state_dict(state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {})))
    return module.eval()


def test_position_encoding_matches_jax():
    np.testing.assert_array_equal(attention.sine_position_encoding(16, 5, 7),
                                  jatt.sine_position_encoding(16, 5, 7))
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 16)).astype(
        np.float32)
    np.testing.assert_array_equal(
        attention.add_position_encoding(torch.from_numpy(x)).numpy(),
        np.asarray(jatt.add_position_encoding(jnp.asarray(x))))


def test_linear_attention_matches_jax():
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 24, 4, 8)).astype(np.float32)
               for _ in range(3))
    _close(attention.linear_attention(*map(torch.from_numpy, (q, k, v))),
           jatt.linear_attention(*map(jnp.asarray, (q, k, v))))


def test_loftr_layer_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 30, 32)).astype(np.float32)
    src = rng.normal(size=(2, 20, 32)).astype(np.float32)
    jlayer = jatt.LoFTREncoderLayer(32, 4)
    v = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(src))
    layer = _port(attention.LoFTREncoderLayer(32, 4), v)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), torch.from_numpy(src))
    _close(got, jlayer.apply(v, jnp.asarray(x), jnp.asarray(src)))


@pytest.mark.parametrize("gate,pe_in_stream", [(True, False), (False, False),
                                               (True, True)])
def test_cross_modal_attention_matches_jax(gate, pe_in_stream):
    """The gamma leaf exists where the JAX module creates it (gated, PE
    kept out of the stream)."""
    rng = np.random.default_rng(4)
    rgb = rng.normal(size=(2, 4, 6, 32)).astype(np.float32)
    pol = rng.normal(size=(2, 4, 6, 16)).astype(np.float32)
    jmod = jatt.CrossModalAttention(d_model=32, nhead=4,
                                    pe_in_stream=pe_in_stream, gate=gate)
    v = jmod.init(jax.random.PRNGKey(2), jnp.asarray(rgb), jnp.asarray(pol))
    assert ("gamma" in v["params"]) == (gate and not pe_in_stream)
    if "gamma" in v["params"]:
        v["params"] = dict(v["params"], gamma=jnp.full((1,), 0.7))
    mod = _port(attention.CrossModalAttention(
        32, 16, nhead=4, pe_in_stream=pe_in_stream, gate=gate), v)
    with torch.no_grad():
        got = mod(torch.from_numpy(rgb), torch.from_numpy(pol))
    _close(got, jmod.apply(v, jnp.asarray(rgb), jnp.asarray(pol)))
    params, _ = jax_from_state_dict(mod.state_dict())
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(jax.device_get(v["params"]))


def _seeded_model(cfg, seed):
    """The port's model of cfg, torch's init seeded, BatchNorm statistics
    and the gates redrawn with numpy."""
    torch.manual_seed(seed)
    model = trainer.build_model(cfg)
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_var") or k.endswith(".gamma"):
            v = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(
                np.float32))
        elif k.endswith("running_mean"):
            v = torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(
                np.float32))
        sd[k] = v
    model.load_state_dict(sd)
    return model.eval()


@pytest.mark.parametrize("over", [{}, {"attention_pe_in_stream": True}],
                         ids=["gated", "pe_in_stream"])
def test_network_with_attention_matches_jax(over):
    """PolarDepthNet in eval mode from the same XOLP and priors (the JAX
    package's CPU preprocess); the JAX tree through jax_from_state_dict."""
    cfg_over = dict(height=H, width=W, use_attention=True, **over)
    model = _seeded_model(config.PUBLISHED.replace(**cfg_over), 0)
    assert hasattr(model, "cross_modal_attention")
    jmodel = jtrainer.build_model(jconfig.PUBLISHED.replace(**cfg_over))
    params, stats = jax_from_state_dict(model.state_dict(),
                                        fused_encoders=True)
    rng = np.random.default_rng(5)
    color = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    pol = rng.uniform(20, 230, (B, H, W, 4)).astype(np.float32)
    xolp = xolp_from_pol(jnp.asarray(pol))
    want, inter = jax.jit(lambda v, c, x: jmodel.apply(
        v, c, xolp=x, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(color), xolp)
    attended = []
    model.cross_modal_attention.register_forward_hook(
        lambda mod, args, out: attended.append(out))
    with torch.no_grad():
        got = model(torch.from_numpy(color),
                    xolp=torch.from_numpy(np.array(xolp)),
                    priors=torch.from_numpy(np.array(
                        normal_priors_from_xolp(xolp, 1.5))))
    # the attention's output, as the JointEncoder reads it
    want_att = inter["intermediates"]["cross_modal_attention"]["__call__"][0]
    _close(attended[0], want_att, DISP_RTOL)
    rgb_in = inter["intermediates"]["rgb_encoder"]["__call__"][0][-1]
    assert np.abs(np.asarray(want_att) - np.asarray(rgb_in)).max() > \
        100 * DISP_RTOL * np.abs(np.asarray(rgb_in)).max()
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                   rtol=DISP_RTOL, err_msg=str(key))


def test_supervised_step_with_attention_matches_jax(monkeypatch):
    """Both sides on the JAX package's CPU preprocess, as in
    test_torch_train.py."""
    monkeypatch.setattr(network, "fused_polar_preprocess", _jax_preprocess)
    over = dict(height=H, width=W, batch_size=B, dropout_rate=0.0,
                use_attention=True)
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
    assert "normals_loss/0" in logs


def test_attention_components_cross_the_packages(tmp_path):
    """export_components writes cross_modal_attention.npz with the JAX
    package's keys and values; the JAX package's import reads the port's
    files, and the port's import the JAX package's, bit for bit."""
    cfg = config.PUBLISHED.replace(height=H, width=W, use_attention=True)
    model = _seeded_model(cfg, 1)
    st = state.create_train_state(model, cfg)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    written = checkpoint.export_components(str(port_dir), st)
    assert str(port_dir / "cross_modal_attention.npz") in written
    params, stats = jax_from_state_dict(model.state_dict(),
                                        fused_encoders=True)

    class JState:
        def __init__(self, p, s):
            self.params, self.batch_stats = p, s

        def replace(self, params, batch_stats):
            return JState(params, batch_stats)

    jcheckpoint.export_components(str(jax_dir), JState(params, stats))
    with np.load(port_dir / "cross_modal_attention.npz") as a, \
            np.load(jax_dir / "cross_modal_attention.npz") as b:
        assert set(a.files) == set(b.files)
        assert "cross_0/Dense_0/kernel" in a.files and "gamma" in a.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    back = jcheckpoint.import_components(str(port_dir),
                                         JState(zeros, stats))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        got = back.params
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(np.asarray(got), leaf)
    fresh = _seeded_model(cfg, 2)
    st2 = state.create_train_state(fresh, cfg)
    checkpoint.import_components(str(jax_dir), st2)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], v), k


def test_attention_export_and_reference_import(tmp_path):
    """The exported program of an attention model: one K1 node, a symbolic
    batch, Predictor's depth; and a reference .pth set (which has no
    attention component) leaves the attention at its values and says
    so."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    cfg = config.PUBLISHED.replace(height=32, width=32, use_attention=True)
    sd = chip_smoke.seeded_state_dict(cfg, 0)
    assert any(k.startswith("cross_modal_attention.") for k in sd)
    program = make_export(cfg, sd, device="cpu")
    assert preprocess_nodes(program) == 1
    path = tmp_path / "m.pt2"
    torch.export.save(program, str(path))
    loaded = load_artifact(str(path)).module()
    predictor = trainer.Predictor(cfg, sd, device="cpu")
    for b in (2, 3):
        batch = chip_smoke.random_batch(np.random.default_rng(b), b, cfg)
        got = loaded(torch.from_numpy(batch["color"]),
                     torch.from_numpy(batch["pol"])).numpy()
        want = predictor.predict(batch)
        np.testing.assert_allclose(got, want, rtol=EXPORT_RTOL, atol=0)

    ref_dir = tmp_path / "weights_0"
    ref_dir.mkdir()
    chip_smoke.write_reference_pth(sd, cfg, str(ref_dir))
    model = trainer.build_model(cfg)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    said = []
    loaded = load_reference_components(str(ref_dir), model, log=said.append)
    assert "cross_modal_attention" not in loaded
    assert "left at their initialisation: cross_modal_attention" in said[0]
    for k, v in model.state_dict().items():
        if k.startswith("cross_modal_attention."):
            assert torch.equal(v, init[k]), k
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k


def test_attention_cli_and_chip_smoke_phase_on_cpu(tmp_path):
    """``train --use_attention`` at 32x32 checkpoints the attention's
    weights and ``evaluate`` reads them back; phase 11 of chip_smoke.py
    runs on the CPU at 32x32, batch 2: every check passes and no kernel
    launches."""
    flags = ["--height", "32", "--width", "32", "--batch_size", "2",
             "--device", "cpu"]
    trained, _ = cli.train(["--use_attention", "--synthetic", "2",
                            "--num_epochs", "1", "--log_dir",
                            str(tmp_path), *flags])
    step_dir = tmp_path / "polardepth" / "checkpoints" / "step_1"
    with open(tmp_path / "polardepth" / "checkpoints" / "config.json") as f:
        assert json.load(f)["use_attention"] is True
    ev, _ = cli.evaluate(["--use_attention", "--synthetic", "2",
                          "--weights", str(step_dir), *flags])
    for k, v in trained.model.state_dict().items():
        assert torch.equal(ev.model.state_dict()[k], v), k
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    cfg = chip_smoke.attention_cfg().replace(height=32, width=32,
                                             batch_size=2)
    at = chip_smoke.attention_phase("cpu", cfg, 2, 1, 0, flags[:6], 4)
    assert at["serve"]["err_plain"] == 0.0
    assert [len(v) for v in at["turns"].values()] == [2, 2]
    assert set(at["serve"]["launches"].values()) == {0}
    assert len(at["train"]["losses"]) == 2
    assert at["export"]["nodes"] == 1
    assert at["cli"]["counts"]["train_steps"] == 2
