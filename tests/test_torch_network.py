"""The port's serving path against the JAX package's, end to end: uint8
captures -> ``make_infer_step`` -> depth, for the published tri-encoder, the
three ablation graphs, the separate-encoder layout, the 12-channel mode and
flip-averaged post-processing; and the weight bridge against the JAX
package's component exports.

Limit of the infer step: 2e-5 relative on depth.  Off the TPU the JAX network
inverts the Fresnel curves with its compare-matrix LUT (method "fused", within
2e-5 rad of the exact interpolation), the port with the pruned two-level table
of the CUDA kernel (within 1e-5 rad); the priors differ by up to ~3e-5, and
the float32 convolutions sum in other orders.
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from polardepth_tpu import config as jconfig  # noqa: E402
from polardepth_tpu.train import trainer as jtrainer  # noqa: E402
from polardepth_tpu.train.checkpoint import export_components  # noqa: E402

from polardepth_tpu_torch import config  # noqa: E402
from polardepth_tpu_torch.models.convert import (  # noqa: E402
    jax_from_state_dict, load_components, state_dict_from_jax)
from polardepth_tpu_torch.train.trainer import (  # noqa: E402
    Predictor, build_model, make_infer_step)

B, H, W = 2, 64, 96
DEPTH_RTOL = 2e-5

CASES = {
    "published": {},
    "rgb_only": {"augment_xolp": False, "augment_normals": False},
    "rgb_xolp": {"augment_normals": False},
    "rgb_normals": {"augment_xolp": False},
    "separate_encoders": {"fused_encoders": False},
    "twelve_channels": {"enable_12channels": True},
    "post_process": {"post_process": True},
}


def _jax_model(overrides, seed=0):
    """(JAX config, model, params, batch_stats) with numpy-drawn BN."""
    cfg = jconfig.PUBLISHED.replace(height=H, width=W, **overrides)
    model = jtrainer.build_model(cfg)
    in_ch = 12 if cfg.enable_12channels else 3
    v = model.init({"params": jax.random.PRNGKey(seed),
                    "dropout": jax.random.PRNGKey(seed + 1)},
                   jnp.zeros((1, H, W, in_ch), jnp.float32),
                   pol=jnp.zeros((1, H, W, 4), jnp.float32))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = path[-1].key
        a = np.asarray(a, np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return a

    v = jax.tree_util.tree_map_with_path(redraw, jax.device_get(v))
    return cfg, model, v["params"], v["batch_stats"]


def _batch(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    iun = rng.uniform(30, 220, (B, h, w))
    rho = rng.uniform(0, 0.9, (B, h, w))
    phi = rng.uniform(-np.pi / 2, np.pi / 2, (B, h, w))
    pol = np.stack([iun * (1 + rho * np.cos(2 * a - 2 * phi)) / 2
                    for a in np.deg2rad([0, 45, 90, 135])], axis=-1)
    return {"color": rng.integers(0, 256, (B, h, w, 3), np.uint8),
            "pol": pol.round().clip(0, 255).astype(np.uint8)}


def _jax_depth(cfg, model, params, stats, batch):
    step = jtrainer.make_infer_step(model, cfg)
    fn = jax.jit(lambda p, s, b: step(
        types.SimpleNamespace(params=p, batch_stats=s), b))
    return np.asarray(fn(params, stats,
                         {k: jnp.asarray(v) for k, v in batch.items()}))


@pytest.mark.parametrize("case", list(CASES))
def test_infer_step_matches_jax(case):
    overrides = CASES[case]
    jcfg, jmodel, params, stats = _jax_model(overrides)
    # post-processing is checked on captures at twice the working
    # resolution, so that the anti-aliased ingest resize runs too
    batch = _batch(1, *((2 * H, 2 * W) if case == "post_process" else (H, W)))
    ref = _jax_depth(jcfg, jmodel, params, stats, batch)
    cfg = config.PUBLISHED.replace(height=H, width=W, **overrides)
    both = cfg.augment_xolp and cfg.augment_normals
    predictor = Predictor(cfg, state_dict_from_jax(
        params, stats, cfg.fused_encoders and both), device="cpu")
    got = predictor.predict(batch)
    assert got.shape == ref.shape == (B, H, W, 1) and got.dtype == np.float32
    assert ref.std() > 1e-4           # the weights make the depth vary
    np.testing.assert_allclose(got, ref, rtol=DEPTH_RTOL, atol=0)


def test_infer_step_is_deterministic_and_in_range():
    cfg = config.PUBLISHED.replace(height=H, width=W)
    model = build_model(cfg)
    step = make_infer_step(model, cfg)
    assert not model.training
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    a, b = step(batch), step(batch)
    assert torch.equal(a, b)
    assert a.min() >= cfg.min_depth and a.max() <= cfg.max_depth


def test_priors_come_only_from_the_preprocess():
    """Given an XOLP map but no priors, a model with the normals encoder
    raises: nothing computes the priors but fused_polar_preprocess."""
    model = build_model(config.PUBLISHED.replace(height=H, width=W)).eval()
    color = torch.zeros(1, H, W, 3)
    with pytest.raises(ValueError, match="priors"):
        model(color, xolp=torch.zeros(1, H, W, 2))
    with pytest.raises(ValueError, match="pol or xolp"):
        model(color)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A JAX model of the published layout (fused encoders) and its
    reference-shaped component export."""
    jcfg, jmodel, params, stats = _jax_model({}, seed=3)
    directory = tmp_path_factory.mktemp("components")
    export_components(str(directory), types.SimpleNamespace(
        params=params, batch_stats=stats))
    return jcfg, jmodel, params, stats, directory


def test_load_components_reads_jax_exports(exported):
    jcfg, jmodel, params, stats, directory = exported
    names = sorted(p.stem for p in directory.glob("*.npz"))
    assert names == ["joint_encoder", "mono_depth", "normals_encoder",
                     "rgb_encoder", "xolp_encoder"]
    sd = load_components(directory)
    direct = state_dict_from_jax(params, stats)
    assert sd.keys() == direct.keys()
    for k in sd:
        assert torch.equal(sd[k], direct[k]), k
    cfg = config.PUBLISHED.replace(height=H, width=W)
    batch = _batch(4)
    got = Predictor(cfg, sd, device="cpu").predict(batch)
    ref = _jax_depth(jcfg, jmodel, params, stats, batch)
    np.testing.assert_allclose(got, ref, rtol=DEPTH_RTOL, atol=0)
    # the separate-encoder layout loads the same files
    separate = load_components(directory, fused_encoders=False)
    got_sep = Predictor(cfg.replace(fused_encoders=False), separate,
                        device="cpu").predict(batch)
    np.testing.assert_allclose(got_sep, got, rtol=1e-6, atol=0)


@pytest.mark.parametrize("missing", ["xolp_encoder", "normals_encoder"])
def test_load_components_raises_on_one_modality_encoder(exported, missing,
                                                        tmp_path):
    directory = exported[-1]
    for p in directory.glob("*.npz"):
        if p.stem != missing:
            (tmp_path / p.name).write_bytes(p.read_bytes())
    with pytest.raises(FileNotFoundError, match=missing):
        load_components(tmp_path)


@pytest.mark.parametrize("fused", [True, False])
def test_state_dict_round_trip(fused):
    cfg = config.PUBLISHED.replace(height=H, width=W, fused_encoders=fused)
    sd = build_model(cfg).state_dict()
    params, stats = jax_from_state_dict(sd, fused_encoders=not fused)
    back = state_dict_from_jax(params, stats, fused_encoders=fused)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
