"""The port's serving export (eval/export.py) against the JAX package's
(polardepth_tpu/eval/export.py:make_export), both on the CPU.

One program with a symbolic batch, saved and loaded back, must give the
depth of the JAX artifact (serialized and deserialized) at batch 2 and 3
within DEPTH_RTOL (tests/test_torch_network.py: the JAX CPU Fresnel LUT
against the port's table, float32 convolutions in other orders), and hold
exactly one node of the polar-preprocess operator; the RGB-only graph none.
JAX is imported inside the fixtures, so that the card test at the end runs
on a machine without JAX:
``python -m pytest tests/test_torch_export.py -m gpu -q``.
"""

import json
import types

import numpy as np
import pytest
import torch

import chip_smoke
from polardepth_tpu_torch import cli, config
from polardepth_tpu_torch.eval.export import (
    load_artifact, load_module, make_export, preprocess_nodes, save_artifact)
from polardepth_tpu_torch.models.convert import jax_from_state_dict
from polardepth_tpu_torch.ops import build, fresnel, resize
from polardepth_tpu_torch.train.trainer import Predictor, takes_pol

H, W = 64, 96
DEPTH_RTOL = 2e-5
# the loaded program against Predictor on the card: the same operations and
# kernels, bit for bit expected (chip_smoke.py's limit)
CARD_RTOL = 1e-6


def _jax_artifact(overrides, batch, tmp):
    """(port config, seeded port state_dict, the deserialized JAX artifact
    of the same weights, its .json).  The JAX trees come through the weight
    bridge, which spares the JAX model's initialisation."""
    pytest.importorskip("jax")
    from polardepth_tpu import config as jconfig
    from polardepth_tpu.eval import export as jexport

    cfg = config.PUBLISHED.replace(height=H, width=W, dropout_rate=0.0,
                                   **overrides)
    sd = chip_smoke.seeded_state_dict(cfg, 0)
    both = cfg.augment_xolp and cfg.augment_normals
    params, stats = jax_from_state_dict(sd, cfg.fused_encoders and both)
    jcfg = jconfig.PUBLISHED.replace(height=H, width=W, dropout_rate=0.0,
                                     **overrides)
    exp = jexport.make_export(jcfg, types.SimpleNamespace(
        params=params, batch_stats=stats), batch=batch)
    path = str(tmp / "model.shlo")
    jexport.save_artifact(exp, path, jcfg)
    with open(path + ".json") as f:
        meta = json.load(f)
    return cfg, sd, jexport.load_artifact(path), meta


@pytest.fixture(scope="module")
def published(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    cfg, sd, jax_artifact, jax_meta = _jax_artifact({}, None, tmp)

    def caches():
        return (resize._antialias_weights_on.cache_info().currsize,
                fresnel.tables_on.cache_info().currsize)

    before = caches()
    program = make_export(cfg, sd, device="cpu")
    after = caches()
    path = str(tmp / "model.pt2")
    save_artifact(program, path, cfg)
    with open(path + ".json") as f:
        meta = json.load(f)
    return types.SimpleNamespace(
        cfg=cfg, sd=sd, jax=jax_artifact, jax_meta=jax_meta, program=program,
        loaded=load_artifact(path), meta=meta, caches=(before, after))


def _inputs(seed, b, cfg):
    batch = chip_smoke.random_batch(np.random.default_rng(seed), b, cfg)
    return [batch[k] for k in ("color", "pol")[:1 + takes_pol(cfg)]]


@pytest.mark.parametrize("b", [2, 3])
def test_loaded_program_matches_the_jax_artifact(published, b):
    args = _inputs(b, b, published.cfg)
    got = published.loaded.module()(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(published.jax.call(*args))
    assert got.shape == want.shape == (b, H, W, 1)
    assert want.std() > 1e-4
    np.testing.assert_allclose(got, want, rtol=DEPTH_RTOL, atol=0)


def test_graph_holds_one_preprocess_node(published):
    assert preprocess_nodes(published.program) == 1
    assert preprocess_nodes(published.loaded) == 1
    # the preprocess tables and the ingest resizes were not traced: the
    # exported size bypasses the resizes, and the operator's fake
    # implementation reads no table
    before, after = published.caches
    assert after == before


def test_sidecar_has_the_jax_keys(published):
    assert published.meta.keys() == published.jax_meta.keys()
    assert published.meta["platforms"] == ["cpu"]
    ins = published.meta["inputs"]
    b = ins[0].split("[")[1].split(",")[0]        # the symbolic batch
    assert not b.isdigit()
    assert ins == [f"uint8[{b},{H},{W},3]", f"uint8[{b},{H},{W},4]"]
    assert published.meta["output"] == [f"float32[{b},{H},{W},1]"]


def test_rgb_only_graph(tmp_path):
    cfg, sd, jax_artifact, _ = _jax_artifact(
        {"augment_xolp": False, "augment_normals": False}, 2, tmp_path)
    program = make_export(cfg, sd, batch=2, device="cpu")
    assert preprocess_nodes(program) == 0
    (color,) = _inputs(7, 2, cfg)
    got = program.module()(torch.from_numpy(color)).numpy()
    want = np.asarray(jax_artifact.call(color, None))
    assert got.shape == (2, H, W, 1) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=DEPTH_RTOL, atol=0)


def test_cli_export_and_its_refusals(tmp_path, capsys):
    flags = ["--height", "32", "--width", "32", "--device", "cpu"]
    out = str(tmp_path / "m" / "model.pt2")
    cli.main(["export", *flags, "--out", out, "--batch", "2"])
    assert "wrote" in capsys.readouterr().out
    loaded = load_module(out)
    depth = loaded(torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
                   torch.zeros(2, 32, 32, 4, dtype=torch.uint8))
    assert depth.shape == (2, 32, 32, 1) and not depth.requires_grad
    with open(out + ".json") as f:
        assert json.load(f)["inputs"][0] == "uint8[2,32,32,3]"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.main(["export", *flags, "--train_dpt", "--out", out])


@pytest.mark.gpu
def test_loaded_program_launches_k1_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cfg = config.PUBLISHED.replace(height=H, width=W)
    sd = chip_smoke.seeded_state_dict(cfg, 0)
    path = str(tmp_path / "model.pt2")
    save_artifact(make_export(cfg, sd, device="cuda"), path, cfg)
    loaded = load_module(path)
    predictor = Predictor(cfg, sd, device="cuda")
    for b in (2, 3):
        color, pol = _inputs(b, b, cfg)
        before = build.launch_counts["polar_preprocess"]
        got = loaded(torch.from_numpy(color).cuda(),
                     torch.from_numpy(pol).cuda()).cpu().numpy()
        assert build.launch_counts["polar_preprocess"] == before + 1
        want = predictor.predict({"color": color, "pol": pol})
        np.testing.assert_allclose(got, want, rtol=CARD_RTOL, atol=0)
