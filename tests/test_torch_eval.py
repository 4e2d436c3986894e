"""The port's evaluation against the JAX package's: the depth metrics, the
per-material step metrics, the on-device accumulator and the table, the eval
step through the model, and the analysis, logging, colour-map and profiling
utilities.  Inputs are float32 numpy arrays made from seeds, at batch 2."""

import json
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from polardepth_tpu import config as jconfig  # noqa: E402
from polardepth_tpu.data.synthetic import SyntheticHammer  # noqa: E402
from polardepth_tpu.eval import analysis as janalysis  # noqa: E402
from polardepth_tpu.eval import evaluation as jeval  # noqa: E402
from polardepth_tpu.ops import metrics as jmetrics  # noqa: E402
from polardepth_tpu.train import trainer as jtrainer  # noqa: E402
from polardepth_tpu.train.state import create_train_state  # noqa: E402
from polardepth_tpu.utils import logging as jlogging  # noqa: E402

from polardepth_tpu_torch import config  # noqa: E402
from polardepth_tpu_torch.eval import analysis, evaluation  # noqa: E402
from polardepth_tpu_torch.models.convert import state_dict_from_jax  # noqa: E402
from polardepth_tpu_torch.ops import metrics  # noqa: E402
from polardepth_tpu_torch.train import trainer  # noqa: E402
from polardepth_tpu_torch.utils import colormap, logging, profiling  # noqa: E402

B = 2
# the same float32 means of a few thousand pixels, summed in another order
METRIC_RTOL = 1e-6
# the eval step through the model: the port's and the JAX package's depths
# differ by float32 convolution sums and by the preprocess tables (~3e-5 in
# the priors); the depth-derived metrics agree within DEPTH_METRIC_RTOL
# (measured largest: 9.6e-7), and a1-a3, which count pixels, within two
# pixels' share of each slice (measured: equal)
DEPTH_METRIC_RTOL = 1e-5
THRESHOLD_PIXELS = 2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside the
    other test workers torch's default of a thread per core oversubscribes
    the machine, where its thread barriers stall."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _float32_jax():
    """The JAX functions in float32 (tests/conftest.py turns on x64)."""
    with jax.enable_x64(False):
        yield


def _depths(rng, shape):
    gt = rng.uniform(0.0, 2.4, shape).astype(np.float32)
    pred = np.clip(gt * rng.uniform(0.6, 1.6, shape), 0.1, 2.0).astype(
        np.float32)
    return gt, pred


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_allclose(a[ok], b[ok], rtol=rtol, atol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_compute_depth_errors_matches_jax(masked):
    rng = np.random.default_rng(1)
    gt, pred = _depths(rng, (64, 96, 1))
    mask = (gt > 0.1) & (gt < 2.0) if masked else None
    ref = jmetrics.compute_depth_errors(
        jnp.asarray(gt), jnp.asarray(pred),
        None if mask is None else jnp.asarray(mask))
    got = metrics.compute_depth_errors(
        torch.from_numpy(gt), torch.from_numpy(pred),
        None if mask is None else torch.from_numpy(mask))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], METRIC_RTOL)


def test_compute_depth_errors_empty_mask_is_nan_not_poisoned():
    """An empty mask gives NaN, as the JAX package's; a masked-out zero
    depth does not leak into a non-empty mask's means."""
    gt = torch.tensor([[0.0, 1.0], [1.5, 0.0]])
    pred = torch.tensor([[1.0, 1.1], [1.4, 1.0]])
    empty = metrics.compute_depth_errors(gt, pred, torch.zeros(2, 2, dtype=bool))
    assert all(np.isnan(float(v)) for v in empty.values())
    some = metrics.compute_depth_errors(gt, pred, gt > 0)
    assert all(np.isfinite(float(v)) for v in some.values())
    ref = metrics.compute_depth_errors(gt[gt > 0], pred[gt > 0])
    for k in ref:
        assert float(some[k]) == pytest.approx(float(ref[k]), rel=1e-6)


def _eval_inputs(seed):
    rng = np.random.default_rng(seed)
    gt, pred = _depths(rng, (B, 32, 48, 1))
    ids = np.array([20, 40, 60, 80, 100, 120, 140, 180], np.int32)
    mask = rng.choice(ids, (B, 32, 48, 1)).astype(np.int32)
    mask[1] = 180                       # frame 1: every material slice empty
    return gt, pred, mask


def test_eval_step_metrics_match_jax_including_empty_slices():
    gt, pred, mask = _eval_inputs(2)
    ref = jeval.eval_step_metrics(jnp.asarray(gt), jnp.asarray(pred),
                                  jnp.asarray(mask), 0.1, 2.0)
    got = evaluation.eval_step_metrics(torch.from_numpy(gt),
                                       torch.from_numpy(pred),
                                       torch.from_numpy(mask), 0.1, 2.0)
    assert list(got) == list(ref) == list(evaluation.MATERIAL_THRESHOLDS)
    assert int(got["wall"]["count"].sum()) == 0
    assert int(got["cutlery"]["count"][1]) == 0
    for name in ref:
        np.testing.assert_array_equal(np.asarray(got[name]["count"]),
                                      np.asarray(ref[name]["count"]))
        for m in evaluation.METRIC_ORDER:
            _close(got[name][m], ref[name][m], METRIC_RTOL)


def test_accumulator_and_table_match_jax():
    """Two batches folded on the device, fetched once, and formatted."""
    acc_j = jeval.empty_accumulator()
    acc_t = evaluation.empty_accumulator("cpu")
    host = evaluation.MetricAccumulator()
    host_j = jeval.MetricAccumulator()
    for seed in (3, 4):
        gt, pred, mask = _eval_inputs(seed)
        mj = jeval.eval_step_metrics(jnp.asarray(gt), jnp.asarray(pred),
                                     jnp.asarray(mask), 0.1, 2.0)
        mt = evaluation.eval_step_metrics(torch.from_numpy(gt),
                                          torch.from_numpy(pred),
                                          torch.from_numpy(mask), 0.1, 2.0)
        acc_j = jeval.accumulate_on_device(acc_j, mj)
        acc_t = evaluation.accumulate_on_device(acc_t, mt)
        host.update(mt)
        host_j.update(mj)
    assert all(v.ndim == 0 and v.dtype == torch.float32
               for row in acc_t.values() for v in row.values())
    ref = jeval.accumulator_result(jax.device_get(acc_j))
    got = evaluation.accumulator_result(acc_t)
    for table in (got, host.result()):
        assert list(table) == list(ref)
        for name in ref:
            assert table[name]["frames"] == ref[name]["frames"]
            for m in evaluation.METRIC_ORDER:
                _close(table[name][m], ref[name][m], METRIC_RTOL)
    assert ref["wall"]["frames"] == 0 and ref["all"]["frames"] == 2 * B
    assert ref["cutlery"]["frames"] == 2
    assert evaluation.format_table(ref) == jeval.format_table(ref)
    _close([host.result()[n][m] for n in ref for m in evaluation.METRIC_ORDER],
           [host_j.result()[n][m] for n in ref
            for m in evaluation.METRIC_ORDER], METRIC_RTOL)


def _jax_state_and_weights(jcfg, seed=0):
    """A JAX train state of jcfg's model with BatchNorm and the scale-0
    disparity bias set so that the depth lies among the scenes' (~1.35 m),
    and the same weights as the port's state_dict."""
    jmodel = jtrainer.build_model(jcfg)
    h, w = jcfg.height, jcfg.width
    example = {"color": jnp.zeros((1, h, w, 3), jnp.float32),
               "pol": jnp.zeros((1, h, w, 4), jnp.float32)}
    rng = jax.random.PRNGKey(seed)
    jstate = create_train_state(jmodel, {"params": rng, "dropout": rng},
                                example, jcfg.learning_rate)
    nrng = np.random.default_rng(seed)

    def redraw(path, a):
        a = np.asarray(a, np.float32)
        names = [getattr(p, "key", "") for p in path]
        if names[-1] in ("scale", "var"):
            return nrng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if names[-1] == "mean":
            return nrng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if names[:2] == ["mono_depth", "ReflectConv_3"] and \
                names[-1] == "bias":
            return np.full(a.shape, -3.7, np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(
        redraw, jax.device_get(jstate.params))
    stats = jax.tree_util.tree_map_with_path(
        redraw, jax.device_get(jstate.batch_stats))
    jstate = jstate.replace(params=params, batch_stats=stats)
    return jmodel, jstate, state_dict_from_jax(
        params, stats, fused_encoders=jcfg.fused_encoders)


def test_eval_step_through_the_model_matches_jax():
    over = dict(height=64, width=96, batch_size=B, dropout_rate=0.0)
    jcfg = jconfig.PUBLISHED.replace(**over)
    tcfg = config.PUBLISHED.replace(**over)
    jmodel, jstate, weights = _jax_state_and_weights(jcfg)
    batch = SyntheticHammer(64, 96, seed=5).batch(B)
    batch = {k: batch[k] for k in trainer.EVAL_BATCH_KEYS}
    acc_j = jax.jit(jtrainer.make_eval_step(jmodel, jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jeval.empty_accumulator())
    ref = jeval.accumulator_result(jax.device_get(acc_j))

    model = trainer.build_model(tcfg)
    model.load_state_dict(weights)
    step = trainer.make_eval_step(model, tcfg)
    acc = step({k: torch.from_numpy(v) for k, v in batch.items()},
               evaluation.empty_accumulator("cpu"))
    got = evaluation.accumulator_result(acc)
    counts = evaluation.eval_step_metrics(
        torch.from_numpy(batch["depth_gt"]), torch.from_numpy(batch["depth_gt"]),
        torch.from_numpy(batch["mask"]), tcfg.min_depth, tcfg.max_depth)
    assert 0.05 < ref["all"]["a1"] < 0.95        # the thresholds are tested
    for name in ref:
        assert got[name]["frames"] == ref[name]["frames"]
        if not ref[name]["frames"]:
            continue
        for m in ("abs_rel", "sq_rel", "rmse", "rmse_log"):
            _close(got[name][m], ref[name][m], DEPTH_METRIC_RTOL)
        # a frame's a1 moves by 1/count per flipped pixel; the slice's mean
        # by at most THRESHOLD_PIXELS / (its smallest count) per frame
        c = counts[name]["count"]
        share = THRESHOLD_PIXELS / float(c[c > 0].min())
        for m in ("a1", "a2", "a3"):
            assert abs(got[name][m] - ref[name][m]) <= share, (name, m)


def test_analysis_matches_jax():
    rng = np.random.default_rng(6)
    gt, pred, mask = _eval_inputs(6)
    gt, pred, mask = gt[0], pred[0], mask[0]
    ref, got = janalysis.error_maps(pred, gt), analysis.error_maps(pred, gt)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    ref_rms = janalysis.per_material_rms(pred, gt, mask)
    got_rms = analysis.per_material_rms(pred, gt, mask)
    _close(list(got_rms.values()), list(ref_rms.values()), 0)
    assert np.isnan(got_rms["wall"])
    depth = rng.uniform(0.5, 1.5, (32, 48)).astype(np.float32)
    K = np.array([[30.0, 0, 24, 0], [0, 30, 16, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    np.testing.assert_allclose(analysis.render_normals(depth, K),
                               janalysis.render_normals(depth, K),
                               rtol=1e-5, atol=1e-6)
    for img in (analysis.render_error_heatmap(pred, gt),
                analysis.render_disparity(1.0 / pred)):
        assert img.shape == (32, 48, 3) and 0.0 <= img.min() <= img.max() <= 1


def test_colormap_is_the_anchor_table():
    """numpy only: the plasma anchors of the JAX package's table at both
    ends, monotone inputs to 256 entries."""
    assert colormap.PLASMA.shape == (256, 3)
    np.testing.assert_allclose(colormap.PLASMA[0], [0.050, 0.030, 0.528])
    np.testing.assert_allclose(colormap.PLASMA[-1], [0.940, 0.975, 0.131])
    x = np.linspace(0, 5, 12).reshape(3, 4)
    out = colormap.colormap_plasma(x)
    assert out.shape == (3, 4, 3)
    np.testing.assert_array_equal(out[0, 0], colormap.PLASMA[0])
    np.testing.assert_array_equal(out[-1, -1], colormap.PLASMA[254])
    np.testing.assert_allclose(colormap.normalize_image(x),
                               (x - 0) / (5 + 1e-5))


def test_metric_writer_jsonl_and_no_tensorboard(tmp_path, monkeypatch):
    """JSONL always; without TensorBoard one warning, then JSONL alone."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = logging.MetricWriter(str(tmp_path))
    with pytest.warns(UserWarning, match="TensorBoard logging disabled"):
        w.scalars("train", 3, {"loss": torch.tensor(0.5), "x": 2})
    w.scalars("val", 4, {"rmse": 0.25})
    w.image("val", 4, "depth", np.zeros((4, 4, 3)))
    w.close()
    rows = [json.loads(ln) for ln in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["mode"], r["step"]) for r in rows] == [("train", 3),
                                                     ("val", 4)]
    assert rows[0]["loss"] == 0.5 and rows[1]["rmse"] == 0.25
    for t in (0, 59, 3600 + 61, 100 * 3600 + 5):
        assert logging.sec_to_hm_str(t) == jlogging.sec_to_hm_str(t)


def test_profiler_trace_and_step_timer(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace.json").is_file()
    assert any("mm" in e.key for e in prof.key_averages())
    timer = profiling.StepTimer(batch_size=4, total_steps=3)
    assert timer.tick() == {}
    stats = timer.tick()
    assert stats["examples_per_sec"] > 0 and stats["eta_s"] >= 0
