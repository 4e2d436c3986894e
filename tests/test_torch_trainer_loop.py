"""The port's training loop and command line on the CPU at 32x32, batch 2:
a killed and resumed fit against an uninterrupted one (the port of
tests/test_train.py::test_fit_kill_resume_identical_batch_sequence), an
overfit run, the logging cadence, the image logging's guard, and
``python -m polardepth_tpu_torch train|evaluate``."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from polardepth_tpu_torch import cli, config
from polardepth_tpu_torch.data.pipeline import BatchIterator, device_prefetch
from polardepth_tpu_torch.data.synthetic import SyntheticHammer
from polardepth_tpu_torch.eval.evaluation import METRIC_ORDER
from polardepth_tpu_torch.train import trainer
from polardepth_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
H, W = 32, 32
# two evaluations of the same weights on the same frames, batched in
# another order: the frame sums are taken in another order
TABLE_RTOL = 1e-5


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
    base = dict(height=H, width=W, batch_size=2, num_epochs=2)
    base.update(kw)
    return config.PUBLISHED.replace(**base)


def _quiet(cfg, spe=4):
    return Trainer(cfg, steps_per_epoch=spe, device="cpu",
                   log_fn=lambda *_: None)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """JSONL alone: the writer warns once and goes on without TensorBoard."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _kill_and_resume(tmp_path, n_trained):
    """Kill a fit while it loads the batch after its n_trained-th and
    resume it in a fresh trainer and iterator: the batches consumed across
    the kill equal an uninterrupted run's, and so do the final parameters.
    Dropout is on, so the per-step draws must be a function of (seed,
    step) too."""
    cfg = _cfg(save_frequency=10)
    assert cfg.dropout_rate > 0
    gen = SyntheticHammer(H, W, seed=0)
    n_samples, spe = 6, 3

    def make_iter(log, bomb_at=None):
        calls = {"n": 0}

        def load(i):
            if bomb_at is not None and calls["n"] >= bomb_at:
                raise KeyboardInterrupt("simulated preemption")
            calls["n"] += 1
            log.append(int(i))
            return gen.sample(int(i))

        return BatchIterator(load, n_samples, cfg.batch_size, shuffle=True,
                             seed=cfg.seed, num_workers=1)

    ref_log = []
    t_ref = _quiet(cfg, spe)
    t_ref.fit(make_iter(ref_log), num_epochs=2)
    assert t_ref.state.step == 6

    ckdir = str(tmp_path / "ck")
    log1 = []
    t1 = _quiet(cfg, spe)
    with pytest.raises(KeyboardInterrupt):
        t1.fit(make_iter(log1, bomb_at=n_trained * cfg.batch_size),
               num_epochs=2, checkpoint_dir=ckdir, save_every_steps=1)
    assert len(log1) == n_trained * cfg.batch_size
    assert t1.state.step == n_trained

    log2 = []
    t2 = _quiet(cfg, spe)
    t2.fit(make_iter(log2), num_epochs=2, checkpoint_dir=ckdir,
           save_every_steps=1)
    assert t2.state.step == 6
    assert log1 + log2 == ref_log
    for a, b in zip(t_ref.model.state_dict().values(),
                    t2.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_fit_kill_resume_identical_batch_sequence(tmp_path):
    """Dies while loading epoch 0's last batch, after 2 trained."""
    _kill_and_resume(tmp_path, 2)


def test_fit_kill_resume_after_an_epochs_last_batch(tmp_path):
    """Dies while loading epoch 1's first batch: the last checkpoint was
    taken after epoch 0's last step, before its pass ended, so its data
    state is (epoch 0, cursor 3), which must resume at epoch 1's top."""
    _kill_and_resume(tmp_path, 3)


def test_step_seed_is_a_function_of_seed_and_step():
    seeds = {trainer.step_seed(s, k) for s in (0, 1) for k in range(50)}
    assert len(seeds) == 100
    assert trainer.step_seed(42, 7) == trainer.step_seed(42, 7)


def test_overfit_single_batch_loss_decreases():
    cfg = _cfg(dropout_rate=0.0)
    t = _quiet(cfg, 1)
    batch = SyntheticHammer(H, W, seed=0).batch(cfg.batch_size)
    losses = [t.train_epoch([batch])["loss"] for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses
    table = t.evaluate([batch])
    assert table["all"]["frames"] == cfg.batch_size
    assert all(np.isfinite(table["all"][m]) for m in METRIC_ORDER)
    assert t.counts == {"train_steps": 8, "eval_batches": 1,
                        "predict_batches": 0}


class _Writer:
    def __init__(self, fail_images=False):
        self.rows, self.images, self.fail = [], [], fail_images

    def scalars(self, mode, step, values):
        self.rows.append((mode, step, dict(values)))

    def image(self, mode, step, tag, img):
        if self.fail:
            raise OSError("disk full")
        self.images.append((mode, step, tag, img.shape))


def test_log_frequency_cadence_and_val_rows():
    """log_frequency 2 over 4 steps: train and single-batch val rows at
    steps 2 and 4, then the epoch's train row and its evaluation's val
    row; images of the first eval frame."""
    cfg = _cfg(log_frequency=2, num_epochs=1, dropout_rate=0.0)
    gen = SyntheticHammer(H, W, seed=1)
    batches = [gen.batch(2, start=2 * i) for i in range(4)]
    t = _quiet(cfg)
    w = _Writer()
    results = t.fit(lambda: iter(batches), lambda: iter(batches[:1]),
                    writer=w)
    assert list(results) == ["initial", "epoch_0"]
    assert [(m, s) for m, s, _ in w.rows] == [
        ("train", 2), ("val", 2), ("train", 4), ("val", 4), ("train", 4),
        ("val", 4)]
    assert set(w.rows[1][2]) == set(METRIC_ORDER)
    assert ("val", 4, "depth_pred", (H, W, 3)) in w.images
    assert t.counts == {"train_steps": 4, "eval_batches": 4,
                        "predict_batches": 1}


def test_log_images_guards_only_the_writing():
    cfg = _cfg(dropout_rate=0.0)
    batch = SyntheticHammer(H, W, seed=2).batch(2)
    t = _quiet(cfg)
    logged = []
    t.log = logged.append
    t._log_images(lambda: iter([batch]), _Writer(fail_images=True))
    assert logged == ["image logging skipped: disk full"]

    def broken(_):
        raise RuntimeError("kernel launch failed")

    t._infer_step = broken
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        t._log_images(lambda: iter([batch]), _Writer())


def test_cli_train_then_evaluate(tmp_path, capsys):
    """The acceptance run at 32x32 on 4 scenes: metrics.jsonl with train
    and val rows, config.json and step_4, the table printed, and evaluate
    --weights on step_4 printing the fit's last table."""
    flags = ["--synthetic", "4", "--height", "32", "--width", "32",
             "--batch_size", "2", "--device", "cpu"]
    assert cli.main(["train", *flags, "--num_epochs", "2", "--log_dir",
                     str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "glass" in out and "epoch 1: loss=" in out
    run = tmp_path / "polardepth"
    rows = [json.loads(ln) for ln in
            (run / "metrics.jsonl").read_text().splitlines()]
    modes = [r["mode"] for r in rows]
    assert modes.count("train") == 2 and modes.count("val") == 2
    assert all(np.isfinite(r["loss"]) for r in rows if r["mode"] == "train")
    ck = run / "checkpoints"
    assert (ck / "config.json").is_file()
    assert (ck / "step_4" / "state.pt").is_file()
    saved = config.Config.from_json((ck / "config.json").read_text())
    assert saved.height == 32 and saved.decode_backend == "cv2"

    fit_table = {r["mode"][len("test_"):]: r for r in rows
                 if r["mode"].startswith("test_")}
    _, table = cli.evaluate([*flags, "--weights", str(ck / "step_4")])
    assert "glass" in capsys.readouterr().out
    assert table["all"]["frames"] == 4
    for name, row in table.items():
        for m in METRIC_ORDER:
            assert row[m] == pytest.approx(fit_table[name][m],
                                           rel=TABLE_RTOL, abs=1e-7)


@pytest.mark.parametrize("flags", [
    ["--train_student"], ["--train_dpt"], ["--res_pose"],
    ["--use_attention"], ["--depth_supervision_only", "false"]])
def test_cli_refuses_unported_paths(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.main(["train", "--synthetic", "2", "--device", "cpu",
                  "--log_dir", str(tmp_path), *flags])
    assert not (tmp_path / "polardepth").exists()


def test_cli_refuses_reference_weights_and_other_datasets(tmp_path):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.main(["evaluate", "--synthetic", "2", "--device", "cpu",
                  "--reference_weights", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="kitti.*not ported yet"):
        cli.main(["evaluate", "--dataset", "kitti", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["train", "--compute_dtype", "bfloat16"])
    assert cli.main([]) == 1


def test_chip_smoke_train_loop_phase_on_cpu():
    """Phase 8 of chip_smoke.py with device="cpu" at 32x32, batch 2, 4
    scenes: every check passes, and on the CPU no kernel launches."""
    chip_smoke = _chip_smoke()
    lp = chip_smoke.train_loop(
        "cpu", ["--height", "32", "--width", "32", "--batch_size", "2"],
        scenes=4, epochs=2)
    assert lp["steps"] == 4 and len(lp["losses"]) == 2
    assert set(lp["launches"].values()) == {0}
    assert lp["counts"] == {"train_steps": 4, "eval_batches": 6,
                            "predict_batches": 2}
    assert lp["eval_rel_diff"] <= chip_smoke.EVAL_TABLE_RTOL
    assert lp["all"]["frames"] == 4 and lp["profile"] is None
    assert lp["loop_images_per_s"] > 0 and lp["eval_images_per_s"] > 0
    assert set(lp["decoders"]) == {"cv2", "PIL", "libpng"}


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_host_feed_on_cpu():
    """Phase 8's host feed at 32x32: each pair trains one epoch from the
    cache and one over the same batches already placed, 2 steps each."""
    chip_smoke = _chip_smoke()
    t = _quiet(_cfg(), 2)
    fd = chip_smoke.host_feed(t, scenes=4, pairs=1)
    assert fd["steps"] == 2 and t.state.step == 4
    assert len(fd["loop"]) == len(fd["alone"]) == len(fd["ratio"]) == 1
    assert fd["ratio"][0] == pytest.approx(fd["loop"][0] / fd["alone"][0])


def test_chip_smoke_device_idle_from_a_trace(tmp_path):
    """The idle share over a step's span from a Chrome trace: overlapping
    device operations count once, operations before the span not at all,
    and the span ends at the last device operation."""
    chip_smoke = _chip_smoke()
    ev = [{"ph": "X", "cat": "user_annotation", "name": "train_step",
           "ts": 100.0, "dur": 300.0},
          {"ph": "X", "cat": "kernel", "name": "early", "ts": 10.0,
           "dur": 50.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "h2d", "ts": 150.0,
           "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 200.0,
           "dur": 100.0},
          {"ph": "X", "cat": "Kernel", "name": "b", "ts": 500.0,
           "dur": 600.0, "args": {"correlation": 7}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 120.0,
           "dur": 900.0, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::conv", "ts": 470.0,
           "dur": 20.0, "tid": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 480.0, "dur": 5.0, "tid": 1, "args": {"correlation": 7}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
           "ts": 310.0, "dur": 150.0, "tid": 1}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    idle = chip_smoke.device_idle(str(path), "train_step")
    # span 100 -> 1100 us; busy 150-300 and 500-1100
    assert idle["span_ms"] == pytest.approx(1.0)
    assert idle["busy_ms"] == pytest.approx(0.75)
    assert idle["idle_share"] == pytest.approx(0.25)
    assert idle["host_ms"] == pytest.approx(0.3)
    assert idle["first_op_ms"] == pytest.approx(0.05)
    assert idle["ops"] == 3
    # the longest gap first: 300 -> 500 us, ended by b, which aten::conv
    # launched; then the host's lead before the first operation
    assert [(g["at_ms"], g["ms"], g["next_op"], g["launched_by"])
            for g in idle["gaps"]] == [
        pytest.approx((0.2, 0.2, "b", "aten::conv")),
        pytest.approx((0.0, 0.05, "h2d", "?"))]
    assert idle["n_waits"] == 1 and idle["waits"] == [
        {"name": "cudaStreamSynchronize", "at_ms": pytest.approx(0.21),
         "ms": pytest.approx(0.15), "in": ["aten::add"]}]
    # without an annotation the span starts at the host's first runtime
    # call (310 us) and runs to b's end; only b lies in it
    card = chip_smoke.device_idle(str(path))
    assert card["span_ms"] == pytest.approx(0.79)
    assert card["busy_ms"] == pytest.approx(0.6)
    assert card["host_ms"] == pytest.approx(0.175)
    assert card["ops"] == 1


@pytest.mark.gpu
def test_trainer_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg(height=64, width=96, dropout_rate=0.0)
    batch = SyntheticHammer(64, 96, seed=3).batch(2)
    tables = []
    for device in ("cpu", "cuda"):
        t = Trainer(cfg, steps_per_epoch=1, device=device,
                    log_fn=lambda *_: None)
        t.train_step(batch)
        tables.append(t.evaluate([batch]))
    for name, row in tables[0].items():
        for m in ("abs_rel", "sq_rel", "rmse", "rmse_log"):
            assert tables[1][name][m] == pytest.approx(row[m], rel=1e-3)


@pytest.mark.gpu
def test_device_prefetch_on_the_card_same_bytes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    host = [{"color": rng.integers(0, 256, (12, 320, 480, 3), np.uint8),
             "depth": rng.uniform(0, 2, (12, 320, 480, 1)).astype(
                 np.float32)} for _ in range(4)]
    got = list(device_prefetch(iter(host), "cuda"))
    for g, h in zip(got, host):
        for k in h:
            assert g[k].device.type == "cuda"
            assert torch.equal(g[k], torch.from_numpy(h[k]).to("cuda"))


@pytest.mark.gpu
def test_checkpoint_restore_on_the_card(tmp_path):
    """A restore on the card matches the live state: the same predictions,
    Adam's moments on the card and its step counts on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from polardepth_tpu_torch.train import checkpoint
    cfg = _cfg(height=64, width=96)
    batch = SyntheticHammer(64, 96, seed=4).batch(2)
    live = Trainer(cfg, steps_per_epoch=1, device="cuda",
                   log_fn=lambda *_: None)
    live.train_step(batch)
    path = checkpoint.save(str(tmp_path), live.state, cfg)
    fresh = Trainer(cfg, steps_per_epoch=1, device="cuda",
                    log_fn=lambda *_: None)
    checkpoint.restore(path, fresh.state)
    np.testing.assert_array_equal(live.predict(batch), fresh.predict(batch))
    a = live.state.optimizer.state_dict()["state"]
    b = fresh.state.optimizer.state_dict()["state"]
    for i in a:
        assert b[i]["step"].device == a[i]["step"].device
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert b[i][k].device == a[i][k].device
            assert torch.equal(a[i][k], b[i][k])
