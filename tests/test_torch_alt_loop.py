"""The port's loop of the self-supervised and teacher-student runs
(train/loop.py:AltTrainer) and its command line on the CPU at 32x32, batch
2: a fit killed after its first epoch and resumed in a fresh trainer
against an uninterrupted one (state and depth-bin trackers), the frozen
teacher's epoch, and ``python -m polardepth_tpu_torch train --train_student``
and ``train --depth_supervision_only false`` end to end; the flags of paths
still unported raise."""

import json
import shutil
import sys

import numpy as np
import pytest
import torch

from polardepth_tpu_torch import cli, config
from polardepth_tpu_torch.train import loop

H = W = 32
FLAGS = ["--synthetic", "4", "--height", "32", "--width", "32",
         "--batch_size", "2", "--device", "cpu", "--num_depth_bins", "16"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread beside the other test workers (see
    test_torch_trainer_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A student checkpoint holds 48 M parameters and Adam's two moments
    (~0.6 GB): remove each test's files when it ends, not when pytest
    prunes its old temporary directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(**kw):
    base = dict(height=H, width=W, batch_size=2, num_epochs=2,
                depth_supervision_only=False, train_student=True,
                num_depth_bins=16)
    base.update(kw)
    return config.PUBLISHED.replace(**base)


def _data(cfg, scenes=4):
    args = type("A", (), {"synthetic": scenes})
    return cli._make_multiframe_data(cfg, args, "train")


def _fit(cfg, ckpt, epochs, log=None):
    data, spe = _data(cfg)
    alt = loop.make_alt_trainer(cfg, spe, device="cpu",
                                log_fn=(log or (lambda *_: None)))
    alt.fit(data, data, epochs, ckpt, steps_per_epoch=spe)
    return alt


def _state(alt):
    return ({k: v.clone() for k, v in alt.state.model.state_dict().items()},
            [float(t) for t in alt.trackers])


def test_multiframe_batches_are_the_synthetic_batch_frames():
    cfg = _cfg()
    data, spe = _data(cfg)
    assert spe == 2
    from polardepth_tpu_torch.data.synthetic import SyntheticHammer
    want = SyntheticHammer(H, W, seed=cfg.seed).batch_frames(
        2, tuple(cfg.frame_ids), cfg.offset, start=2)
    got = list(data())[1]
    assert got.keys() >= {"color_frames", "rel_poses", "pol", "K", "inv_K",
                          "depth_gt", "mask"}
    for k in ("color_frames", "rel_poses", "pol", "color", "depth"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_multiframe_batches_of_a_hammer_scene(tmp_path):
    """HAMMER data (a synthetic scene written in its on-disk layout, read
    with cv2): each sample's frames in frame_ids order and its poses
    relative to frame 0, as HammerLoader gives them."""
    from polardepth_tpu_torch.data import hammer, synthetic
    synthetic.write_synthetic_scene(str(tmp_path), "scene_a", num_frames=12,
                                    height=H, width=W)
    cfg = _cfg(data_path=str(tmp_path), overfit=True,
               overfit_scene="scene_a", offset=2)
    args = type("A", (), {"synthetic": 0})
    data, spe = cli._make_multiframe_data(cfg, args, "val")
    batch = next(data())
    assert batch["color_frames"].shape == (2, 3, H, W, 3)
    np.testing.assert_array_equal(batch["color_frames"][:, 0],
                                  batch["color"])
    index = hammer.HammerIndex(str(tmp_path), ["scene_a"], cfg.frame_ids, 2)
    loader = hammer.HammerLoader(index)
    assert spe == len(index) // 2
    for i in range(2):
        base, center = index.entries[i]
        for j, f in enumerate(cfg.frame_ids):
            np.testing.assert_array_equal(batch["color_frames"][i, j],
                                          loader.load(i, f)["color"])
            want = (np.eye(4) if f == 0 else
                    loader.relative_pose(base, center + 2 * f, center))
            np.testing.assert_array_equal(batch["rel_poses"][i, j], want)
    np.testing.assert_array_equal(
        batch["K"][0], loader.intrinsics_for(index.entries[0][0], W, H))


def test_fit_kill_resume_restores_state_and_trackers(tmp_path):
    """One epoch, killed, then a fresh trainer that resumes from step_2 and
    runs the second epoch: the same weights and trackers as two epochs in
    one fit, and the trackers moved from their start."""
    cfg = _cfg()
    whole = _fit(cfg, str(tmp_path / "whole"), 2)
    _fit(cfg, str(tmp_path / "killed"), 1)
    lines = []
    resumed = _fit(cfg, str(tmp_path / "killed"), 2, lines.append)
    assert any("resumed from" in ln and "step_2" in ln for ln in lines)
    assert resumed.state.step == whole.state.step == 4
    (sd_a, tr_a), (sd_b, tr_b) = _state(whole), _state(resumed)
    assert tr_a == tr_b
    assert tr_a != [cfg.min_depth, cfg.max_depth]
    for k, v in sd_a.items():
        torch.testing.assert_close(sd_b[k], v, rtol=0, atol=0, msg=k)
    saved = torch.load(tmp_path / "killed" / "step_2" / "state.pt",
                       weights_only=True)
    assert len(saved["extra"]["trackers"]) == 2


def test_frozen_teacher_epoch_keeps_trackers_and_teacher_statistics(tmp_path):
    """freeze_teacher_epoch=1: epoch 1 runs the frozen step, which moves
    neither the trackers nor the teacher's BatchNorm statistics, while the
    student trains on."""
    cfg = _cfg(freeze_teacher_epoch=1)
    alt = _fit(cfg, None, 1)
    tr1, sd1 = list(alt.trackers), _state(alt)[0]
    data, spe = _data(cfg)
    alt.fit(data, None, 2, None, steps_per_epoch=spe)
    assert alt.state.step == 4
    assert [float(t) for t in tr1] == [float(t) for t in alt.trackers]
    sd2 = alt.state.model.state_dict()
    for k, v in sd1.items():
        if k.startswith("teacher.") and "running_" in k:
            torch.testing.assert_close(sd2[k], v, rtol=0, atol=0, msg=k)
    assert any(not torch.equal(sd2[k], v) for k, v in sd1.items()
               if k.startswith("encoder.") and "running_" in k)


@pytest.mark.parametrize("flags", [
    ["--train_student"], ["--depth_supervision_only", "false"],
    ["--train_student", "--cv_warp_impl", "xla"]])
def test_cli_trains_the_multiframe_runs(flags, tmp_path, capsys):
    """The acceptance runs at 32x32 on 4 synthetic scenes for 2 epochs:
    the table printed, metrics.jsonl with train and val rows, step_4 and
    config.json, and the student's trackers in the checkpoint."""
    assert cli.main(["train", *FLAGS, "--num_epochs", "2", "--log_dir",
                     str(tmp_path), *flags]) == 0
    out = capsys.readouterr().out
    assert "glass" in out and "epoch 1: loss=" in out
    run = tmp_path / "polardepth"
    rows = [json.loads(ln) for ln in
            (run / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in rows if r["mode"] == "train_epoch"]
    assert len(epochs) == 2 and all(np.isfinite(r["loss"]) for r in epochs)
    ck = run / "checkpoints"
    saved = config.Config.from_json((ck / "config.json").read_text())
    assert saved.train_student == ("--train_student" in flags)
    # as in the JAX package, --train_student takes the student's path with
    # depth_supervision_only left as it is: the student step reads only
    # depth_supervision
    assert saved.depth_supervision_only == ("false" not in flags)
    state = torch.load(ck / "step_4" / "state.pt", weights_only=True)
    if "--cv_warp_impl" in flags:
        assert saved.cv_warp_impl == "xla"
    if "--train_student" in flags:
        assert any(k.startswith("encoder._FeatureExtractor_0")
                   for k in state["model"])
        assert all(np.isfinite(float(t)) for t in state["extra"]["trackers"])
    else:
        assert state["extra"] is None
        assert any(k.startswith("pose_net.") for k in state["model"])


@pytest.mark.parametrize("flags", [
    ["--train_student", "--train_dpt"], ["--train_dpt"],
    ["--depth_supervision_only", "false", "--train_dpt"],
    ["--train_student", "--decode_backend", "native"]])
def test_cli_still_refuses_the_unported_flags(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.main(["train", *FLAGS, "--log_dir", str(tmp_path), *flags])
    assert not (tmp_path / "polardepth").exists()


def test_evaluate_refuses_the_student():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.main(["evaluate", *FLAGS, "--train_student"])


def _chip_smoke():
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def test_chip_smoke_student_phase_on_cpu():
    """Phase 9 of chip_smoke.py with device="cpu" at 32x32, batch 2, 16
    bins: every check passes, and on the CPU no kernel launches."""
    chip_smoke = _chip_smoke()
    cfg = chip_smoke.student_cfg().replace(height=H, width=W, batch_size=2,
                                           num_depth_bins=16)
    ts = chip_smoke.train_student("cpu", cfg, 2, 1, 0)
    assert len(ts["losses"]) == 2 and ts["profile"] is None
    assert set(ts["launches"].values()) == {0}
    assert set(ts["launches_frozen"].values()) == {0}
    assert ts["loss_rel_err"] == 0.0 and ts["sweep"]["plain_err"] == 0.0
    assert 0.0 <= ts["sweep"]["clamped"] <= 1.0
    runs = chip_smoke.student_cli("cpu", (
        ("--train_student --height 32 --width 32 --batch_size 2 "
         "--num_depth_bins 16", 4, 1),
        ("--depth_supervision_only false --height 32 --width 32 "
         "--batch_size 2", 2, 1)))
    assert [len(r["losses"]) for r in runs] == [1, 1]
    assert all(set(r["launches"].values()) == {0} for r in runs)


@pytest.mark.gpu
def test_student_on_the_card_matches_the_cpu(tmp_path):
    """The student's per-material table on the card (K1, the sweep through
    K2's lanes kernel) equals the CPU's within 1e-3; one train step
    launches K2 22 times (6 of them the sweep's) and K3 16 times; a
    checkpoint restores the trackers onto the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from polardepth_tpu_torch.ops import build
    cfg = _cfg(height=64, width=96, num_depth_bins=96, dropout_rate=0.0)
    data, spe = _data(cfg, scenes=2)
    batch = next(data())
    tables = []
    for device in ("cpu", "cuda"):
        alt = loop.make_alt_trainer(cfg, spe, device=device,
                                    log_fn=lambda *_: None)
        tables.append(alt.evaluate([batch]))
    for name, row in tables[0].items():
        for m in ("abs_rel", "sq_rel", "rmse", "rmse_log"):
            assert tables[1][name][m] == pytest.approx(row[m], rel=1e-3)
    build.reset_launch_counts()
    alt.train_step(batch)
    torch.cuda.synchronize()
    assert build.launch_counts == {"polar_preprocess": 1,
                                   "band_warp_fwd": 22,
                                   "band_warp_fwd_lanes": 6,
                                   "band_warp_bwd": 16,
                                   "band_warp_img_grad": 0}
    from polardepth_tpu_torch.train import checkpoint
    path = checkpoint.save(str(tmp_path), alt.state, cfg, extra=alt._extra())
    fresh = loop.make_alt_trainer(cfg, spe, device="cuda",
                                  log_fn=lambda *_: None)
    fresh.restore(path)
    for a, b in zip(alt.trackers, fresh.trackers):
        assert b.device.type == "cuda" and torch.equal(a, b)
