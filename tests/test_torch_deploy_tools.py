"""The port's deployment tools against the JAX package's, on the same inputs:
point clouds and PLY files (eval/pointcloud.py), the AR composite
(apps/ar.py) and the polarization mosaic tools (data/mosaic.py), which are
numpy and cv2 on both sides and must agree exactly; ``xolp_statistics``
within XOLP_STATS_TOL on physical captures (the port's Stokes fit takes
the float32-rounded pseudoinverse, the JAX package's its float64 one).
Then the command line's chain pointcloud -> analyze -> ar, and ``evaluate
--save_pred_disps``, on the CPU at 32x32, and chip_smoke.py's deploy phase
on the CPU at the same size."""

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from polardepth_tpu.apps import ar as jar  # noqa: E402
from polardepth_tpu.data import mosaic as jmosaic  # noqa: E402
from polardepth_tpu.eval import pointcloud as jpc  # noqa: E402

import chip_smoke  # noqa: E402
from polardepth_tpu_torch import cli, config  # noqa: E402
from polardepth_tpu_torch.apps import ar  # noqa: E402
from polardepth_tpu_torch.data import mosaic  # noqa: E402
from polardepth_tpu_torch.eval import pointcloud as pc  # noqa: E402

XOLP_STATS_TOL = 1e-6
H, W = 48, 64


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread beside the other test workers (see
    tests/test_torch_trainer_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.2, 1.8, (H, W, 1)).astype(np.float32)
    depth[::7, ::5] = 0.0
    rgb = rng.integers(0, 256, (H, W, 3), np.uint8)
    mask = (rng.uniform(size=(H, W)) < 0.3).astype(np.uint8) * 100
    return depth, rgb, mask


@pytest.mark.parametrize("flip_yz,with_mask", [(True, False), (False, True)])
def test_pointcloud_and_ply_equal_the_jax_package(tmp_path, flip_yz,
                                                  with_mask):
    depth, rgb, mask = _scene(0)
    kw = dict(fx=40.5, fy=41.0, cx=31.7, cy=23.2, flip_yz=flip_yz,
              mask=mask if with_mask else None)
    pts, cols = pc.depth_to_pointcloud(depth, rgb, **kw)
    jpts, jcols = jpc.depth_to_pointcloud(depth, rgb, **kw)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(cols, jcols)
    pc.write_ply(str(tmp_path / "a.ply"), pts, cols)
    jpc.write_ply(str(tmp_path / "b.ply"), jpts, jcols)
    assert ((tmp_path / "a.ply").read_bytes()
            == (tmp_path / "b.ply").read_bytes())
    back, back_cols = pc.read_ply(str(tmp_path / "b.ply"))
    np.testing.assert_array_equal(back, pts)
    np.testing.assert_array_equal(back_cols, cols)


def test_ar_composite_equals_the_jax_package():
    depth, rgb, mask = _scene(1)
    gt = _scene(2)[0] + 0.5
    np.testing.assert_array_equal(ar.create_naked_depth(gt, mask),
                                  jar.create_naked_depth(gt, mask))
    naked = ar.create_naked_depth(gt, mask)
    logo = cli._placeholder_logo()
    for y, x in ((3, 5), (20, 40), (47, 63)):
        np.testing.assert_array_equal(
            ar.composite_ar_frame(rgb, depth, naked, logo, y, x, 20),
            jar.composite_ar_frame(rgb, depth, naked, logo, y, x, 20))


def test_mosaic_tools_equal_the_jax_package(tmp_path):
    import cv2
    rng = np.random.default_rng(3)
    frame = rng.integers(0, 256, (2 * H, 2 * W), np.uint8)
    got = mosaic.split_pol_mosaic(frame)
    want = jmosaic.split_pol_mosaic(frame)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    src = tmp_path / "raw"
    src.mkdir()
    cv2.imwrite(str(src / "000001.png"), frame)
    assert mosaic.split_and_save_scene(str(src), str(tmp_path / "a")) == 1
    assert jmosaic.split_and_save_scene(str(src), str(tmp_path / "b")) == 1
    for sub in ("pol00", "pol01", "pol10", "pol11"):
        assert ((tmp_path / "a" / sub / "000001.png").read_bytes()
                == (tmp_path / "b" / sub / "000001.png").read_bytes())
    # physical captures: integer ones tie 0-vs-90 or 45-vs-135 grays, where
    # the AoLP sits on its +-pi/2 branch cut and the sign of the fits'
    # ~1e-17 pseudoinverse residues (float32-rounded in the port, float64 in
    # the JAX package) picks the branch: the same angle modulo pi, a
    # different raw value in the reference's statistic
    stacks = [chip_smoke.physical_pol(rng, (H, W)) for _ in range(4)]
    got = mosaic.xolp_statistics(stacks)
    want = jmosaic.xolp_statistics(stacks)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=XOLP_STATS_TOL)


def test_cli_chain_pointcloud_analyze_ar(tmp_path, capsys):
    flags = ["--synthetic", "4", "--height", "32", "--width", "32",
             "--batch_size", "2", "--device", "cpu"]
    out = tmp_path / "pc"
    depth = cli.pointcloud([*flags, "--out", str(out)])
    assert depth.shape == (2, 32, 32, 1)
    for i in range(2):
        for tag in ("rgb", "mask", "depth_pred", "depth_gt"):
            assert (out / f"{i:03d}_{tag}.png").is_file()
        pts, _ = pc.read_ply(str(out / f"cloud_{i:03d}.ply"))
        assert len(pts) == int((depth[i] > 0).sum())
    report = cli.analyze(["--pred_dir", str(out)])
    text = open(report).read()
    assert sum(ln.startswith("| 0") for ln in text.splitlines()) == 2
    assert "| **mean** |" in text
    assert (out / "analysis" / "001_error_objects.png").is_file()
    gif = cli.ar(["--pred_dir", str(out), "--num_frames", "4"])
    from PIL import Image, ImageSequence
    with Image.open(gif) as im:
        durations = [f.info["duration"] for f in ImageSequence.Iterator(im)]
    assert sum(durations) == 2 * 4 * chip_smoke.AR_FRAME_MS

    cli.evaluate([*flags, "--save_pred_disps", "--eval_out_dir",
                  str(tmp_path / "ev")])
    assert "saved predicted disparities" in capsys.readouterr().out
    disps = np.load(tmp_path / "ev" / "disps_HAMMER_HAMMER_split.npy")
    assert disps.shape == (4, 32, 32, 1)
    assert disps.min() >= 1 / 2.0 and disps.max() <= 1 / 0.1
    with pytest.raises(FileNotFoundError, match="depth_pred"):
        cli.analyze(["--pred_dir", str(tmp_path / "ev")])


def test_chip_smoke_deploy_phase_on_cpu():
    """Phase 10 of chip_smoke.py with device="cpu" at 32x32, batch 2: the
    export at a symbolic batch against Predictor, the reference .pth
    files, weights_init pretrained and the chain, with all its checks."""
    cfg = config.PUBLISHED.replace(height=32, width=32, batch_size=2)
    dp = chip_smoke.deploy("cpu", cfg, requests=2, ar_frames=4)
    assert dp["nodes"] == 1 and dp["rel_err"] == {2: 0.0, 3: 0.0}
    assert dp["meta"]["platforms"] == ["cpu"]
    assert dp["components"] == sorted(
        ["rgb_encoder", "xolp_encoder", "normals_encoder", "joint_encoder",
         "mono_depth"])
    assert dp["points"] == [32 * 32] * 2 and dp["report_rows"] == 2
    assert dp["gt_gif_frames"] == 2 * 4 - 1
    assert dp["launches"]["polar_preprocess"] == 0
