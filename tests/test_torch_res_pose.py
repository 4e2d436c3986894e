"""The residual-pose refinement (``res_pose``) of the port's self-supervised
step against the JAX package's (polardepth_tpu/train/selfsup.py:283-302,
:530-577, :604-611), at batch 2, 64x96 and the published widths.

The JAX package's band-warp route gives the re-warped image no gradient
(its custom VJP returns a zero image cotangent), so it is no oracle for the
residual loss's gradient.  The whole step is compared with
``warp_impl="patch"`` on both sides, the JAX package's own "auto" off the
TPU.  Then the port's band-warp step ("pallas_fast": K2, K3 and K4's plain
versions on the CPU) is held against its own "patch" step, where the
synthetic frames' parallax stays inside the 32-row band (checked).

The step comparisons are those of test_torch_train.py (its docstring and
tests/torch_step_parity.py): the loss and every log term within 1e-5
relative (the photometric terms reproj_loss/s within 1e-3), every gradient
within 1e-4 of its max abs plus four times the port's own float32 spread,
the statistics within 1e-5, the parameters within 1e-6 plus Adam's spread.
The step against the JAX package's takes into that spread, besides the
steps from the weights scaled by 1 +- 2^-20, two steps from the weights
multiplied element by element by 1 + or - 2^-20 at random, as
tests/test_torch_student.py does for the student's leaves: with the
residual pass, the XOLP stem's and the pose encoder's first gradients move
by up to 1.8e-3 and 3e-3 of their max under such a jiggle (a float32-level
change of the forward flips some of the step's hard selections, its
automask and the residual pass's min), by as much as they differ from the
JAX package's, while the uniform scale, which train-mode BatchNorm
normalises away, moves them by 3e-5 (measured on the CPU).
The pose net's running statistics are redrawn away from their init, so
that a residual pass that read the statistics the step's own forward has
just moved would differ: the test plants that fault in the port and
requires its residual loss to fail the 1e-5 limit.

Pieces: ``predict_residual_poses`` within 1e-5 relative (plus 1e-7
absolute) of the JAX package's on the same eval-mode pose net;
``residual_reprojection_loss`` within 1e-5 relative, and its gradients
with respect to the warped images, the depth and each pose-net parameter
within 1e-4 of their max abs (the SSIM's float32 sums, the min's
selections at near-ties); residual poses cut from the pose net (computed
under torch.no_grad(), planted) must fail the pose-net limit.
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
from polardepth_tpu_torch.models.convert import (  # noqa: E402
    jax_from_state_dict, state_dict_from_jax)
from polardepth_tpu_torch.ops import band_warp  # noqa: E402
from polardepth_tpu_torch.train import selfsup  # noqa: E402

from torch_step_parity import (  # noqa: E402,F401
    B, H, W, _compare_port, _flat, _float32_jax, _jax_reference,
    _jitter_draws, _redraw_bn, _run_port, _same_preprocess, _torch_trees)

POSE_RTOL = 1e-5
POSE_ATOL = 1e-7
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the seeds of the element jiggles in the steps' float32 spread
JIGGLES = (1, 2)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: beside the other test workers, torch's default
    of a thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
OVER = dict(height=H, width=W, batch_size=B, dropout_rate=0.0,
            depth_supervision_only=False, res_pose=True)


def _pose_net(seed):
    """(JAX variables, the port's PoseNet) with the same weights, BatchNorm
    parameters and statistics redrawn."""
    jnet = jselfsup.PoseNet()
    a = jnp.zeros((1, H, W, 3), jnp.float32)
    v = jnet.init(jax.random.PRNGKey(seed), a, a, False)
    v = _redraw_bn(jax.device_get(v), seed, stats=True)
    net = selfsup.PoseNet()
    net.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    return v, net.eval()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    frames = {f: rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
              for f in (-1, 1)}
    color0 = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.5, (B, H, W, 1)).astype(np.float32)
    K = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 0.9 * W
    K[:, 0, 2], K[:, 1, 2] = (W - 1) / 2, (H - 1) / 2
    return frames, color0, depth, K, np.linalg.inv(K).astype(np.float32)


def test_predict_residual_poses_matches_jax():
    v, net = _pose_net(0)
    frames, color0, *_ = _inputs(0)
    jcfg = jconfig.PUBLISHED.replace(**OVER)
    jnet = jselfsup.PoseNet()
    want = jselfsup.predict_residual_poses(
        jnet.apply, v, jcfg,
        {("color", f, 0): jnp.asarray(x) for f, x in frames.items()},
        jnp.asarray(color0))
    with torch.no_grad():
        got = selfsup.predict_residual_poses(
            net, config.PUBLISHED.replace(**OVER),
            {("color", f, 0): torch.from_numpy(x) for f, x in frames.items()},
            torch.from_numpy(color0))
    assert set(got) == set(want) == {-1, 1}
    for f in want:
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]),
                                   rtol=POSE_RTOL, atol=POSE_ATOL)
    # the poses move: the residual pass is no identity
    assert float(np.abs(np.asarray(want[1])[:, :3, 3]).max()) > 1e-4


def _residual_loss_pair(seed):
    """The residual loss on both sides, on an eval-mode pose net with
    redrawn statistics, through the "patch" sampler on both sides -> (the
    JAX loss and its gradients with respect to the warped sources, the
    depth and the pose net's parameters; the port's loss, warped sources,
    depth and pose net, the loss not yet differentiated)."""
    v, net = _pose_net(seed)
    frames, color0, depth, K, inv_K = _inputs(seed)
    over = dict(OVER, warp_impl="patch")
    jcfg = jconfig.PUBLISHED.replace(**over)
    tcfg = config.PUBLISHED.replace(**over)
    rng = jax.random.PRNGKey(5)
    jnoise = {f: np.array(jax.random.normal(
        jax.random.fold_in(rng, f + 128), (B, H, W, 1))) for f in (-1, 1)}

    def jloss(warped, d, params):
        return jselfsup.residual_reprojection_loss(
            jcfg, rng, params, v["batch_stats"],
            {("color", f, 0): x for f, x in warped.items()},
            {("depth", 0, 0): d}, jnp.asarray(color0), jnp.asarray(K),
            jnp.asarray(inv_K))

    jwarped = {f: jnp.asarray(x) for f, x in frames.items()}
    want, grads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jwarped, jnp.asarray(depth), v["params"])
    warped = {f: torch.from_numpy(x).requires_grad_(True)
              for f, x in frames.items()}
    d = torch.from_numpy(depth).requires_grad_(True)
    stats = dict(net.named_buffers())
    net.train()         # the loss runs the pose net in eval mode itself
    got = selfsup.residual_reprojection_loss(
        tcfg, net, stats, {("color", f, 0): x for f, x in warped.items()},
        {("depth", 0, 0): d}, torch.from_numpy(color0), torch.from_numpy(K),
        torch.from_numpy(inv_K),
        {f: torch.from_numpy(x) for f, x in jnoise.items()})
    assert net.training
    return (want, grads), (got, warped, d, net)


def test_residual_reprojection_loss_matches_jax():
    """The loss and its gradients with respect to the warped sources and
    the depth."""
    (want, (gw_ref, gd_ref, _)), (got, warped, d, _) = _residual_loss_pair(1)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    got.backward()
    for f in (-1, 1):
        ref = np.asarray(gw_ref[f])
        assert np.abs(ref).max() > 0
        assert np.abs(warped[f].grad.numpy() - ref).max() <= \
            GRAD_RTOL * np.abs(ref).max()
    ref = np.asarray(gd_ref)
    assert np.abs(ref).max() > 0
    assert np.abs(d.grad.numpy() - ref).max() <= GRAD_RTOL * np.abs(ref).max()


def _pose_grad_errors(net, gp_ref) -> dict:
    """{pose-net leaf: max abs difference of the port's gradient from the
    JAX package's over GRAD_RTOL of the JAX one's max abs}; a parameter
    the loss did not reach has a zero gradient."""
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in net.named_parameters()}
    got = _flat(jax_from_state_dict(grads)[0])
    want = _flat(jax.device_get(gp_ref))
    assert got.keys() == want.keys()
    assert all(np.abs(r).max() > 0 for r in want.values())
    return {k: np.abs(got[k] - r).max() / (GRAD_RTOL * np.abs(r).max())
            for k, r in want.items()}


def test_residual_loss_reaches_the_pose_net_like_jax(monkeypatch):
    """The loss's gradient with respect to every pose-net parameter within
    GRAD_RTOL of its max abs.  The planted fault, residual poses computed
    under torch.no_grad(), must fail that limit."""
    (_, (_, _, gp_ref)), (got, *_, net) = _residual_loss_pair(1)
    got.backward()
    over = _pose_grad_errors(net, gp_ref)
    assert max(over.values()) <= 1.0, over

    real = selfsup.predict_residual_poses

    def detached(*args):
        with torch.no_grad():
            return real(*args)

    monkeypatch.setattr(selfsup, "predict_residual_poses", detached)
    (_, (_, _, gp_ref)), (got, *_, net) = _residual_loss_pair(1)
    got.backward()
    assert min(_pose_grad_errors(net, gp_ref).values()) > 1.0


def _step_draws(rng):
    """The draws of the JAX self-supervised step
    (polardepth_tpu/train/selfsup.py:584-585, :469-470, :571-573)."""
    k_jit, k_noise, k_res, _ = jax.random.split(rng, 4)
    key_jit, _ = jax.random.split(k_jit)
    noise = np.array(jax.random.normal(jax.random.fold_in(k_noise, 0),
                                       (B, H, W, 1)))
    res = {f: torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(k_res, f + 128), (B, H, W, 1)))) for f in (-1, 1)}
    return {"jitter": _jitter_draws(key_jit, B),
            "noise": {0: torch.from_numpy(noise)}, "res_noise": res}


def _batch():
    return SyntheticHammer(H, W, seed=2).batch_frames(
        B, frame_ids=(0, -1, 1), offset=2)


def _post_forward_statistics(monkeypatch):
    """The planted fault: the residual pass reads the pose net's
    statistics as the step's train-mode forward left them."""
    real = selfsup.residual_reprojection_loss

    def faulty(cfg, pose_net, pose_stats, *args):
        return real(cfg, pose_net, dict(pose_net.named_buffers()), *args)

    monkeypatch.setattr(selfsup, "residual_reprojection_loss", faulty)


def test_res_pose_step_matches_jax(monkeypatch):
    over = dict(OVER, warp_impl="patch")
    jcfg = jconfig.PUBLISHED.replace(**over)
    tcfg = config.PUBLISHED.replace(**over)
    jmodel = jselfsup.SelfSupModel.from_config(jcfg)
    example = {"color_frames": jnp.zeros((1, 3, H, W, 3), jnp.float32),
               "pol": jnp.zeros((1, H, W, 4), jnp.float32)}
    batch = _batch()
    weights, draws, ref = _jax_reference(
        jcfg, jmodel, jselfsup.make_selfsup_train_step(jmodel, jcfg),
        example, batch, _step_draws, redraw_stats=True)
    assert float(ref["logs"]["res_pose_loss"]) > 0
    logs = _compare_port(ref, selfsup.SelfSupModel.from_config,
                         selfsup.make_selfsup_train_step, tcfg, weights,
                         batch, draws, jcfg.learning_rate, JIGGLES)
    assert "res_pose_loss" in logs
    _post_forward_statistics(monkeypatch)
    faulty, _ = _run_port(selfsup.SelfSupModel.from_config,
                          selfsup.make_selfsup_train_step, tcfg, weights,
                          batch, draws)
    with pytest.raises(AssertionError, match="res_pose_loss"):
        np.testing.assert_allclose(
            float(faulty["res_pose_loss"]),
            float(ref["logs"]["res_pose_loss"]), rtol=LOSS_RTOL,
            err_msg="res_pose_loss")


def test_band_warp_step_matches_the_patch_step(monkeypatch):
    """The port's res_pose step through the band warp (K2, K3, K4's plain
    versions) against its own "patch" step: the same draws and weights,
    every band-warp call unclamped by its band and sampling no interior
    row at an exact integer.

    The two routes are one function only there.  At an exact integer row
    K3 gives d/d iy = 0, as the TPU kernel does (band_warp_bwd_plain),
    while the "patch" route's weights give a nonzero derivative: a single
    such pixel with a large cotangent moves the pose net's gradients by
    ~1e-3 of their max.  Both conditions are checked on every call; the
    model's init is seeded, so the data does not depend on the tests run
    before this one."""
    tcfg = config.PUBLISHED.replace(**OVER, warp_impl="patch")
    rng = np.random.default_rng(3)
    torch.manual_seed(3)
    model = selfsup.SelfSupModel.from_config(tcfg)
    sd = model.state_dict()
    weights = {k: (torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(
        np.float32)) if k.endswith("running_var") else torch.from_numpy(
        rng.normal(0, 0.1, v.shape).astype(np.float32))
        if k.endswith("running_mean") else v) for k, v in sd.items()}
    batch = _batch()
    draws = _step_draws(jax.random.PRNGKey(7))
    logs, patch_model = _run_port(selfsup.SelfSupModel.from_config,
                                  selfsup.make_selfsup_train_step, tcfg,
                                  weights, batch, draws)
    g, p, s = _torch_trees(patch_model)
    ref = {"logs": logs, "g": g, "p": p, "s": s}

    clamped, integer_rows = [], []
    real_prep = band_warp.prep

    def prep(img_shape, grid, k, step, align_corners, *args):
        ix, iy, base = real_prep(img_shape, grid, k, step, align_corners,
                                 *args)
        _, iy_image, _ = real_prep(img_shape, grid, img_shape[1], 1,
                                   align_corners)
        clamped.append(bool((iy != iy_image).any()))
        inside = (iy > 0) & (iy < img_shape[1] - 1)
        integer_rows.append(int(((iy == torch.floor(iy)) & inside).sum()))
        return ix, iy, base

    monkeypatch.setattr(band_warp, "prep", prep)
    launches = []
    real_img_grad = band_warp.band_warp_img_grad

    def img_grad(*args):
        launches.append(1)
        return real_img_grad(*args)

    monkeypatch.setattr(band_warp, "band_warp_img_grad", img_grad)
    _compare_port(ref, selfsup.SelfSupModel.from_config,
                  selfsup.make_selfsup_train_step,
                  tcfg.replace(warp_impl="pallas_fast"), weights, batch,
                  draws, tcfg.learning_rate)
    # 3 steps (the step and its two rerolls) x (8 warps + 2 re-warps); the
    # image gradient only for the re-warps
    assert len(clamped) == 30 and not any(clamped)
    assert not any(integer_rows), integer_rows
    assert len(launches) == 6


def test_res_pose_cli_and_chip_smoke_phase_on_cpu(tmp_path):
    """``train --depth_supervision_only false --res_pose`` at 32x32 logs the
    residual loss, and phase 12 of chip_smoke.py runs at batch 2, 32x32 on
    the CPU: finite losses, no kernel launch, the plain-warp step equal to
    the main one."""
    import json
    import sys
    from pathlib import Path
    from polardepth_tpu_torch import cli
    cli.main(["train", "--depth_supervision_only", "false", "--res_pose",
              "--synthetic", "2", "--height", "32", "--width", "32",
              "--batch_size", "2", "--num_epochs", "1", "--device", "cpu",
              "--log_dir", str(tmp_path)])
    with open(tmp_path / "polardepth" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    res = [r["res_pose_loss"] for r in rows if "res_pose_loss" in r]
    assert res and np.isfinite(res).all() and min(res) > 0
    root = str(Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    cfg = chip_smoke.res_pose_cfg().replace(height=32, width=32)
    rp = chip_smoke.train_selfsup("cpu", cfg, 2, 1, 0)
    assert len(rp["losses"]) == 2 and np.isfinite(rp["losses"]).all()
    assert set(rp["launches"].values()) == {0}
    assert rp["loss_rel_err"] == 0.0 and rp["grad_err_over_limit"] <= 1.0
    assert chip_smoke.selfsup_launches(cfg) == {
        "polar_preprocess": 1, "band_warp_fwd": 10, "band_warp_fwd_lanes": 0,
        "band_warp_bwd": 10, "band_warp_img_grad": 2}
