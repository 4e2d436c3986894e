"""The modules of the port's training slice against their JAX functions, on
the same numpy inputs and, for the networks, the same parameters carried
over by ``state_dict_from_jax``: se3, camera, normals, the five losses, the
colour jitter (given factors) and the flip, the colour pyramid, the pose
net (ResNet18Encoder over two frames + PoseDecoder), BatchNorm in train
mode, Adam, the StepLR schedule and the self-supervised model's infer
step.

Limits, each stated at its test: 1e-5 relative (or tighter where float32
allows) on values, and gradients where the function is differentiated on
the path.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import flax.linen as fnn  # noqa: E402

from polardepth_tpu.data import augment as jaug  # noqa: E402
from polardepth_tpu.ops import camera as jcam  # noqa: E402
from polardepth_tpu.ops import losses as jlosses  # noqa: E402
from polardepth_tpu.ops import normals as jnormals  # noqa: E402
from polardepth_tpu.ops import se3 as jse3  # noqa: E402
from polardepth_tpu.train import losses as jtlosses  # noqa: E402
from polardepth_tpu.train import selfsup as jselfsup  # noqa: E402
from polardepth_tpu.train.state import step_lr_schedule  # noqa: E402

from polardepth_tpu_torch.data import augment  # noqa: E402
from polardepth_tpu_torch.models.convert import (  # noqa: E402
    jax_from_state_dict, state_dict_from_jax)
from polardepth_tpu_torch.models.layers import BatchNorm, Dropout  # noqa: E402
from polardepth_tpu_torch.models.layers import set_dropout_generator  # noqa: E402
from polardepth_tpu_torch.ops import camera, losses, normals, se3  # noqa: E402
from polardepth_tpu_torch.train import losses as tlosses  # noqa: E402
from polardepth_tpu_torch.train import selfsup, state  # noqa: E402
from polardepth_tpu_torch import config  # noqa: E402

B, H, W = 2, 64, 96


@pytest.fixture(autouse=True)
def _float32_jax():
    """float32 on the JAX side, as on the TPU (tests/conftest.py turns x64
    on for other tests' float64 oracles)."""
    with jax.enable_x64(False):
        yield


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, ref, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(ref), rtol=rtol, atol=atol)


def _intrinsics(b=B, h=H, w=W):
    K = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    K[:, 0, 0], K[:, 1, 1] = 0.9 * w, 0.9 * w
    K[:, 0, 2], K[:, 1, 2] = w / 2, h / 2
    return K, np.linalg.inv(K).astype(np.float32)


def _pose(rng, b=B):
    aa = rng.normal(0, 0.05, (b, 1, 3)).astype(np.float32)
    t = rng.normal(0, 0.05, (b, 1, 3)).astype(np.float32)
    return aa, t


# --- se3 and camera ----------------------------------------------------------

@pytest.mark.parametrize("invert", [False, True])
def test_se3_transforms_match(invert):
    rng = np.random.default_rng(0)
    aa, t = _pose(rng, 8)
    ref = jse3.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(t),
                                              invert)
    got = se3.transformation_from_parameters(_t(aa), _t(t), invert)
    _close(got, ref, atol=1e-7)
    _close(se3.get_translation_matrix(_t(t)),
           jse3.get_translation_matrix(jnp.asarray(t)))


def test_rotmat_to_rotvec_matches_including_its_gradient():
    rng = np.random.default_rng(1)
    aa = rng.normal(0, 0.6, (6, 1, 3)).astype(np.float32)
    aa[0] = [[0.6 * np.pi, -0.64 * np.pi, 0.48 * np.pi]]  # |aa| near pi
    R = np.asarray(jse3.rot_from_axisangle(jnp.asarray(aa)))[:, :3, :3]
    cot = rng.normal(size=(6, 3)).astype(np.float32)
    ref, vjp = jax.vjp(jse3.rotmat_to_rotvec, jnp.asarray(R))
    Rt = _t(R).requires_grad_(True)
    got = se3.rotmat_to_rotvec(Rt)
    (got * _t(cot)).sum().backward()
    _close(got, ref, rtol=1e-5, atol=1e-6)
    _close(Rt.grad, vjp(jnp.asarray(cot))[0], rtol=1e-4, atol=1e-5)


def test_camera_projection_matches():
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.1, 2.0, (B, H, W, 1)).astype(np.float32)
    K, inv_K = _intrinsics()
    aa, t = _pose(rng)
    T = np.asarray(jse3.transformation_from_parameters(
        jnp.asarray(aa), jnp.asarray(t)))
    pts_ref = jcam.backproject_depth(jnp.asarray(depth), jnp.asarray(inv_K))
    pts = camera.backproject_depth(_t(depth), _t(inv_K))
    _close(pts, pts_ref, atol=1e-6)
    grid_ref = jcam.project_3d(pts_ref, jnp.asarray(K), jnp.asarray(T), H, W)
    grid = camera.project_3d(pts, _t(K), _t(T), H, W)
    _close(grid, grid_ref, rtol=1e-5, atol=1e-6)
    _close(camera.scale_intrinsics(_t(K), 0.25),
           jcam.scale_intrinsics(jnp.asarray(K), 0.25))


# --- normals and losses ------------------------------------------------------

def _depth_pair(rng):
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    base = 0.8 + 0.3 * xx + 0.2 * np.sin(6 * yy)
    gt = (base[None, ..., None] + rng.normal(0, 0.01, (B, H, W, 1)))
    pred = gt * rng.uniform(0.9, 1.1, gt.shape)
    gt[:, :5] = 3.0                      # out of range: masked
    return gt.astype(np.float32), pred.astype(np.float32)


def test_normals_match():
    rng = np.random.default_rng(3)
    gt, _ = _depth_pair(rng)
    K, _ = _intrinsics()
    gx_ref, gy_ref = jnormals.spatial_gradient_sobel(jnp.asarray(gt))
    gx, gy = normals.spatial_gradient_sobel(_t(gt))
    _close(gx, gx_ref, atol=1e-7)
    _close(gy, gy_ref, atol=1e-7)
    _close(normals.depth_to_3d(_t(gt), _t(K[:, :3, :3])),
           jnormals.depth_to_3d(jnp.asarray(gt), jnp.asarray(K[:, :3, :3])),
           atol=1e-6)
    _close(normals.depth_to_normals(_t(gt), _t(K[:, :3, :3])),
           jnormals.depth_to_normals(jnp.asarray(gt),
                                     jnp.asarray(K[:, :3, :3])),
           rtol=1e-5, atol=2e-6)


def _value_and_grad_pair(jfn, tfn, *arrays, wrt=1):
    """The value and the gradient with respect to arrays[wrt] of both."""
    ref, g_ref = jax.value_and_grad(
        lambda *a: jfn(*a), argnums=wrt)(*[jnp.asarray(a) for a in arrays])
    ts = [_t(a) for a in arrays]
    ts[wrt].requires_grad_(True)
    got = tfn(*ts)
    got.backward()
    return got, ref, ts[wrt].grad, g_ref


def test_supervised_losses_match():
    rng = np.random.default_rng(4)
    gt, pred = _depth_pair(rng)
    K, _ = _intrinsics()
    mask = ((gt >= 0.1) & (gt <= 2.0)).astype(np.float32)
    got, ref, g, g_ref = _value_and_grad_pair(
        jlosses.masked_l1_depth_loss, losses.masked_l1_depth_loss,
        gt, pred, mask)
    _close(got, ref)
    _close(g, g_ref, atol=1e-9)
    got, ref, g, g_ref = _value_and_grad_pair(
        jlosses.supervised_normals_loss, losses.supervised_normals_loss,
        gt, pred, K, mask)
    _close(got, ref)
    _close(g, g_ref, rtol=1e-4, atol=1e-4 * float(np.abs(g_ref).max()))


def test_photometric_losses_match():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    pred = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1).astype(
        np.float32)
    disp = rng.uniform(0.1, 1.0, (B, H, W, 1)).astype(np.float32)
    _close(losses.ssim(_t(pred), _t(img)),
           jlosses.ssim(jnp.asarray(pred), jnp.asarray(img)), atol=2e-6)
    for use_ssim in (True, False):
        ref, vjp = jax.vjp(lambda p: jlosses.reprojection_loss(
            p, jnp.asarray(img), use_ssim), jnp.asarray(pred))
        cot = rng.normal(size=ref.shape).astype(np.float32)
        p = _t(pred).requires_grad_(True)
        got = losses.reprojection_loss(p, _t(img), use_ssim)
        (got * _t(cot)).sum().backward()
        _close(got, ref, atol=2e-6)
        g_ref = np.asarray(vjp(jnp.asarray(cot))[0])
        _close(p.grad, g_ref, atol=1e-4 * np.abs(g_ref).max())
    got, ref, g, g_ref = _value_and_grad_pair(
        jlosses.smooth_loss, losses.smooth_loss, disp, img, wrt=0)
    _close(got, ref)
    _close(g, g_ref, atol=1e-5 * float(np.abs(g_ref).max()))


# --- augmentation and the colour pyramid -------------------------------------

def test_color_jitter_with_given_factors_matches():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (4, 16, 24, 3)).astype(np.float32)
    img[0, :4] = 1.0                     # saturated pixels, clip at 1
    img[1, :4] = img[1, :4, :, :1]       # grey pixels, zero saturation
    key = jax.random.PRNGKey(3)
    ref = jaug.color_jitter(key, jnp.asarray(img), apply_prob=0.75)
    kb, kc, ks, kh, kp = jax.random.split(key, 5)

    def u(k, lo, hi):
        return _t(jax.random.uniform(k, (4, 1, 1, 1), minval=lo, maxval=hi))

    factors = {"brightness": u(kb, 0.8, 1.2), "contrast": u(kc, 0.8, 1.2),
               "saturation": u(ks, 0.8, 1.2), "hue": u(kh, -0.1, 0.1),
               "apply": torch.from_numpy(np.asarray(
                   jax.random.uniform(kp, (4, 1, 1, 1)) < 0.75))}
    assert 0 < int(factors["apply"].sum()) < 4
    _close(augment.color_jitter_apply(_t(img), factors), ref, atol=2e-6)


def test_color_jitter_draws_from_the_generator():
    g = torch.Generator().manual_seed(0)
    f = augment.color_jitter_factors(g, 256)
    assert set(f) == {"brightness", "contrast", "saturation", "hue", "apply"}
    assert 0.8 <= float(f["brightness"].min()) < float(
        f["brightness"].max()) <= 1.2
    assert -0.1 <= float(f["hue"].min()) < float(f["hue"].max()) <= 0.1
    assert 64 < int(f["apply"].sum()) < 192
    again = augment.color_jitter_factors(torch.Generator().manual_seed(0),
                                         256)
    assert all(torch.equal(f[k], again[k]) for k in f)


def test_random_horizontal_flip_matches():
    rng = np.random.default_rng(7)
    batch = {"color": rng.uniform(0, 1, (4, 8, 12, 3)).astype(np.float32),
             "color_frames": rng.uniform(0, 1, (4, 3, 8, 12, 3)).astype(
                 np.float32),
             "K": rng.uniform(0, 1, (4, 4, 4)).astype(np.float32)}
    key = jax.random.PRNGKey(5)
    ref = jaug.random_horizontal_flip(key, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    flip = torch.from_numpy(np.asarray(
        jax.random.uniform(key, (4, 1, 1, 1)) < 0.5).reshape(-1))
    got = augment.random_horizontal_flip({k: _t(v) for k, v in batch.items()},
                                         flip)
    for k in batch:
        _close(got[k], ref[k], rtol=0)


def test_color_pyramid_matches():
    img = np.random.default_rng(8).uniform(0, 1, (B, H, W, 3)).astype(
        np.float32)
    ref = jtlosses.color_pyramid(jnp.asarray(img), (0, 1, 2, 3))
    got = tlosses.color_pyramid(_t(img), (0, 1, 2, 3))
    for s in ref:
        _close(got[s], ref[s], atol=2e-6)


# --- the pose net ------------------------------------------------------------

def test_pose_net_matches_in_train_mode():
    """ResNet18Encoder over two stacked frames + PoseDecoder, BN on batch
    statistics, from converted parameters; the running statistics after
    the forward pass too."""
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    jnet = jselfsup.PoseNet()
    v = jax.device_get(jnet.init(jax.random.PRNGKey(0), jnp.asarray(a),
                                 jnp.asarray(b)))
    (aa_ref, t_ref), mut = jnet.apply(v, jnp.asarray(a), jnp.asarray(b),
                                      True, mutable=["batch_stats"])
    net = selfsup.PoseNet()
    net.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    net.train()
    aa, t = net(_t(a), _t(b))
    assert aa.shape == t.shape == (B, 2, 1, 3)
    _close(aa, aa_ref, rtol=1e-4, atol=1e-5 * float(np.abs(aa_ref).max()))
    _close(t, t_ref, rtol=1e-4, atol=1e-5 * float(np.abs(t_ref).max()))
    _, stats = jax_from_state_dict(net.state_dict())
    flat = dict(jax.tree_util.tree_leaves_with_path(stats))
    ref_flat = dict(jax.tree_util.tree_leaves_with_path(
        jax.device_get(mut["batch_stats"])))
    assert flat.keys() == ref_flat.keys() and len(flat) == 2 * 20
    for k, ref in ref_flat.items():
        _close(flat[k], ref, atol=1e-5)


# --- BatchNorm, dropout, Adam and the schedule -------------------------------

@pytest.mark.parametrize("shape", [(2, 2, 3, 5), (4, 8, 8, 3)])
def test_batch_norm_train_mode_matches_flax(shape):
    """Train mode at a 2x3 feature map (12 values per channel at batch 2):
    the output, its gradient and the running statistics, which flax
    updates with the biased batch variance (torch's own module takes the
    unbiased one, 12/11 times larger here)."""
    rng = np.random.default_rng(10)
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)      # NHWC
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}
    cot = rng.normal(size=shape).astype(np.float32)

    def f(xx):
        y, mut = bn.apply(v, xx, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut)

    (_, (y_ref, mut)), g_ref = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))
    m = BatchNorm(c, eps=1e-5, momentum=0.1)
    m.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                       "running_mean": _t(mean0), "running_var": _t(var0),
                       "num_batches_tracked": torch.tensor(0)})
    m.train()
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = m(xt)
    (y * _t(cot).permute(0, 3, 1, 2)).sum().backward()
    _close(y.permute(0, 2, 3, 1), y_ref, rtol=1e-5, atol=1e-5)
    _close(xt.grad.permute(0, 2, 3, 1), g_ref, rtol=1e-4, atol=1e-5)
    _close(m.running_mean, mut["batch_stats"]["mean"], atol=1e-6)
    _close(m.running_var, mut["batch_stats"]["var"], rtol=1e-5, atol=1e-6)
    n = x.size // c
    assert not np.allclose(
        m.running_var.numpy(),
        0.9 * var0 + 0.1 * x.reshape(-1, c).var(0, ddof=1), rtol=0.1 / n)
    m.eval()
    bn_eval = fnn.BatchNorm(use_running_average=True, epsilon=1e-5)
    _close(m(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
           bn_eval.apply({"params": v["params"],
                          "batch_stats": mut["batch_stats"]},
                         jnp.asarray(x)), rtol=1e-5, atol=1e-6)


def test_dropout_draws_from_its_generator_only():
    d = Dropout(0.25)
    x = torch.ones(4096)
    d.train()
    with pytest.raises(RuntimeError, match="generator"):
        d(x)
    set_dropout_generator(d, torch.Generator().manual_seed(1))
    y = d(x)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.7 < float(kept.float().mean()) < 0.8
    set_dropout_generator(d, torch.Generator().manual_seed(1))
    assert torch.equal(d(x), y)
    d.eval()
    assert torch.equal(d(x), x)


def test_step_lr_schedule_matches_at_its_boundaries():
    cfg = config.PUBLISHED.replace(num_epochs=50, scheduler_step_size=15,
                                   learning_rate=1e-4)
    spe = 7
    ref = step_lr_schedule(cfg.learning_rate, spe, cfg.scheduler_step_size,
                           cfg.scheduler_gamma, cfg.num_epochs)
    model = torch.nn.Linear(2, 2)
    st = state.create_train_state(model, cfg, steps_per_epoch=spe)
    seen = {}
    for i in range(50 * spe + 3):
        seen[i] = st.optimizer.param_groups[0]["lr"]
        st.scheduler.step()
    for i in (0, 15 * spe - 1, 15 * spe, 30 * spe - 1, 30 * spe, 45 * spe,
              50 * spe, 50 * spe + 2):
        np.testing.assert_allclose(seen[i], float(ref(i)), rtol=1e-6,
                                   err_msg=f"step {i}")


def test_adam_update_matches_optax():
    """One and two Adam steps on the same gradients (optax's defaults)."""
    import optax
    rng = np.random.default_rng(11)
    p0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [rng.normal(size=(64,)).astype(np.float32) * s
             for s in (1.0, 1e-6)]
    tx = optax.adam(1e-3)
    p, opt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    prm = torch.nn.Parameter(_t(p0))
    adam = torch.optim.Adam([prm], lr=1e-3)
    for g in grads:
        upd, opt = tx.update(jnp.asarray(g), opt, p)
        p = optax.apply_updates(p, upd)
        prm.grad = _t(g)
        adam.step()
        _close(prm, p, rtol=0, atol=1e-7)


def test_selfsup_infer_step_matches_jax():
    """make_selfsup_infer_step: the mono depth net of the self-supervised
    model in eval mode, from converted weights; the serving limit, 2e-5
    relative (the priors of the two preprocesses differ by ~3e-5,
    tests/test_torch_network.py)."""
    import types
    from polardepth_tpu import config as jconfig
    from polardepth_tpu.data.synthetic import SyntheticHammer
    cfg_kw = dict(height=H, width=W, depth_supervision_only=False)
    jcfg = jconfig.PUBLISHED.replace(**cfg_kw)
    jmodel = jselfsup.SelfSupModel.from_config(jcfg)
    v = jmodel.init(jax.random.PRNGKey(0),
                    jnp.zeros((1, 3, H, W, 3), jnp.float32),
                    pol=jnp.zeros((1, H, W, 4), jnp.float32))
    rng = np.random.default_rng(12)

    def redraw(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if path[-1].key == "mean" or (path[-1].key == "bias" and any(
                getattr(q, "key", "").startswith("BatchNorm") for q in path)):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return a

    v = jax.tree_util.tree_map_with_path(redraw, jax.device_get(v))
    batch = SyntheticHammer(H, W, seed=4).batch_frames(B, offset=2)
    ref = np.asarray(jax.jit(lambda p, s, b: jselfsup.make_selfsup_infer_step(
        jmodel, jcfg)(types.SimpleNamespace(params=p, batch_stats=s), b))(
            v["params"], v["batch_stats"],
            {k: jnp.asarray(x) for k, x in batch.items()}))
    tcfg = config.PUBLISHED.replace(**cfg_kw)
    model = selfsup.SelfSupModel.from_config(tcfg)
    model.load_state_dict(state_dict_from_jax(v["params"], v["batch_stats"]))
    got = selfsup.make_selfsup_infer_step(model, tcfg)(batch).numpy()
    assert got.shape == ref.shape == (B, H, W, 1) and ref.std() > 1e-4
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=0)
