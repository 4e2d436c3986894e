"""The port's modules against the JAX package's, module by module.

Parameters come from flax ``init`` with a seed, with the BatchNorm affine
and running statistics redrawn with numpy so that eval-mode BN is no identity,
and cross to the port through ``state_dict_from_jax``.  Inputs are float32
numpy arrays (tests/conftest.py turns x64 on, so float64 would run JAX in
float64).  Both sides run float32 convolutions on the CPU; the limits allow
for the sums being taken in another order.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from polardepth_tpu.models import depth_decoder as jdec  # noqa: E402
from polardepth_tpu.models import pre_encoders as jpre  # noqa: E402
from polardepth_tpu.models import resnet as jres  # noqa: E402
from polardepth_tpu.config import PUBLISHED as J_PUBLISHED  # noqa: E402
from polardepth_tpu.ops import depth as jdepth  # noqa: E402
from polardepth_tpu.ops import fresnel as jfresnel  # noqa: E402
from polardepth_tpu.ops import resize as jresize  # noqa: E402
from polardepth_tpu.train import losses as jlosses  # noqa: E402

from polardepth_tpu_torch.config import PUBLISHED  # noqa: E402
from polardepth_tpu_torch.models import depth_decoder  # noqa: E402
from polardepth_tpu_torch.models import pre_encoders  # noqa: E402
from polardepth_tpu_torch.models import resnet  # noqa: E402
from polardepth_tpu_torch.models.convert import state_dict_from_jax  # noqa: E402
from polardepth_tpu_torch.ops import depth, resize  # noqa: E402
from polardepth_tpu_torch.train import losses  # noqa: E402

B, H, W = 2, 64, 96
# float32 conv stacks of up to ~20 layers, summed in other orders
FEAT_TOL = dict(rtol=1e-4, atol=1e-5)


def _f32(rng, shape, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _init(module, seed, *inputs, **kw):
    """flax init on jnp inputs, then numpy draws for BN scale/bias and
    statistics."""
    v = module.init(jax.random.PRNGKey(seed), *inputs, **kw)
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
    return v["params"], v.get("batch_stats", {})


def _port(module, params, stats, fused=False):
    module.load_state_dict(state_dict_from_jax(params, stats, fused))
    return module.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def test_shallow_resnet18_stem():
    x = _f32(np.random.default_rng(0), (B, H, W, 3))
    jm = jres.ShallowResNet18Stem()
    params, stats = _init(jm, 0, x)
    ref = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    got = _port(resnet.ShallowResNet18Stem(3), params, stats)(_nchw(x))
    assert [tuple(g.shape) for g in got] == [
        (B, 64, H // 2, W // 2), (B, 64, H // 4, W // 4),
        (B, 128, H // 8, W // 8)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **FEAT_TOL)


@pytest.fixture(scope="module")
def modality_inputs():
    rng = np.random.default_rng(1)
    xolp = np.stack([_f32(rng, (B, H, W), 0, 0.9),
                     _f32(rng, (B, H, W), -1.5, 1.5)], axis=-1)
    priors = np.asarray(jfresnel.normal_priors_from_xolp(
        jnp.asarray(xolp), 1.5, method="exact")).astype(np.float32)
    return xolp, priors


def test_fused_modality_encoders_dense_plan(modality_inputs):
    """The JAX package's default "dense" plan against the port's groups=2
    convs: the same parameters and the same function."""
    xolp, priors = modality_inputs
    jm = jpre.FusedModalityEncoders(plan="dense")
    params, stats = _init(jm, 2, xolp, priors=jnp.asarray(priors))
    ref = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(xolp), priors=jnp.asarray(priors))
    pm = _port(pre_encoders.FusedModalityEncoders(), params, stats)
    got = pm(torch.from_numpy(xolp), torch.from_numpy(priors))
    assert tuple(got.shape) == (B, 128, H // 8, W // 8)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **FEAT_TOL)


def test_separate_encoders_and_fusion(modality_inputs):
    """The reference-shaped XOLP and normals encoders, and the fused stack
    loaded from their converted parameters, give one function."""
    xolp, priors = modality_inputs
    jx, jn = jpre.ShallowEncoder("XOLP"), jpre.ShallowNormalsEncoder()
    px, sx = _init(jx, 3, xolp)
    pn, sn = _init(jn, 4, xolp, priors=jnp.asarray(priors))
    ref_x = jx.apply({"params": px, "batch_stats": sx}, jnp.asarray(xolp))
    ref_n = jn.apply({"params": pn, "batch_stats": sn}, jnp.asarray(xolp),
                     priors=jnp.asarray(priors))
    got_x = _port(pre_encoders.ShallowEncoder(2, "XOLP"), px, sx)(
        _nchw(xolp))
    got_n = _port(pre_encoders.ShallowNormalsEncoder(), pn, sn)(
        torch.from_numpy(priors))
    np.testing.assert_allclose(_nhwc(got_x), np.asarray(ref_x), **FEAT_TOL)
    np.testing.assert_allclose(_nhwc(got_n), np.asarray(ref_n), **FEAT_TOL)
    fused = _port(pre_encoders.FusedModalityEncoders(),
                  pre_encoders.fuse_modality_params(px, pn["ShallowEncoder_0"]),
                  pre_encoders.fuse_modality_params(sx, sn["ShallowEncoder_0"]))
    got = fused(torch.from_numpy(xolp), torch.from_numpy(priors))
    np.testing.assert_allclose(
        _nhwc(got), np.concatenate([ref_x, ref_n], axis=-1), **FEAT_TOL)


def test_fuse_and_split_are_the_jax_packages(modality_inputs):
    xolp, priors = modality_inputs
    fused, _ = _init(jpre.FusedModalityEncoders(), 5, xolp,
                     priors=jnp.asarray(priors))
    ours = pre_encoders.split_modality_params(fused)
    ref = jpre.split_modality_params(fused)
    for a, b in zip(ours, ref):
        jax.tree_util.tree_map(np.testing.assert_array_equal, a, b)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           pre_encoders.fuse_modality_params(*ours),
                           jpre.fuse_modality_params(*ref))


def test_joint_encoder():
    rng = np.random.default_rng(6)
    feats = [_f32(rng, (B, H // 8, W // 8, c), -1, 1) for c in (128, 64, 64)]
    jm = jpre.JointEncoder(0.1)
    params, stats = _init(jm, 6, *feats)
    ref = jm.apply({"params": params, "batch_stats": stats},
                   *map(jnp.asarray, feats))
    pm = _port(pre_encoders.JointEncoder(256, 0.1), params, stats)
    got = pm(*map(_nchw, feats))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), **FEAT_TOL)


def test_depth_decoder_against_phase_packed():
    """The JAX package's phase-packed plan (its default) against the port's
    unpacked decoder, every scale."""
    rng = np.random.default_rng(7)
    feats = [_f32(rng, (B, H // 2 ** (k + 1), W // 2 ** (k + 1), c), -1, 1)
             for k, c in enumerate(depth_decoder.NUM_CH_ENC)]
    # both plans hold one parameter tree; the unpacked one initialises fast
    params, _ = _init(jdec.DepthDecoder(), 7, [jnp.asarray(f) for f in feats])
    jm = jdec.DepthDecoder(phase_packed=True)
    ref = jax.jit(jm.apply)({"params": params},
                            [jnp.asarray(f) for f in feats])
    pm = _port(depth_decoder.DepthDecoder(), params, {})
    got = pm([_nchw(f) for f in feats])
    assert set(got) == set(ref) == {("disp", s) for s in range(4)}
    for key in ref:
        r = np.asarray(ref[key])
        assert r.std() > 1e-3
        np.testing.assert_allclose(_nhwc(got[key]), r, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("in_out", [(80, 64), (120, 96), (97, 31), (32, 48),
                                    (64, 64)])
def test_antialias_weights_are_jax_images(in_out):
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat
    n_in, n_out = in_out
    ref = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                        _fill_triangle_kernel, True))
    np.testing.assert_allclose(resize.antialias_weights(n_in, n_out), ref.T,
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("hw", [(64, 96), (40, 50), (128, 96)])
def test_resizes_match_jax(hw):
    x = _f32(np.random.default_rng(8), (B, 80, 120, 3))
    got = resize.resize_antialias(torch.from_numpy(x), hw).numpy()
    ref = np.asarray(jresize.resize_antialias(jnp.asarray(x), hw))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    for align in (False, True):
        # torch computes the source coordinate in float32, as the reference
        # did; the JAX package builds its weights in float64 and sums them
        # with a float32 einsum: ~7e-6 apart on values in [0, 1]
        got = resize.resize_bilinear(torch.from_numpy(x), hw, align).numpy()
        ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), hw, align))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    m = np.random.default_rng(9).integers(0, 5, (B, 80, 120, 1), np.uint8)
    got = resize.resize_nearest(torch.from_numpy(m), hw).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jresize.resize_nearest(jnp.asarray(m), hw)))


def test_upsample2x_and_disp_to_depth():
    x = _f32(np.random.default_rng(10), (B, 5, 7, 3))
    np.testing.assert_allclose(
        resize.upsample2x(torch.from_numpy(x)).numpy(),
        np.asarray(jresize.upsample2x(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    for got, ref in zip(depth.disp_to_depth(torch.from_numpy(x), 0.1, 2.0),
                        jdepth.disp_to_depth(jnp.asarray(x), 0.1, 2.0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_preprocess_batch_and_twelve_channels():
    rng = np.random.default_rng(11)
    batch = {"color": rng.integers(0, 256, (B, 80, 120, 3), np.uint8),
             "pol": rng.integers(0, 256, (B, 80, 120, 4), np.uint8),
             "depth_gt": _f32(rng, (B, 80, 120, 1), 0.1, 2.0),
             "mask": rng.integers(0, 3, (B, 80, 120, 1), np.uint8)}
    cfg = PUBLISHED.replace(height=H, width=W)
    got = losses.preprocess_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    ref = jlosses.preprocess_batch(
        {k: jnp.asarray(v) for k, v in batch.items()},
        J_PUBLISHED.replace(height=H, width=W))
    for k in batch:
        assert got[k].shape == ref[k].shape == (B, H, W, batch[k].shape[-1])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5)
    pol = got["pol"]
    np.testing.assert_allclose(
        losses.twelve_channel_input(pol).numpy(),
        np.asarray(jlosses.twelve_channel_input(jnp.asarray(pol.numpy()))),
        rtol=1e-7)
