"""The port's import of reference-trained per-component .pth files
(models/reference_import.py) against the JAX package's
(polardepth_tpu/models/reference_import.py:load_reference_components).

The .pth files are written from torch modules with the reference's module
structure (pre_encoders.py ConvBlock/ResidualBlock/ShallowEncoder/
JointEncoder, depth_decoder.py, the torchvision resnet18 under 'encoder.'),
with random weights and random BatchNorm statistics: the port's copy of
tests/test_reference_import.py:32-240's oracles, without their forward
passes.  Both importers read the same files; the port's state_dict must be
exactly ``state_dict_from_jax`` of the JAX result, and the depth of the two
models must agree at DEPTH_RTOL (tests/test_torch_network.py: the JAX CPU
Fresnel LUT against the port's table, float32 convolutions in other
orders).  ``evaluate --reference_weights`` must print the table of
``evaluate --weights`` on the same weights within TABLE_RTOL (the same
function on the same frames; tests/test_torch_trainer_loop.py).
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn as tnn  # noqa: E402

from polardepth_tpu import config as jconfig  # noqa: E402
from polardepth_tpu.models.reference_import import (  # noqa: E402
    load_reference_components as jax_load_reference_components)
from polardepth_tpu.train import trainer as jtrainer  # noqa: E402

import chip_smoke  # noqa: E402
from polardepth_tpu_torch import cli, config  # noqa: E402
from polardepth_tpu_torch.models.convert import (  # noqa: E402
    jax_from_state_dict, state_dict_from_jax)
from polardepth_tpu_torch.models.reference_import import (  # noqa: E402
    COMPONENTS, load_reference_components)
from polardepth_tpu_torch.train import checkpoint  # noqa: E402
from polardepth_tpu_torch.train.trainer import (  # noqa: E402
    Trainer, build_model, make_infer_step)

B, H, W = 2, 64, 96
DEPTH_RTOL = 2e-5
TABLE_RTOL = 1e-5


# -- the reference's module structure (torch.nn only) -------------------------

class TConvBlock(tnn.Module):
    """pre_encoders.py ConvBlock: conv -> bn (-> relu -> [maxpool])."""

    def __init__(self, cin, cout, k, pad):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, k, padding=pad)
        self.bn = tnn.BatchNorm2d(cout)


class TResBlock(tnn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv1 = TConvBlock(ch, ch, 3, 1)
        self.conv2 = TConvBlock(ch, ch, 3, 1)


class TShallowEncoder(tnn.Module):
    def __init__(self, cin):
        super().__init__()
        self.Conv1 = TConvBlock(cin, 64, 7, 3)
        self.ResBlock1 = TResBlock(64)
        self.Conv2 = TConvBlock(64, 64, 5, 2)
        self.ResBlock2 = TResBlock(64)
        self.Conv3 = TConvBlock(64, 64, 5, 2)
        self.ResBlock3 = TResBlock(64)


class TJointEncoder(tnn.Module):
    def __init__(self, extra=128):
        super().__init__()
        self.fc1 = TConvBlock(128 + extra, 256, 1, 0)
        self.fc2 = TConvBlock(256, 128, 1, 0)
        self.ResBlock1 = TResBlock(128)
        self.ResBlock2 = TResBlock(128)
        self.Conv1 = TConvBlock(128, 256, 5, 2)
        self.ResBlock3 = TResBlock(256)
        self.ResBlock4 = TResBlock(256)
        self.Conv2 = TConvBlock(256, 512, 5, 2)
        self.ResBlock5 = TResBlock(512)
        self.ResBlock6 = TResBlock(512)


class TConv3x3(tnn.Module):
    """layers.py Conv3x3: reflection pad + 3x3 valid conv."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = tnn.Conv2d(cin, cout, 3)


class TDecoderBlock(tnn.Module):
    """layers.py ConvBlock: Conv3x3 + ELU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = TConv3x3(cin, cout)


class TDepthDecoder(tnn.Module):
    NUM_CH_DEC = (16, 32, 64, 128, 256)
    NUM_CH_ENC = (64, 64, 128, 256, 512)

    def __init__(self, scales=(0, 1, 2, 3)):
        super().__init__()
        mods = []
        for i in range(4, -1, -1):
            cin = self.NUM_CH_ENC[-1] if i == 4 else self.NUM_CH_DEC[i + 1]
            mods.append(TDecoderBlock(cin, self.NUM_CH_DEC[i]))
            cin = self.NUM_CH_DEC[i] + (self.NUM_CH_ENC[i - 1] if i > 0
                                        else 0)
            mods.append(TDecoderBlock(cin, self.NUM_CH_DEC[i]))
        for s in scales:
            mods.append(TConv3x3(self.NUM_CH_DEC[s], 1))
        self.decoder = tnn.ModuleList(mods)


class TBasicBlock(tnn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(cout)
        self.conv2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = tnn.BatchNorm2d(cout)
        if stride != 1 or cin != cout:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, cout, 1, stride, bias=False),
                tnn.BatchNorm2d(cout))


class TResNet18(tnn.Module):
    """torchvision-resnet18-shaped module (its state_dict keys)."""

    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        chans = [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
        for li, (cin, cout, stride) in enumerate(chans):
            setattr(self, f"layer{li + 1}", tnn.Sequential(
                TBasicBlock(cin, cout, stride), TBasicBlock(cout, cout, 1)))
        self.fc = tnn.Linear(512, 1000)


class TRgbEncoderWrapper(tnn.Module):
    """ShallowResnetEncoder's state_dict layout: all under 'encoder.'"""

    def __init__(self):
        super().__init__()
        self.encoder = TResNet18()


def _randomize(module, rng):
    """Random weights in torch's default ranges (kernels within
    1/sqrt(fan_in)), BatchNorm scales and variances in [0.5, 1.5], biases
    and means around 0: the depth then spans its range instead of
    saturating the sigmoid."""
    def draw(shape, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.weight.copy_(draw(m.weight.shape, 0.5, 1.5))
                m.running_var.copy_(draw(m.running_var.shape, 0.5, 1.5))
                for t in (m.bias, m.running_mean):
                    t.copy_(torch.from_numpy(
                        rng.normal(0, 0.1, t.shape).astype(np.float32)))
            elif isinstance(m, (tnn.Conv2d, tnn.Linear)):
                bound = 1.0 / np.sqrt(np.prod(m.weight.shape[1:]))
                m.weight.copy_(draw(m.weight.shape, -bound, bound))
                if m.bias is not None:
                    m.bias.copy_(torch.from_numpy(
                        rng.normal(0, 0.1, m.bias.shape).astype(np.float32)))


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """A reference weights_<epoch>/ directory; the encoders' .pth also hold
    the height and width ints that the reference saves beside the
    tensors."""
    d = tmp_path_factory.mktemp("weights_47")
    rng = np.random.default_rng(11)
    oracles = {"rgb_encoder": TRgbEncoderWrapper(),
               "xolp_encoder": TShallowEncoder(2),
               "normals_encoder": TShallowEncoder(9),
               "joint_encoder": TJointEncoder(),
               "mono_depth": TDepthDecoder()}
    for name, mod in oracles.items():
        _randomize(mod, rng)
        sd = mod.state_dict()
        if name == "rgb_encoder":
            sd.update(height=H, width=W, use_stereo=False)
        torch.save(sd, str(d / f"{name}.pth"))
    return d


def _jax_import(weights_dir, overrides):
    """(JAX config, model, params, batch_stats, loaded) with the reference
    weights grafted in by the JAX package.  The trees it grafts into are a
    port model's through the weight bridge, which spares the JAX model's
    initialisation."""
    jcfg = jconfig.PUBLISHED.replace(height=H, width=W, **overrides)
    cfg = config.PUBLISHED.replace(height=H, width=W, **overrides)
    both = cfg.augment_xolp and cfg.augment_normals
    params, stats = jax_from_state_dict(build_model(cfg).state_dict(),
                                        cfg.fused_encoders and both)
    params, stats, loaded = jax_load_reference_components(
        str(weights_dir), params, stats, log=lambda *_: None)
    return jcfg, jtrainer.build_model(jcfg), params, stats, loaded


def _port_import(weights_dir, overrides):
    cfg = config.PUBLISHED.replace(height=H, width=W, **overrides)
    model = build_model(cfg)
    loaded = load_reference_components(str(weights_dir), model,
                                       log=lambda *_: None)
    return cfg, model, loaded


@pytest.mark.parametrize("overrides", [{}, {"fused_encoders": False}],
                         ids=["fused", "separate"])
def test_state_dict_equals_the_jax_import(weights_dir, overrides):
    _, _, params, stats, jloaded = _jax_import(weights_dir, overrides)
    cfg, model, loaded = _port_import(weights_dir, overrides)
    assert set(loaded) == set(jloaded) == set(COMPONENTS)
    want = state_dict_from_jax(params, stats, cfg.fused_encoders)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_depth_agrees_with_the_jax_import(weights_dir):
    jcfg, jmodel, params, stats, _ = _jax_import(weights_dir, {})
    cfg, model, _ = _port_import(weights_dir, {})
    batch = chip_smoke.random_batch(np.random.default_rng(5), B, cfg)
    step = jtrainer.make_infer_step(jmodel, jcfg)
    ref = np.asarray(jax.jit(lambda p, s, b: step(
        types.SimpleNamespace(params=p, batch_stats=s), b))(
            params, stats, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = make_infer_step(model, cfg)(
        {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert got.shape == ref.shape == (B, H, W, 1)
    assert ref.std() > 1e-4
    np.testing.assert_allclose(got, ref, rtol=DEPTH_RTOL, atol=0)


def test_shape_mismatch_raises(weights_dir):
    """The RGB + normals graph's joint encoder is 128 + 64 wide; the file's
    is 128 + 128."""
    with pytest.raises(ValueError, match="shapes do not match"):
        _port_import(weights_dir, {"augment_xolp": False})


def test_nothing_found_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no reference component"):
        _port_import(tmp_path, {})


@pytest.mark.parametrize("missing", ["xolp_encoder", "normals_encoder"])
def test_half_pair_raises_where_the_jax_import_loads_the_rest(
        weights_dir, missing, tmp_path):
    """A fused model with one modality .pth: the JAX package skips both
    modality encoders silently and loads the rest (their weights stay
    random); the port raises."""
    for p in weights_dir.glob("*.pth"):
        if p.stem != missing:
            (tmp_path / p.name).write_bytes(p.read_bytes())
    *_, jloaded = _jax_import(tmp_path, {})
    assert set(jloaded) == {"rgb_encoder", "joint_encoder", "mono_depth"}
    with pytest.raises(FileNotFoundError, match=missing):
        _port_import(tmp_path, {})


def test_refuses_a_file_that_weights_only_refuses(weights_dir, tmp_path):
    for p in weights_dir.glob("*.pth"):
        (tmp_path / p.name).write_bytes(p.read_bytes())
    torch.save({"conv": types.SimpleNamespace(w=1)},
               str(tmp_path / "mono_depth.pth"))
    with pytest.raises(ValueError, match="weights_only"):
        _port_import(tmp_path, {})


def test_chip_smoke_writes_what_the_import_reads(weights_dir, tmp_path):
    """chip_smoke.py's inverse mapping (state_dict -> reference .pth files)
    writes the keys the reference's modules have, and the import reads the
    same weights back."""
    cfg, model, _ = _port_import(weights_dir, {})
    chip_smoke.write_reference_pth(model.state_dict(), cfg, str(tmp_path))
    for name in COMPONENTS:
        ref = torch.load(str(weights_dir / f"{name}.pth"), weights_only=True)
        mine = torch.load(str(tmp_path / f"{name}.pth"), weights_only=True)
        want = {k for k, v in ref.items() if isinstance(v, torch.Tensor)
                and not k.endswith("num_batches_tracked")
                and not k.startswith(("encoder.layer3", "encoder.layer4",
                                      "encoder.fc"))}
        assert set(mine) == want, name
    _, again, _ = _port_import(tmp_path, {})
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_evaluate_reference_weights_prints_the_weights_table(
        weights_dir, tmp_path, capsys):
    flags = ["--synthetic", "4", "--height", "32", "--width", "32",
             "--batch_size", "2", "--device", "cpu"]
    cfg = config.PUBLISHED.replace(height=32, width=32, batch_size=2)
    trainer = Trainer(cfg, steps_per_epoch=1, device="cpu",
                      log_fn=lambda *_: None)
    load_reference_components(str(weights_dir), trainer.model,
                              log=lambda *_: None)
    step_dir = checkpoint.save(str(tmp_path), trainer.state, cfg)
    _, by_ckpt = cli.evaluate([*flags, "--weights", step_dir])
    capsys.readouterr()
    _, by_ref = cli.evaluate([*flags, "--reference_weights",
                              str(weights_dir)])
    assert "reference components loaded" in capsys.readouterr().out
    assert by_ref["all"]["frames"] == 4
    for name, row in by_ckpt.items():
        for m, v in row.items():
            assert by_ref[name][m] == pytest.approx(v, rel=TABLE_RTOL,
                                                    abs=1e-7), (name, m)
