"""The port's ImageNet ResNet18 initialisation (train/pretrained.py) against
the JAX package's (polardepth_tpu/train/pretrained.py:apply_pretrained).

One seeded .npz under torchvision's resnet18 keys goes into a port model
and, through the weight bridge, into the same weights as JAX trees.  Both
graft structurally; the port's state_dict must then be exactly
``state_dict_from_jax`` of the JAX result, for the published model (the
shallow RGB encoder), the self-supervised model (the pose encoder's conv1
averaged over its two frames) and the teacher-student model (the cost
volume's feature extractor and layers 2-4 besides).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from polardepth_tpu.train.pretrained import (  # noqa: E402
    apply_pretrained as jax_apply_pretrained)

import chip_smoke  # noqa: E402
from polardepth_tpu_torch import cli, config  # noqa: E402
from polardepth_tpu_torch.models.convert import (  # noqa: E402
    jax_from_state_dict, state_dict_from_jax)
from polardepth_tpu_torch.train import selfsup, student  # noqa: E402
from polardepth_tpu_torch.train.loop import make_alt_trainer  # noqa: E402
from polardepth_tpu_torch.train.pretrained import (  # noqa: E402
    apply_pretrained)
from polardepth_tpu_torch.train.trainer import (  # noqa: E402
    Trainer, build_model)

H, W = 64, 96
CFG = config.PUBLISHED.replace(height=H, width=W)
SELFSUP = CFG.replace(depth_supervision_only=False)
STUDENT = SELFSUP.replace(train_student=True)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("imagenet") / "resnet18.npz")
    return path, chip_smoke.pretrained_npz(path, seed=3)


def _model(case):
    torch.manual_seed(0)
    if case == "published":
        return build_model(CFG)
    if case == "selfsup":
        return selfsup.SelfSupModel.from_config(SELFSUP)
    return student.StudentModel.from_config(STUDENT)


GRAFTED = {
    "published": ["rgb_encoder"],
    "selfsup": ["mono.rgb_encoder", "pose_net.pose_encoder"],
    "student": ["teacher.mono.rgb_encoder", "teacher.pose_net.pose_encoder",
                "encoder._FeatureExtractor_0", "encoder"],
}


@pytest.mark.parametrize("case", list(GRAFTED))
def test_graft_equals_the_jax_graft(npz, case):
    path, raw = npz
    model = _model(case)
    params, stats = jax_from_state_dict(model.state_dict(),
                                        fused_encoders=True)
    jp, js, jgrafted = jax_apply_pretrained(params, stats, path,
                                            log_fn=lambda *_: None)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grafted = apply_pretrained(model, path, log_fn=lambda *_: None)
    assert sorted(grafted) == sorted(GRAFTED[case])
    assert sorted(g.replace(":layers2-4", "").replace("/", ".")
                  for g in jgrafted) == sorted(GRAFTED[case])
    want = state_dict_from_jax(jp, js, fused_encoders=True)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    changed = [k for k in got if not torch.equal(got[k], before[k])]
    assert changed and all(k.startswith(tuple(GRAFTED[case]))
                           for k in changed)
    if case != "published":
        conv1 = got[f"{GRAFTED[case][1]}.Conv_0.weight"].numpy()
        w = raw["conv1.weight"]
        np.testing.assert_array_equal(
            conv1, np.concatenate([w, w], axis=1) / 2)


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="convert_torch_resnet18"):
        apply_pretrained(build_model(CFG), str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError, match="convert_torch_resnet18"):
        Trainer(CFG.replace(weights_init="pretrained"), 1, device="cpu")


def test_trainers_apply_weights_init(npz):
    path, raw = npz
    cfg = CFG.replace(weights_init="pretrained", pretrained_weights_path=path)
    t = Trainer(cfg, 1, device="cpu", log_fn=lambda *_: None)
    sd = t.model.state_dict()
    np.testing.assert_array_equal(sd["rgb_encoder.Conv_0.weight"].numpy(),
                                  raw["conv1.weight"])
    np.testing.assert_array_equal(
        sd["rgb_encoder.BasicBlock_2.BatchNorm_2.running_var"].numpy(),
        raw["layer2.0.downsample.1.running_var"])
    alt = make_alt_trainer(STUDENT.replace(
        weights_init="pretrained", pretrained_weights_path=path), 1,
        device="cpu", log_fn=lambda *_: None)
    sd = alt.state.model.state_dict()
    np.testing.assert_array_equal(
        sd["encoder.BasicBlock_5.Conv_1.weight"].numpy(),
        raw["layer4.1.conv2.weight"])
    with pytest.raises(ValueError, match="weights_init"):
        Trainer(CFG.replace(weights_init="imagenet"), 1, device="cpu")


def test_cli_takes_weights_init_pretrained(npz, tmp_path, capsys):
    path, _ = npz
    trainer, _ = cli.train([
        "--synthetic", "2", "--height", "32", "--width", "32",
        "--batch_size", "2", "--num_epochs", "1", "--device", "cpu",
        "--log_dir", str(tmp_path), "--weights_init", "pretrained",
        "--pretrained_weights_path", path])
    assert "pretrained ResNet18 grafted into: rgb_encoder" in \
        capsys.readouterr().out
    assert trainer.state.step == 1
