"""ImageNet-pretrained ResNet18 initialisation (--weights_init pretrained).

A torch copy of polardepth_tpu/train/pretrained.py:36-169 and of
polardepth_tpu/models/resnet.py:121-180 (load_torch_resnet18).  The
reference's accuracy table is built on ImageNet-pretrained torchvision
ResNet18 weights for the RGB encoder, the pose encoder (conv1 tiled over the
stacked frames and divided by their count, reference
manydepth/networks/resnet_encoder.py:46-54) and the cost-volume matching
encoder (resnet_encoder.py:343,374); the reference trainer selects this with
weights_init="pretrained" (trainer.py:176,193,217).

The weights come as the .npz of torchvision's state_dict that
scripts/convert_torch_resnet18.py writes.  ``apply_pretrained`` grafts them
by structure: every module that holds a ResNet18 stem (a 7x7 ``Conv_0`` of
64 outputs over 3k inputs, then ``BasicBlock_*``) or the cost-volume
encoder's layers 2-4 (six ``BasicBlock_*`` after a reduce conv, the first
64 -> 128) takes them, wherever it sits:

  * PolarDepthNet.rgb_encoder          (shallow: conv1 + layers 1-2)
  * PoseNet.pose_encoder               (full, conv1 averaged over 2 frames)
  * CostVolumeEncoder                  (stem and layer1 in the feature
                                        extractor, layers 2-4 after the
                                        reduce conv)
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from polardepth_tpu_torch.models.convert import state_dict_from_jax


def torchvision_resnet18_tree(raw, shallow: bool = False,
                              num_input_images: int = 1):
    """torchvision resnet18 state_dict entries (a {torch key: array} dict or
    an .npz path; OIHW kernels) -> (params, batch_stats) numpy trees under
    the flax names of ShallowResNet18Stem (shallow) or ResNet18Encoder.

    num_input_images > 1 widens conv1 for stacked frames by tiling it along
    the input channels and dividing by the frame count (the reference's
    multi-image init: cat([conv1_weight] * n, 1) / n)."""
    if isinstance(raw, (str, os.PathLike)):
        with np.load(raw) as f:
            raw = {k: f[k] for k in f.files}
    raw = {k: np.asarray(v, np.float32) for k, v in raw.items()}
    if num_input_images > 1:
        raw["conv1.weight"] = np.concatenate(
            [raw["conv1.weight"]] * num_input_images,
            axis=1) / num_input_images

    def conv(k):
        return np.transpose(raw[k], (2, 3, 1, 0))          # OIHW -> HWIO

    def bn(prefix):
        return ({"scale": raw[f"{prefix}.weight"],
                 "bias": raw[f"{prefix}.bias"]},
                {"mean": raw[f"{prefix}.running_mean"],
                 "var": raw[f"{prefix}.running_var"]})

    params = {"Conv_0": {"kernel": conv("conv1.weight")}}
    stats = {}
    params["BatchNorm_0"], stats["BatchNorm_0"] = bn("bn1")
    layers = [("layer1", False), ("layer2", True)]
    if not shallow:
        layers += [("layer3", True), ("layer4", True)]
    block_i = 0
    for layer, first_downsamples in layers:
        for b in range(2):
            name = f"BasicBlock_{block_i}"
            block_i += 1
            p = {"Conv_0": {"kernel": conv(f"{layer}.{b}.conv1.weight")}}
            s = {}
            p["BatchNorm_0"], s["BatchNorm_0"] = bn(f"{layer}.{b}.bn1")
            p["Conv_1"] = {"kernel": conv(f"{layer}.{b}.conv2.weight")}
            p["BatchNorm_1"], s["BatchNorm_1"] = bn(f"{layer}.{b}.bn2")
            if b == 0 and first_downsamples:
                p["Conv_2"] = {"kernel": conv(
                    f"{layer}.{b}.downsample.0.weight")}
                p["BatchNorm_2"], s["BatchNorm_2"] = bn(
                    f"{layer}.{b}.downsample.1")
            params[name] = p
            stats[name] = s
    return params, stats


def _n_blocks(module: nn.Module) -> int:
    return sum(1 for name, _ in module.named_children()
               if name.startswith("BasicBlock_"))


def _stem_images(module: nn.Module) -> int:
    """The frames a ResNet18 stem module takes (0: not a stem)."""
    conv = getattr(module, "Conv_0", None)
    if not isinstance(conv, nn.Conv2d) or not hasattr(module, "BasicBlock_0"):
        return 0
    if conv.kernel_size != (7, 7) or conv.out_channels != 64 \
            or conv.in_channels % 3:
        return 0
    return conv.in_channels // 3


def _is_trunk(module: nn.Module) -> bool:
    """Layers 2-4 of the cost-volume encoder: six BasicBlocks, the first
    64 -> 128 channels, and no stem conv."""
    if hasattr(module, "Conv_0") or _n_blocks(module) != 6:
        return False
    first = getattr(module.BasicBlock_0, "Conv_0", None)
    return isinstance(first, nn.Conv2d) and first.in_channels == 64 \
        and first.out_channels == 128


def _source(module: nn.Module, raw: dict, full):
    """The (params, batch_stats) trees a recognised module takes, or
    None."""
    n_img = _stem_images(module)
    if n_img:
        blocks = _n_blocks(module)
        if blocks in (4, 8):         # shallow stem / full encoder
            return torchvision_resnet18_tree(raw, shallow=blocks == 4,
                                             num_input_images=n_img)
        if blocks == 2:              # the cost volume's feature extractor
            keep = ("Conv_0", "BatchNorm_0", "BasicBlock_0", "BasicBlock_1")
            return ({k: full[0][k] for k in keep},
                    {k: full[1][k] for k in keep if k in full[1]})
        return None
    if _is_trunk(module):            # layers 2-4, renumbered from 0
        return ({f"BasicBlock_{i}": full[0][f"BasicBlock_{i + 2}"]
                 for i in range(6)},
                {f"BasicBlock_{i}": full[1][f"BasicBlock_{i + 2}"]
                 for i in range(6)})
    return None


def apply_pretrained(model: nn.Module, npz_path: str, log_fn=print) -> list:
    """Graft the converted torchvision ResNet18 weights into every
    recognised encoder of model, in place; a module whose shapes differ is
    left as it is.  Returns the grafted module paths; raises if the npz is
    missing or nothing matched."""
    if not npz_path or not os.path.exists(npz_path):
        raise FileNotFoundError(
            "weights_init='pretrained' needs a converted torchvision "
            f"ResNet18 .npz (got pretrained_weights_path={npz_path!r}); "
            "generate it offline with scripts/convert_torch_resnet18.py "
            "on a machine that has torchvision.")
    with np.load(npz_path) as f:
        raw = {k: f[k] for k in f.files}
    full = torchvision_resnet18_tree(raw)
    grafted = []
    for path, module in model.named_modules():
        src = _source(module, raw, full)
        if src is None:
            continue
        new = {k: v for k, v in state_dict_from_jax(*src).items()
               if not k.endswith("num_batches_tracked")}
        current = module.state_dict()
        if any(k not in current or current[k].shape != v.shape
               for k, v in new.items()):
            continue
        with torch.no_grad():
            for k, v in new.items():
                current[k].copy_(v)
        grafted.append(path or "<root>")
    if not grafted:
        raise ValueError(
            "weights_init='pretrained': no ResNet18 encoder found in the "
            "model to graft the ImageNet weights into.")
    log_fn(f"pretrained ResNet18 grafted into: {', '.join(grafted)}")
    return grafted


def maybe_apply_pretrained(model: nn.Module, cfg, log_fn=print) -> list:
    """With cfg.weights_init == 'pretrained', graft the ImageNet encoder
    weights of cfg.pretrained_weights_path into model; returns the grafted
    paths (none otherwise)."""
    if cfg.weights_init != "pretrained":
        return []
    return apply_pretrained(model, cfg.pretrained_weights_path, log_fn)
