"""Import reference-trained per-component checkpoints (weights_<epoch>/*.pth).

A torch copy of polardepth_tpu/models/reference_import.py:43-209.  The
reference's deliverable is a set of per-component torch state_dicts,
rgb_encoder / xolp_encoder / normals_encoder / joint_encoder / mono_depth
(reference manydepth/trainer.py:1597-1617 save format; loaded per component
in evaluation.py:290-311).  This module maps them onto PolarDepthNet's
``state_dict``.  torch reads a ``.pth`` itself, with
``torch.load(weights_only=True)``, so the JAX package's torch-free reader
(polardepth_tpu/utils/torch_pth.py) has no counterpart here.

Each component becomes a JAX-layout tree (flax paths, HWIO kernels), as the
JAX package's converters build it, and goes to the port's keys through
models/convert.py:state_dict_from_jax, which fuses the two modality encoders
for a fused-encoder model.  Key correspondences (torch module tree -> flax
names, reference_import.py:12-32):

  ShallowEncoder (pre_encoders.py:49-83)      ShallowEncoder
    Conv1 / Conv2 / Conv3                       ConvBNReLUDrop_{0,1,2}
    ResBlock{1,2,3}.conv{1,2}                   ResidualBlock_{0,1,2}.
                                                ConvBNReLUDrop_{0,1}
    <blk>.conv.{weight,bias}, <blk>.bn.*        TorchConv_0/Conv_0,
                                                BatchNorm_0

  JointEncoder (pre_encoders.py:116-164)      JointEncoder
    fc1, fc2, Conv1, Conv2                      ConvBNReLUDrop_{0,1,2,3}
    ResBlock{1..6}                              ResidualBlock_{0..5}

  DepthDecoder (depth_decoder.py:15-75)       DepthDecoder
    decoder.{0..9}   = upconv (4,0)..(0,1)      ConvBlockELU_{0..9}.
                       (.conv.conv.{w,b})        ReflectConv_0/Conv_0
    decoder.{10+k}   = dispconv scale k         ReflectConv_j/Conv_0 where
                       (.conv.{w,b})             j indexes scales DESCENDING

  ShallowResnetEncoder (resnet_encoder.py:783-822): 'encoder.' prefix
  stripped, then the torchvision ResNet18 names of
  train/pretrained.py:torchvision_resnet18_tree (shallow).

Unlike the JAX function, a fused-encoder model that finds only one of
xolp_encoder.pth / normals_encoder.pth raises, instead of leaving both
modality encoders random.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from polardepth_tpu_torch.models.convert import state_dict_from_jax
from polardepth_tpu_torch.train.pretrained import torchvision_resnet18_tree

COMPONENTS = ("rgb_encoder", "xolp_encoder", "normals_encoder",
              "joint_encoder", "mono_depth")
_MODALITIES = ("xolp_encoder", "normals_encoder")


def _hwio(w: np.ndarray) -> np.ndarray:
    """torch OIHW conv kernel -> flax HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def _convblock(sd: dict, prefix: str):
    """Reference pre-encoder ConvBlock (conv + bn) -> ConvBNReLUDrop."""
    conv = {"kernel": _hwio(sd[f"{prefix}.conv.weight"]),
            "bias": sd[f"{prefix}.conv.bias"]}
    p = {"TorchConv_0": {"Conv_0": conv},
         "BatchNorm_0": {"scale": sd[f"{prefix}.bn.weight"],
                         "bias": sd[f"{prefix}.bn.bias"]}}
    s = {"BatchNorm_0": {"mean": sd[f"{prefix}.bn.running_mean"],
                         "var": sd[f"{prefix}.bn.running_var"]}}
    return p, s


def _resblock(sd: dict, prefix: str):
    p, s = {}, {}
    for i, conv in enumerate(("conv1", "conv2")):
        p[f"ConvBNReLUDrop_{i}"], s[f"ConvBNReLUDrop_{i}"] = _convblock(
            sd, f"{prefix}.{conv}")
    return p, s


def _blocks(sd: dict, pairs):
    p, s = {}, {}
    for ours, theirs in pairs:
        fn = _resblock if theirs.startswith("Res") else _convblock
        p[ours], s[ours] = fn(sd, theirs)
    return p, s


def convert_shallow_encoder(sd: dict):
    """xolp_encoder.pth / normals_encoder.pth -> (params, batch_stats) under
    ShallowEncoder's names."""
    return _blocks(sd, [
        ("ConvBNReLUDrop_0", "Conv1"), ("ResidualBlock_0", "ResBlock1"),
        ("ConvBNReLUDrop_1", "Conv2"), ("ResidualBlock_1", "ResBlock2"),
        ("ConvBNReLUDrop_2", "Conv3"), ("ResidualBlock_2", "ResBlock3")])


def convert_joint_encoder(sd: dict):
    return _blocks(sd, [
        ("ConvBNReLUDrop_0", "fc1"), ("ConvBNReLUDrop_1", "fc2"),
        ("ResidualBlock_0", "ResBlock1"), ("ResidualBlock_1", "ResBlock2"),
        ("ConvBNReLUDrop_2", "Conv1"),
        ("ResidualBlock_2", "ResBlock3"), ("ResidualBlock_3", "ResBlock4"),
        ("ConvBNReLUDrop_3", "Conv2"),
        ("ResidualBlock_4", "ResBlock5"), ("ResidualBlock_5", "ResBlock6")])


def convert_depth_decoder(sd: dict, scales=(0, 1, 2, 3)):
    """mono_depth.pth (the ModuleList flattening of the reference's convs
    OrderedDict) -> DepthDecoder params; the decoder has no BatchNorm."""
    p = {}
    for k in range(10):  # upconv (4,0),(4,1),(3,0),(3,1)...(0,0),(0,1)
        p[f"ConvBlockELU_{k}"] = {"ReflectConv_0": {"Conv_0": {
            "kernel": _hwio(sd[f"decoder.{k}.conv.conv.weight"]),
            "bias": sd[f"decoder.{k}.conv.conv.bias"]}}}
    # the heads: torch's list order is ascending scale (10 + position); the
    # ReflectConv_j order is descending
    for j, i in enumerate(sorted(scales, reverse=True)):
        t = 10 + list(scales).index(i)
        p[f"ReflectConv_{j}"] = {"Conv_0": {
            "kernel": _hwio(sd[f"decoder.{t}.conv.weight"]),
            "bias": sd[f"decoder.{t}.conv.bias"]}}
    return p, {}


def convert_rgb_encoder(sd: dict):
    """rgb_encoder.pth (ShallowResnetEncoder wrapping torchvision's resnet18
    under 'encoder.') -> ShallowResNet18Stem (params, batch_stats)."""
    stripped = {k[len("encoder."):]: v for k, v in sd.items()
                if k.startswith("encoder.")}
    return torchvision_resnet18_tree(stripped, shallow=True)


_CONVERTERS = {
    "rgb_encoder": convert_rgb_encoder,
    "xolp_encoder": convert_shallow_encoder,
    "normals_encoder": convert_shallow_encoder,
    "joint_encoder": convert_joint_encoder,
    "mono_depth": convert_depth_decoder,
}


def read_pth(path: str) -> dict:
    """The tensors of a reference .pth as float32 numpy arrays, read with
    ``torch.load(weights_only=True)``; other entries (the encoders' height
    and width) are dropped.  A file that weights_only refuses raises with
    the loader's reason."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        raise ValueError(f"{path}: torch.load(weights_only=True) refuses "
                         f"this file: {exc}") from exc
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds a {type(sd).__name__}, not a "
                         "state_dict")
    return {k: v.numpy().astype(np.float32) for k, v in sd.items()
            if isinstance(v, torch.Tensor)
            and not k.endswith("num_batches_tracked")}


def reference_state_dict(weights_dir: str, model_keys, fused: bool,
                         scales=(0, 1, 2, 3)) -> tuple[dict, list]:
    """The port's state_dict entries of every <component>.pth in weights_dir
    that the model (its ``state_dict`` keys, model_keys) has, and the names
    loaded.  Raises if a fused model finds one modality encoder alone."""
    present = {c for c in COMPONENTS
               if os.path.exists(os.path.join(weights_dir, f"{c}.pth"))}
    owners = {k.split(".")[0] for k in model_keys}
    if fused:
        found = [m for m in _MODALITIES if m in present]
        if len(found) == 1:
            missing = next(m for m in _MODALITIES if m not in present)
            raise FileNotFoundError(
                f"{weights_dir} holds {found[0]}.pth but not {missing}.pth:"
                " a fused-encoder model needs both modality encoders")
        if found:
            owners |= set(_MODALITIES)
    params, stats, loaded = {}, {}, []
    for name in COMPONENTS:
        if name not in present or name not in owners:
            continue
        sd = read_pth(os.path.join(weights_dir, f"{name}.pth"))
        if name == "mono_depth":
            p, s = convert_depth_decoder(sd, scales)
        else:
            p, s = _CONVERTERS[name](sd)
        if name == "normals_encoder":   # one level down in PolarDepthNet
            p, s = {"ShallowEncoder_0": p}, {"ShallowEncoder_0": s}
        params[name] = p
        if s:
            stats[name] = s
        loaded.append(name)
    return state_dict_from_jax(params, stats, fused), loaded


def load_reference_components(weights_dir: str, model: torch.nn.Module,
                              log=print) -> list:
    """Load every <component>.pth of weights_dir that the PolarDepthNet
    ``model`` has into it, in place; returns the names loaded.  Raises if
    nothing was found, if a fused model finds one modality encoder alone,
    or if a present component's shapes do not match the model.  A model
    component that no file supplies (always ``cross_modal_attention``: the
    reference saves none) keeps its values, and the log names it."""
    current = model.state_dict()
    fused = any(k.startswith("fused_encoders.") for k in current)
    sd, loaded = reference_state_dict(weights_dir, current, fused,
                                      tuple(sorted(model.mono_depth.heads)))
    if not loaded:
        raise FileNotFoundError(
            f"no reference component checkpoints found in {weights_dir} "
            f"(expected any of {', '.join(COMPONENTS)}.pth)")
    for key, value in sd.items():
        if key not in current or current[key].shape != value.shape:
            raise ValueError(
                f"{key.split('.')[0]}: checkpoint shapes do not match the "
                f"model graph at {key} (flag mismatch?)")
    model.load_state_dict({**current, **sd})
    kept = sorted({k.split(".")[0] for k in current}
                  - {k.split(".")[0] for k in sd})
    log(f"reference components loaded: {', '.join(loaded)}"
        + (f"; left at their initialisation: {', '.join(kept)}" if kept
           else ""))
    return loaded
