"""Weight bridge between the JAX package's parameter trees and the port.

A JAX tree is what ``jax.device_get(state.params)`` and
``jax.device_get(state.batch_stats)`` give: nested dicts of numpy arrays keyed
by flax module names.  The port's modules carry the same names, so a flax path
becomes a ``state_dict`` key by joining it with dots; conv kernels go from
HWIO to OIHW, ``Dense`` kernels (in, out) to ``nn.Linear``'s (out, in),
BatchNorm's and LayerNorm's ``scale`` becomes ``weight``, a ``gamma`` leaf
(the attention's gates) keeps its name, and the statistics ``mean``/``var``
become ``running_mean``/``running_var``.

The trees of the self-supervised model (train/selfsup.py:SelfSupModel) hold
the depth net under ``mono`` and the pose net under ``pose_net`` (its
``pose_encoder`` and ``pose``), and convert the same way.  So do those of
the teacher-student model (train/student.py:StudentModel): the
self-supervised model under ``teacher``, the cost-volume encoder under
``encoder`` (its flax auto-names ``_FeatureExtractor_0``, ``TorchConv_0`` and
``BasicBlock_*``) and the student's decoder under ``depth``.

The two modality encoders come in two layouts: the reference's
``xolp_encoder`` + ``normals_encoder`` (what the JAX package's component
exports hold, train/checkpoint.py:121 export_components) and the
``fused_encoders`` stack.  Either converts to either.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from polardepth_tpu_torch.models.pre_encoders import (
    fuse_modality_params, split_modality_params)

_MODALITIES = ("xolp_encoder", "normals_encoder")


def to_layout(tree: dict, fused_encoders: bool) -> dict:
    """A params or batch_stats tree in the requested encoder layout.  A tree
    that holds neither both modality encoders nor the fused stack is
    returned as it is.  A self-supervised model's tree (``mono`` beside
    ``pose_net``) has its depth net converted, and a teacher-student
    model's its teacher."""
    tree = dict(tree)
    if "teacher" in tree:
        tree["teacher"] = to_layout(tree["teacher"], fused_encoders)
        return tree
    if "mono" in tree:
        tree["mono"] = to_layout(tree["mono"], fused_encoders)
        return tree
    if fused_encoders and all(m in tree for m in _MODALITIES):
        tree["fused_encoders"] = fuse_modality_params(
            tree.pop("xolp_encoder"),
            tree.pop("normals_encoder")["ShallowEncoder_0"])
    elif not fused_encoders and "fused_encoders" in tree:
        xolp, normals = split_modality_params(tree.pop("fused_encoders"))
        tree["xolp_encoder"] = xolp
        tree["normals_encoder"] = {"ShallowEncoder_0": normals}
    return tree


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


_PARAM_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "gamma": "gamma"}
# flax kernel layout -> torch weight layout, by the kernel's rank: conv
# HWIO -> OIHW, Dense (in, out) -> Linear (out, in)
_TO_TORCH = {4: (3, 2, 0, 1), 2: (1, 0)}
_TO_FLAX = {4: (2, 3, 1, 0), 2: (1, 0)}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def state_dict_from_jax(params: dict, batch_stats: dict,
                        fused_encoders: bool = True) -> dict:
    """JAX params + batch_stats -> the port's ``state_dict``, with the
    modality encoders in the layout of a model built with
    ``fused_encoders``."""
    sd = {}
    for path, leaf in _leaves(to_layout(params, fused_encoders)):
        if path[-1] not in _PARAM_NAMES:
            raise KeyError(f"unknown parameter {'/'.join(path)}")
        if path[-1] == "kernel":
            leaf = leaf.transpose(_TO_TORCH[leaf.ndim])
        key = ".".join(path[:-1] + (_PARAM_NAMES[path[-1]],))
        sd[key] = torch.from_numpy(np.array(leaf, np.float32))
    for path, leaf in _leaves(to_layout(batch_stats, fused_encoders)):
        if path[-1] not in _STAT_NAMES:
            raise KeyError(f"unknown statistic {'/'.join(path)}")
        module = ".".join(path[:-1])
        sd[f"{module}.{_STAT_NAMES[path[-1]]}"] = torch.from_numpy(
            np.array(leaf, np.float32))
        sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return sd


def jax_from_state_dict(state_dict: dict, fused_encoders: bool = False):
    """The inverse: a ``state_dict`` -> (params, batch_stats) numpy trees in
    the JAX layout, with the modality encoders fused or in the reference's
    split."""
    params, stats = {}, {}
    for key, value in state_dict.items():
        *path, name = key.split(".")
        arr = value.detach().cpu().numpy()
        if name == "num_batches_tracked":
            continue
        if name in ("running_mean", "running_var"):
            dst, leaf = stats, name[len("running_"):]
        elif name == "weight" and arr.ndim in _TO_FLAX:
            dst, leaf, arr = params, "kernel", arr.transpose(_TO_FLAX[arr.ndim])
        elif name == "weight":
            dst, leaf = params, "scale"
        elif name in ("bias", "gamma"):
            dst, leaf = params, name
        else:
            raise KeyError(f"unknown state_dict entry {key}")
        for p in path:
            dst = dst.setdefault(p, {})
        dst[leaf] = np.ascontiguousarray(arr)
    return (to_layout(params, fused_encoders),
            to_layout(stats, fused_encoders))


def load_components(directory, fused_encoders: bool = True) -> dict:
    """Read the per-component ``.npz`` files of the JAX package's
    export_components (``rgb_encoder``, ``xolp_encoder``,
    ``normals_encoder``, ``joint_encoder``, ``mono_depth``; statistics under
    ``stats/``) -> the port's ``state_dict``.

    A fused model needs both modality encoders: with only one of them on
    disk this raises, instead of leaving the other one random.
    """
    files = {p.stem: p for p in sorted(Path(directory).glob("*.npz"))}
    present = [m for m in _MODALITIES if m in files]
    if fused_encoders and len(present) == 1:
        missing = next(m for m in _MODALITIES if m not in files)
        raise FileNotFoundError(
            f"{directory} holds {present[0]}.npz but not {missing}.npz: a "
            "fused-encoder model needs both modality encoders")
    params, stats = {}, {}
    for component, path in files.items():
        with np.load(path) as raw:
            for key in raw.files:
                parts = key.split("/")
                if parts[0] == "stats":
                    dst, parts = stats.setdefault(component, {}), parts[1:]
                else:
                    dst = params.setdefault(component, {})
                for p in parts[:-1]:
                    dst = dst.setdefault(p, {})
                dst[parts[-1]] = raw[key]
    return state_dict_from_jax(params, stats, fused_encoders)
