"""Checkpoints: the whole train state at any step, and per-component exports
(polardepth_tpu/train/checkpoint.py).

``save`` writes directory/step_<N>/state.pt with torch.save: the model's
state dict (parameters and BatchNorm statistics), Adam's, the schedule's,
the step and an optional ``extra`` tree of plain values (the data
iterator's position), and directory/config.json beside it.  ``restore``
loads one into a live TrainState.

``export_components`` / ``import_components`` write and read the
reference-shaped per-component .npz files of the JAX package
(rgb_encoder, xolp_encoder, normals_encoder, joint_encoder, mono_depth;
keys are flax paths joined by "/", BatchNorm statistics under "stats/").
A fused-encoder model exports the same two modality files as a
separate-encoder one, so the files cross between the two packages and
between encoder layouts.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from polardepth_tpu_torch.config import Config
from polardepth_tpu_torch.models.convert import (
    jax_from_state_dict, load_components)
from polardepth_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


def save(directory: str, state: TrainState, cfg: Optional[Config] = None,
         step: Optional[int] = None, extra=None) -> str:
    """Write the full train state under directory/step_<N>; returns that
    directory."""
    step = state.step if step is None else step
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    tree = {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": int(state.step), "extra": extra}
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if cfg is not None:
        with open(os.path.join(directory, "config.json"), "w") as f:
            f.write(cfg.to_json())
    return path


def restore(path: str, state: TrainState, extra=None):
    """Load a checkpoint directory into state, in place.  The tensors are
    read to the host and copied into the model's and Adam's tensors on
    their devices (Adam's step counts stay on the host, as a live Adam's
    do).  With an ``extra`` template, returns (state, extra) with the
    checkpoint's extra, or the template where the checkpoint has none;
    else returns state."""
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    state.scheduler.load_state_dict(tree["scheduler"])
    state.step = int(tree["step"])
    if extra is None:
        return state
    if tree["extra"] is None:
        print(f"checkpoint {path} has no 'extra' tree; exact data-order "
              "resume unavailable, using template values")
        return state, extra
    return state, tree["extra"]


def latest_step_dir(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_"):
            try:
                steps.append((int(d.split("_", 1)[1]), d))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(directory, max(steps)[1])


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def export_components(directory: str, state: TrainState) -> list[str]:
    """One .npz per reference component of state's model, in the JAX
    package's layout (polardepth_tpu/train/checkpoint.py:121-145)."""
    os.makedirs(directory, exist_ok=True)
    params, stats = jax_from_state_dict(state.model.state_dict(),
                                        fused_encoders=False)
    written = []
    for component, tree in params.items():
        arrays = dict(_flatten(tree))
        arrays.update({f"stats/{k}": v
                       for k, v in _flatten(stats.get(component, {}))})
        out = os.path.join(directory, f"{component}.npz")
        np.savez(out, **arrays)
        written.append(out)
    return written


def import_components(directory: str, state: TrainState) -> TrainState:
    """Load the .npz components in directory into state's model, in place.
    Every entry must name a tensor of the model with the same shape;
    components not on disk keep their values.  A fused-encoder model needs
    both modality files or neither (models/convert.py:load_components)."""
    model = state.model
    fused = any(k.startswith("fused_encoders.")
                for k in model.state_dict())
    loaded = load_components(directory, fused_encoders=fused)
    current = model.state_dict()
    update = {}
    for key, value in loaded.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key not in current:
            raise KeyError(f"{Path(directory)}: {key} is not in the model")
        if tuple(value.shape) != tuple(current[key].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} on disk, "
                             f"{tuple(current[key].shape)} in the model")
        update[key] = value
    model.load_state_dict({**current, **update})
    return state
