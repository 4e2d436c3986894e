"""Serving export: the whole preprocess + inference graph as one serialized
``torch.export`` program (polardepth_tpu/eval/export.py:30-101, where it is
a ``jax.export`` StableHLO artifact).

The program takes what ``Predictor.predict`` takes, uint8 captures in,
clamped metric depth out, and holds the weights.  Its batch dimension is a
``torch.export.Dim`` unless a batch is fixed, so one program serves any
batch size.  The polar preprocess is the registered operator
``polardepth_tpu::polar_preprocess`` (ops/polar_preprocess.py), one node of
the graph: on the card it launches csrc/polar_preprocess.cu.  So loading a
program needs that operator registered, which importing this module (or
``polardepth_tpu_torch.ops.polar_preprocess``) does.  ``load_module`` runs
the loaded program under the port's float32 (utils/precision.py), as
``Predictor`` runs the model.

  python -m polardepth_tpu_torch export --weights <step dir> --out model.pt2
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

# registers the operator that exported programs call
import polardepth_tpu_torch.ops.polar_preprocess  # noqa: F401
from polardepth_tpu_torch.config import Config
from polardepth_tpu_torch.train.losses import preprocess_batch
from polardepth_tpu_torch.train.trainer import (
    _forward_depth, build_model, takes_pol)
from polardepth_tpu_torch.utils.precision import float32


class DepthProgram(nn.Module):
    """color (b, H, W, 3, or 12 in the 12-channel mode) uint8 [+ pol
    (b, H, W, 4) uint8] -> depth (b, H, W, 1) in [min_depth, max_depth]:
    ``make_infer_step``'s function, without its inference mode."""

    def __init__(self, model: nn.Module, cfg: Config):
        super().__init__()
        self.model = model
        self.cfg = cfg

    def forward(self, color, pol=None):
        batch = {"color": color}
        if pol is not None:
            batch["pol"] = pol
        return _forward_depth(self.model, self.cfg,
                              preprocess_batch(batch, self.cfg))


@float32()
def make_export(cfg: Config, state_dict: dict, batch: int | None = None,
                device="cuda") -> torch.export.ExportedProgram:
    """Export cfg's model with the weights of state_dict on device.
    batch=None exports a symbolic batch dimension."""
    cfg.validate()
    device = torch.device(device)
    model = build_model(cfg)
    model.load_state_dict(state_dict)
    model.requires_grad_(False)     # a served program builds no graph
    program = DepthProgram(model.to(device).eval(), cfg).eval()
    n = batch or 2
    in_ch = 12 if cfg.enable_12channels else 3
    args = [torch.zeros(n, cfg.height, cfg.width, in_ch, dtype=torch.uint8,
                        device=device)]
    if takes_pol(cfg):
        args.append(torch.zeros(n, cfg.height, cfg.width, 4,
                                dtype=torch.uint8, device=device))
    dynamic = None
    if batch is None:
        # traced on the card, torch's CUDA kernels guard the batch at
        # 65535 (a grid's y and z limit)
        b = torch.export.Dim("b", max=65535)
        dynamic = tuple({0: b} for _ in args)
    with torch.no_grad():
        return torch.export.export(program, tuple(args),
                                   dynamic_shapes=dynamic)


def _specs(nodes) -> list:
    """'dtype[d0,d1,...]' of each node's value, symbolic sizes by name."""
    out = []
    for node in nodes:
        v = node.meta["val"]
        dtype = str(v.dtype).removeprefix("torch.")
        out.append(f"{dtype}[{','.join(str(d) for d in v.shape)}]")
    return out


def save_artifact(program: torch.export.ExportedProgram, path: str,
                  cfg: Config) -> None:
    """Write <path> (torch.export.save) and <path>.json, the metadata."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    graph = program.graph
    inputs = [n for n in graph.nodes if n.op == "placeholder"
              and n.name in program.graph_signature.user_inputs]
    outputs = list(graph.output_node().args[0])
    devices = sorted({n.meta["val"].device.type for n in inputs})
    meta = {
        "height": cfg.height, "width": cfg.width,
        "inputs": _specs(inputs), "output": _specs(outputs),
        "platforms": devices,
        "min_depth": cfg.min_depth, "max_depth": cfg.max_depth,
        "augment_xolp": cfg.augment_xolp,
        "augment_normals": cfg.augment_normals,
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)


def load_artifact(path: str) -> torch.export.ExportedProgram:
    """Load a saved program; ``load_module`` gives the module that serves
    it."""
    return torch.export.load(path)


class Float32Module(nn.Module):
    """A loaded program's module, each call under ``float32()``: the graph
    reads torch's TF32 flags when it runs, not when it was exported."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, *args):
        with float32():
            return self.module(*args)


def load_module(path: str) -> Float32Module:
    """Load a saved program as a module: ``load_module(path)(color, pol)``
    runs it on the device it was exported for, in float32."""
    return Float32Module(load_artifact(path).module())


def preprocess_nodes(program: torch.export.ExportedProgram) -> int:
    """How many calls of the polar-preprocess operator the graph holds."""
    op = torch.ops.polardepth_tpu.polar_preprocess.default
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function" and n.target is op)
