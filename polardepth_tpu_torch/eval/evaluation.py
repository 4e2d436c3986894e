"""Per-material depth evaluation (polardepth_tpu/eval/evaluation.py;
reference manydepth/evaluation.py:120-288).

  * pred = clamp(disp_to_depth(disp_0) inverted, min_depth, max_depth)
  * valid mask: min_depth < depth_gt < max_depth (strict)
  * material slice: instance id in [thres1, thres2]; ids are box=20,
    bottle=40, can=60, cup=80, remote=100, teapot=120, cutlery=140,
    glass=160, table=180, wall=200, objects=[20, 160]
  * metrics per frame, then averaged over the frames whose slice is not
    empty; no median scaling (supervised evaluation)

The 12 slices of a batch are one batched reduction over (H, W, 1) per frame
and slice.  The accumulator is a tree of 0-d float32 tensors on the model's
device, so that a whole evaluation needs one host fetch at its end.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from polardepth_tpu_torch.ops.metrics import compute_depth_errors

MATERIAL_THRESHOLDS = {
    "all": None,
    "objects": (20, 160),
    "box": (20, 20), "bottle": (40, 40), "can": (60, 60), "cup": (80, 80),
    "remote": (100, 100), "teapot": (120, 120), "cutlery": (140, 140),
    "glass": (160, 160), "table": (180, 180), "wall": (200, 200),
}

METRIC_ORDER = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
_ACC_KEYS = METRIC_ORDER + ("frames",)


def slice_masks(depth_gt: torch.Tensor, instance_mask: torch.Tensor,
                min_depth: float, max_depth: float) -> torch.Tensor:
    """(S, B, H, W, 1) boolean masks of the S = 12 slices, in
    MATERIAL_THRESHOLDS order."""
    valid = (depth_gt > min_depth) & (depth_gt < max_depth)
    masks = []
    for thr in MATERIAL_THRESHOLDS.values():
        if thr is None:
            masks.append(valid)
        else:
            masks.append(valid & (instance_mask >= thr[0])
                         & (instance_mask <= thr[1]))
    return torch.stack(masks)


def eval_step_metrics(depth_gt: torch.Tensor, depth_pred: torch.Tensor,
                      instance_mask: torch.Tensor, min_depth: float,
                      max_depth: float) -> Dict[str, dict]:
    """Per-frame metrics for every material slice, on the device.

    depth_gt, depth_pred: (B, H, W, 1), pred clamped by the caller;
    instance_mask: (B, H, W, 1) integer ids.  Returns {slice: {metric: (B,),
    "count": (B,) valid-pixel counts}}; a frame whose slice is empty has NaN
    metrics and count 0.
    """
    masks = slice_masks(depth_gt, instance_mask, min_depth, max_depth)
    shape = masks.shape
    res = compute_depth_errors(depth_gt.expand(shape),
                               depth_pred.expand(shape), masks,
                               dims=(2, 3, 4))
    counts = masks.sum(dim=(2, 3, 4))
    out = {}
    for i, name in enumerate(MATERIAL_THRESHOLDS):
        out[name] = {m: res[m][i] for m in METRIC_ORDER}
        out[name]["count"] = counts[i]
    return out


def empty_accumulator(device="cpu") -> dict:
    """Per-slice metric sums over the frames with a non-empty slice, and the
    frame count: 0-d float32 tensors on device."""
    zeros = torch.zeros(len(MATERIAL_THRESHOLDS), len(_ACC_KEYS),
                        dtype=torch.float32, device=device)
    return _tree(zeros)


def _tree(table: torch.Tensor) -> dict:
    """(S, 8) table -> {slice: {key: 0-d view}}."""
    return {name: {k: table[i, j] for j, k in enumerate(_ACC_KEYS)}
            for i, name in enumerate(MATERIAL_THRESHOLDS)}


def _table(acc: dict) -> torch.Tensor:
    return torch.stack([torch.stack([torch.as_tensor(acc[name][k])
                                     for k in _ACC_KEYS])
                        for name in MATERIAL_THRESHOLDS])


def accumulate_on_device(acc: dict, step_metrics: dict) -> dict:
    """Fold one batch's per-frame metrics into the accumulator on the
    device; an empty slice of a frame is left out by torch.where."""
    rows = []
    for name in MATERIAL_THRESHOLDS:
        res = step_metrics[name]
        nonempty = res["count"] > 0
        vals = [torch.where(nonempty, res[m], torch.zeros_like(res[m])).sum()
                for m in METRIC_ORDER]
        vals.append(nonempty.to(torch.float32).sum())
        rows.append(torch.stack(vals))
    return _tree(_table(acc) + torch.stack(rows).to(torch.float32))


def accumulator_result(acc: dict) -> Dict[str, Dict[str, float]]:
    """The table of means, from one host fetch of the accumulator."""
    table = _table(acc).cpu().tolist()
    out = {}
    for name, row in zip(MATERIAL_THRESHOLDS, table):
        frames = row[-1]
        c = max(frames, 1.0)
        out[name] = {m: row[j] / c for j, m in enumerate(METRIC_ORDER)}
        out[name]["frames"] = int(frames)
    return out


class MetricAccumulator:
    """Host-side accumulation of per-frame metrics (mean over frames with a
    non-empty slice, matching the reference's frame mean)."""

    def __init__(self):
        self.sums = {k: np.zeros(len(METRIC_ORDER))
                     for k in MATERIAL_THRESHOLDS}
        self.counts = {k: 0 for k in MATERIAL_THRESHOLDS}

    def update(self, step_metrics: Dict[str, dict]) -> None:
        for name, res in step_metrics.items():
            counts = np.asarray(torch.as_tensor(res["count"]).cpu())
            vals = np.stack([np.asarray(torch.as_tensor(res[m]).cpu())
                             for m in METRIC_ORDER], axis=-1)
            nonempty = counts > 0
            if nonempty.any():
                self.sums[name] += vals[nonempty].sum(axis=0)
                self.counts[name] += int(nonempty.sum())

    def result(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name in MATERIAL_THRESHOLDS:
            c = max(self.counts[name], 1)
            out[name] = {m: float(self.sums[name][i] / c)
                         for i, m in enumerate(METRIC_ORDER)}
            out[name]["frames"] = self.counts[name]
        return out


def format_table(results: Dict[str, Dict[str, float]]) -> str:
    """The reference's LaTeX-ready table layout (evaluation.py:284-285)."""
    lines = ["  " + ("{:>9} | " * 8).format("slice", *METRIC_ORDER)]
    for name, row in results.items():
        vals = "".join("&{: 9.5f}  ".format(row[m]) for m in METRIC_ORDER)
        lines.append(f"{name:>10} {vals}\\\\")
    return "\n".join(lines)
