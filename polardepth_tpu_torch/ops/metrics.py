"""The 7 standard depth-error metrics (polardepth_tpu/ops/metrics.py:15-56;
reference manydepth/layers.py:539-577), as masked weighted means reduced on
the device.
"""

from __future__ import annotations

import torch


def compute_depth_errors(gt: torch.Tensor, pred: torch.Tensor,
                         mask: torch.Tensor | None = None,
                         dims=None) -> dict:
    """abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 over valid pixels.

    gt, pred: same-shape positive depths (pred clamped by the caller to
    [min_depth, max_depth]).  mask: optional boolean or 0/1 validity mask.
    dims: the dimensions to reduce; None reduces all of them (one scalar
    each), (1, 2, 3) gives one value per frame of a (B, H, W, 1) batch.
    An empty mask gives NaN (0 / 0); callers exclude such slices.
    """
    if mask is None:
        w = torch.ones_like(gt)
    else:
        w = mask.to(gt.dtype)
        # neutralise masked-out pixels before the log and the divide, so
        # that 0 * inf never poisons the weighted sums
        one = torch.ones_like(gt)
        gt = torch.where(w > 0, gt, one)
        pred = torch.where(w > 0, pred, one)
    dims = tuple(range(gt.ndim)) if dims is None else tuple(dims)
    denom = torch.sum(w, dim=dims)

    def wmean(x):
        return torch.sum(x * w, dim=dims) / denom

    thresh = torch.maximum(gt / pred, pred / gt)
    a1 = wmean((thresh < 1.25).to(gt.dtype))
    a2 = wmean((thresh < 1.25 ** 2).to(gt.dtype))
    a3 = wmean((thresh < 1.25 ** 3).to(gt.dtype))

    diff = gt - pred
    rmse = torch.sqrt(wmean(diff * diff))
    log_diff = torch.log(gt) - torch.log(pred)
    rmse_log = torch.sqrt(wmean(log_diff * log_diff))
    abs_rel = wmean(torch.abs(diff) / gt)
    sq_rel = wmean(diff * diff / gt)

    return {"abs_rel": abs_rel, "sq_rel": sq_rel, "rmse": rmse,
            "rmse_log": rmse_log, "a1": a1, "a2": a2, "a3": a3}
