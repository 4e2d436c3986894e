"""Metric and image logging: JSONL always, TensorBoard where it imports
(polardepth_tpu/utils/logging.py).

One writer namespaces the modes ("train", "val", "test_all", ...).  JSONL
(``metrics.jsonl`` in the log directory) is the primary record.  TensorBoard
event files go through torch.utils.tensorboard; where that cannot be
imported, the writer warns once and goes on with JSONL alone, as the JAX
package's does.
"""

from __future__ import annotations

import json
import os
import time
import warnings

import numpy as np


def sec_to_hm_str(t: float) -> str:
    """seconds -> 'HHhMMmSSs' (reference utils.sec_to_hm_str)."""
    t = int(t)
    s = t % 60
    t //= 60
    m = t % 60
    t //= 60
    return f"{t:02d}h{m:02d}m{s:02d}s"


class MetricWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = {}
        self._use_tb = True
        self._t0 = time.time()

    def _tb_writer(self, mode: str):
        if not self._use_tb:
            return None
        if mode not in self._tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                # JSONL only, but never silently: a user pointing
                # TensorBoard at log_dir must know why it is empty
                warnings.warn(
                    f"TensorBoard logging disabled ({type(e).__name__}: "
                    f"{e}); metrics continue in metrics.jsonl")
                self._use_tb = False
                return None
            self._tb[mode] = SummaryWriter(os.path.join(self.log_dir, mode))
        return self._tb[mode]

    def scalars(self, mode: str, step: int, values: dict) -> None:
        rec = {"mode": mode, "step": int(step),
               "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        tb = self._tb_writer(mode)
        if tb is not None:
            for k, v in values.items():
                tb.add_scalar(k, float(v), step)

    def image(self, mode: str, step: int, tag: str, img: np.ndarray) -> None:
        """img: (H, W, 3) float in [0, 1] or uint8."""
        tb = self._tb_writer(mode)
        if tb is not None:
            if img.dtype != np.uint8:
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            tb.add_image(tag, img, step, dataformats="HWC")

    def close(self) -> None:
        self._jsonl.close()
        for tb in self._tb.values():
            tb.close()
