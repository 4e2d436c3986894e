"""The training loop of the self-supervised and teacher-student paths
(polardepth_tpu/train/loop.py; reference Trainer.train, trainer.py:379-467).

``AltTrainer`` runs the reference's protocol around a train step and an
infer step: an evaluation before epoch 0, per epoch the train steps with the
in-epoch validation and logging cadence, then an evaluation and a checkpoint
on the save_frequency cadence, and auto-resume from the latest checkpoint.
The student's depth-bin trackers are threaded through every call and ride in
the checkpoint's ``extra`` tree.  The metric sums stay on the device and are
fetched once per evaluation (eval/evaluation.py).  As in the JAX package,
there is no exact data resume here: a resumed run starts its epoch over.

``make_alt_trainer`` builds the model, the steps and the trainer of a
configuration: the teacher-student path with ``train_student``, else the
self-supervised one.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from polardepth_tpu_torch.config import Config
from polardepth_tpu_torch.eval.evaluation import (
    accumulate_on_device, accumulator_result, empty_accumulator,
    eval_step_metrics, format_table)
from polardepth_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from polardepth_tpu_torch.train import checkpoint as ckpt
from polardepth_tpu_torch.train.pretrained import maybe_apply_pretrained
from polardepth_tpu_torch.train.selfsup import to_device
from polardepth_tpu_torch.train.state import TrainState, create_train_state
from polardepth_tpu_torch.train.trainer import step_seed
from polardepth_tpu_torch.utils.precision import float32

# the batch keys each step reads (the rest stay on the host)
STEP_KEYS = ("color_frames", "pol", "K", "inv_K", "depth", "rel_poses")
INFER_KEYS = ("color_frames", "pol", "K", "inv_K", "rel_poses")


class AltTrainer:
    """Train, evaluate and checkpoint around (step_fn, infer_fn).

    step_fn(state, [trackers,] batch, generator) -> ([trackers,] logs)
    infer_fn([trackers,] batch) -> clipped depth (B, H, W, 1) on the device

    trackers: None, or the student's (min, max) depth-bin tensors, handed
    to both and checkpointed.  step_select, when set, maps an epoch to the
    step function of that epoch (the frozen-teacher step).  Each train
    step's generator is seeded from (cfg.seed, step), as ``Trainer`` does.
    """

    def __init__(self, cfg: Config, state: TrainState, step_fn: Callable,
                 infer_fn: Optional[Callable], device, trackers=None,
                 log_fn=print):
        self.cfg = cfg
        self.state = state
        self.step_fn = step_fn
        self.infer_fn = infer_fn
        self.device = torch.device(device)
        self.trackers = trackers
        self.log = log_fn
        self.step_select: Optional[Callable[[int], Callable]] = None
        self._active_step = step_fn
        self.generator = torch.Generator(device=self.device)
        self.counts = {"train_steps": 0, "eval_batches": 0}

    def _keys(self, batch: dict, keys) -> dict:
        return to_device({k: batch[k] for k in keys if k in batch},
                         self.device)

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on a host batch; the logs stay on the
        device."""
        self.generator.manual_seed(step_seed(self.cfg.seed, self.state.step))
        batch = self._keys(batch, STEP_KEYS)
        if self.trackers is not None:
            self.trackers, logs = self._active_step(
                self.state, self.trackers, batch, self.generator)
        else:
            logs = self._active_step(self.state, batch, self.generator)
        self.counts["train_steps"] += 1
        return logs

    def infer(self, batch: dict) -> torch.Tensor:
        batch = self._keys(batch, INFER_KEYS)
        if self.trackers is not None:
            return self.infer_fn(self.trackers, batch)
        return self.infer_fn(batch)

    def _accumulate(self, batch: dict, acc: dict) -> dict:
        """Fold one batch's per-material metrics into acc on the device;
        the ground truth is resized to the prediction where they differ."""
        self.counts["eval_batches"] += 1
        pred = self.infer(batch)
        gt = self._keys(batch, ("depth_gt", "mask"))
        depth_gt, mask = gt["depth_gt"].float(), gt["mask"]
        hw = tuple(pred.shape[1:3])
        if tuple(depth_gt.shape[1:3]) != hw:
            depth_gt = resize_bilinear(depth_gt, hw)
            mask = resize_nearest(mask, hw)
        with torch.inference_mode():
            metrics = eval_step_metrics(depth_gt, pred, mask,
                                        self.cfg.min_depth,
                                        self.cfg.max_depth)
            return accumulate_on_device(acc, metrics)

    @float32()
    def evaluate(self, batches) -> dict:
        """The per-material table through the infer step; one host fetch
        at the end."""
        acc = empty_accumulator(self.device)
        for batch in batches:
            acc = self._accumulate(batch, acc)
        results = accumulator_result(acc)
        self.log(format_table(results))
        return results

    def _val_single(self, batch: dict) -> dict:
        """The "all" row of one batch (reference val(),
        trainer.py:752-780)."""
        row = accumulator_result(self._accumulate(
            batch, empty_accumulator(self.device)))["all"]
        return {k: v for k, v in row.items() if k != "frames"}

    def _extra(self):
        if self.trackers is None:
            return None
        return {"trackers": [t.detach().cpu() for t in self.trackers]}

    def restore(self, path: str) -> None:
        """Load a checkpoint directory into the state, and the trackers."""
        if self.trackers is None:
            ckpt.restore(path, self.state)
            return
        _, extra = ckpt.restore(path, self.state, extra=self._extra())
        self.trackers = tuple(torch.as_tensor(t, dtype=torch.float32)
                              .to(self.device) for t in extra["trackers"])

    @float32()
    def fit(self, train_batches_fn, eval_batches_fn=None,
            num_epochs: Optional[int] = None,
            checkpoint_dir: Optional[str] = None, writer=None,
            steps_per_epoch: int = 1) -> dict:
        """The reference's train() protocol; returns {"initial": table,
        "epoch_<e>": table, ...}.  train_batches_fn and eval_batches_fn
        are callables that give a fresh iterator of host batches."""
        cfg = self.cfg
        num_epochs = num_epochs or cfg.num_epochs
        if checkpoint_dir:
            latest = ckpt.latest_step_dir(checkpoint_dir)
            if latest:
                self.restore(latest)
                self.log(f"resumed from {latest} (step {self.state.step})")
        can_eval = eval_batches_fn is not None and self.infer_fn is not None
        results = {}
        if can_eval:
            results["initial"] = self.evaluate(eval_batches_fn())

        def host(logs):
            return dict(zip(logs, torch.stack(list(logs.values()))
                            .cpu().tolist()))

        for e in range(self.state.step // max(steps_per_epoch, 1),
                       num_epochs):
            self._active_step = (self.step_select(e) if self.step_select
                                 else self.step_fn)
            t0 = time.perf_counter()
            n = 0
            logs = {}
            for batch in train_batches_fn():
                logs = self.train_step(batch)
                n += 1
                step = self.state.step
                # in-epoch val/log: every log_frequency batches early,
                # every 2000 steps late (trainer.py:447-461)
                early = n % max(cfg.log_frequency, 1) == 0 and step < 2000
                if (early or step % 2000 == 0) and writer is not None:
                    writer.scalars("train", step, host(logs))
                    if can_eval:
                        writer.scalars("val", step, self._val_single(
                            next(iter(eval_batches_fn()))))
            host_logs = host(logs) if n else {}
            eps = n * cfg.batch_size / max(time.perf_counter() - t0, 1e-9)
            self.log(f"epoch {e}: loss="
                     f"{host_logs.get('loss', float('nan')):.5f} "
                     f"({eps:.1f} ex/s)")
            if writer is not None and host_logs:
                writer.scalars("train_epoch", self.state.step, host_logs)
            if (e + 1) % cfg.save_frequency == 0:
                if can_eval:
                    results[f"epoch_{e}"] = self.evaluate(eval_batches_fn())
                if checkpoint_dir:
                    ckpt.save(checkpoint_dir, self.state, cfg,
                              extra=self._extra())
        return results


def make_alt_trainer(cfg: Config, steps_per_epoch: int, device="cuda",
                     log_fn=print) -> AltTrainer:
    """The AltTrainer of cfg's path (polardepth_tpu/cli.py:539-597): the
    teacher-student model with ``train_student`` (the frozen-teacher step
    from freeze_teacher_epoch on, when that is >= 0), else the
    self-supervised model.  torch's initialisation is seeded by cfg.seed,
    the model is built on device, and with cfg.weights_init "pretrained"
    its ResNet18 encoders take the ImageNet weights."""
    cfg.validate()
    device = torch.device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        if cfg.train_student:
            from polardepth_tpu_torch.train import student
            model = student.StudentModel.from_config(cfg)
        else:
            from polardepth_tpu_torch.train import selfsup
            model = selfsup.SelfSupModel.from_config(cfg)
    model.to(device)
    maybe_apply_pretrained(model, cfg, log_fn)
    state = create_train_state(model, cfg, steps_per_epoch)
    if not cfg.train_student:
        return AltTrainer(cfg, state,
                          selfsup.make_selfsup_train_step(model, cfg),
                          selfsup.make_selfsup_infer_step(model, cfg),
                          device, log_fn=log_fn)
    step = student.make_student_train_step(model, cfg)
    frozen = student.make_student_train_step(model, cfg, freeze_teacher=True)
    alt = AltTrainer(cfg, state, step,
                     student.make_student_infer_step(model, cfg), device,
                     trackers=student.initial_trackers(cfg, device),
                     log_fn=log_fn)
    alt.step_select = (lambda e: frozen
                       if 0 <= cfg.freeze_teacher_epoch <= e else step)
    return alt
