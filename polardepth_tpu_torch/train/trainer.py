"""The published supervised train step, the eval and inference steps,
``Trainer`` (the supervised training loop) and ``Predictor``
(polardepth_tpu/train/trainer.py).

The JAX package's steps are pure functions of (state, batch); here the model
holds its parameters.  The train step runs it in train mode (BN on batch
statistics, dropout from an explicit generator) and updates the state in
place; the eval and infer steps run it in eval mode under
``torch.inference_mode``.  The JAX package's multi-step train call
(``lax.scan`` over stacked batches) is a plain loop here, its scanned eval
call one batch after another, and its mesh placement one copy to the
model's device.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch

from polardepth_tpu_torch.config import Config
from polardepth_tpu_torch.data.augment import (
    color_jitter_apply, color_jitter_factors, draw_flip,
    random_horizontal_flip)
from polardepth_tpu_torch.eval.evaluation import (
    MATERIAL_THRESHOLDS, accumulate_on_device, accumulator_result,
    empty_accumulator, eval_step_metrics, format_table)
from polardepth_tpu_torch.models.layers import set_dropout_generator
from polardepth_tpu_torch.models.network import PolarDepthNet
from polardepth_tpu_torch.ops.depth import disp_to_depth
from polardepth_tpu_torch.train.losses import (
    preprocess_batch, supervised_losses, twelve_channel_input)
from polardepth_tpu_torch.train.selfsup import model_device, to_device
from polardepth_tpu_torch.train.state import (
    TrainState, apply_gradients, create_train_state)

TRAIN_BATCH_KEYS = ("color", "pol", "depth", "K")
EVAL_BATCH_KEYS = ("color", "pol", "depth_gt", "mask")


def build_model(cfg: Config) -> PolarDepthNet:
    both = cfg.augment_xolp and cfg.augment_normals
    return PolarDepthNet(
        augment_xolp=cfg.augment_xolp,
        augment_normals=cfg.augment_normals,
        dropout_rate=cfg.dropout_rate,
        scales=tuple(cfg.scales),
        refraction_index=cfg.refraction_index,
        # the fused stack exists only when both modality encoders do
        fused_encoders=cfg.fused_encoders and both,
        in_ch=12 if cfg.enable_12channels else 3,
    )


def _needs_pol(cfg: Config) -> bool:
    return cfg.augment_xolp or cfg.augment_normals


def _encoder_input(cfg: Config, pb: dict) -> torch.Tensor:
    """The depth encoder's input: the RGB frame, or in the 12-channel mode
    the stacked captures."""
    if cfg.enable_12channels:
        return twelve_channel_input(pb["pol"])
    return pb["color"]


def _jittered_encoder_input(cfg: Config, pb: dict,
                            factors: dict) -> torch.Tensor:
    """The depth encoder's input with the colour jitter: the RGB frame, or
    in the 12-channel mode each of the four 3-channel capture groups with
    the same factors (train/losses.py:85-95 of the JAX package)."""
    x = _encoder_input(cfg, pb)
    if not cfg.enable_12channels:
        return color_jitter_apply(x, factors)
    return torch.cat([color_jitter_apply(x[..., 3 * i:3 * i + 3], factors)
                      for i in range(4)], dim=-1)


def make_train_step(model: PolarDepthNet, cfg: Config):
    """The published supervised train step on the device of model
    (polardepth_tpu/train/trainer.py:85-115).

    step(state, batch, generator, *, jitter=None, flip=None) -> logs: batch
    holds color, pol, depth (uint8 or float, any resolution) and K;
    generator (on the model's device) draws the jitter factors, the flip
    (with random_flip) and dropout unless given.  One Adam step updates
    state in place; the gradients stay on the parameters.  The logs are
    detached tensors on the device.
    """
    cfg.validate()
    needs_pol = cfg.augment_xolp or cfg.augment_normals

    def step(state: TrainState, batch: dict,
             generator: torch.Generator | None = None, *,
             jitter: dict | None = None,
             flip: torch.Tensor | None = None) -> dict:
        batch = to_device(batch, model_device(model))
        model.train()
        set_dropout_generator(model, generator)
        pb = preprocess_batch(batch, cfg)
        b = pb["color"].shape[0]
        if jitter is None:
            jitter = color_jitter_factors(generator, b)
        if cfg.random_flip:
            pb = random_horizontal_flip(
                pb, draw_flip(generator, b) if flip is None else flip)
        state.optimizer.zero_grad(set_to_none=True)
        outputs = model(_jittered_encoder_input(cfg, pb, jitter),
                        pol=pb["pol"] if needs_pol else None)
        loss, logs = supervised_losses(cfg, outputs, pb)
        loss.backward()
        apply_gradients(state)
        return {k: v.detach() for k, v in logs.items()}

    return step


def _flip_average_disp(disp: torch.Tensor,
                       disp_flipped: torch.Tensor) -> torch.Tensor:
    """Monodepth2 batch_post_process_disparity on (B, H, W, 1): blend the
    straight scaled disparity with the prediction on the mirrored input
    (already flipped back), with 5%-border ramp masks."""
    w = disp.shape[2]
    xs = torch.linspace(0.0, 1.0, w, dtype=disp.dtype,
                        device=disp.device)[None, None, :, None]
    l_mask = 1.0 - torch.clamp(20.0 * (xs - 0.05), 0.0, 1.0)
    r_mask = l_mask.flip(2)
    mean = 0.5 * (disp + disp_flipped)
    return (r_mask * disp + l_mask * disp_flipped
            + (1.0 - l_mask - r_mask) * mean)


def _forward_depth(model: PolarDepthNet, cfg: Config,
                   pb: dict) -> torch.Tensor:
    """Full-scale disparity -> clipped depth (B, H, W, 1), flip-averaged when
    cfg.post_process (the scaled disparities are blended, then inverted)."""
    needs_pol = _needs_pol(cfg)

    def disp_of(pb_):
        outputs = model(_encoder_input(cfg, pb_),
                        pol=pb_["pol"] if needs_pol else None)
        scaled, _ = disp_to_depth(outputs[("disp", 0)], cfg.min_depth,
                                  cfg.max_depth)
        return scaled

    scaled = disp_of(pb)
    if cfg.post_process:
        # mirror every image-like input on W; the captures flip naively, as
        # the reference flips its stacked input channels
        pb_f = dict(pb)
        pb_f["color"] = pb["color"].flip(2)
        if needs_pol:
            pb_f["pol"] = pb["pol"].flip(2)
        scaled = _flip_average_disp(scaled, disp_of(pb_f).flip(2))
    return torch.clamp(1.0 / scaled, cfg.min_depth, cfg.max_depth)


def make_eval_step(model: PolarDepthNet, cfg: Config):
    """step(batch, acc) -> acc (polardepth_tpu/train/trainer.py:184-192):
    batch of raw tensors {"color", "pol", "depth_gt", "mask"} on the model's
    device; the per-material metrics of the clipped depth are folded into
    the accumulator on the device (eval/evaluation.py).  Puts the model in
    eval mode."""

    def step(batch: dict, acc: dict) -> dict:
        model.eval()
        with torch.inference_mode():
            pb = preprocess_batch(batch, cfg)
            pred = _forward_depth(model, cfg, pb)
            metrics = eval_step_metrics(pb["depth_gt"], pred, pb["mask"],
                                        cfg.min_depth, cfg.max_depth)
            return accumulate_on_device(acc, metrics)

    return step


def make_infer_step(model: PolarDepthNet, cfg: Config):
    """batch of raw tensors {"color", "pol"} -> depth (B, H, W, 1).
    Puts the model in eval mode, now and at each call."""
    model.eval()

    def step(batch: dict) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return _forward_depth(model, cfg, preprocess_batch(batch, cfg))

    return step


def step_seed(seed: int, step: int) -> int:
    """The seed of train step ``step``'s draws (jitter, flip, dropout): a
    function of (seed, step) alone, as the JAX step folds its key with the
    step (polardepth_tpu/train/trainer.py:89), so that a resumed run draws
    what an uninterrupted one does."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


class Trainer:
    """The supervised training loop (polardepth_tpu/train/trainer.py:
    218-525): train epochs, per-material evaluation, checkpoints with
    auto-resume, and logging.

    Trainer(cfg, steps_per_epoch, device="cuda", log_fn=print) builds the
    model from cfg with torch's initialisation seeded by cfg.seed, on
    device.  ``counts`` tallies the train steps, eval batches and predict
    batches that ran (each runs the polarization preprocess once).
    """

    def __init__(self, cfg: Config, steps_per_epoch: int, device="cuda",
                 log_fn=print):
        cfg.validate()
        self.cfg = cfg
        self.log = log_fn
        self.device = torch.device(device)
        self.steps_per_epoch = steps_per_epoch
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = build_model(cfg)
        self.model = model.to(self.device)
        self.state = create_train_state(self.model, cfg, steps_per_epoch)
        self.generator = torch.Generator(device=self.device)
        self._train_step = make_train_step(self.model, cfg)
        self._eval_step = make_eval_step(self.model, cfg)
        self._infer_step = make_infer_step(self.model, cfg)
        self.epoch = 0
        self.counts = {"train_steps": 0, "eval_batches": 0,
                       "predict_batches": 0}

    # -- data placement -------------------------------------------------------

    def _to_device(self, batch: dict, keys) -> dict:
        return to_device({k: batch[k] for k in keys if k in batch},
                         self.device)

    # -- public API -----------------------------------------------------------

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on a host batch; the logs stay on the
        device."""
        self.generator.manual_seed(step_seed(self.cfg.seed, self.state.step))
        logs = self._train_step(self.state,
                                self._to_device(batch, TRAIN_BATCH_KEYS),
                                self.generator)
        self.counts["train_steps"] += 1
        return logs

    def train_epoch(self, batches: Iterable[dict], periodic_cb=None,
                    flush_cb=None) -> dict:
        """One pass over batches; returns the last step's logs as floats,
        with examples_per_sec over the whole pass.

        After each step, periodic_cb(global_step, logs) runs on the
        reference's logging cadence: every log_frequency batches while
        step < 2000, then every 2000 steps (trainer.py:447-461), and
        flush_cb(global_step) runs, the hook of mid-epoch checkpoints.  The
        host waits for the card only there, in the callbacks, and once at
        the end of the pass.
        """
        logs = {}
        t0 = time.perf_counter()
        n = 0
        for batch in batches:
            logs = self.train_step(batch)
            n += 1
            step = self.state.step
            if periodic_cb is not None:
                early = (n % max(self.cfg.log_frequency, 1) == 0
                         and step < 2000)
                if early or step % 2000 == 0:
                    periodic_cb(step, logs)
            if flush_cb is not None:
                flush_cb(step)
        if n:
            logs = dict(zip(logs, torch.stack(list(logs.values()))
                            .cpu().tolist()))
            dt = time.perf_counter() - t0
            logs["examples_per_sec"] = n * self.cfg.batch_size / max(dt, 1e-9)
        self.epoch += 1
        return logs

    def _eval_batch(self, batch: dict, acc: dict) -> dict:
        self.counts["eval_batches"] += 1
        return self._eval_step(self._to_device(batch, EVAL_BATCH_KEYS), acc)

    def evaluate(self, batches: Iterable[dict]) -> dict:
        """The per-material metric table over batches (reference
        Trainer.test / Evaluation.test).  The sums accumulate on the device;
        the host fetches them once at the end."""
        acc = empty_accumulator(self.device)
        for batch in batches:
            acc = self._eval_batch(batch, acc)
        results = accumulator_result(acc)
        self.log(format_table(results))
        return results

    def predict(self, batch: dict) -> np.ndarray:
        """Depth (B, H, W, 1) of a host batch, as numpy."""
        self.counts["predict_batches"] += 1
        return self._infer_step(
            self._to_device(batch, EVAL_BATCH_KEYS)).cpu().numpy()

    def fit(self, train_batches_fn, eval_batches_fn=None,
            num_epochs: Optional[int] = None,
            checkpoint_dir: Optional[str] = None, writer=None, save_every_steps: Optional[int] = None) -> dict:
        """The reference's train() protocol: evaluate before epoch 0, then
        per epoch train, evaluate and save on the save_frequency cadence
        (trainer.py:379-402).  Returns {"initial": table, "epoch_<e>":
        table, ...}.

        Auto-resume: when checkpoint_dir holds step checkpoints, the latest
        is restored first.  Exact data resume: pass a BatchIterator itself
        (not a function) as train_batches_fn; its shuffle state and cursor
        are saved with every checkpoint and restored on resume, so a killed
        run goes on with the same batch sequence.  save_every_steps adds
        mid-epoch checkpoints on that step cadence.  With a writer, each
        epoch's evaluation also goes to the writer's "val" mode as its
        "all" row.
        """
        from polardepth_tpu_torch.train import checkpoint as ckpt
        num_epochs = num_epochs or self.cfg.num_epochs
        data_iter = None
        if not callable(train_batches_fn):
            data_iter = train_batches_fn
            train_batches_fn = lambda: iter(data_iter)  # noqa: E731

        def ckpt_extra():
            return {"data": data_iter.state()} if data_iter is not None \
                else None

        if checkpoint_dir:
            latest = ckpt.latest_step_dir(checkpoint_dir)
            if latest:
                if data_iter is not None:
                    _, extra = ckpt.restore(latest, self.state,
                                            extra=ckpt_extra())
                    data_iter.set_state(extra["data"])
                else:
                    ckpt.restore(latest, self.state)
                self.log(f"resumed from {latest} (step {self.state.step})")
        results = {}
        if eval_batches_fn is not None:
            results["initial"] = self.evaluate(eval_batches_fn())

        periodic_cb = None
        if writer is not None and eval_batches_fn is not None:
            def periodic_cb(step, logs):
                """log_frequency cadence: the train scalars and a
                single-batch validation (reference trainer.py:447-461)."""
                writer.scalars("train", step, dict(zip(
                    logs, torch.stack(list(logs.values())).cpu().tolist())))
                batch = next(iter(eval_batches_fn()))
                acc = self._eval_batch(batch, empty_accumulator(self.device))
                row = accumulator_result(acc)["all"]
                writer.scalars("val", step, {k: v for k, v in row.items()
                                             if k != "frames"})

        flush_cb = None
        if checkpoint_dir and save_every_steps:
            last_saved = [self.state.step]

            def flush_cb(step):
                if step - last_saved[0] >= save_every_steps:
                    ckpt.save(checkpoint_dir, self.state, self.cfg,
                              extra=ckpt_extra())
                    last_saved[0] = step

        start_epoch = self.state.step // max(self.steps_per_epoch, 1)
        for e in range(start_epoch, num_epochs):
            logs = self.train_epoch(train_batches_fn(), periodic_cb,
                                    flush_cb)
            self.log(f"epoch {e}: loss={logs.get('loss', float('nan')):.5f} "
                     f"({logs.get('examples_per_sec', 0):.1f} ex/s)")
            if writer is not None:
                writer.scalars("train", self.state.step, logs)
            if (e + 1) % self.cfg.save_frequency == 0:
                if eval_batches_fn is not None:
                    table = self.evaluate(eval_batches_fn())
                    results[f"epoch_{e}"] = table
                    if writer is not None:
                        writer.scalars("val", self.state.step, {
                            k: v for k, v in table["all"].items()
                            if k != "frames"})
                    self._log_images(eval_batches_fn, writer)
                if checkpoint_dir:
                    ckpt.save(checkpoint_dir, self.state, self.cfg,
                              extra=ckpt_extra())
        return results

    def _log_images(self, eval_batches_fn, writer) -> None:
        """Colour-mapped disparity and error of the first eval frame, and
        the disparity masked to each material present (the reference's
        TensorBoard images, trainer.py:1449-1585).  The prediction runs
        outside the guard, so that an error of the model or a kernel is
        raised; only an error of the image writing is logged and passed."""
        if writer is None:
            return
        batch = next(iter(eval_batches_fn()))
        depth = self.predict(batch)
        step = self.state.step
        try:
            from polardepth_tpu_torch.eval.analysis import (
                render_disparity, render_error_heatmap)
            disp = 1.0 / depth[0]
            writer.image("val", step, "depth_pred", render_disparity(disp))
            if "depth_gt" in batch:
                writer.image("val", step, "error", render_error_heatmap(
                    depth[0], batch["depth_gt"][0], self.cfg.min_depth,
                    self.cfg.max_depth))
            if "mask" in batch and "depth_gt" in batch:
                mask0 = np.asarray(batch["mask"][0]).squeeze()
                for name, thr in MATERIAL_THRESHOLDS.items():
                    if thr is None:
                        continue
                    sel = (mask0 >= thr[0]) & (mask0 <= thr[1])
                    if sel.any():
                        writer.image(f"test_{name}", step, "depth_pred",
                                     render_disparity(disp * sel[..., None]))
        except Exception as exc:  # noqa: BLE001 - logging must not stop training
            self.log(f"image logging skipped: {exc}")


class Predictor:
    """Serves a model with given weights on one device.

    state_dict: the port's weights, e.g. from models/convert.py
    (state_dict_from_jax or load_components).
    """

    def __init__(self, cfg: Config, state_dict: dict, device="cuda"):
        cfg.validate()
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(cfg)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device)
        self._keys = ("color", "pol") if _needs_pol(cfg) or \
            cfg.enable_12channels else ("color",)
        self._step = make_infer_step(self.model, cfg)

    def predict(self, batch: dict) -> np.ndarray:
        """{"color": (B, H, W, 3) uint8, "pol": (B, H, W, 4) uint8} ->
        depth (B, H, W, 1) float32 in [min_depth, max_depth]."""
        db = {k: torch.as_tensor(batch[k]).to(self.device)
              for k in self._keys}
        return self._step(db).cpu().numpy()
