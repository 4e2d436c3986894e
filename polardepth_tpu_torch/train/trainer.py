"""The published supervised train step, the inference step and
``Predictor`` (polardepth_tpu/train/trainer.py:53-214, 394-396).

The JAX package's steps are pure functions of (state, batch); here the model
holds its parameters.  The train step runs it in train mode (BN on batch
statistics, dropout from an explicit generator) and updates the state in
place; the infer step runs it in eval mode under ``torch.inference_mode``.
"""

from __future__ import annotations

import numpy as np
import torch

from polardepth_tpu_torch.config import Config
from polardepth_tpu_torch.data.augment import (
    color_jitter_apply, color_jitter_factors, draw_flip,
    random_horizontal_flip)
from polardepth_tpu_torch.models.layers import set_dropout_generator
from polardepth_tpu_torch.models.network import PolarDepthNet
from polardepth_tpu_torch.ops.depth import disp_to_depth
from polardepth_tpu_torch.train.losses import (
    preprocess_batch, supervised_losses, twelve_channel_input)
from polardepth_tpu_torch.train.selfsup import model_device, to_device
from polardepth_tpu_torch.train.state import TrainState, apply_gradients


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


def make_infer_step(model: PolarDepthNet, cfg: Config):
    """batch of raw tensors {"color", "pol"} -> depth (B, H, W, 1).
    Puts the model in eval mode."""
    model.eval()

    def step(batch: dict) -> torch.Tensor:
        with torch.inference_mode():
            return _forward_depth(model, cfg, preprocess_batch(batch, cfg))

    return step


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
