"""The ManyDepth teacher-student train and infer steps
(polardepth_tpu/train/student.py; reference trainer.py:569-648, 1112-1296).

  teacher  the self-supervised model (``mono`` depth net + pose net) with
           its own losses, until freeze_teacher_epoch; then frozen;
  student  the cost-volume encoder and a depth decoder over the current
           frame and the lookup frames, warped through the teacher's
           matching poses (or the dataset's, with pose_input);
  coupling |student depth - teacher depth| where the cost volume is not
           trusted (motion and augmentation masks), the photometric loss
           elsewhere;
  tricks   static-camera and zero-pose matching augmentation per sample,
           and the adaptive depth-bin trackers, two 0-d float32 tensors on
           the device that the step returns updated.

A frozen teacher runs in eval mode without gradient, and its parameters get
zero gradients, so that Adam moves them by its first moment as optax does on
the JAX package's whole-tree update (student.py:126-128, 389-390).  Random
draws come from an explicit ``torch.Generator``; the step also takes each
of them as an argument.  The JAX package's packed loss form
(``_student_losses_packed``, a TPU layout) and its rematerialisation are not
ported.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
from torch import nn

from polardepth_tpu_torch.config import Config
from polardepth_tpu_torch.models.cost_volume import CostVolumeEncoder
from polardepth_tpu_torch.models.depth_decoder import DepthDecoder
from polardepth_tpu_torch.models.layers import set_dropout_generator
from polardepth_tpu_torch.ops.depth import disp_to_depth
from polardepth_tpu_torch.ops.losses import reprojection_loss, smooth_loss
from polardepth_tpu_torch.ops.resize import resize_nearest
from polardepth_tpu_torch.train.losses import color_pyramid
from polardepth_tpu_torch.train.selfsup import (
    SelfSupModel, _reduce_frames, draw_identity_noise, generate_images_pred,
    model_device, preprocess_multiframe, selfsup_losses, to_device)
from polardepth_tpu_torch.train.state import TrainState, apply_gradients
from polardepth_tpu_torch.utils.precision import float32


class StudentModel(nn.Module):
    """The teacher (``teacher``: a SelfSupModel) and the matching student
    (``encoder``: CostVolumeEncoder, ``depth``: DepthDecoder) in one
    module, with the JAX package's subtree names."""

    def __init__(self, frame_ids: Sequence[int] = (0, -1, 1),
                 matching_ids: Sequence[int] = (0, -1),
                 augment_xolp: bool = True, augment_normals: bool = True,
                 dropout_rate: float = 0.1,
                 scales: Sequence[int] = (0, 1, 2, 3),
                 num_depth_bins: int = 96, depth_binning: str = "linear",
                 cv_warp_impl: str = "auto", refraction_index: float = 1.5,
                 fused_encoders: bool = False):
        super().__init__()
        self.matching_ids = tuple(matching_ids)
        self.teacher = SelfSupModel(frame_ids, augment_xolp, augment_normals,
                                    dropout_rate, scales, refraction_index,
                                    fused_encoders)
        self.encoder = CostVolumeEncoder(num_depth_bins, depth_binning,
                                         cv_warp_impl)
        self.depth = DepthDecoder(tuple(scales))

    @classmethod
    def from_config(cls, cfg: Config, **over) -> "StudentModel":
        kw = dict(frame_ids=tuple(cfg.frame_ids),
                  matching_ids=cfg.matching_ids,
                  augment_xolp=cfg.augment_xolp,
                  augment_normals=cfg.augment_normals,
                  dropout_rate=cfg.dropout_rate, scales=tuple(cfg.scales),
                  num_depth_bins=cfg.num_depth_bins,
                  depth_binning=cfg.depth_binning,
                  cv_warp_impl=cfg.cv_warp_impl,
                  refraction_index=cfg.refraction_index,
                  fused_encoders=cfg.fused_encoders)
        kw.update(over)
        return cls(**kw)

    def forward(self, color_frames: torch.Tensor,
                pol: Optional[torch.Tensor], lookup_frames: torch.Tensor,
                rel_poses: Optional[torch.Tensor], K_quarter: torch.Tensor,
                inv_K_quarter: torch.Tensor, min_depth_bin, max_depth_bin,
                freeze_teacher: bool = False,
                pose_zero_mask: Optional[torch.Tensor] = None):
        """color_frames (B, F, H, W, 3) in frame_ids order; lookup_frames
        (B, L, H, W, 3); rel_poses (B, L, 4, 4), or None for the teacher's
        matching poses; intrinsics at 1/4 scale; the bin endpoints.

        Returns ((teacher disps, poses), (student disps, lowest_cost,
        confidence)).  freeze_teacher runs the teacher without gradient;
        pose_zero_mask (B,) multiplies the lookup poses (the zero-pose
        matching augmentation on predicted poses, trainer.py:602-603).
        """
        grad = torch.no_grad() if freeze_teacher else contextlib.nullcontext()
        with grad:
            if rel_poses is None:
                disps, poses, matching = self.teacher(
                    color_frames, pol, self.matching_ids)
                rel_poses = torch.stack([matching[f] for f in
                                         self.matching_ids if f != 0], dim=1)
            else:
                disps, poses = self.teacher(color_frames, pol)
        if pose_zero_mask is not None:
            rel_poses = rel_poses * pose_zero_mask[:, None, None, None]
        feats, lowest_cost, confidence = self.encoder(
            color_frames[:, 0], lookup_frames, rel_poses, K_quarter,
            inv_K_quarter, min_depth_bin, max_depth_bin)
        student = {k: v.permute(0, 2, 3, 1)
                   for k, v in self.depth(feats).items()}
        return (disps, poses), (student, lowest_cost, confidence)


def matching_augmentation(u: torch.Tensor, color_frames: torch.Tensor,
                          lookup_frames: torch.Tensor,
                          rel_poses: Optional[torch.Tensor]):
    """Static-camera and zero-pose augmentation (trainer.py:587-605) from
    one uniform draw u (B,) per sample: below 0.25 the lookup frames become
    the current frame, in [0.25, 0.5) the relative poses become zero.
    Returns (lookup_frames, rel_poses, augmentation mask (B, 1, 1, 1),
    zeroed (B,))."""
    static = u < 0.25
    zeroed = (u >= 0.25) & (u < 0.5)
    cur = color_frames[:, 0:1].expand_as(lookup_frames)
    lookup = torch.where(static[:, None, None, None, None], cur,
                         lookup_frames)
    poses = None
    if rel_poses is not None:
        poses = torch.where(zeroed[:, None, None, None],
                            torch.zeros_like(rel_poses), rel_poses)
    aug_mask = (static | zeroed).to(torch.float32)[:, None, None, None]
    return lookup, poses, aug_mask, zeroed


def upsample_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, h, w, C) -> (B, H, W, C) for whole factors H/h and W/w (the cost
    volume's 1/4 resolution): the values of ops/resize.resize_nearest
    (index floor(i h / H) = i // (H / h)), by views and one copy, with no
    index tensor to copy to the card."""
    b, h, w, c = x.shape
    fh, fw = out_hw[0] // h, out_hw[1] // w
    return x[:, :, None, :, None, :].expand(b, h, fh, w, fw, c).reshape(
        b, h * fh, w * fw, c)


def compute_matching_mask(cfg: Config, lowest_cost: torch.Tensor,
                          mono_depth0: torch.Tensor) -> torch.Tensor:
    """1 where the cost volume's argmin depth lies within 100% of the
    teacher's depth both ways (trainer.py:1112-1124); lowest_cost is a
    disparity (B, h, w) at 1/4 resolution."""
    matching_depth = 1.0 / upsample_nearest(lowest_cost[..., None],
                                            (cfg.height, cfg.width))
    mono = mono_depth0.detach()
    m = ((matching_depth - mono) / mono) < 1.0
    m = m & (((mono - matching_depth) / matching_depth) < 1.0)
    return m.to(torch.float32)


def student_losses(cfg: Config, student_disps: dict, warped: dict,
                   depths: dict, mono_depths: dict,
                   consistency_mask: torch.Tensor, aug_mask: torch.Tensor,
                   batch: dict):
    """The multi-frame loss (trainer.py:1126-1296): the photometric loss on
    trusted pixels, |student depth - teacher depth| (the teacher's
    detached) on the rest, and the smoothness term; (total, logs)."""
    pyr = color_pyramid(batch["color"], cfg.scales)
    frames = [f for f in cfg.frame_ids if f != 0]
    logs = {}
    total = 0.0
    for s in cfg.scales:
        target = pyr[s if cfg.v1_multiscale else 0]
        reproj = _reduce_frames(
            [reprojection_loss(warped[("color", f, s)], target,
                               not cfg.no_ssim) for f in frames],
            cfg.avg_reprojection)
        mask = torch.ones_like(reproj)
        if not cfg.disable_motion_masking:
            cmask = consistency_mask
            if cfg.v1_multiscale and s:
                cmask = resize_nearest(cmask, reproj.shape[1:3])
            mask = mask * cmask
        if not cfg.no_matching_augmentation:
            mask = mask * (1.0 - aug_mask)
        cons_mask = 1.0 - mask
        loss_s = torch.sum(reproj * mask) / (torch.sum(mask) + 1e-7)
        logs[f"reproj_loss/{s}"] = loss_s
        consistency = torch.mean(torch.abs(
            depths[("depth", 0, s)] - mono_depths[("depth", 0, s)].detach())
            * cons_mask)
        logs[f"consistency_loss/{s}"] = consistency
        loss_s = loss_s + consistency
        disp = student_disps[("disp", s)]
        mean_disp = torch.mean(disp, dim=(1, 2), keepdim=True)
        loss_s = loss_s + cfg.disparity_smoothness * smooth_loss(
            disp / (mean_disp + 1e-7), pyr[s]) / (2 ** s)
        logs[f"loss/{s}"] = loss_s
        total = total + loss_s
    total = total / cfg.num_scales
    logs["loss"] = total
    return total, logs


def update_depth_bin_trackers(min_tracker: torch.Tensor,
                              max_tracker: torch.Tensor,
                              mono_depth0: torch.Tensor, floor: float):
    """EMA of the teacher's depth range (trainer.py:650-667), on the
    device."""
    mn = torch.mean(torch.amin(mono_depth0, dim=(1, 2, 3)))
    mx = torch.mean(torch.amax(mono_depth0, dim=(1, 2, 3)))
    mn = torch.clamp(mn * 0.9, min=floor)
    mx = mx * 1.1
    return min_tracker * 0.99 + mn * 0.01, max_tracker * 0.99 + mx * 0.01


def initial_trackers(cfg: Config, device) -> tuple:
    """(min_depth, max_depth) as 0-d float32 tensors on device."""
    return tuple(torch.full((), v, dtype=torch.float32, device=device)
                 for v in (cfg.min_depth, cfg.max_depth))


def quarter_intrinsics(K: torch.Tensor):
    """K (B, 4, 4) with its first two rows scaled by 1/4, and its inverse
    (``inv_ex``: no check on the host, so no wait for the card)."""
    K4 = torch.cat([K[:, :2] * 0.25, K[:, 2:]], dim=1)
    return K4, torch.linalg.inv_ex(K4)[0]


def _lookup(cfg: Config, x: torch.Tensor) -> torch.Tensor:
    """The lookup frames' entries of x (B, F, ...) in frame_ids order, as
    (B, L, ...): a stack of views, since indexing with a list would copy
    the indices to the card and wait for it."""
    return torch.stack([x[:, list(cfg.frame_ids).index(f)]
                        for f in cfg.matching_ids if f != 0], dim=1)


def make_student_train_step(model: StudentModel, cfg: Config,
                            freeze_teacher: bool = False):
    """The teacher + student train step on the device of model
    (polardepth_tpu/train/student.py:316-396).

    step(state, trackers, batch, generator, *, jitter=None, flip=None,
    noise=None, u=None) -> (trackers, logs): batch holds color_frames
    (B, F, H, W, 3) uint8, pol, K, inv_K (+ depth with depth_supervision,
    rel_poses with pose_input); trackers are the (min, max) depth-bin
    tensors.  generator (on the model's device) draws what is not handed
    in: the jitter factors, the flip, the matching augmentation's u (B,),
    the automask noise and dropout.  One Adam step updates state in place;
    the new trackers and the logs are tensors on the device.

    freeze_teacher: the teacher runs in eval mode without gradient, its
    loss is logged but not trained, its parameters get zero gradients (so
    Adam moves them by its first moment, as the JAX package's update of the
    whole tree does) and the trackers stay as they are.
    """
    cfg.validate()
    needs_pol = cfg.augment_xolp or cfg.augment_normals

    @float32()
    def step(state: TrainState, trackers, batch: dict,
             generator: Optional[torch.Generator] = None, *,
             jitter: Optional[dict] = None,
             flip: Optional[torch.Tensor] = None,
             noise: Optional[dict] = None,
             u: Optional[torch.Tensor] = None):
        min_bin, max_bin = trackers
        device = model_device(model)
        batch = to_device(batch, device)
        model.train()
        if freeze_teacher:
            model.teacher.eval()
        set_dropout_generator(model, generator)
        pb = preprocess_multiframe(batch, cfg, True, generator, jitter, flip)
        b = pb["color"].shape[0]
        color_frames = pb["color_frames"]          # clean: the losses
        color_aug = pb["color_frames_aug"]         # jittered: the networks
        # the lookup frames come from the jittered copy (trainer.py:491)
        lookup = _lookup(cfg, color_aug)
        rel = _lookup(cfg, pb["rel_poses"]) if cfg.pose_input else None
        pose_zero_mask = None
        if not cfg.no_matching_augmentation:
            if u is None:
                u = torch.rand(b, generator=generator,
                               device=generator.device)
            lookup, rel, aug_mask, zeroed = matching_augmentation(
                u, color_frames, lookup, rel)
            if rel is None:
                pose_zero_mask = 1.0 - zeroed.to(torch.float32)
        else:
            aug_mask = torch.zeros(b, 1, 1, 1, device=device)
        if noise is None:
            noise = draw_identity_noise(cfg, generator, b)
        K4, inv_K4 = quarter_intrinsics(pb["K"])

        state.optimizer.zero_grad(set_to_none=True)
        (disps, poses), (sdisps, lowest, conf) = model(
            color_aug, pb["pol"] if needs_pol else None, lookup, rel, K4,
            inv_K4, min_bin, max_bin, freeze_teacher=freeze_teacher,
            pose_zero_mask=pose_zero_mask)
        # the teacher's losses, on the mono path
        warped_t, depths_t = generate_images_pred(
            cfg, disps, poses, color_frames, pb["K"], pb["inv_K"])
        t_loss, t_logs = selfsup_losses(cfg, disps, warped_t, depths_t, pb,
                                        noise)
        # the student's, through the teacher's poses
        warped_s, depths_s = generate_images_pred(
            cfg, sdisps, poses, color_frames, pb["K"], pb["inv_K"])
        cons_mask = upsample_nearest(conf[..., None], (cfg.height, cfg.width))
        if not cfg.disable_motion_masking:
            cons_mask = cons_mask * compute_matching_mask(
                cfg, lowest, depths_t[("depth", 0, 0)])
        s_loss, s_logs = student_losses(cfg, sdisps, warped_s, depths_s,
                                        depths_t, cons_mask, aug_mask, pb)
        loss = s_loss if freeze_teacher else s_loss + t_loss
        logs = {f"mono_{k}": v for k, v in t_logs.items()}
        logs.update(s_logs)
        logs["loss"] = loss
        loss.backward()
        for p in model.parameters():
            if p.grad is None:           # the JAX gradient of an unused leaf
                p.grad = torch.zeros_like(p)
        apply_gradients(state)
        if not freeze_teacher:
            trackers = update_depth_bin_trackers(
                min_bin, max_bin, depths_t[("depth", 0, 0)].detach(),
                cfg.min_depth)
        return trackers, {k: v.detach() for k, v in logs.items()}

    return step


def make_student_infer_step(model: StudentModel, cfg: Config):
    """step(trackers, batch) -> the student's depth (B, H, W, 1), clipped
    to [min_depth, max_depth], in eval mode (polardepth_tpu/train/
    student.py:399-424): lookup frames through the dataset's poses with
    pose_input, else through the teacher's matching poses.  Puts the model
    in eval mode."""
    needs_pol = cfg.augment_xolp or cfg.augment_normals
    model.eval()

    @float32()
    def step(trackers, batch: dict) -> torch.Tensor:
        model.eval()
        batch = to_device(batch, model_device(model))
        with torch.inference_mode():
            pb = preprocess_multiframe(batch, cfg, train=False)
            color_frames = pb["color_frames"]
            rel = _lookup(cfg, pb["rel_poses"]) if cfg.pose_input else None
            K4, inv_K4 = quarter_intrinsics(pb["K"])
            _, (sdisps, _, _) = model(
                color_frames, pb["pol"] if needs_pol else None,
                _lookup(cfg, color_frames), rel, K4, inv_K4, *trackers)
            _, depth = disp_to_depth(sdisps[("disp", 0)], cfg.min_depth,
                                     cfg.max_depth)
            return torch.clamp(depth, cfg.min_depth, cfg.max_depth)

    return step
