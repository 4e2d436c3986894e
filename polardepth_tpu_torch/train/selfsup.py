"""The self-supervised (pose + reprojection) train step, optionally with depth
supervision (polardepth_tpu/train/selfsup.py; reference trainer.py:669-750,
983-1067, 1069-1296).

The depth net predicts disparity for frame 0, the pose net a transform to
each neighbour frame; ``generate_images_pred`` warps every neighbour into
frame 0 at every scale through ops/warp.grid_sample (with "auto", the banded
warp kernels K2 and, in the backward pass, K3), and ``selfsup_losses`` adds
the Monodepth2 photometric loss with automasking, the supervised depth and
normals terms when ``depth_supervision``, and the smoothness term.  With
``res_pose`` the step adds ``residual_reprojection_loss``: the pose net's
residual poses from each warped source and frame 0, and the warped source
warped again through them.  That second warp's image carries a gradient
through depth and pose, which the band warp gives through kernel K4.

Random draws (colour jitter, flip, dropout, the automask tie-break noise and
the residual pass's) come from an explicit ``torch.Generator`` on the
model's device; a caller may hand any of them in instead, as the tests do
with the JAX package's draws.  With ``matching_ids`` the model also gives
the cost volume's lookup poses (train/student.py).  Not ported: the packed
photometric form (a TPU layout).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from polardepth_tpu_torch.config import Config
from polardepth_tpu_torch.data.augment import (
    color_jitter_apply, color_jitter_factors, draw_flip,
    random_horizontal_flip)
from polardepth_tpu_torch.models.layers import set_dropout_generator
from polardepth_tpu_torch.models.network import PolarDepthNet
from polardepth_tpu_torch.models.pose import PoseDecoder
from polardepth_tpu_torch.models.resnet import ResNet18Encoder
from polardepth_tpu_torch.ops.camera import (
    backproject_depth, project_3d, scale_intrinsics)
from polardepth_tpu_torch.ops.depth import disp_to_depth
from polardepth_tpu_torch.ops.losses import reprojection_loss
from polardepth_tpu_torch.ops.resize import resize_antialias, resize_bilinear
from polardepth_tpu_torch.ops.se3 import (
    rotmat_to_rotvec, transformation_from_parameters)
from polardepth_tpu_torch.ops.warp import grid_sample
from polardepth_tpu_torch.train.losses import (
    color_pyramid, smoothness_term, supervised_scale_terms)
from polardepth_tpu_torch.train.state import TrainState, apply_gradients
from polardepth_tpu_torch.utils.precision import float32


def color_jitter_frames(frames: torch.Tensor, factors: dict) -> torch.Tensor:
    """Jitter (B, F, H, W, 3) with one factor draw per sample shared by its
    frames (the reference builds one ColorJitter per item,
    indoor_dataset.py:402-407)."""
    return torch.stack([color_jitter_apply(frames[:, i], factors)
                        for i in range(frames.shape[1])], dim=1)


def _resize_frames(frames: torch.Tensor, hw) -> torch.Tensor:
    b, f = frames.shape[:2]
    out = resize_antialias(frames.reshape(b * f, *frames.shape[2:]), hw)
    return out.reshape(b, f, *out.shape[1:])


def preprocess_multiframe(batch: dict, cfg: Config, train: bool = True,
                          generator: Optional[torch.Generator] = None,
                          jitter: Optional[dict] = None,
                          flip: Optional[torch.Tensor] = None) -> dict:
    """Raw multi-frame batch (uint8, any resolution) -> float tensors at the
    working resolution, and the colour-jittered copy the networks read
    (the losses read the clean frames, reference trainer.py:497).  In train
    mode the jitter factors (and, with random_flip, the flip) are drawn from
    generator unless given."""
    h, w = cfg.height, cfg.width
    cf = batch["color_frames"].float() / 255.0
    if tuple(cf.shape[2:4]) != (h, w):
        cf = _resize_frames(cf, (h, w))
    pb = {"color_frames": cf, "K": batch["K"], "inv_K": batch["inv_K"]}
    if "pol" in batch:
        pol = batch["pol"].float()            # the 0..255 scale of XOLP
        if tuple(pol.shape[1:3]) != (h, w):
            pol = resize_antialias(pol, (h, w))
        pb["pol"] = pol
    if "depth" in batch:
        d = batch["depth"].float()
        if tuple(d.shape[1:3]) != (h, w):
            d = resize_bilinear(d, (h, w))
        pb["depth"] = d
    if train and jitter is None:
        jitter = color_jitter_factors(generator, cf.shape[0])
    if train and cfg.random_flip:
        if flip is None:
            flip = draw_flip(generator, cf.shape[0])
        pb = random_horizontal_flip(pb, flip)
    pb["color"] = pb["color_frames"][:, 0]
    pb["color_frames_aug"] = (color_jitter_frames(pb["color_frames"], jitter)
                              if train else pb["color_frames"])
    if "rel_poses" in batch:
        pb["rel_poses"] = batch["rel_poses"]
    return pb


def frames_pyramid(color_frames: torch.Tensor, scales,
                   v1_multiscale: bool) -> dict:
    """{s: (B, F, H/2^s, W/2^s, 3)} source frames; only scale 0 unless
    v1_multiscale (reference trainer.py:1140-1145)."""
    pyr = {0: color_frames}
    if v1_multiscale:
        _, _, h, w, _ = color_frames.shape
        for s in scales:
            if s:
                pyr[s] = _resize_frames(color_frames,
                                        (h // 2 ** s, w // 2 ** s))
    return pyr


class PoseNet(nn.Module):
    """ResNet18 over two stacked frames + PoseDecoder; the children carry
    the reference's component names (pose_encoder, pose)."""

    def __init__(self):
        super().__init__()
        self.pose_encoder = ResNet18Encoder(num_input_images=2)
        self.pose = PoseDecoder(512, 2)

    def forward(self, frame_a: torch.Tensor, frame_b: torch.Tensor):
        """Two (B, H, W, 3) frames -> (axisangle, translation), each
        (B, 2, 1, 3)."""
        x = torch.cat([frame_a, frame_b], dim=-1).permute(0, 3, 1, 2)
        return self.pose(self.pose_encoder(x))


class SelfSupModel(nn.Module):
    """Depth net (``mono``) + pose net (``pose_net``) over a frame stack in
    frame_ids order, frame 0 first."""

    def __init__(self, frame_ids: Sequence[int] = (0, -1, 1),
                 augment_xolp: bool = True, augment_normals: bool = True,
                 dropout_rate: float = 0.1,
                 scales: Sequence[int] = (0, 1, 2, 3),
                 refraction_index: float = 1.5, fused_encoders: bool = False):
        super().__init__()
        self.frame_ids = tuple(frame_ids)
        self.mono = PolarDepthNet(
            augment_xolp, augment_normals, dropout_rate, scales,
            refraction_index,
            fused_encoders=fused_encoders and augment_xolp and augment_normals)
        self.pose_net = PoseNet()

    @classmethod
    def from_config(cls, cfg: Config) -> "SelfSupModel":
        return cls(tuple(cfg.frame_ids), cfg.augment_xolp,
                   cfg.augment_normals, cfg.dropout_rate, tuple(cfg.scales),
                   cfg.refraction_index, cfg.fused_encoders)

    def forward(self, color_frames: torch.Tensor,
                pol: Optional[torch.Tensor] = None, matching_ids=None):
        """color_frames (B, F, H, W, 3) -> (disps {("disp", s)}, poses
        {frame_id: T (B, 4, 4)}), T from the pair in temporal order,
        inverted for past frames (reference trainer.py:696-706).

        With matching_ids (e.g. (0, -1)) also returns the cost volume's
        lookup poses {frame_id: T}, chained without gradient along
        consecutive pairs by the same pose net (the reference's
        pose_input=False path, trainer.py:708-746); poses[-1] is reused for
        frame -1, and a blank frame gets a zero pose."""
        disps = self.mono(color_frames[:, 0], pol=pol)
        poses = {}
        for i, f in enumerate(self.frame_ids):
            if f == 0:
                continue
            if f < 0:
                aa, t = self.pose_net(color_frames[:, i], color_frames[:, 0])
            else:
                aa, t = self.pose_net(color_frames[:, 0], color_frames[:, i])
            poses[f] = transformation_from_parameters(aa[:, 0], t[:, 0],
                                                      invert=f < 0)
        if matching_ids is None:
            return disps, poses
        reuse = {-1: poses[-1]} if -1 in poses else {}
        return disps, poses, matching_poses(
            self.pose_net, color_frames, self.frame_ids, matching_ids, reuse)


def matching_poses(pose_net: nn.Module, color_frames: torch.Tensor,
                   frame_ids: Sequence[int], matching_ids: Sequence[int],
                   reuse: Optional[dict] = None) -> dict:
    """{fi: T (B, 4, 4)} for each nonzero fi of matching_ids, without
    gradient (polardepth_tpu/train/selfsup.py:206-239): a past frame's pose
    from the pair (frame fi, frame fi + 1) inverted, a future frame's from
    (frame fi - 1, frame fi), each composed with its neighbour's towards
    frame 0; a frame whose pixels are all 0 gets the zero pose.  reuse
    holds poses already predicted for a frame id (the pair of frame -1 is
    the self-supervised pose's own).  The pose net's BatchNorm runs in its
    module's mode."""
    idx_of = {f: i for i, f in enumerate(frame_ids)}
    reuse = reuse or {}
    rel = {}
    with torch.no_grad():
        for fi in matching_ids:
            if fi == 0:
                continue
            if fi < 0:
                if fi in reuse:
                    pose = reuse[fi].detach()
                else:
                    aa, t = pose_net(color_frames[:, idx_of[fi]],
                                     color_frames[:, idx_of[fi + 1]])
                    pose = transformation_from_parameters(aa[:, 0], t[:, 0],
                                                          invert=True)
                if fi != -1:
                    pose = torch.einsum("bij,bjk->bik", pose, rel[fi + 1])
            else:
                aa, t = pose_net(color_frames[:, idx_of[fi - 1]],
                                 color_frames[:, idx_of[fi]])
                pose = transformation_from_parameters(aa[:, 0], t[:, 0],
                                                      invert=False)
                if fi != 1:
                    pose = torch.einsum("bij,bjk->bik", pose, rel[fi - 1])
            valid = (torch.sum(torch.abs(color_frames[:, idx_of[fi]]),
                               dim=(1, 2, 3)) > 0).to(pose.dtype)
            rel[fi] = pose * valid[:, None, None]
    return rel


class MatchingPoseNet(nn.Module):
    """A pose net of its own that gives only the lookup poses
    (polardepth_tpu/train/selfsup.py:242-279; ``matching_poses`` without
    reuse)."""

    def __init__(self):
        super().__init__()
        self.pose_net = PoseNet()

    def forward(self, color_frames: torch.Tensor, frame_ids: Sequence[int],
                matching_ids: Sequence[int]) -> dict:
        return matching_poses(self.pose_net, color_frames, frame_ids,
                              matching_ids)


def predict_residual_poses(pose_net, cfg: Config, warped: dict,
                           color0: torch.Tensor) -> dict:
    """{frame_id: residual T (B, 4, 4)} from pose_net (a PoseNet, or any
    callable of two frames) on each [warped source, frame 0] pair in
    temporal order, inverted for past frames
    (polardepth_tpu/train/selfsup.py:283-302)."""
    res = {}
    for f in cfg.frame_ids:
        if f == 0:
            continue
        w = warped[("color", f, 0)]
        aa, t = pose_net(w, color0) if f < 0 else pose_net(color0, w)
        res[f] = transformation_from_parameters(aa[:, 0], t[:, 0],
                                                invert=f < 0)
    return res


def generate_images_pred(cfg: Config, disps: dict, poses: dict,
                         color_frames: torch.Tensor, K: torch.Tensor,
                         inv_K: torch.Tensor):
    """Warp each source frame into frame 0 through the predicted depth and
    pose at every scale (border padding, align_corners=True; reference
    trainer.py:983-1067) -> ({("color", f, s)}, {("depth", 0, s)}).

    color_frames (B, F, H, W, 3) are the clean frames in [0, 1]."""
    h, w = cfg.height, cfg.width
    warped, depths = {}, {}
    pyr = frames_pyramid(color_frames.float(), cfg.scales, cfg.v1_multiscale)
    # one contiguous image per source frame and pyramid level, as the warp
    # kernels take them
    src = {s: {i: p[:, i].contiguous()
               for i, f in enumerate(cfg.frame_ids) if f}
           for s, p in pyr.items()}
    for s in cfg.scales:
        disp = disps[("disp", s)]
        if cfg.v1_multiscale:
            hs, ws = h // 2 ** s, w // 2 ** s
            Ks = scale_intrinsics(K, 2.0 ** -s)
            inv_Ks = torch.linalg.inv(Ks)
            src_s = src[s]
        else:
            hs, ws = h, w
            Ks, inv_Ks = K, inv_K
            disp = resize_bilinear(disp, (h, w)) if s else disp
            src_s = src[0]
        _, depth = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        depths[("depth", 0, s)] = depth
        points = backproject_depth(depth, inv_Ks)
        for i, f in enumerate(cfg.frame_ids):
            if f == 0:
                continue
            grid = project_3d(points, Ks, poses[f], hs, ws)
            warped[("color", f, s)] = grid_sample(
                src_s[i], grid, padding_mode="border", align_corners=True,
                impl=cfg.warp_impl)
    return warped, depths


def _reduce_frames(per_frame, avg: bool) -> torch.Tensor:
    """Min over the source frames (mean with avg_reprojection); amin splits
    the gradient at ties as jnp.min does."""
    stacked = torch.cat(per_frame, dim=-1)
    if avg:
        return torch.mean(stacked, dim=-1, keepdim=True)
    return torch.amin(stacked, dim=-1, keepdim=True)


def draw_identity_noise(cfg: Config, generator: torch.Generator,
                        batch: int) -> dict:
    """{s: standard normals (B, H/2^s, W/2^s, 1)} for the automask's
    tie-break, at scale 0 (at every scale with v1_multiscale)."""
    if cfg.disable_automasking:
        return {}
    scales = tuple(cfg.scales) if cfg.v1_multiscale else (0,)
    return {s: torch.randn(batch, cfg.height // 2 ** s, cfg.width // 2 ** s,
                           1, generator=generator, device=generator.device)
            for s in scales}


def draw_residual_noise(cfg: Config, generator: torch.Generator,
                        batch: int) -> dict:
    """{frame_id: standard normals (B, H, W, 1)} for the residual pass's
    automask tie-break, one draw per source frame."""
    return {f: torch.randn(batch, cfg.height, cfg.width, 1,
                           generator=generator, device=generator.device)
            for f in cfg.frame_ids if f != 0}


def residual_reprojection_loss(cfg: Config, pose_net: nn.Module,
                               pose_stats: dict, warped: dict, depths: dict,
                               color0: torch.Tensor, K: torch.Tensor,
                               inv_K: torch.Tensor,
                               noise: dict) -> torch.Tensor:
    """The res_pose refinement loss (polardepth_tpu/train/selfsup.py:530-577;
    reference trainer.py:548-565, 1158-1165, 1238-1239): the residual pose
    of each warped source and frame 0 from the same pose net, the warped
    source warped again through it with frame 0's depth, and the mean of
    min over frames of min(reprojection of the re-warp, reprojection of the
    warped source + noise x 1e-5).

    The pose net runs in eval mode on pose_stats, its BatchNorm statistics
    from before the step's forward (the JAX package's state.batch_stats),
    with its live parameters, so that the loss reaches them.  noise holds
    each source frame's standard normals (``draw_residual_noise``)."""
    h, w = cfg.height, cfg.width
    use_ssim = not cfg.no_ssim
    was_training = pose_net.training
    pose_net.eval()
    try:
        res = predict_residual_poses(
            lambda a, b: functional_call(pose_net, pose_stats, (a, b)), cfg,
            warped, color0)
    finally:
        pose_net.train(was_training)
    points = backproject_depth(depths[("depth", 0, 0)], inv_K)
    losses = []
    for f in cfg.frame_ids:
        if f == 0:
            continue
        src = warped[("color", f, 0)]
        re_warped = grid_sample(src, project_3d(points, K, res[f], h, w),
                                padding_mode="border", align_corners=True,
                                impl=cfg.warp_impl)
        pair = torch.cat(
            [reprojection_loss(re_warped, color0, use_ssim),
             reprojection_loss(src, color0, use_ssim) + noise[f] * 1e-5],
            dim=-1)
        losses.append(torch.amin(pair, dim=-1, keepdim=True))
    return torch.mean(torch.amin(torch.cat(losses, dim=-1), dim=-1))


def selfsup_losses(cfg: Config, disps: dict, warped: dict, depths: dict,
                   batch: dict, noise: dict):
    """Monodepth2 loss with automasking (reference trainer.py:1126-1296),
    plus the supervised depth and normals terms when depth_supervision.
    noise holds the automask's standard normals by scale
    (``draw_identity_noise``); they enter times 1e-5."""
    pyr = color_pyramid(batch["color"], cfg.scales)
    src_pyr = frames_pyramid(batch["color_frames"], cfg.scales,
                             cfg.v1_multiscale)
    frames = [f for f in cfg.frame_ids if f != 0]
    frame_idx = {f: i for i, f in enumerate(cfg.frame_ids)}
    use_ssim = not cfg.no_ssim

    def identity_at(s: int):
        per_frame = [reprojection_loss(src_pyr[s][:, frame_idx[f]], pyr[s],
                                       use_ssim) for f in frames]
        return (_reduce_frames(per_frame, cfg.avg_reprojection)
                + noise[s] * 1e-5)

    identity0 = None if cfg.disable_automasking or cfg.v1_multiscale \
        else identity_at(0)
    logs = {}
    total = 0.0
    for s in cfg.scales:
        target = pyr[s if cfg.v1_multiscale else 0]
        reproj = _reduce_frames(
            [reprojection_loss(warped[("color", f, s)], target, use_ssim)
             for f in frames], cfg.avg_reprojection)
        if cfg.disable_automasking:
            mask = torch.ones_like(reproj)
        else:
            identity = identity0 if identity0 is not None else identity_at(s)
            mask = (reproj < identity).float()
        loss_s = torch.sum(reproj * mask) / (torch.sum(mask) + 1e-7)
        logs[f"reproj_loss/{s}"] = loss_s
        if cfg.depth_supervision:
            l_dep, l_nrm = supervised_scale_terms(
                cfg, depths[("depth", 0, s)], batch["depth"], batch["K"], s)
            logs[f"supervised_depth_loss/{s}"] = l_dep
            loss_s = loss_s + l_dep + cfg.normals_loss_weight * l_nrm
        l_sm = smoothness_term(disps[("disp", s)], pyr[s])
        loss_s = loss_s + cfg.disparity_smoothness * l_sm / (2 ** s)
        logs[f"loss/{s}"] = loss_s
        total = total + loss_s
    total = total / cfg.num_scales
    logs["loss"] = total
    return total, logs


def pose_supervision_loss(poses: dict, rel_poses: torch.Tensor,
                          frame_ids: Sequence[int]):
    """(0.1 x mean |rotvec diff|^2, mean |t diff|^2) against the ground-truth
    relative poses (reference trainer.py:1267-1285)."""
    r_loss = 0.0
    t_loss = 0.0
    for i, f in enumerate(frame_ids):
        if f == 0:
            continue
        T_pred, T_gt = poses[f], rel_poses[:, i]
        r_pred = rotmat_to_rotvec(T_pred[:, :3, :3])
        r_gt = rotmat_to_rotvec(T_gt[:, :3, :3])
        r_loss = r_loss + 0.1 * torch.mean((r_pred - r_gt) ** 2)
        t_loss = t_loss + torch.mean((T_pred[:, :3, 3] - T_gt[:, :3, 3]) ** 2)
    return r_loss, t_loss


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def to_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays as tensors on device (numpy arrays are copied
    there; tensors already there are left as they are)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_selfsup_train_step(model: SelfSupModel, cfg: Config):
    """The self-supervised train step on the device of model.

    step(state, batch, generator, *, jitter=None, flip=None, noise=None,
    res_noise=None) -> logs: batch holds color_frames (B, F, H, W, 3)
    uint8, pol, K, inv_K (+ depth with depth_supervision, rel_poses with
    supervise_pose); generator (on the model's device) draws what is not
    handed in: the jitter factors (``color_jitter_factors``), the flip, the
    automask noise (``draw_identity_noise``), with res_pose the residual
    pass's noise (``draw_residual_noise``), and dropout.  One Adam step
    updates state in place; the gradients stay on the parameters.  The logs
    are detached tensors on the device.
    """
    cfg.validate()
    needs_pol = cfg.augment_xolp or cfg.augment_normals

    @float32()
    def step(state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None, *,
             jitter: Optional[dict] = None,
             flip: Optional[torch.Tensor] = None,
             noise: Optional[dict] = None,
             res_noise: Optional[dict] = None) -> dict:
        device = model_device(model)
        batch = to_device(batch, device)
        model.train()
        set_dropout_generator(model, generator)
        pb = preprocess_multiframe(batch, cfg, True, generator, jitter, flip)
        b = pb["color"].shape[0]
        if noise is None:
            noise = draw_identity_noise(cfg, generator, b)
        if cfg.res_pose:
            if res_noise is None:
                res_noise = draw_residual_noise(cfg, generator, b)
            # the train-mode forward below moves the running statistics
            pose_stats = {k: v.clone()
                          for k, v in model.pose_net.named_buffers()}
        state.optimizer.zero_grad(set_to_none=True)
        disps, poses = model(pb["color_frames_aug"],
                             pol=pb["pol"] if needs_pol else None)
        warped, depths = generate_images_pred(
            cfg, disps, poses, pb["color_frames"], pb["K"], batch["inv_K"])
        loss, logs = selfsup_losses(cfg, disps, warped, depths, pb, noise)
        if cfg.res_pose:
            res_loss = residual_reprojection_loss(
                cfg, model.pose_net, pose_stats, warped, depths, pb["color"],
                batch["K"], batch["inv_K"], res_noise)
            loss = loss + res_loss
            logs["res_pose_loss"] = res_loss
            logs["loss"] = loss
        if cfg.supervise_pose:
            r_loss, t_loss = pose_supervision_loss(poses, batch["rel_poses"],
                                                   cfg.frame_ids)
            loss = loss + r_loss + t_loss
            logs["r_loss"] = r_loss
            logs["t_loss"] = t_loss
            logs["loss"] = loss
        loss.backward()
        apply_gradients(state)
        return {k: v.detach() for k, v in logs.items()}

    return step


def make_selfsup_infer_step(model: SelfSupModel, cfg: Config):
    """Depth (B, H, W, 1) in [min_depth, max_depth] from the mono depth net
    of the self-supervised model, in eval mode.  Puts the model in eval
    mode."""
    needs_pol = cfg.augment_xolp or cfg.augment_normals
    model.eval()

    @float32()
    def step(batch: dict) -> torch.Tensor:
        batch = to_device(batch, model_device(model))
        with torch.inference_mode():
            pb = preprocess_multiframe(batch, cfg, train=False)
            disps = model.mono(pb["color_frames"][:, 0],
                               pol=pb["pol"] if needs_pol else None)
            _, depth = disp_to_depth(disps[("disp", 0)], cfg.min_depth,
                                     cfg.max_depth)
            return torch.clamp(depth, cfg.min_depth, cfg.max_depth)

    return step
