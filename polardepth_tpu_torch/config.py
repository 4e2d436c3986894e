"""The configuration fields that the serving path, the training steps, the
training loop and the command line read.

A copy of part of the JAX package's ``Config`` dataclass
(polardepth_tpu/config.py:18-281, matching_ids :240-248, validation
:272-288, JSON :253-266) and of its named configurations
(polardepth_tpu/config.py:290-298).  The port keeps its own copy so that it
imports nothing of the JAX package.  Field
names and defaults are those of the reference's flags
(manydepth/options.py); the defaults reproduce the published run,
train_supervised_GT.sh.  Fields of paths this package does not port yet
(DPT, parallelism, TPU layout plans) are left out and come with their
slice.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Config:
    # paths
    data_path: str = ""
    data_path_val: str = ""
    log_dir: str = "experiments"
    model_name: str = "polardepth"

    # image geometry
    height: int = 320            # must be a multiple of 32
    width: int = 480
    scales: Sequence[int] = (0, 1, 2, 3)
    min_depth: float = 0.1
    max_depth: float = 2.0

    # dataset
    dataset: str = "HAMMER"
    split: str = "HAMMER"
    eval_split: str = "HAMMER_unseen"
    # temporal neighbours of the self-supervised path, frame 0 first
    frame_ids: Sequence[int] = (0, -1, 1)
    offset: int = 10             # temporal neighbour spacing in frames
    modality: str = "polarization"
    depth_modality: str = "_gt"  # folder suffix holding supervision depth
    overfit: bool = False
    overfit_scene: str = ""

    # model graph selection
    depth_supervision: bool = True
    depth_supervision_only: bool = True
    train_student: bool = False      # ManyDepth cost-volume student path
    # the cost volume's lookup poses: the dataset's relative poses instead
    # of the teacher's pose net
    pose_input: bool = False
    supervise_pose: bool = False
    # residual-pose refinement pass of the self-supervised step
    res_pose: bool = False
    # arch1++_attention: cross-modal attention between the RGB stem and the
    # JointEncoder of the supervised net (models/attention.py).
    # attention_pe_in_stream is the legacy integration (the position
    # encoding stays in the fused features); attention_gate scales the
    # attention's delta by a learnable gamma (init 0.1)
    use_attention: bool = False
    attention_pe_in_stream: bool = False
    attention_gate: bool = True
    augment_xolp: bool = True
    augment_normals: bool = True
    # the depth encoder reads the four captures, each replicated to 3
    # channels, instead of the RGB frame (train/losses.twelve_channel_input)
    enable_12channels: bool = False
    dropout_rate: float = 0.1
    # "pretrained" grafts the torchvision ResNet18 .npz at
    # pretrained_weights_path into every ResNet18 encoder
    # (train/pretrained.py)
    weights_init: str = "scratch"
    pretrained_weights_path: str = ""
    refraction_index: float = 1.5    # n of the Fresnel normal priors
    # the XOLP and normals encoders run as one groups=2 stack at 128
    # channels; needs augment_xolp and augment_normals (ignored otherwise)
    fused_encoders: bool = True
    # 50% per-sample horizontal flip in training (off for HAMMER, whose
    # dataset hardwires do_flip=False)
    random_flip: bool = False

    # losses
    normals_loss_weight: float = 0.35
    disparity_smoothness: float = 1e-3
    no_ssim: bool = False
    avg_reprojection: bool = False
    disable_automasking: bool = False
    v1_multiscale: bool = False
    # grid_sample route of the reprojection warps (ops/warp.py): "auto" is
    # the banded warp kernel, "flat4" / "patch" the plain gather forms
    warp_impl: str = "auto"

    # cost volume (student path, polardepth_tpu/config.py:88-96)
    num_depth_bins: int = 96
    depth_binning: str = "linear"    # "linear" | "inverse"
    num_matching_frames: int = 1
    use_future_frame: bool = False
    # matching augmentation is on, as in the reference (its flag is
    # store_true default-False, options.py:278-281)
    no_matching_augmentation: bool = False
    disable_motion_masking: bool = False
    freeze_teacher_epoch: int = -1   # -1: the teacher never freezes
    # plane-sweep sampler (models/cost_volume.py): "auto" is the banded warp
    # kernel with an 8-row band ("pallas8_fast"), "xla" the exact 4-corner
    # gather with zeros padding
    cv_warp_impl: str = "auto"

    # optimization
    batch_size: int = 12
    learning_rate: float = 1e-4
    num_epochs: int = 50
    scheduler_step_size: int = 15    # StepLR: lr *= gamma every N epochs
    scheduler_gamma: float = 0.1

    # logging and checkpoints
    log_frequency: int = 250
    save_frequency: int = 1
    checkpoint_dir: str = ""

    # flip-averaged prediction (Monodepth2 post-processing)
    post_process: bool = False

    # host PNG decode: "cv2" is the only backend of the port (the JAX
    # package's "native" libpng decoder is not ported, and its "auto" falls
    # back silently, which the port does not do)
    decode_backend: str = "cv2"
    # decoded-sample host RAM cache (GB; 0 disables): samples are raw
    # uint8/uint16 and every augmentation runs on the device, so caching is
    # exact and epochs 2+ skip the decode
    host_cache_gb: float = 8.0
    seed: int = 42

    @property
    def num_scales(self) -> int:
        return len(self.scales)

    @property
    def matching_ids(self) -> tuple:
        """Cost-volume lookup frame ids (reference trainer.py:131-135):
        [0] + ([1] if use_future_frame) + [-1 .. -num_matching_frames]."""
        ids = [0]
        if self.use_future_frame:
            ids.append(1)
        ids += list(range(-1, -1 - self.num_matching_frames, -1))
        return tuple(ids)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["scales"] = list(self.scales)
        d["frame_ids"] = list(self.frame_ids)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        for k in ("scales", "frame_ids"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)

    def validate(self) -> None:
        if self.weights_init not in ("scratch", "pretrained"):
            raise ValueError(f"weights_init must be 'scratch' or 'pretrained'"
                             f" (got {self.weights_init!r})")
        if self.height % 32 or self.width % 32:
            raise ValueError("height and width must be multiples of 32 "
                             f"(got {self.height}x{self.width})")
        if self.depth_supervision_only and not self.depth_supervision:
            raise ValueError(
                "depth_supervision_only requires depth_supervision")
        if self.train_student:
            missing = [f for f in self.matching_ids
                       if f not in tuple(self.frame_ids)]
            if missing:
                raise ValueError(
                    f"matching frame ids {missing} (num_matching_frames="
                    f"{self.num_matching_frames}, use_future_frame="
                    f"{self.use_future_frame}) not in frame_ids "
                    f"{tuple(self.frame_ids)}")


# The published configuration (reference: train_supervised_GT.sh).
PUBLISHED = Config()

# Ablation graphs of the reference's final presentation.
RGB_ONLY = Config(augment_xolp=False, augment_normals=False,
                  model_name="ABLATIONS_rgb")
RGB_XOLP = Config(augment_normals=False, model_name="ABLATIONS_rgb_xolp")
RGB_NORMALS = Config(augment_xolp=False, model_name="ABLATIONS_rgb_normals")
TRI_ENCODER = Config(model_name="ABLATIONS_rgb_xolp_normals")
