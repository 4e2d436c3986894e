"""The configuration fields that the serving path reads.

A copy of part of the JAX package's ``Config`` dataclass
(polardepth_tpu/config.py:18-281) and of its named configurations
(polardepth_tpu/config.py:290-298).  The port keeps its own copy so that it
imports nothing of the JAX package.  Field names and defaults are those of the
reference's flags (manydepth/options.py); the defaults reproduce the published
run, train_supervised_GT.sh.  Fields of paths this package does not port yet
(self-supervised, teacher-student, DPT, training and its supervision and
initialisation switches) are left out and come with their slice.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Config:
    # image geometry
    height: int = 320            # must be a multiple of 32
    width: int = 480
    scales: Sequence[int] = (0, 1, 2, 3)
    min_depth: float = 0.1
    max_depth: float = 2.0

    # model graph selection
    augment_xolp: bool = True
    augment_normals: bool = True
    # the depth encoder reads the four captures, each replicated to 3
    # channels, instead of the RGB frame (train/losses.twelve_channel_input)
    enable_12channels: bool = False
    dropout_rate: float = 0.1
    refraction_index: float = 1.5    # n of the Fresnel normal priors
    # the XOLP and normals encoders run as one groups=2 stack at 128
    # channels; needs augment_xolp and augment_normals (ignored otherwise)
    fused_encoders: bool = True

    # serving
    batch_size: int = 12
    # flip-averaged prediction (Monodepth2 post-processing)
    post_process: bool = False

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.height % 32 or self.width % 32:
            raise ValueError("height and width must be multiples of 32 "
                             f"(got {self.height}x{self.width})")


# The published configuration (reference: train_supervised_GT.sh).
PUBLISHED = Config()

# Ablation graphs of the reference's final presentation.
RGB_ONLY = Config(augment_xolp=False, augment_normals=False)
RGB_XOLP = Config(augment_normals=False)
RGB_NORMALS = Config(augment_xolp=False)
TRI_ENCODER = PUBLISHED
