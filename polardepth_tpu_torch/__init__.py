"""polardepth_tpu_torch: the PyTorch and CUDA port of polardepth_tpu.

It serves the published tri-encoder depth network from uint8 captures to
metric depth on an NVIDIA H100 (train/trainer.py:Predictor), and trains it
with the published supervised step (train/trainer.py:make_train_step) or the
self-supervised step with optional depth supervision
(train/selfsup.py:make_selfsup_train_step).  The published supervised run
goes end to end through ``python -m polardepth_tpu_torch train|evaluate``
(cli.py): train/trainer.py:Trainer with per-material evaluation
(eval/evaluation.py), synthetic or HAMMER data (data/) and checkpoints
(train/checkpoint.py).  Tensor code is PyTorch; the
polarization preprocess (csrc/polar_preprocess.cu) and the band warp of the
reprojection loss and its grid gradient (csrc/band_warp.cu) are hand-written
CUDA kernels, each with a plain torch version beside it.  The package
imports torch, numpy and scipy only.
"""
