"""polardepth_tpu_torch: the PyTorch and CUDA port of polardepth_tpu.

It serves the published tri-encoder depth network from uint8 captures to
metric depth on an NVIDIA H100 (train/trainer.py:Predictor).  Tensor code is
PyTorch; the polarization preprocess is a hand-written CUDA kernel
(csrc/polar_preprocess.cu) with a plain torch version beside it
(ops/polar_preprocess.py).  The package imports torch, numpy and scipy only.
"""
