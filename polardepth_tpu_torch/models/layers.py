"""Convolutional building blocks (polardepth_tpu/models/layers.py).

Modules compute on (B, C, H, W) tensors.  Submodules carry the names the JAX
package's flax modules give their parameters (``Conv_0``, ``BatchNorm_0``,
``TorchConv_0``, ...), so that models/convert.py maps a flax parameter path to
a ``state_dict`` key by joining it with dots.

torch's ``nn.Conv2d`` default initialisation is the one the JAX package's
``TorchConv`` reproduces.  ``BatchNorm`` has the semantics of its
``_batch_norm`` (flax ``BatchNorm``, eps 1e-5, momentum 0.1 in torch's
convention) in both modes, and ``Dropout`` those of flax's ``Dropout``.  The
JAX package's ``_DenseExpandConv`` executes a grouped conv as a
block-diagonal dense one, a TPU execution plan; here the same parameters run
as a ``groups=2`` conv.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates the running statistics as
    flax's ``BatchNorm(momentum=0.9)`` does (models/layers.py:183-192 of the
    JAX package): with the *biased* batch variance, where torch's own
    module takes the unbiased one.  The normalisation itself is the same in
    both (biased batch variance in train mode, running statistics in eval
    mode)."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                             self.eps)


def batch_norm(channels: int) -> BatchNorm:
    return BatchNorm(channels, eps=1e-5, momentum=0.1)


class Dropout(nn.Module):
    """flax ``Dropout``: in train mode each element is kept with probability
    1 - rate and scaled by 1 / (1 - rate).  The bits come from
    ``self.generator`` (``set_dropout_generator``), never from torch's
    global stream; a train-mode call with a nonzero rate and no generator
    raises."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator "
                               "(set_dropout_generator)")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Hand every ``Dropout`` of ``model`` the generator of its draws."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class TorchConv(nn.Module):
    """Zero-padded conv, grouped where groups > 1."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, kernel_size, stride, padding,
                                groups=groups)

    def forward(self, x):
        return self.Conv_0(x)


class ReflectConv(nn.Module):
    """Reflection pad + valid 3x3 conv (reference Conv3x3,
    layers.py:345-380).  An axis of length 1 (the deepest decoder level of
    a 32-pixel image) pads by repeating its element, as the JAX package's
    jnp.pad(mode="reflect") does; torch's reflection pad refuses it."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, 3, padding=1,
                                padding_mode="reflect")

    def forward(self, x):
        h, w = x.shape[-2:]
        if h > 1 and w > 1:
            return self.Conv_0(x)
        x = F.pad(x, (1, 1, 0, 0), mode="reflect" if w > 1 else "replicate")
        x = F.pad(x, (0, 0, 1, 1), mode="reflect" if h > 1 else "replicate")
        return F.conv2d(x, self.Conv_0.weight, self.Conv_0.bias)


class ConvBlockELU(nn.Module):
    """ReflectConv3x3 + ELU, the decoder block (layers.py:329-342)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.ReflectConv_0 = ReflectConv(cin, cout)

    def forward(self, x):
        return F.elu(self.ReflectConv_0(x))


class ConvBNReLUDrop(nn.Module):
    """Conv -> BN -> ReLU -> [pool] -> Dropout, the pre-encoder ConvBlock
    (reference pre_encoders.py:8-34).  downsampling: 'none' | 'maxpool' |
    'stride2' (a stride of 2 in the conv)."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 downsampling: str = "none", padding: int = 0,
                 dropout_rate: float = 0.1, groups: int = 1):
        super().__init__()
        if downsampling not in ("none", "maxpool", "stride2"):
            raise ValueError(f"unknown downsampling {downsampling!r}")
        self.downsampling = downsampling
        stride = 2 if downsampling == "stride2" else 1
        self.TorchConv_0 = TorchConv(cin, cout, kernel_size, stride, padding,
                                     groups)
        self.BatchNorm_0 = batch_norm(cout)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.TorchConv_0(x)))
        if self.downsampling == "maxpool":
            x = F.max_pool2d(x, 2, 2)
        return self.dropout(x)


class ResidualBlock(nn.Module):
    """Two 3x3 ConvBNReLUDrop blocks and an additive skip
    (reference pre_encoders.py:36-46)."""

    def __init__(self, channels: int, dropout_rate: float = 0.1,
                 groups: int = 1):
        super().__init__()
        self.ConvBNReLUDrop_0 = ConvBNReLUDrop(channels, channels, 3, "none",
                                               1, dropout_rate, groups)
        self.ConvBNReLUDrop_1 = ConvBNReLUDrop(channels, channels, 3, "none",
                                               1, dropout_rate, groups)

    def forward(self, x):
        return self.ConvBNReLUDrop_1(self.ConvBNReLUDrop_0(x)) + x
