"""Attention modules of the arch1++_attention variant
(polardepth_tpu/models/attention.py).

The 2-D sine position encoding (:26-43), elu feature-map linear attention
(:53-60), the LoFTR encoder layer (:63-92) and ``CrossModalAttention``
(:127-175), which PolarDepthNet runs between the RGB stem and the
JointEncoder.  The JAX module's ``SpatialAttention`` (:95-124) and the
encoding's ``temp_bug_fix=False`` branch have no caller in either package
and are not ported.  Public functions take the JAX package's channels-last layout
(B, H, W, C) and tokens as (B, L, C).  The products are einsums, as in the
JAX package, which leaves them to XLA outside any Pallas kernel; here they
are torch matrix products in float32: the port's entry points turn TF32
off around them (utils/precision.py), whatever the caller's
``torch.backends.cuda.matmul.allow_tf32`` says.

Submodules carry the flax names of the JAX modules' parameters, its
auto-names included (``Dense_0``, ``LayerNorm_1``), so that
models/convert.py maps them.  flax ``Dense`` becomes ``nn.Linear``, with
flax's initialisation (LeCun normal kernel, zero bias); flax ``LayerNorm``
becomes ``nn.LayerNorm`` with flax's epsilon, 1e-6.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

_LAYER_NORM_EPS = 1e-6      # flax's default (torch's is 1e-5)


def dense(cin: int, cout: int, bias: bool = True) -> nn.Linear:
    """flax ``nn.Dense``: kernel from LeCun's truncated normal (variance
    1/fan_in), bias 0."""
    layer = nn.Linear(cin, cout, bias=bias)
    # flax's variance_scaling(1, "fan_in", "truncated_normal"): the normal's
    # std corrected for the truncation at two standard deviations
    std = math.sqrt(1.0 / cin) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def sine_position_encoding(d_model: int, height: int,
                           width: int) -> np.ndarray:
    """(H, W, C) float64 2-D sinusoidal position encoding, channels
    interleaved x-sin, x-cos, y-sin, y-cos (LoFTR's convention)."""
    pe = np.zeros((d_model, height, width))
    y_pos = np.cumsum(np.ones((height, width)), axis=0)[None]
    x_pos = np.cumsum(np.ones((height, width)), axis=1)[None]
    div = np.exp(np.arange(0, d_model // 2, 2)
                 * (-math.log(10000.0) / (d_model // 2)))[:, None, None]
    pe[0::4] = np.sin(x_pos * div)
    pe[1::4] = np.cos(x_pos * div)
    pe[2::4] = np.sin(y_pos * div)
    pe[3::4] = np.cos(y_pos * div)
    return np.transpose(pe, (1, 2, 0))


@functools.lru_cache(maxsize=16)
def _position_encoding_on(c: int, h: int, w: int, device: torch.device,
                          dtype: torch.dtype) -> torch.Tensor:
    """The encoding as a tensor on device, copied there once: a copy from
    the host at each forward would wait for the card."""
    return torch.from_numpy(sine_position_encoding(c, h, w)).to(
        device=device, dtype=dtype)


def add_position_encoding(x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> x + the encoding.  While torch.export traces, the
    encoding is made anew (a constant of the graph) and not cached, since
    the tracer's tensors are fakes."""
    _, h, w, c = x.shape
    if torch.compiler.is_compiling():
        pe = torch.from_numpy(sine_position_encoding(c, h, w)).to(
            device=x.device, dtype=x.dtype)
    else:
        pe = _position_encoding_on(c, h, w, x.device, x.dtype)
    return x + pe[None]


def linear_attention(q, k, v, eps: float = 1e-6):
    """elu(.) + 1 feature-map linear attention ("Transformers are RNNs").
    q (B, L, H, D); k, v (B, S, H, D) -> (B, L, H, D)."""
    q = F.elu(q) + 1.0
    k = F.elu(k) + 1.0
    kv = torch.einsum("nshd,nshv->nhdv", k, v)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(dim=1)) + eps)
    # two products, not one einsum of three operands, whose contraction
    # path search would fix the batch of an exported program
    return torch.einsum("nlhd,nhdv->nlhv", q, kv) * z[..., None]


class LoFTREncoderLayer(nn.Module):
    """Q, K, V projections, linear attention, and the MLP merge of the
    queries with the message."""

    def __init__(self, d_model: int = 64, nhead: int = 8):
        super().__init__()
        self.d_model = d_model
        self.nhead = nhead
        self.q_proj = dense(d_model, d_model, bias=False)
        self.k_proj = dense(d_model, d_model, bias=False)
        self.v_proj = dense(d_model, d_model, bias=False)
        self.merge = dense(d_model, d_model, bias=False)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=_LAYER_NORM_EPS)
        self.Dense_0 = dense(2 * d_model, 2 * d_model, bias=False)
        self.Dense_1 = dense(2 * d_model, d_model, bias=False)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=_LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        """x (B, L, C) queries; source (B, S, C) keys and values."""
        b, l, _ = x.shape
        dim = self.d_model // self.nhead
        q = self.q_proj(x).reshape(b, l, self.nhead, dim)
        k = self.k_proj(source).reshape(b, -1, self.nhead, dim)
        v = self.v_proj(source).reshape(b, -1, self.nhead, dim)
        msg = linear_attention(q, k, v).reshape(b, l, self.d_model)
        msg = self.LayerNorm_0(self.merge(msg))
        msg = self.Dense_1(F.relu(self.Dense_0(torch.cat([x, msg], dim=-1))))
        return x + self.LayerNorm_1(msg)


class CrossModalAttention(nn.Module):
    """RGB tokens attend to the polarization modality's tokens, then to
    themselves, at the fusion level before the JointEncoder.

    pe_in_stream=True returns the attended stream, position encoding
    included (the legacy integration).  Otherwise the attention's delta
    (attended minus the encoded input) is added to the clean RGB features,
    scaled with gate=True by a learnable gamma (init 0.1).  As in the JAX
    module, gamma exists only where it is used."""

    def __init__(self, d_model: int = 128, pol_channels: int = 128,
                 nhead: int = 8, num_layers: int = 1,
                 pe_in_stream: bool = False, gate: bool = True):
        super().__init__()
        self.d_model = d_model
        self.num_layers = num_layers
        self.pe_in_stream = pe_in_stream
        self.pol_embed = dense(pol_channels, d_model)
        for i in range(num_layers):
            setattr(self, f"cross_{i}", LoFTREncoderLayer(d_model, nhead))
            setattr(self, f"self_{i}", LoFTREncoderLayer(d_model, nhead))
        self.gamma = (nn.Parameter(torch.full((1,), 0.1))
                      if gate and not pe_in_stream else None)

    def forward(self, rgb_feats: torch.Tensor,
                pol_feats: torch.Tensor) -> torch.Tensor:
        """rgb_feats (B, H, W, Cr = d_model); pol_feats (B, H, W, Cp) ->
        the attended RGB features (B, H, W, Cr)."""
        b, h, w, cr = rgb_feats.shape
        rgb0 = add_position_encoding(rgb_feats).reshape(b, h * w, cr)
        pol = add_position_encoding(self.pol_embed(pol_feats)).reshape(
            b, h * w, self.d_model)
        rgb = rgb0
        for i in range(self.num_layers):
            rgb = getattr(self, f"cross_{i}")(rgb, pol)
            rgb = getattr(self, f"self_{i}")(rgb, rgb)
        if self.pe_in_stream:
            return rgb.reshape(b, h, w, cr)
        delta = rgb - rgb0        # the attention's messages, free of the PE
        if self.gamma is not None:
            delta = self.gamma * delta
        return (rgb_feats.reshape(b, h * w, cr) + delta).reshape(b, h, w, cr)
