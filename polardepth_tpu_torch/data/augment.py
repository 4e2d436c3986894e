"""On-device colour jitter and horizontal flip (polardepth_tpu/data/augment.py:
23-116; reference torchvision ColorJitter at indoor_dataset.py:96-107, 301).

``color_jitter`` is split in two: ``color_jitter_factors`` draws the
per-sample factors from an explicit ``torch.Generator``, and
``color_jitter_apply`` applies given factors, so that a test can hand the
JAX package's draws to the port.  The order of the operations is fixed
(brightness, contrast, saturation, hue), as in the JAX package.
"""

from __future__ import annotations

import torch

from polardepth_tpu_torch.ops.clip import clip

_LUMA = (0.299, 0.587, 0.114)


def _grayscale(img):
    return (img[..., 0:1] * _LUMA[0] + img[..., 1:2] * _LUMA[1]
            + img[..., 2:3] * _LUMA[2])


def _rgb_to_hsv(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(dim=-1)
    minc = img.amin(dim=-1)
    v = maxc
    spread = maxc - minc
    tiny = torch.full_like(maxc, 1e-12)
    s = torch.where(maxc > 0, spread / torch.maximum(maxc, tiny), 0.0)
    safe = torch.maximum(spread, tiny)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(spread == 0.0, 0.0, h)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.long(), 6)

    def select(*vals):
        out = vals[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, vals[k], out)
        return out

    # the JAX package's selection; its g and b lists differ from colorsys's
    # HSV->RGB at i = 2, 3, 5 (g) and i = 4, 5 (b), and the port keeps them
    return torch.stack([select(v, q, p, p, t, v), select(t, v, q, p, p, q),
                        select(p, p, t, v, q, v)], dim=-1)


def color_jitter_factors(generator: torch.Generator, batch: int,
                         brightness=(0.8, 1.2), contrast=(0.8, 1.2),
                         saturation=(0.8, 1.2), hue=(-0.1, 0.1),
                         apply_prob: float = 0.5) -> dict:
    """Per-sample factors, each (B, 1, 1, 1), on the generator's device:
    brightness, contrast, saturation and hue uniform in their ranges, and
    ``apply``, whether the sample is jittered at all (probability
    apply_prob)."""
    def u(lo, hi):
        r = torch.rand(batch, 1, 1, 1, generator=generator,
                       device=generator.device)
        return lo + (hi - lo) * r

    out = {"brightness": u(*brightness), "contrast": u(*contrast),
           "saturation": u(*saturation), "hue": u(*hue)}
    out["apply"] = torch.rand(batch, 1, 1, 1, generator=generator,
                              device=generator.device) < apply_prob
    return out


def color_jitter_apply(img: torch.Tensor, factors: dict) -> torch.Tensor:
    """Jitter img (B, H, W, 3) in [0, 1] with given per-sample factors."""
    fb, fc = factors["brightness"], factors["contrast"]
    fs, fh = factors["saturation"], factors["hue"]
    out = clip(img * fb, 0.0, 1.0)
    mean_gray = torch.mean(_grayscale(out), dim=(1, 2, 3), keepdim=True)
    out = clip(out * fc + mean_gray * (1.0 - fc), 0.0, 1.0)
    gray = _grayscale(out)
    out = clip(out * fs + gray * (1.0 - fs), 0.0, 1.0)
    h, s, v = _rgb_to_hsv(out)
    out = _hsv_to_rgb(torch.remainder(h + fh[..., 0], 1.0), s, v)
    out = clip(out, 0.0, 1.0)
    return torch.where(factors["apply"], out, img)


def random_horizontal_flip(batch: dict, flip: torch.Tensor) -> dict:
    """Mirror on W every (B, H, W, C) and (B, F, H, W, C) entry of batch for
    the samples where flip (B,) is true; other entries (K, poses) are left
    as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.dim() in (4, 5):
            m = flip.reshape(-1, *([1] * (v.dim() - 1)))
            out[k] = torch.where(m, v.flip(v.dim() - 2), v)
        else:
            out[k] = v
    return out


def draw_flip(generator: torch.Generator, batch: int,
              prob: float = 0.5) -> torch.Tensor:
    """Which samples to flip: (B,) bool with probability prob."""
    return torch.rand(batch, generator=generator,
                      device=generator.device) < prob
