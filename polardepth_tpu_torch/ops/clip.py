"""``jnp.clip`` with its gradient.

At a bound that x equals, ``jnp.clip`` gives x half the cotangent (its
minimum and maximum split a tie evenly); ``torch.clamp`` passes all of it.
The port's copies of JAX functions clip through this function wherever a
coordinate, a weight or a colour can sit exactly on a bound, so that their
gradients agree with the JAX package's there too.
"""

from __future__ import annotations

import torch


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)
