"""The float32 of the port's entry points.

The JAX package computes its convolutions and matrix products in float32
(polardepth_tpu/config.py:163-167, ``compute_dtype`` "float32").  torch on a
card leaves ``torch.backends.cudnn.allow_tf32`` True, so that a float32
convolution runs in TF32 (a 10-bit mantissa) unless someone says otherwise.
``float32()`` says otherwise for the span of one call: each public entry
point of the port (the step functions, ``Trainer``, ``AltTrainer``,
``Predictor``, the export and the loaded program, ``cli.main``) runs its
device work inside it, so it computes the JAX package's float32 whatever the
caller's global settings are, and leaves those settings as it found them.

Reads and writes go through one torch API, the one with a flag per library
(``torch.backends.cudnn.allow_tf32``, ``torch.backends.cuda.matmul.
allow_tf32``), and a flag is written only where it differs from False, so
that the caller's settings come back exactly, those of torch's newer API
(``torch.backends.cudnn.conv.fp32_precision`` and its kin) included.  torch
refuses to read the per-library flags once the newer API has set them in a
way they cannot express (cuDNN's convolutions apart from its recurrent
layers, "ieee" anywhere, a matmul precision); ``float32()`` then raises,
naming that setting, and changes nothing.  It never writes the newer API,
so it cannot leave the two mixed.

The flags are global to the process, so sections that overlap share one
save and restore: the first to enter (in any thread) turns the flags off,
the last to leave restores them, and no section runs with them on.

On the CPU neither flag changes a result; they are set all the same, so
that the CPU tests see what the card does.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_FLAGS = (torch.backends.cudnn, torch.backends.cuda.matmul)
_lock = threading.Lock()
_open = 0                     # sections open, in every thread
_turned_off: tuple = ()       # the flags the first of them turned off


def _read() -> tuple[bool, ...]:
    """(cuDNN's, cuBLAS's) allow_tf32."""
    try:
        return tuple(flags.allow_tf32 for flags in _FLAGS)
    except RuntimeError as exc:
        raise RuntimeError(
            "float32(): torch cannot read its TF32 settings through "
            "torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul."
            "allow_tf32, the flags the port sets them with, since they were "
            "set through torch.backends.*.fp32_precision to values those "
            "flags cannot express.  Set TF32 through the allow_tf32 flags "
            "alone") from exc


@contextlib.contextmanager
def float32():
    """Run the block (or, as a decorator, each call) with TF32 off for
    cuDNN's convolutions and cuBLAS's matrix products; restore the caller's
    flags on the way out, error or not, once no other section is open."""
    global _open, _turned_off
    with _lock:
        if not _open:
            _turned_off = tuple(
                flags for flags, on in zip(_FLAGS, _read()) if on)
            for flags in _turned_off:
                flags.allow_tf32 = False
        _open += 1
    try:
        yield
    finally:
        with _lock:
            _open -= 1
            if not _open:
                for flags in _turned_off:
                    flags.allow_tf32 = True
                _turned_off = ()
