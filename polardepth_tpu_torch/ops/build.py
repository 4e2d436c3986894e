"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` holds kernels with a plain C interface.
``nvcc`` compiles it for Hopper (sm_90a) into a shared library under
``build/polardepth_tpu_torch/`` at the repository root, named by a hash of the
source and the flags, and ``ctypes`` loads it.  The build runs at first use,
one ``nvcc`` per source.  There is no other route: a missing ``nvcc`` or a
failed build raises with the compiler's output, and no caller falls back to a
plain version for a tensor on the card.

``launch_counts`` holds one plain integer per kernel: its wrapper adds one
each time it launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "polardepth_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
# C signatures of each source's exported functions: (name, restype, argtypes)
SIGNATURES = {
    "polar_preprocess": (
        ("polar_preprocess_launch", ctypes.c_int,
         (_P, _P, _P, ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int,
          ctypes.c_int, _P, _P)),
        ("polardepth_cuda_error_string", ctypes.c_char_p, (ctypes.c_int,)),
    ),
}

launch_counts = {name: 0 for name in SIGNATURES}
# name -> {"seconds": build time or 0.0 when already built, "log": nvcc output}
build_info: dict[str, dict] = {}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "polardepth_tpu_torch are built with nvcc at first use")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Build every source not yet built and load them all."""
    for name in SIGNATURES:
        if name in _libs:
            continue
        target = _target(name)
        log_file = target.with_suffix(".log")
        if target.is_file():
            build_info[name] = {"seconds": 0.0, "log": log_file.read_text()
                                if log_file.is_file() else ""}
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            start = time.perf_counter()
            out = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 check=False)
            if out.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {name}.cu "
                                   f"(exit {out.returncode}):\n{out.stdout}")
            os.replace(tmp, target)
            log_file.write_text(out.stdout)
            build_info[name] = {"seconds": time.perf_counter() - start,
                                "log": out.stdout}
        lib = ctypes.CDLL(str(target))
        for fn_name, restype, argtypes in SIGNATURES[name]:
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = list(argtypes)
        _libs[name] = lib
    return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _libs:
        build_all()
    return _libs[name]


def check(name: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = library(name).polardepth_cuda_error_string(code)
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg.decode() if msg else 'unknown'})")
