"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` holds kernels with a plain C interface.
``nvcc`` compiles it for Hopper (sm_90a) into a shared library under
``build/polardepth_tpu_torch/`` at the repository root, named by a hash of the
source and the flags, and ``ctypes`` loads it.  The build runs at first use,
one ``nvcc`` per source, all of them started together.  There is no other
route: a missing ``nvcc`` or a failed build raises with the compiler's output,
and no caller falls back to a plain version for a tensor on the card.

``launch_counts`` holds one plain integer per kernel (``KERNELS``): its
wrapper adds one each time it launches the kernel, and nowhere else.
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
_I = ctypes.c_int
_L = ctypes.c_longlong
_ERROR_STRING = ("polardepth_cuda_error_string", ctypes.c_char_p, (_I,))
# C signatures of each source's exported functions: (name, restype, argtypes)
SIGNATURES = {
    "polar_preprocess": (
        ("polar_preprocess_launch", _I,
         (_P, _P, _P, _L, _P, _P, _I, _I, _I, _P, _P)),
        _ERROR_STRING,
    ),
    "band_warp": (
        ("band_warp_fwd_launch", _I, (_P, _P, _P, _P, _I, _I, _I, _L, _L, _P)),
        ("band_warp_bwd_launch", _I,
         (_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _P)),
        _ERROR_STRING,
    ),
}
# the kernels of each source, by the names of their launch counts
KERNELS = {
    "polar_preprocess": ("polar_preprocess",),
    "band_warp": ("band_warp_fwd", "band_warp_bwd"),
}

launch_counts = {k: 0 for names in KERNELS.values() for k in names}
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
    """Build every source not yet built, with all nvcc calls running at
    once, and load them all.  Raises with the compiler's output if any build
    fails."""
    running = {}
    for name in SIGNATURES:
        if name in _libs:
            continue
        target = _target(name)
        log_file = target.with_suffix(".log")
        if target.is_file():
            build_info[name] = {"seconds": 0.0, "log": log_file.read_text()
                                if log_file.is_file() else ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        tmp_log = log_file.with_suffix(f".{os.getpid()}.tmplog")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(tmp_log, "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        running[name] = (proc, time.perf_counter(), target, tmp, tmp_log)
    failures = []
    for name, (proc, start, target, tmp, tmp_log) in running.items():
        code = proc.wait()
        seconds = time.perf_counter() - start
        log = tmp_log.read_text()
        if code != 0:
            tmp.unlink(missing_ok=True)
            tmp_log.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {name}.cu (exit {code}):\n{log}")
            continue
        os.replace(tmp, target)
        os.replace(tmp_log, target.with_suffix(".log"))
        build_info[name] = {"seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    for name in SIGNATURES:
        if name in _libs:
            continue
        lib = ctypes.CDLL(str(_target(name)))
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
