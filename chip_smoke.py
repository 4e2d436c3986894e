#!/usr/bin/env python3
"""On-card smoke run of polardepth_tpu_torch, the PyTorch/CUDA port.

Serves the published tri-encoder (uint8 captures -> metric depth, 320x480,
batch 12, seeded random weights) on one CUDA card through the port's entry
point, ``Predictor.predict``, and holds every CUDA kernel of that path against
its plain torch version.  One timed line per phase:

  1. device: the card's name and power limit; TF32 off for convolutions and
     matrix products, so float32 means float32.
  2. build: nvcc builds the kernels from csrc/ (ops/build.py).
  3. kernel: the polar-preprocess kernel against its plain version at the
     serving shape, on physical, wild, zero-intensity and odd-sized inputs;
     its time beside the plain version's and its memory bound.
  4. serve: one warm-up request and ``--requests`` timed requests; every
     depth finite and in range, one kernel launch per request, and the depth
     equal (within DEPTH_TOL) to the same model run with the plain preprocess
     on the card and, for the first image, on the CPU.
  5. result: the kernels' JSON line, then the final JSON line.

Usage: python3 chip_smoke.py [--seed N] [--requests N]
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from polardepth_tpu_torch.config import PUBLISHED, Config
from polardepth_tpu_torch.models.convert import (
    jax_from_state_dict, state_dict_from_jax)
from polardepth_tpu_torch.ops import build
from polardepth_tpu_torch.ops.depth import disp_to_depth
from polardepth_tpu_torch.ops.fresnel import host_tables
from polardepth_tpu_torch.ops.polar_preprocess import (
    fused_polar_preprocess, polar_preprocess_plain)
from polardepth_tpu_torch.train.losses import preprocess_batch
from polardepth_tpu_torch.train.trainer import Predictor, build_model

# H100 SXM peaks (NVIDIA data sheet): memory rate and float32 rate outside
# the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The preprocess kernel's arithmetic per pixel, each transcendental counted
# as one operation: Stokes fit 21, rho and phi 7, azimuth trig 5, and per
# curve ~13 compares, <= 21 adds, 5 to evaluate theta and its normal.
PREPROCESS_OPS_PER_PIXEL = 150

# Kernel vs plain version: the JAX package's own limits for its kernel
# (tests/test_pallas_preprocess.py).  Both read one table in one order of
# operations, so they hold on wild data too.
XOLP_TOL = 2e-6      # rho, and phi modulo pi (AoLP is defined mod pi)
PRIORS_TOL = 5e-5
# Served depth (m) vs the plain preprocess: float32 convolutions summed in
# another order (cuDNN picks its algorithms per call), TF32 off.
DEPTH_TOL = 1e-4


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


@contextlib.contextmanager
def phase(name: str):
    start = time.perf_counter()
    print(f"[phase {name}] start", flush=True)
    yield
    print(f"[phase {name}] done in {time.perf_counter() - start:.2f} s",
          flush=True)


def card() -> str:
    """nvidia-smi's name and power limit of the card the run uses."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES") or "0"
    out = subprocess.run(
        ["nvidia-smi", "-i", visible, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# --- inputs, all from numpy seeds ------------------------------------------

def physical_pol(rng, shape) -> np.ndarray:
    """I(t) = Iun (1 + rho cos(2t - 2phi)) / 2 with rho in [0, 0.9), as real
    sensors give (tests/test_pallas_preprocess.py)."""
    iun = rng.uniform(30, 220, shape)
    rho = rng.uniform(0, 0.9, shape)
    phi = rng.uniform(-np.pi / 2, np.pi / 2, shape)
    angs = np.deg2rad([0, 45, 90, 135])
    return np.stack([iun * (1 + rho * np.cos(2 * a - 2 * phi)) / 2
                     for a in angs], axis=-1).astype(np.float32)


def kernel_inputs(rng, shape) -> dict:
    zeros = physical_pol(rng, shape)
    zeros[:, ::7, ::5] = 0.0                  # zero-intensity pixels
    return {
        "physical": physical_pol(rng, shape),
        # independent uint8 grays: DoLP up to ~2, deep extrapolation
        "wild": rng.integers(0, 256, (*shape, 4)).astype(np.float32),
        "zeros": zeros,
        "odd": rng.integers(0, 256, (3, 7, 11, 4)).astype(np.float32),
    }


def random_batch(rng, batch: int, cfg: Config) -> dict:
    hw = (batch, cfg.height, cfg.width)
    return {"color": rng.integers(0, 256, (*hw, 3), dtype=np.uint8),
            "pol": physical_pol(rng, hw).round().clip(0, 255).astype(
                np.uint8)}


def seeded_state_dict(cfg: Config, seed: int) -> dict:
    """Random weights of cfg's model, made with numpy in the JAX package's
    reference-shaped layout (what its component exports hold) and carried
    over by state_dict_from_jax."""
    params, stats = jax_from_state_dict(build_model(cfg).state_dict(),
                                        fused_encoders=False)
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel":     # torch's default conv init range
                bound = 1.0 / np.sqrt(np.prod(v.shape[:3]))
                out[k] = rng.uniform(-bound, bound, v.shape)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape)
            else:                   # bias, mean
                out[k] = rng.normal(0.0, 0.1, v.shape)
        return out

    both = cfg.augment_xolp and cfg.augment_normals
    return state_dict_from_jax(fill(params), fill(stats),
                               fused_encoders=cfg.fused_encoders and both)


# --- phase 3: the kernel against its plain version -------------------------

def preprocess_errors(pol: torch.Tensor) -> dict:
    xo_k, pr_k = fused_polar_preprocess(pol)
    xo_p, pr_p = polar_preprocess_plain(pol)
    torch.cuda.synchronize()
    dphi = torch.remainder(xo_k[..., 1] - xo_p[..., 1], np.pi)
    dphi = torch.minimum(dphi, np.pi - dphi)
    finite = bool(torch.isfinite(xo_k).all() and torch.isfinite(pr_k).all())
    return {"rho": float((xo_k[..., 0] - xo_p[..., 0]).abs().max()),
            "phi_mod_pi": float(dphi.max()),
            "priors": float((pr_k - pr_p).abs().max()),
            "finite": finite}


def time_ms(fn, iters: int, warmup: int = 5) -> tuple[float, float]:
    """(device ms, host ms) per call of fn, over iters calls after warmup.
    Where the host takes longer per call than the device, the device time
    includes idle gaps and is host-bound."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = time.perf_counter() - host
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, 1e3 * host / iters


def preprocess_bound_ms(n_pix: int) -> tuple[float, str]:
    ck, rows, _ = host_tables(PUBLISHED.refraction_index, 1e-5)
    bytes_moved = n_pix * (16 + 8 + 36) + ck.nbytes + rows.nbytes
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = n_pix * PREPROCESS_OPS_PER_PIXEL / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernel(device: torch.device, batch: int, cfg: Config,
                 seed: int) -> dict:
    rng = np.random.default_rng(seed)
    errors = {}
    for name, pol in kernel_inputs(rng, (batch, cfg.height, cfg.width)).items():
        e = preprocess_errors(torch.from_numpy(pol).to(device))
        print(f"  {name:8s} max|rho| {e['rho']:.3e}  max|phi| mod pi "
              f"{e['phi_mod_pi']:.3e} (limit {XOLP_TOL})  max|priors| "
              f"{e['priors']:.3e} (limit {PRIORS_TOL})  finite {e['finite']}")
        require(e["finite"], f"non-finite kernel output on {name} data")
        require(max(e["rho"], e["phi_mod_pi"]) <= XOLP_TOL,
                f"xolp error on {name} data")
        require(e["priors"] <= PRIORS_TOL, f"priors error on {name} data")
        errors[name] = e
    pol = torch.from_numpy(
        physical_pol(rng, (batch, cfg.height, cfg.width))).to(device)
    kernel_ms, host_ms = time_ms(lambda: fused_polar_preprocess(pol), 200)
    plain_ms, _ = time_ms(lambda: polar_preprocess_plain(pol), 20)
    bound_ms, bound_by = preprocess_bound_ms(pol.numel() // 4)
    print(f"  wrapper host time per call {host_ms:.4f} ms")
    print(f"  kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms "
          f"{bound_ms:.4f} ({bound_by})  share of bound "
          f"{bound_ms / kernel_ms:.3f}  library_ms none  "
          f"[{card() if device.type == 'cuda' else device}]")
    return {"max_abs_err": max(max(e["rho"], e["phi_mod_pi"], e["priors"])
                               for e in errors.values()),
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# --- phase 4: serve ---------------------------------------------------------

def plain_depth(predictor: Predictor, batch: dict) -> np.ndarray:
    """The served function with the kernel's plain version in its place."""
    cfg = predictor.cfg
    db = {k: torch.as_tensor(batch[k]).to(predictor.device)
          for k in ("color", "pol")}
    with torch.inference_mode():
        pb = preprocess_batch(db, cfg)
        xolp, priors = polar_preprocess_plain(pb["pol"])
        out = predictor.model(pb["color"], xolp=xolp, priors=priors)
        scaled, _ = disp_to_depth(out[("disp", 0)], cfg.min_depth,
                                  cfg.max_depth)
        return torch.clamp(1.0 / scaled, cfg.min_depth,
                           cfg.max_depth).cpu().numpy()


def serve(device, cfg: Config = PUBLISHED, batch: int | None = None,
          requests: int = 5, seed: int = 0) -> dict:
    device = torch.device(device)
    batch = batch or cfg.batch_size
    rng = np.random.default_rng(seed)
    weights = seeded_state_dict(cfg, seed)
    predictor = Predictor(cfg, weights, device=device)
    batches = [random_batch(rng, batch, cfg) for _ in range(requests + 1)]

    build.reset_launch_counts()
    depths = [predictor.predict(batches[0])]          # warm-up
    times = []
    window = time.perf_counter()
    for b in batches[1:]:
        start = time.perf_counter()
        depths.append(predictor.predict(b))
        times.append(time.perf_counter() - start)
    window = time.perf_counter() - window
    launches = dict(build.launch_counts)

    # on the card the kernel runs once per request; on the CPU never
    want = requests + 1 if device.type == "cuda" else 0
    require(launches["polar_preprocess"] == want,
            f"polar_preprocess launched {launches['polar_preprocess']} times,"
            f" expected {want}")
    for d in depths:
        require(d.shape == (batch, cfg.height, cfg.width, 1),
                f"depth shape {d.shape}")
        require(bool(np.isfinite(d).all()), "non-finite depth")
        require(bool(d.min() >= cfg.min_depth and d.max() <= cfg.max_depth),
                "depth outside [min_depth, max_depth]")
    err_plain = float(np.abs(depths[-1] - plain_depth(predictor,
                                                      batches[-1])).max())
    first = {k: v[:1] for k, v in batches[-1].items()}
    on_cpu = Predictor(cfg, weights, device="cpu").predict(first)
    err_cpu = float(np.abs(depths[-1][:1] - on_cpu).max())
    require(err_plain <= DEPTH_TOL,
            f"served depth vs plain preprocess: {err_plain:.3e}")
    require(err_cpu <= DEPTH_TOL, f"served depth vs the CPU: {err_cpu:.3e}")
    # throughput: every image served over the whole timed window, so that a
    # stalled request lowers it; the median is a latency statistic only
    return {"launches": launches,
            "ms_per_request": 1e3 * float(np.median(times)),
            "images_per_s": batch * requests / window, "err_plain": err_plain,
            "err_cpu": err_cpu, "depth_range": (float(depths[-1].min()),
                                                float(depths[-1].max()))}


# --- phase 5 ----------------------------------------------------------------

def result_line(device) -> dict:
    device = torch.device(device)
    if device.type == "cuda":
        return {"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}
    return {"ok": True, "device": {"platform": device.type,
                                   "kind": device.type, "count": 1}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=5)
    args = ap.parse_args()
    # The run uses one card: make it the only one torch sees (before CUDA
    # starts), so that the result line's count is the number of cards used.
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cfg = PUBLISHED

    with phase("1 device"):
        name_power = card()
        print(name_power)
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print("  TF32 off: torch.backends.cudnn.allow_tf32 = False, "
              "torch.backends.cuda.matmul.allow_tf32 = False")
    with phase("2 build"):
        build.build_all()
        for name, info in build.build_info.items():
            print(f"  {name}: nvcc {info['seconds']:.2f} s")
            for line in info["log"].splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print(f"    {line.strip()}")
    with phase("3 kernel"):
        k1 = check_kernel(device, cfg.batch_size, cfg, args.seed)
    with phase("4 serve"):
        s = serve(device, cfg, requests=args.requests, seed=args.seed)
        print(f"  {args.requests} requests of {cfg.batch_size}x{cfg.height}x"
              f"{cfg.width}: {s['ms_per_request']:.2f} ms/request (median), "
              f"{s['images_per_s']:.1f} images/s (all images over the "
              f"timed window)  [{name_power}]")
        print(f"  launches {s['launches']}, depth range {s['depth_range']}, "
              f"max |depth - plain preprocess| {s['err_plain']:.3e} m, "
              f"max |depth - CPU| {s['err_cpu']:.3e} m (limit {DEPTH_TOL})")
    with phase("5 result"):
        kernels = [{
            "name": "polar_preprocess", "route": "cuda",
            "source": "polardepth_tpu_torch/csrc/polar_preprocess.cu",
            "replaces": "polardepth_tpu/ops/pallas/polar_preprocess.py:239",
            "launches": s["launches"]["polar_preprocess"],
            "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
            "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"], "library_ms": None}]
        print(f"  card: {name_power}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(result_line(device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
