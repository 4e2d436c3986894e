#!/usr/bin/env python3
"""On-card smoke run of polardepth_tpu_torch, the PyTorch/CUDA port.

Serves the published tri-encoder (uint8 captures -> metric depth, 320x480,
batch 12, seeded random weights) through ``Predictor.predict``, trains the
self-supervised + depth-supervised model (``make_selfsup_train_step``) and the
published supervised model (``make_train_step``) for a few steps at the same
geometry, and holds every CUDA kernel of those paths against its plain torch
version.  One timed line per phase:

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
  5. warp: the band-warp kernels K2 (forward) and K3 (grid gradient)
     against their plain versions at the training shape (12, 320, 480, 3)
     on a parallax grid (project_3d of a random depth and pose) and a
     sheared grid whose rows leave the 32-row band; the share of pixels
     the band clamps; kernel, plain and F.grid_sample times; the bounds.
     Then K2 at the plane sweep's shape (the teacher's cost volume: 64
     feature channels at 80x120, 16 depth bins stacked on rows, k = 8)
     against its plain version, beside F.grid_sample and its bound.
  6. self-supervised training: PUBLISHED with depth_supervision_only off,
     three frames, one warm-up and ``--steps`` timed steps; every loss
     finite, K1 once and K2, K3 eight times per step; then one step with
     the plain warps on the card, whose loss and gradients must match.
  7. supervised training: PUBLISHED, one warm-up and ``--steps`` timed
     steps, every loss finite, K1 once per step.
  8. train loop: the published supervised run through the command line,
     ``train --synthetic 48 --num_epochs 2`` (320x480, batch 12, 4 steps
     per epoch: the initial evaluation, 8 train steps, 2 evaluations and 2
     checkpoints); every loss finite, metrics.jsonl with train and val
     rows, step_8/ and config.json written, the "all" row finite over 48
     frames, K1 once per train step, eval batch and logged image.  Then
     ``evaluate --weights step_8`` against the fit's last table, a restore
     into a fresh Trainer against the live state, and device_prefetch
     against a plain copy; the loop's images/s in epoch 2 beside phase 7's
     step alone; the host feed, from pairs of epochs run in turns, one
     from the host cache and one over the same batches on the card; the
     eval images/s; and a torch.profiler trace of one train step: the
     card's idle share over the step's wall span, and its ten largest
     device operations.
  9. result: the kernels' JSON line, then the final JSON line.

Kernel times (phases 3 and 5, and the kernels line) are taken behind a spin
on the card (``device_ms``), so that a wrapper's host time per call does not
hide in them; the back-to-back reading (``time_ms``) is printed beside each
as the wrapper's host time per call.

Usage: python3 chip_smoke.py [--seed N] [--requests N] [--steps N]
Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes.util
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import torch.nn.functional as F

from polardepth_tpu_torch import cli
from polardepth_tpu_torch.config import PUBLISHED, Config
from polardepth_tpu_torch.data.pipeline import BatchIterator, device_prefetch
from polardepth_tpu_torch.data.synthetic import SyntheticHammer
from polardepth_tpu_torch.models.convert import (
    jax_from_state_dict, state_dict_from_jax)
from polardepth_tpu_torch.ops import band_warp, build
from polardepth_tpu_torch.ops.camera import backproject_depth, project_3d
from polardepth_tpu_torch.ops.depth import disp_to_depth
from polardepth_tpu_torch.ops.fresnel import host_tables
from polardepth_tpu_torch.ops.polar_preprocess import (
    fused_polar_preprocess, polar_preprocess_plain)
from polardepth_tpu_torch.ops.se3 import transformation_from_parameters
from polardepth_tpu_torch.ops.warp import grid_sample
from polardepth_tpu_torch.train import checkpoint, selfsup, state
from polardepth_tpu_torch.train.losses import preprocess_batch
from polardepth_tpu_torch.train.trainer import (
    Predictor, Trainer, build_model, make_train_step)
from polardepth_tpu_torch.utils import profiling

# H100 SXM peaks (NVIDIA data sheet): memory rate and float32 rate outside
# the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Clock cycles of the card's spin (torch.cuda._sleep) per ms: the H100's
# highest SM clock, so that a spin lasts at least as long as asked.
SPIN_CYCLES_PER_MS = 1.98e6
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
# Band warp vs its plain version: the forward on images in [0, 1] (the
# kernel repeats the plain version's operations, -fmad=false); dix and diy
# relative to each one's max abs (the channel sums may round in another
# order).
WARP_TOL = 1e-6
WARP_GRAD_RTOL = 1e-5
# A train step with the kernels vs the same step with the plain warps on the
# card: the loss relative; each gradient relative to its tensor's max abs
# plus NOISE_MULT times its float32 spread (plain_warp_step), since K3's
# channel sums round in another order and cuDNN's backward algorithms may
# accumulate in another order from call to call.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-4
NOISE_MULT = 4.0
# the self-supervised step warps 4 scales x 2 source frames
WARPS_PER_STEP = 8
# The train loop's run: PUBLISHED on 48 synthetic scenes for 2 epochs.
LOOP_SCENES = 48
LOOP_EPOCHS = 2
# evaluate --weights against the fit's last table: the same weights on the
# same frames, batched in another order, so each slice's frame sums are taken
# in another order (relative to each entry; an entry below 1e-6 counts as 0)
EVAL_TABLE_RTOL = 1e-5
# The host feed: pairs of epochs (the loop's, the same batches on the card)
FEED_PAIRS = 5
# The profiled step's annotation, and the trace categories of device work
STEP_SPAN = "train_step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def seeded_state_dict(cfg: Config, seed: int, model=None) -> dict:
    """Random weights of model (by default cfg's serving model), made with
    numpy in the JAX package's reference-shaped layout (what its component
    exports hold) and carried over by state_dict_from_jax."""
    model = build_model(cfg) if model is None else model
    params, stats = jax_from_state_dict(model.state_dict(),
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


def device_ms(fn, iters: int) -> float:
    """Device ms per call of fn over iters back-to-back calls queued behind
    a spin on the card, so that the card runs them with no wait for the
    host: a kernel's own time even where its wrapper's host time per call
    is longer, which time_ms would read instead.  The kernels line's times.

    The spin lasts 0.2 ms per call.  Where the host took longer to queue
    the calls than the spin lasted, the card may have waited for it, and
    the reading is taken again behind a spin of twice the host's time.  If
    the host outlasts that spin too, its queueing grew with the spin: the
    card's launch queue was full, so the card held the host back and did
    not wait; the reading stands.  Anything else raises."""
    fn()
    torch.cuda.synchronize()
    spin_ms = 0.2 * iters
    for attempt in range(2):
        spun = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        host = time.perf_counter()
        spun.record()
        torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * spin_ms))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - host)
        torch.cuda.synchronize()
        spin_ran = spun.elapsed_time(start)
        if host_ms < spin_ran or (attempt and host_ms >= 0.9 * spin_ran):
            return start.elapsed_time(end) / iters
        spin_ms = 2 * host_ms
    raise RuntimeError(f"device_ms: the host took {host_ms:.3f} ms to queue "
                       f"{iters} calls behind a {spin_ran:.3f} ms spin")


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
    back_to_back_ms, host_ms = time_ms(lambda: fused_polar_preprocess(pol),
                                       200)
    kernel_ms = device_ms(lambda: fused_polar_preprocess(pol), 200)
    plain_ms = device_ms(lambda: polar_preprocess_plain(pol), 20)
    bound_ms, bound_by = preprocess_bound_ms(pol.numel() // 4)
    print(f"  wrapper host time per call {host_ms:.4f} ms; back to back "
          f"{back_to_back_ms:.4f} ms per call")
    print(f"  kernel_ms {kernel_ms:.4f} (behind a spin)  plain_ms "
          f"{plain_ms:.4f}  bound_ms {bound_ms:.4f} ({bound_by})  share of "
          f"bound {bound_ms / kernel_ms:.3f}  library_ms none  "
          f"[{card() if device.type == 'cuda' else device}]")
    return {"max_abs_err": max(max(e["rho"], e["phi_mod_pi"], e["priors"])
                               for e in errors.values()),
            "ms": kernel_ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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


# --- phase 5: the band-warp kernels ----------------------------------------

def intrinsics(batch: int, h: int, w: int) -> np.ndarray:
    """(B, 4, 4) pinhole intrinsics with a focal length of 0.9 W."""
    K = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    K[:, 0, 0] = K[:, 1, 1] = 0.9 * w
    K[:, 0, 2], K[:, 1, 2] = (w - 1) / 2, (h - 1) / 2
    return K


def random_pose(rng, batch: int, device, scale: float = 1.0):
    """(B, 4, 4) transforms from small random axis-angles and translations."""
    aa = torch.from_numpy(rng.normal(0, 0.02 * scale, (batch, 1, 3)).astype(
        np.float32)).to(device)
    t = torch.from_numpy(rng.normal(0, 0.03 * scale, (batch, 1, 3)).astype(
        np.float32)).to(device)
    return transformation_from_parameters(aa, t)


def parallax_grid(rng, batch: int, h: int, w: int, device) -> torch.Tensor:
    """project_3d of a random depth in [0.1, 2] m through a small pose."""
    depth = torch.from_numpy(rng.uniform(0.1, 2.0, (batch, h, w, 1)).astype(
        np.float32)).to(device)
    K = torch.from_numpy(intrinsics(batch, h, w)).to(device)
    points = backproject_depth(depth, torch.linalg.inv(K))
    return project_3d(points, K, random_pose(rng, batch, device), h, w)


def sheared_grid(batch: int, h: int, w: int, device) -> torch.Tensor:
    """An identity grid whose y grows with x: rows leave the 32-row band."""
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, h, device=device),
                            torch.linspace(-1, 1, w, device=device),
                            indexing="ij")
    grid = torch.stack([xs, ys + 0.3 * xs], dim=-1)
    return grid.expand(batch, h, w, 2).contiguous()


def warp_bound_ms(b: int, h: int, w: int, c: int, n_out: int,
                  backward: bool) -> tuple[float, str]:
    """Each input read once, each output written once: ix, iy and the image,
    plus the output (K2), or the cotangent and dix, diy (K3); a few dozen
    flops per pixel are far below the float32 rate."""
    img = b * h * w * c * 4
    per_px = 8 + 4 * c + (8 if backward else 0)
    t_bytes = (img + n_out * per_px) / HBM_BYTES_PER_S * 1e3
    t_ops = n_out * (30 + 12 * c) / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_warp(device: torch.device, batch: int, cfg: Config, seed: int,
               name_power: str, iters: int = 100) -> dict:
    """K2 and K3 against their plain versions on two grids; times."""
    rng = np.random.default_rng(seed + 5)
    h, w, c = cfg.height, cfg.width, 3
    img = torch.from_numpy(rng.uniform(0, 1, (batch, h, w, c)).astype(
        np.float32)).to(device)
    g = torch.from_numpy(rng.normal(size=(batch, h, w, c)).astype(
        np.float32)).to(device)
    geo = band_warp.band_geometry(h, w, c, h)
    out = {}
    grids = {"parallax": parallax_grid(rng, batch, h, w, device),
             "sheared": sheared_grid(batch, h, w, device)}
    for name, grid in grids.items():
        ix, iy, _ = band_warp.prep(img.shape, grid, geo["k"], geo["step"],
                                   True, geo["wp"])
        _, iy_image, _ = band_warp.prep(img.shape, grid, h, 1, True)
        clamped = float((iy != iy_image).float().mean())
        k_out = band_warp.band_warp_fwd(img, ix, iy)
        p_out = band_warp.band_warp_fwd_plain(img, ix, iy)
        k_dix, k_diy = band_warp.band_warp_bwd(img, ix, iy, g)
        p_dix, p_diy = band_warp.band_warp_bwd_plain(img, ix, iy, g)
        if device.type == "cuda":
            torch.cuda.synchronize()
        e = {"out": float((k_out - p_out).abs().max()),
             "dix": float((k_dix - p_dix).abs().max()),
             "diy": float((k_diy - p_diy).abs().max()),
             "dix_max": float(p_dix.abs().max()),
             "diy_max": float(p_diy.abs().max()), "clamped": clamped}
        finite = all(bool(torch.isfinite(t).all())
                     for t in (k_out, k_dix, k_diy))
        print(f"  {name:8s} band clamps {100 * clamped:.3f}% of pixels  "
              f"max|out| err {e['out']:.3e} (limit {WARP_TOL})  max|dix| err "
              f"{e['dix']:.3e} of {e['dix_max']:.3e}  max|diy| err "
              f"{e['diy']:.3e} of {e['diy_max']:.3e} (limit "
              f"{WARP_GRAD_RTOL} of max)  finite {finite}")
        require(finite, f"non-finite warp kernel output on the {name} grid")
        require(e["out"] <= WARP_TOL, f"K2 error on the {name} grid")
        require(e["dix"] <= WARP_GRAD_RTOL * e["dix_max"]
                and e["diy"] <= WARP_GRAD_RTOL * e["diy_max"],
                f"K3 error on the {name} grid")
        t = {}
        t["fwd_b2b"], t["fwd_host"] = time_ms(
            lambda: band_warp.band_warp_fwd(img, ix, iy), iters)
        t["bwd_b2b"], t["bwd_host"] = time_ms(
            lambda: band_warp.band_warp_bwd(img, ix, iy, g), iters)
        t["fwd"] = device_ms(
            lambda: band_warp.band_warp_fwd(img, ix, iy), iters)
        t["bwd"] = device_ms(
            lambda: band_warp.band_warp_bwd(img, ix, iy, g), iters)
        t["fwd_plain"] = device_ms(
            lambda: band_warp.band_warp_fwd_plain(img, ix, iy), 10)
        t["bwd_plain"] = device_ms(
            lambda: band_warp.band_warp_bwd_plain(img, ix, iy, g), 10)
        # the library yardstick: torch's bilinear border grid_sample on the
        # same image (a channels-last view) and grid; its grid-only backward
        nchw = img.permute(0, 3, 1, 2)
        t["fwd_library"] = device_ms(lambda: F.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="border",
            align_corners=True), iters)
        grid_req = grid.detach().clone().requires_grad_(True)
        lib_out = F.grid_sample(nchw, grid_req, mode="bilinear",
                                padding_mode="border", align_corners=True)
        g_nchw = g.permute(0, 3, 1, 2)
        t["bwd_library"] = device_ms(lambda: torch.autograd.grad(
            lib_out, grid_req, g_nchw, retain_graph=True), iters)
        n_out = ix.numel()
        bounds = {"fwd": warp_bound_ms(batch, h, w, c, n_out, False),
                  "bwd": warp_bound_ms(batch, h, w, c, n_out, True)}
        for k in ("fwd", "bwd"):
            bound, by = bounds[k]
            print(f"  {name:8s} {'K2' if k == 'fwd' else 'K3'} kernel_ms "
                  f"{t[k]:.4f} behind a spin  (wrapper host ms "
                  f"{t[k + '_host']:.4f}; back to back {t[k + '_b2b']:.4f})"
                  f"  plain_ms {t[k + '_plain']:.4f}  "
                  f"F.grid_sample {'forward' if k == 'fwd' else 'grid backward'}"
                  f" ms {t[k + '_library']:.4f}  bound_ms {bound:.4f} ({by})"
                  f"  share of bound {bound / t[k]:.3f}  [{name_power}]")
        out[name] = {"errors": e, "times": t, "bounds": bounds}
    return out


def plane_sweep_inputs(rng, batch: int, h: int, w: int, c: int, bins: int,
                       device) -> dict:
    """K2's operands in the teacher's plane sweep
    (polardepth_tpu/models/cost_volume.py:109-147): features (B, h, w, c)
    in [0, 1]; the h x w pixel grid back-projected at each of ``bins``
    depths in [0.3, 1.5] m and projected through a small random pose per
    sample, the bins stacked on rows as (B, bins * h, w, 2); ix, iy clamped
    into an 8-row band, and the share of pixels the band clamps."""
    img = torch.from_numpy(rng.uniform(0, 1, (batch, h, w, c)).astype(
        np.float32)).to(device)
    K = torch.from_numpy(intrinsics(batch, h, w)).to(device)
    inv_K = torch.linalg.inv(K)
    T = random_pose(rng, batch, device)
    grid = torch.stack([
        project_3d(backproject_depth(torch.full(
            (batch, h, w, 1), float(d), device=device), inv_K), K, T, h, w)
        for d in np.linspace(0.3, 1.5, bins, dtype=np.float32)], dim=1)
    grid = grid.reshape(batch, bins * h, w, 2)
    geo = band_warp.band_geometry(h, w, c, bins * h, k=8)
    ix, iy, _ = band_warp.prep(img.shape, grid, geo["k"], geo["step"], True,
                               geo["wp"])
    _, iy_image, _ = band_warp.prep(img.shape, grid, h, 1, True)
    return {"img": img, "grid": grid, "ix": ix, "iy": iy,
            "clamped": float((iy != iy_image).float().mean())}


def check_plane_sweep(device: torch.device, batch: int, seed: int,
                      name_power: str, h: int = 80, w: int = 120, c: int = 64,
                      bins: int = 16, iters: int = 50) -> dict:
    """K2 at the plane sweep's shape: against its plain version, its time
    beside F.grid_sample's on the same inputs, and its bound."""
    x = plane_sweep_inputs(np.random.default_rng(seed + 8), batch, h, w, c,
                           bins, device)
    img, ix, iy = x["img"], x["ix"], x["iy"]
    k_out = band_warp.band_warp_fwd(img, ix, iy)
    err = float((k_out - band_warp.band_warp_fwd_plain(img, ix, iy)).abs()
                .max())
    finite = bool(torch.isfinite(k_out).all())
    del k_out
    require(finite, "non-finite K2 output on the plane sweep")
    require(err <= WARP_TOL, f"K2 error on the plane sweep: {err:.3e}")
    ms = time_ms(lambda: band_warp.band_warp_fwd(img, ix, iy), iters)[0]
    plain_ms = time_ms(lambda: band_warp.band_warp_fwd_plain(img, ix, iy),
                       5, warmup=1)[0]
    nchw = img.permute(0, 3, 1, 2)
    library_ms = time_ms(lambda: F.grid_sample(
        nchw, x["grid"], mode="bilinear", padding_mode="border",
        align_corners=True), iters)[0]
    bound_ms, by = warp_bound_ms(batch, h, w, c, ix.numel(), False)
    print(f"  plane sweep img {tuple(img.shape)} -> out {(*ix.shape, c)}, "
          f"k=8: band clamps {100 * x['clamped']:.3f}% of pixels  max|out| "
          f"err {err:.3e} (limit {WARP_TOL})  finite {finite}")
    print(f"  plane sweep K2 kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
          f"F.grid_sample forward ms {library_ms:.4f}  bound_ms "
          f"{bound_ms:.4f} ({by})  share of bound {bound_ms / ms:.3f}  "
          f"[{name_power}]")
    clamped = x["clamped"]
    del x, img, ix, iy, nchw
    torch.cuda.empty_cache()     # the plain version's gigabytes of gathers
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "clamped": clamped}


# --- phases 6 and 7: training ------------------------------------------------

def smooth_uint8(rng, shape, device) -> torch.Tensor:
    """A seeded texture: uniform noise at 1/8 resolution, upsampled."""
    b, h, w, c = shape
    low = torch.from_numpy(rng.uniform(0, 255, (b, c, h // 8, w // 8)).astype(
        np.float32)).to(device)
    up = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    return up.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


def train_batch(rng, batch: int, cfg: Config, device) -> dict:
    """Frame 0 (a smooth texture), its physical captures and a smooth depth
    in [0.3, 1.5] m, and source frames that are frame 0 warped through that
    depth by small known poses (``rel_poses``)."""
    h, w = cfg.height, cfg.width
    color0 = smooth_uint8(rng, (batch, h, w, 3), device)
    depth = 0.3 + 1.2 * smooth_uint8(rng, (batch, h, w, 1), device).float() \
        / 255.0
    K = torch.from_numpy(intrinsics(batch, h, w)).to(device)
    inv_K = torch.linalg.inv(K)
    points = backproject_depth(depth, inv_K)
    frames, rel = [], []
    for f in cfg.frame_ids:
        if f == 0:
            frames.append(color0)
            rel.append(torch.eye(4, device=device).expand(batch, 4, 4))
            continue
        T = random_pose(rng, batch, device, scale=0.5)
        grid = project_3d(points, K, torch.linalg.inv(T), h, w)
        moved = grid_sample(color0.float(), grid, impl="flat4")
        frames.append(moved.round().clamp(0, 255).to(torch.uint8))
        rel.append(T)
    pol = torch.from_numpy(physical_pol(rng, (batch, h, w)).round().clip(
        0, 255).astype(np.uint8)).to(device)
    return {"color_frames": torch.stack(frames, dim=1), "color": color0,
            "pol": pol, "depth": depth, "K": K, "inv_K": inv_K,
            "rel_poses": torch.stack(rel, dim=1)}


def run_steps(step, st, batch: dict, generator, steps: int, device):
    """One warm-up step and ``steps`` timed ones -> (losses, ms per step,
    window seconds, launches over all of them)."""
    build.reset_launch_counts()
    losses = [float(step(st, batch, generator)["loss"])]
    times = []
    window = time.perf_counter()
    for _ in range(steps):
        start = time.perf_counter()
        logs = step(st, batch, generator)
        losses.append(float(logs["loss"]))       # waits for the step
        times.append(time.perf_counter() - start)
    window = time.perf_counter() - window
    return losses, times, window, dict(build.launch_counts)


def _grads(model) -> dict:
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def plain_warp_step(cfg: Config, weights: dict, batch: dict, device,
                    seed: int) -> dict:
    """The first step from the same weights, batch and draws: with the
    kernels, with the plain warps on the card, and with the kernels from
    the weights scaled by 1 + 2^-20 (which moves the gradients by their
    float32 spread: kinks, the automask's threshold, the zero gradients of
    the biases before BatchNorm).  Each gradient must lie within
    STEP_GRAD_RTOL of its max abs plus NOISE_MULT times that spread."""
    results = []
    for plain, scale in ((False, None), (True, None), (False, 1 + 2 ** -20)):
        model = selfsup.SelfSupModel.from_config(cfg)
        model.load_state_dict(weights)
        model.to(device)
        if scale is not None:
            with torch.no_grad():
                for prm in model.parameters():
                    prm.mul_(scale)
        st = state.create_train_state(model, cfg)
        step = selfsup.make_selfsup_train_step(model, cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        saved = band_warp.band_warp_fwd, band_warp.band_warp_bwd
        if plain:
            band_warp.band_warp_fwd = band_warp.band_warp_fwd_plain
            band_warp.band_warp_bwd = band_warp.band_warp_bwd_plain
        try:
            loss = float(step(st, batch, gen)["loss"])
        finally:
            band_warp.band_warp_fwd, band_warp.band_warp_bwd = saved
        results.append((loss, _grads(model)))
    (loss_k, g_k), (loss_p, g_p), (_, g_r) = results
    ratios = {k: float((g_k[k] - g_p[k]).abs().max()) / (
        STEP_GRAD_RTOL * float(g_p[k].abs().max())
        + NOISE_MULT * float((g_k[k] - g_r[k]).abs().max()) + 1e-30)
        for k in g_p}
    worst = max(ratios, key=ratios.get)
    rel = {k: float((g_k[k] - g_p[k]).abs().max())
           / max(float(g_p[k].abs().max()), 1e-30) for k in g_p}
    return {"loss_kernel": loss_k, "loss_plain": loss_p,
            "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
            "grad_err_over_limit": ratios[worst], "grad_worst": worst,
            "grad_rel_err_median": float(np.median(list(rel.values())))}


def train_selfsup(device, cfg: Config, batch_size: int, steps: int,
                  seed: int) -> dict:
    device = torch.device(device)
    rng = np.random.default_rng(seed + 6)
    model = selfsup.SelfSupModel.from_config(cfg)
    weights = seeded_state_dict(cfg, seed, model)
    model.load_state_dict(weights)
    model.to(device)
    st = state.create_train_state(model, cfg)
    step = selfsup.make_selfsup_train_step(model, cfg)
    batch = train_batch(rng, batch_size, cfg, device)
    batch.pop("color")
    gen = torch.Generator(device=device).manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, times, window, launches = run_steps(step, st, batch, gen, steps,
                                                device)
    n = steps + 1
    want = ({"polar_preprocess": n, "band_warp_fwd": WARPS_PER_STEP * n,
             "band_warp_bwd": WARPS_PER_STEP * n} if device.type == "cuda"
            else {k: 0 for k in launches})
    require(launches == want, f"self-supervised launches {launches}, "
            f"expected {want}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check = plain_warp_step(cfg, weights, batch, device, seed)
    require(check["loss_rel_err"] <= STEP_LOSS_RTOL,
            f"kernel vs plain-warp step loss: {check['loss_rel_err']:.3e}")
    require(check["grad_err_over_limit"] <= 1.0,
            f"kernel vs plain-warp step gradients: {check['grad_worst']} at "
            f"{check['grad_err_over_limit']:.3f} of its limit")
    return {"losses": losses, "ms_per_step": 1e3 * float(np.median(times)),
            "images_per_s": batch_size * steps / window,
            "launches": launches, "launches_per_step": {
                k: v / n for k, v in launches.items()},
            "max_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
            **check}


def train_supervised(device, cfg: Config, batch_size: int, steps: int,
                     seed: int) -> dict:
    device = torch.device(device)
    rng = np.random.default_rng(seed + 7)
    model = build_model(cfg)
    model.load_state_dict(seeded_state_dict(cfg, seed))
    model.to(device)
    st = state.create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    full = train_batch(rng, batch_size, cfg, device)
    batch = {k: full[k] for k in ("color", "pol", "depth", "K")}
    gen = torch.Generator(device=device).manual_seed(seed)
    losses, times, window, launches = run_steps(step, st, batch, gen, steps,
                                                device)
    n = steps + 1
    want = ({"polar_preprocess": n, "band_warp_fwd": 0, "band_warp_bwd": 0}
            if device.type == "cuda" else {k: 0 for k in launches})
    require(launches == want, f"supervised launches {launches}, expected "
            f"{want}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    return {"losses": losses, "ms_per_step": 1e3 * float(np.median(times)),
            "images_per_s": batch_size * steps / window,
            "launches": launches}


# --- phase 8: the training loop through the command line --------------------

def decoders() -> dict:
    """Which PNG decoders this host has: the HAMMER loader needs cv2; PIL
    and libpng are candidates for later backends."""
    found = {}
    for name in ("cv2", "PIL"):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    found["libpng"] = ctypes.util.find_library("png") is not None
    return found


def _table_rel_diff(a: dict, b: dict) -> float:
    """The largest relative difference between two metric tables, entry by
    entry; entries below 1e-6 in both count as equal."""
    worst = 0.0
    for name, row in a.items():
        require(row["frames"] == b[name]["frames"],
                f"{name}: {row['frames']} frames vs {b[name]['frames']}")
        for m, v in row.items():
            scale = max(abs(v), abs(b[name][m]))
            if m != "frames" and scale >= 1e-6:
                worst = max(worst, abs(v - b[name][m]) / scale)
    return worst


# Device operations by kind, the first pattern of a kernel's name that
# matches deciding (cuDNN's layout transposes before its convolutions).
OP_KINDS = (("layout transpose", ("Transpose", "transpose", "nchwToNhwc",
                                  "nhwcToNchw")),
            ("batch norm", ("bn_", "batch_norm", "welford")),
            ("convolution / matmul", ("gemm", "conv", "grad", "fprop",
                                      "xmma", "cudnn", "winograd")),
            ("reduction", ("reduce", "Reduce")),
            ("copy / fill", ("Memcpy", "Memset", "copy", "fill")),
            ("elementwise", ("elementwise", "vectorized", "unrolled",
                             "Elementwise")))


def device_top(prof, n: int = 10) -> dict:
    """The device operations (kernels and copies) of a profile: the n that
    take the most time with their shares of all device time, the shares of
    each kind (OP_KINDS, else "other"), and the total in ms."""
    def device_us(e):
        v = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if v is None else v
    ops = [(e.key, device_us(e) / 1e3) for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.key != STEP_SPAN]
    total = sum(ms for _, ms in ops)
    ops.sort(key=lambda x: -x[1])
    kinds: dict = {}
    for name, ms in ops:
        kind = next((k for k, pats in OP_KINDS
                     if any(pat in name for pat in pats)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    if total <= 0:
        return {"top": [], "kinds": {}, "device_ms": 0.0}
    return {"top": [(k, ms, ms / total) for k, ms in ops[:n]],
            "kinds": {k: (ms, ms / total) for k, ms in sorted(
                kinds.items(), key=lambda x: -x[1])},
            "device_ms": total}


def host_feed(trainer: Trainer, scenes: int, pairs: int) -> dict:
    """How far the loop's host feed holds the card back: pairs of epochs
    through trainer.train_epoch, in turns, over the same synthetic scenes
    (trainer's geometry and seed): one from a BatchIterator whose samples
    are all in its host cache (the loop's epoch 2: stacking, the thread
    pool, a pageable copy per step), one over the same number of batches
    already on the device.  Both end in the same read of the logs.
    Returns each side's images/s and each pair's ratio, loop over alone."""
    cfg = trainer.cfg
    gen = SyntheticHammer(cfg.height, cfg.width, seed=cfg.seed)
    it = BatchIterator(lambda i: gen.sample(int(i)), scenes, cfg.batch_size,
                       shuffle=True, seed=cfg.seed,
                       cache_bytes=int(cfg.host_cache_gb * 2 ** 30))
    on_device = [selfsup.to_device(b, trainer.device) for b in it]
    require(len(it._cache) == scenes, "the host cache holds "
            f"{len(it._cache)} of {scenes} samples")
    loop, alone = [], []
    for _ in range(pairs):
        loop.append(trainer.train_epoch(iter(it))["examples_per_sec"])
        alone.append(trainer.train_epoch(on_device)["examples_per_sec"])
    return {"loop": loop, "alone": alone,
            "ratio": [a / b for a, b in zip(loop, alone)],
            "steps": len(on_device)}


def device_idle(trace_path: str, span=None, n_gaps: int = 5) -> dict:
    """The card's idle share over one step, from one torch.profiler trace
    (Chrome format).  The step's wall span starts at its host annotation
    (``span``, a record_function), or without one (a trace of the card's
    activity alone) at the host's first runtime call; it ends at the end
    of the last device operation (kernel, copy or fill), or of the
    annotation if that is later.  Its busy time is the union of the device
    operations' intervals inside the span.  Also the n_gaps longest idle
    gaps, each with the device operation that ends it and the innermost
    host operation that launched that one, and the host's runtime calls
    that waited on the card (a synchronize, a blocking copy) for 0.05 ms
    or more, each with the host operations around it, innermost first."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    for e in events:
        e["ts"], e["dur"] = float(e["ts"]), float(e.get("dur", 0.0))
        e["cat"] = e.get("cat", "").lower()
    runtime = [e for e in events if e["cat"] == "cuda_runtime"]
    if span is not None:
        marks = [e for e in events
                 if e["cat"] == "user_annotation" and e.get("name") == span]
        require(len(marks) == 1,
                f"{len(marks)} '{span}' spans in {trace_path}")
        t0 = marks[0]["ts"]
        t1 = t0 + marks[0]["dur"]
    else:
        require(runtime, f"no runtime call in {trace_path}")
        t0 = min(e["ts"] for e in runtime)
        t1 = max(e["ts"] + e["dur"] for e in runtime
                 if "Synchronize" not in e["name"])
    ops = sorted((e for e in events if e["cat"] in DEVICE_CATS
                  and e["ts"] + e["dur"] > t0), key=lambda e: e["ts"])
    require(ops, "no device operation in the step's span")
    end = max(t1, max(e["ts"] + e["dur"] for e in ops))
    busy, gaps = 0.0, []
    cur_a, cur_b = max(ops[0]["ts"], t0), ops[0]["ts"] + ops[0]["dur"]
    gaps.append((cur_a - t0, t0, ops[0]))
    for e in ops[1:]:
        if e["ts"] > cur_b:
            busy += cur_b - cur_a
            gaps.append((e["ts"] - cur_b, cur_b, e))
            cur_a = e["ts"]
        cur_b = max(cur_b, e["ts"] + e["dur"])
    busy += cur_b - cur_a

    launches = {e["args"]["correlation"]: e for e in runtime
                if "correlation" in e.get("args", {})}
    host_ops = [e for e in events if e["cat"] == "cpu_op"]

    def around(call) -> list:
        inside = [h for h in host_ops if h.get("tid") == call.get("tid")
                  and h["ts"] <= call["ts"] <= h["ts"] + h["dur"]]
        return [h["name"] for h in sorted(inside, key=lambda h: h["dur"])]

    def launched_by(op) -> str:
        call = launches.get(op.get("args", {}).get("correlation"))
        if call is None:
            return "?"
        return (around(call) or [call["name"]])[0]

    gaps.sort(key=lambda g: -g[0])
    waits = [e for e in runtime if t0 <= e["ts"] <= end
             and ("Synchronize" in e["name"] or e["name"] == "cudaMemcpy")]
    return {"span_ms": (end - t0) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (end - t0),
            "host_ms": (t1 - t0) / 1e3,
            "first_op_ms": (max(ops[0]["ts"], t0) - t0) / 1e3,
            "ops": len(ops),
            "gaps": [{"at_ms": (at - t0) / 1e3, "ms": g / 1e3,
                      "next_op": op["name"], "launched_by": launched_by(op)}
                     for g, at, op in gaps[:n_gaps]],
            "n_waits": len(waits),
            "waits": [{"name": e["name"], "at_ms": (e["ts"] - t0) / 1e3,
                       "ms": e["dur"] / 1e3, "in": around(e)[:4]}
                      for e in waits if e["dur"] >= 50.0]}


def train_loop(device, flags=(), scenes: int = LOOP_SCENES,
               epochs: int = LOOP_EPOCHS) -> dict:
    """The command line's train command in-process on ``scenes`` synthetic
    scenes for ``epochs`` epochs (PUBLISHED unless flags say otherwise),
    its checks, evaluate --weights on the last checkpoint, a restore into a
    fresh Trainer, device_prefetch against a plain copy, the eval rate and,
    on the card, a profile of one train step."""
    device = torch.device(device)
    common = ["--synthetic", str(scenes), "--device", str(device), *flags]
    out = {"decoders": decoders()}
    with tempfile.TemporaryDirectory() as tmp:
        build.reset_launch_counts()
        start = time.perf_counter()
        live, results = cli.train([*common, "--num_epochs", str(epochs),
                                   "--log_dir", tmp])
        out["wall_s"] = time.perf_counter() - start
        launches = dict(build.launch_counts)
        cfg = live.cfg
        run = os.path.join(tmp, cfg.model_name)
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        train_rows = [r for r in rows if r["mode"] == "train"]
        require(len(train_rows) == epochs and any(r["mode"] == "val"
                                                  for r in rows),
                f"metrics.jsonl modes {[r['mode'] for r in rows]}")
        losses = [r["loss"] for r in train_rows]
        require(all(np.isfinite(v) for r in train_rows for k, v in r.items()
                    if k.startswith("loss")), f"non-finite loss in {rows}")
        spe = scenes // cfg.batch_size
        steps = spe * epochs
        ckdir = os.path.join(run, "checkpoints")
        step_dir = os.path.join(ckdir, f"step_{steps}")
        require(os.path.isfile(os.path.join(step_dir, checkpoint.STATE_FILE))
                and os.path.isfile(os.path.join(ckdir, "config.json")),
                f"no {step_dir} or config.json")
        last = results[f"epoch_{epochs - 1}"]
        require(last["all"]["frames"] == scenes
                and all(np.isfinite(v) for v in last["all"].values()),
                f"the last table's 'all' row {last['all']}")
        counts = dict(live.counts)
        require(counts["train_steps"] == steps
                and counts["eval_batches"] == spe * (1 + epochs),
                f"counts {counts}")
        # K1 runs once per train step, eval batch and logged image's
        # prediction; on the CPU never
        want = sum(counts.values()) if device.type == "cuda" else 0
        require(launches == {"polar_preprocess": want, "band_warp_fwd": 0,
                             "band_warp_bwd": 0},
                f"train loop launches {launches}, expected {want} of K1")

        _, table = cli.evaluate([*common, "--weights", step_dir])
        out["eval_rel_diff"] = _table_rel_diff(table, last)
        require(out["eval_rel_diff"] <= EVAL_TABLE_RTOL,
                f"evaluate --weights vs the fit's last table: "
                f"{out['eval_rel_diff']:.3e}")

        with open(os.path.join(ckdir, "config.json")) as f:
            fresh = Trainer(Config.from_json(f.read()), spe, device=device,
                            log_fn=lambda *_: None)
        checkpoint.restore(step_dir, fresh.state)
        gen = SyntheticHammer(cfg.height, cfg.width, seed=cfg.seed)
        host = [gen.batch(cfg.batch_size, start=i * cfg.batch_size)
                for i in range(spe)]
        require(np.array_equal(live.predict(host[0]), fresh.predict(host[0])),
                "restored predictions differ from the live state's")
        a = live.state.optimizer.state_dict()["state"]
        b = fresh.state.optimizer.state_dict()["state"]
        require(fresh.state.step == live.state.step == steps
                and a.keys() == b.keys()
                and all(torch.equal(a[i][k].cpu(), b[i][k].cpu()) for i in a
                        for k in ("step", "exp_avg", "exp_avg_sq")),
                "restored Adam moments differ from the live state's")

        moved = list(device_prefetch(iter(host[:2]), device))
        require(len(moved) == 2 and all(
            torch.equal(m[k], torch.as_tensor(h[k]).to(device))
            for m, h in zip(moved, host[:2]) for k in h),
            "device_prefetch bytes differ from a plain copy")

        fresh.evaluate(host)                        # warm-up
        start = time.perf_counter()
        fresh.evaluate(host)                        # fetches its table
        out["eval_images_per_s"] = spe * cfg.batch_size / (
            time.perf_counter() - start)

        out["profile"] = out["feed"] = None
        if device.type == "cuda":
            out["feed"] = host_feed(live, scenes, FEED_PAIRS)
            # the step's wall time unprofiled, from a synchronize to one
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                start = time.perf_counter()
                live.train_step(host[0])
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - start))
            out["step_wall_ms"] = walls
            # under the profiler, host and card: once to start the tracer
            # (discarded), once read; then the card's activity alone, which
            # slows the host less
            for i in range(2):
                with profiling.trace(os.path.join(tmp, f"trace{i}")) as prof:
                    with torch.profiler.record_function(STEP_SPAN):
                        live.train_step(host[0])
            out["profile"] = device_top(prof)
            out["idle"] = device_idle(
                os.path.join(tmp, "trace1", "trace.json"), STEP_SPAN)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as card_only:
                live.train_step(host[0])
                torch.cuda.synchronize()
            card_only.export_chrome_trace(os.path.join(tmp, "card.json"))
            out["idle_card"] = device_idle(os.path.join(tmp, "card.json"))
    out.update({"losses": losses, "launches": launches, "counts": counts,
                "steps": steps,
                "loop_images_per_s": train_rows[-1]["examples_per_sec"],
                "all": last["all"]})
    return out


# --- phase 9 ----------------------------------------------------------------

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
    ap.add_argument("--steps", type=int, default=5)
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
    with phase("5 warp"):
        wp = check_warp(device, cfg.batch_size, cfg, args.seed, name_power)
        check_plane_sweep(device, cfg.batch_size, args.seed, name_power)
    with phase("6 self-supervised training"):
        ss_cfg = cfg.replace(depth_supervision_only=False)
        ss = train_selfsup(device, ss_cfg, cfg.batch_size, args.steps,
                           args.seed)
        print(f"  {args.steps} steps of {cfg.batch_size}x{cfg.height}x"
              f"{cfg.width}, frames {tuple(ss_cfg.frame_ids)}: "
              f"{ss['ms_per_step']:.2f} ms/step (median), "
              f"{ss['images_per_s']:.2f} images/s over the timed window, "
              f"peak memory {ss['max_memory_bytes'] / 2 ** 30:.2f} GiB  "
              f"[{name_power}]")
        print(f"  losses {['%.6f' % x for x in ss['losses']]}")
        print(f"  launches {ss['launches']} ({ss['launches_per_step']} "
              f"per step)")
        print(f"  step with the plain warps: loss {ss['loss_plain']:.7f} vs "
              f"{ss['loss_kernel']:.7f} (rel err {ss['loss_rel_err']:.3e}, "
              f"limit {STEP_LOSS_RTOL}); gradients: worst "
              f"{ss['grad_worst']} at {ss['grad_err_over_limit']:.3f} of "
              f"its limit ({STEP_GRAD_RTOL} of its max + {NOISE_MULT} x its "
              f"float32 spread); median relative err "
              f"{ss['grad_rel_err_median']:.3e}")
    with phase("7 supervised training"):
        sv = train_supervised(device, cfg, cfg.batch_size, args.steps,
                              args.seed)
        print(f"  {args.steps} steps of {cfg.batch_size}x{cfg.height}x"
              f"{cfg.width}: {sv['ms_per_step']:.2f} ms/step (median), "
              f"{sv['images_per_s']:.2f} images/s over the timed window  "
              f"[{name_power}]")
        print(f"  losses {['%.6f' % x for x in sv['losses']]}")
        print(f"  launches {sv['launches']}")
    with phase("8 train loop"):
        lp = train_loop(device)
        print(f"  decoders that import: {lp['decoders']}")
        print(f"  train --synthetic {LOOP_SCENES} --num_epochs {LOOP_EPOCHS}"
              f" ({cfg.batch_size}x{cfg.height}x{cfg.width}, "
              f"{lp['steps']} steps): {lp['wall_s']:.2f} s in all  "
              f"[{name_power}]")
        print(f"  losses per epoch {['%.6f' % x for x in lp['losses']]}; "
              f"last table's all row {lp['all']}")
        print(f"  launches {lp['launches']} = train steps + eval batches + "
              f"logged images' predictions {lp['counts']}")
        print(f"  evaluate --weights step_{lp['steps']} vs the fit's last "
              f"table: largest relative difference {lp['eval_rel_diff']:.3e}"
              f" (limit {EVAL_TABLE_RTOL})")
        print("  restore into a fresh Trainer: predictions and Adam moments "
              "bit-identical; device_prefetch: the same bytes as .to()")
        print(f"  loop images/s in epoch 2 (cached samples) "
              f"{lp['loop_images_per_s']:.2f} vs phase 7's step alone "
              f"{sv['images_per_s']:.2f} (ratio "
              f"{lp['loop_images_per_s'] / sv['images_per_s']:.3f})  "
              f"[{name_power}]")
        fd = lp["feed"]
        print(f"  host feed, {FEED_PAIRS} pairs of {fd['steps']}-step epochs "
              f"in turns: loop (cached samples) "
              f"{['%.2f' % x for x in fd['loop']]} images/s, the same "
              f"batches on the card {['%.2f' % x for x in fd['alone']]}; "
              f"ratio per pair {['%.4f' % x for x in fd['ratio']]} (median "
              f"{np.median(fd['ratio']):.4f}, range {min(fd['ratio']):.4f}"
              f"-{max(fd['ratio']):.4f})  [{name_power}]")
        print(f"  eval images/s {lp['eval_images_per_s']:.2f}  "
              f"[{name_power}]")
        prof = lp["profile"]
        if prof and prof["top"]:
            idle, lean = lp["idle"], lp["idle_card"]
            print(f"  one train step of the loop, unprofiled, synchronize to "
                  f"synchronize: {['%.2f' % x for x in lp['step_wall_ms']]}"
                  f" ms  [{name_power}]")
            for what, d in (("the card's activity alone", lean),
                            ("host and card", idle)):
                print(f"  the same step under torch.profiler ({what}): wall "
                      f"span {d['span_ms']:.2f} ms (from the step's start "
                      f"on the host to the last device operation's end), "
                      f"device busy "
                      f"{d['busy_ms']:.2f} ms (union of {d['ops']} "
                      f"operations), idle share {d['idle_share']:.4f}; the "
                      f"host queues the step in {d['host_ms']:.2f} ms, the "
                      f"first device operation starts {d['first_op_ms']:.3f}"
                      f" ms in  [{name_power}]")
            print(f"  summed device time (host and card) "
                  f"{prof['device_ms']:.2f} ms; its longest idle gaps:")
            for g in idle["gaps"]:
                print(f"    {g['ms']:.3f} ms at {g['at_ms']:.2f} ms, before "
                      f"{g['next_op'][:60]} (launched in "
                      f"{g['launched_by'][:60]})")
            print(f"  host calls that wait on the card: {idle['n_waits']}; "
                  f"those of 0.05 ms or more:")
            for w in idle["waits"]:
                print(f"    {w['name']} {w['ms']:.3f} ms at {w['at_ms']:.2f}"
                      f" ms, in {w['in']}")
            print("  by kind: " + "; ".join(
                f"{k} {ms:.2f} ms ({100 * sh:.1f}%)"
                for k, (ms, sh) in prof["kinds"].items()))
            print("  the ten largest device operations:")
            for name, ms, share in prof["top"]:
                print(f"    {ms:9.3f} ms  {100 * share:5.1f}%  {name[:110]}")
        else:
            print("  profile of one train step: the profiler recorded no "
                  "device operation")
    with phase("9 result"):
        par = wp["parallax"]
        warp_err = max(max(v["errors"]["out"], v["errors"]["dix"],
                           v["errors"]["diy"]) for v in wp.values())
        kernels = [{
            "name": "polar_preprocess", "route": "cuda",
            "source": "polardepth_tpu_torch/csrc/polar_preprocess.cu",
            "replaces": "polardepth_tpu/ops/pallas/polar_preprocess.py:239",
            "launches": s["launches"]["polar_preprocess"],
            "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
            "host_ms": k1["host_ms"], "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"], "library_ms": None}]
        for name, k, line in (("band_warp_fwd", "fwd", 376),
                              ("band_warp_bwd", "bwd", 417)):
            kernels.append({
                "name": name, "route": "cuda",
                "source": "polardepth_tpu_torch/csrc/band_warp.cu",
                "replaces": f"polardepth_tpu/ops/pallas/band_warp.py:{line}",
                "launches": ss["launches"][name], "max_abs_err": warp_err,
                "ms": par["times"][k], "host_ms": par["times"][k + "_host"],
                "plain_ms": par["times"][k + "_plain"],
                "bound_ms": par["bounds"][k][0],
                "bound_by": par["bounds"][k][1],
                "library_ms": par["times"][k + "_library"]})
        print(f"  card: {name_power}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(result_line(device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
