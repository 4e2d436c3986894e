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
  8. result: the kernels' JSON line, then the final JSON line.

Usage: python3 chip_smoke.py [--seed N] [--requests N] [--steps N]
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

import torch.nn.functional as F

from polardepth_tpu_torch.config import PUBLISHED, Config
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
from polardepth_tpu_torch.train import selfsup, state
from polardepth_tpu_torch.train.losses import preprocess_batch
from polardepth_tpu_torch.train.trainer import (
    Predictor, build_model, make_train_step)

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
    a spin on the card (0.2 ms per call, several times a wrapper's host
    time), so that the card runs them with no wait for the host: a
    kernel's own time where its wrapper's host time per call is longer and
    time_ms reads the host.  Printed beside time_ms's reading, which the
    kernels line keeps."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * 0.2 * iters))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
        t["fwd"], t["fwd_host"] = time_ms(
            lambda: band_warp.band_warp_fwd(img, ix, iy), iters)
        t["fwd_plain"] = time_ms(
            lambda: band_warp.band_warp_fwd_plain(img, ix, iy), 10)[0]
        t["bwd"], t["bwd_host"] = time_ms(
            lambda: band_warp.band_warp_bwd(img, ix, iy, g), iters)
        t["bwd_plain"] = time_ms(
            lambda: band_warp.band_warp_bwd_plain(img, ix, iy, g), 10)[0]
        t["fwd_device"] = device_ms(
            lambda: band_warp.band_warp_fwd(img, ix, iy), iters)
        t["bwd_device"] = device_ms(
            lambda: band_warp.band_warp_bwd(img, ix, iy, g), iters)
        # the library yardstick: torch's bilinear border grid_sample on the
        # same image (a channels-last view) and grid; its grid-only backward
        nchw = img.permute(0, 3, 1, 2)
        t["fwd_library"] = time_ms(lambda: F.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="border",
            align_corners=True), iters)[0]
        grid_req = grid.detach().clone().requires_grad_(True)
        lib_out = F.grid_sample(nchw, grid_req, mode="bilinear",
                                padding_mode="border", align_corners=True)
        g_nchw = g.permute(0, 3, 1, 2)
        t["bwd_library"] = time_ms(lambda: torch.autograd.grad(
            lib_out, grid_req, g_nchw, retain_graph=True), iters)[0]
        n_out = ix.numel()
        bounds = {"fwd": warp_bound_ms(batch, h, w, c, n_out, False),
                  "bwd": warp_bound_ms(batch, h, w, c, n_out, True)}
        for k in ("fwd", "bwd"):
            bound, by = bounds[k]
            print(f"  {name:8s} {'K2' if k == 'fwd' else 'K3'} kernel_ms "
                  f"{t[k]:.4f}  (wrapper host ms {t[k + '_host']:.4f}; "
                  f"behind a spin {t[k + '_device']:.4f})  "
                  f"plain_ms {t[k + '_plain']:.4f}  "
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


# --- phase 8 ----------------------------------------------------------------

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
    with phase("8 result"):
        par = wp["parallax"]
        warp_err = max(max(v["errors"]["out"], v["errors"]["dix"],
                           v["errors"]["diy"]) for v in wp.values())
        kernels = [{
            "name": "polar_preprocess", "route": "cuda",
            "source": "polardepth_tpu_torch/csrc/polar_preprocess.cu",
            "replaces": "polardepth_tpu/ops/pallas/polar_preprocess.py:239",
            "launches": s["launches"]["polar_preprocess"],
            "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
            "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"], "library_ms": None}]
        for name, k, line in (("band_warp_fwd", "fwd", 376),
                              ("band_warp_bwd", "bwd", 417)):
            kernels.append({
                "name": name, "route": "cuda",
                "source": "polardepth_tpu_torch/csrc/band_warp.cu",
                "replaces": f"polardepth_tpu/ops/pallas/band_warp.py:{line}",
                "launches": ss["launches"][name], "max_abs_err": warp_err,
                "ms": par["times"][k], "plain_ms": par["times"][k + "_plain"],
                "bound_ms": par["bounds"][k][0],
                "bound_by": par["bounds"][k][1],
                "library_ms": par["times"][k + "_library"]})
        print(f"  card: {name_power}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(result_line(device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
