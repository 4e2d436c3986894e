#!/usr/bin/env python3
"""On-card smoke run of polardepth_tpu_torch, the PyTorch/CUDA port.

Serves the published tri-encoder (uint8 captures -> metric depth, 320x480,
batch 12, seeded random weights) through ``Predictor.predict``, trains the
self-supervised + depth-supervised model (``make_selfsup_train_step``, also
with the residual-pose pass), the published supervised model
(``make_train_step``) and the ManyDepth teacher-student model
(``make_student_train_step``) for a few steps at the same geometry, serves,
trains and exports the attention variant, takes the published model in and
out of the port (a
``torch.export`` program, reference .pth files, ImageNet-shaped encoder
weights, point clouds, the analysis report and the AR GIF), and holds every
CUDA kernel of those paths against its plain torch version.  One timed line
per phase:

  1. device: the card's name and power limit; torch's global TF32 flags,
     left as torch sets them (cuDNN's on): every entry point of the port
     computes float32 itself (utils/precision.py).
  2. build: nvcc builds the kernels from csrc/ (ops/build.py).
  3. kernel: the polar-preprocess kernel against its plain version at the
     serving shape, on physical, wild, zero-intensity and odd-sized inputs;
     its time beside the plain version's and its memory bound.
  4. serve: one warm-up request and ``--requests`` timed requests; every
     depth finite and in range, one kernel launch per request, and the depth
     equal (within DEPTH_TOL) to the same model run with the plain preprocess
     on the card and, for the first image, on the CPU.
  5. warp: the band-warp kernels K2 (forward), K3 (grid gradient) and K4
     (image gradient) against their plain versions at the training shape
     (12, 320, 480, 3) on a parallax grid (project_3d of a random depth and
     pose), a sheared grid whose rows leave the 32-row band and a smooth
     grid (project_3d of phase 7's smooth depth); the share of pixels the
     band clamps and of K4's taps that spill past its shared-memory
     window (counted on the card by K4's counting build); kernel, plain and library times (the forward, grid-only and
     input-only backward of grid_sample); the bounds.
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
  9. teacher-student training: PUBLISHED with train_student and
     depth_supervision_only off (96 depth bins, matching frame -1, the
     lookup poses from the teacher's pose net, the plane sweep through K2
     with an 8-row band), one warm-up and ``--steps`` timed steps and one
     frozen-teacher step; K1 once, K2 22 times (6 of them the sweep's
     lanes kernel) and K3 16 times per step, K3 8 times in the frozen one;
     the sweep's share of one profiled step; the kernel step against the
     plain-warp step; the cost volume through K2 against its plain version
     and against the exact "xla" route (the band's clamped share); then
     the command line's ``train --train_student --synthetic 24
     --num_epochs 2`` and ``train --depth_supervision_only false
     --synthetic 12 --num_epochs 1``.
 10. deploy: the published model exported with a symbolic batch
     (eval/export.py: exactly one polar-preprocess operator node), saved,
     loaded fresh and held against ``Predictor`` at batch 12 and 3 (K1
     once per call), then both timed in turns; reference .pth files
     written from the same weights through ``evaluate
     --reference_weights --save_pred_disps`` against ``evaluate
     --weights``; ``train --weights_init pretrained`` for two steps from a
     seeded torchvision-shaped .npz, its grafted leaves checked; and
     ``pointcloud``, ``analyze`` and ``ar`` on the card's predictions,
     their files checked.
 11. attention: the arch1++_attention variant (PUBLISHED with
     use_attention) served as in phase 4, then in turns with the same
     model without the attention on one batch, trained as in phase 7
     (with its peak memory), exported and loaded as in phase 10, and the
     command line's ``train --use_attention --synthetic 24 --num_epochs
     1``.
 12. res_pose: the self-supervised step of phase 6 with the residual-pose
     pass; K1 once, K2 and K3 ten times and K4 (the image gradient) twice
     per step; K4's device time in a profiled step; the kernel step against
     the plain-warp step; and the
     command line's ``train --depth_supervision_only false --res_pose
     --synthetic 12 --num_epochs 1``.
 13. precision: the published supervised step in turns as its entry point
     runs it (float32) and its body under TF32-on flags (measurement
     only), and ``cli.main(["evaluate", ...])`` under TF32-on flags
     against the same run inside float32(): equal tables, the flags left
     on.  Last, so that no earlier phase finds the card in another state
     than without it.
 14. result: the kernels' JSON line, then the final JSON line.

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
import shutil
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
from polardepth_tpu_torch.eval.export import (
    load_module, make_export, preprocess_nodes, save_artifact)
from polardepth_tpu_torch.eval.pointcloud import read_ply
from polardepth_tpu_torch.models import cost_volume
from polardepth_tpu_torch.models.convert import (
    jax_from_state_dict, state_dict_from_jax)
from polardepth_tpu_torch.models.reference_import import (
    load_reference_components)
from polardepth_tpu_torch.ops import band_warp, build
from polardepth_tpu_torch.ops.camera import backproject_depth, project_3d
from polardepth_tpu_torch.ops.depth import disp_to_depth
from polardepth_tpu_torch.ops.fresnel import host_tables
from polardepth_tpu_torch.ops.polar_preprocess import (
    fused_polar_preprocess, polar_preprocess_plain)
from polardepth_tpu_torch.ops.se3 import transformation_from_parameters
from polardepth_tpu_torch.ops.warp import grid_sample
from polardepth_tpu_torch.train import checkpoint, selfsup, state, student
from polardepth_tpu_torch.train.losses import preprocess_batch
from polardepth_tpu_torch.train.trainer import (
    Predictor, Trainer, build_model, make_train_step)
from polardepth_tpu_torch.utils import profiling
from polardepth_tpu_torch.utils.precision import float32

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
# the self-supervised step warps 4 scales x 2 source frames; with res_pose
# it warps each source frame's warp once more, whose image carries a
# gradient (K4)
WARPS_PER_STEP = 8
RES_WARPS_PER_STEP = 2
# K4 vs its plain version: the products are the plain version's to the bit,
# the sums of the contributions to one pixel run in another order (atomics).
# Two float32 sums of the same n terms differ by at most 2 (n - 1) u times
# the sum of their magnitudes, u = 2^-24: the limit, per pixel.
F32_UNIT_ROUNDOFF = 2.0 ** -24
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


def launches_of(**counts) -> dict:
    """Launch counts of every kernel of ops/build.py: those given, 0 for the
    rest."""
    unknown = set(counts) - set(build.launch_counts)
    if unknown:
        raise KeyError(f"no kernel named {sorted(unknown)}")
    return {k: counts.get(k, 0) for k in build.launch_counts}


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
            elif k == "kernel":     # torch's default init range: 1/sqrt(fan_in)
                fan_in = np.prod(v.shape[:3] if v.ndim == 4 else v.shape[:1])
                bound = 1.0 / np.sqrt(fan_in)
                out[k] = rng.uniform(-bound, bound, v.shape)
            elif k in ("scale", "var", "gamma"):
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
    with torch.inference_mode(), float32():
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


def smooth_grid(rng, batch: int, h: int, w: int, device) -> torch.Tensor:
    """project_3d of a smooth depth in [0.3, 1.5] m (the seeded smooth
    texture of phase 7's training batch) through a small pose: the kind of
    grid the res_pose step re-warps through, a predicted depth."""
    depth = 0.3 + 1.2 * smooth_uint8(rng, (batch, h, w, 1), device).float() \
        / 255.0
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


def img_grad_bound_ms(b: int, h: int, w: int, c: int,
                      n_out: int) -> tuple[float, str]:
    """K4: reads ix, iy and the cotangent once and writes the image
    gradient once (the launcher's zeroing pass is the implementation's, not
    the function's); 4 weights and 4C multiply-adds per pixel."""
    t_bytes = (n_out * (8 + 4 * c) + b * h * w * c * 4) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = n_out * (8 + 8 * c) / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def img_grad_limit(img, ix, iy, g) -> tuple[torch.Tensor, int]:
    """(K4's limit against its plain version per pixel: 2 (n - 1) u times
    the sum of the magnitudes of its n contributions, the most two float32
    sums of the same terms in two orders can differ by; the largest n)."""
    b, h, w, _ = img.shape
    magnitude = band_warp.band_warp_img_grad_plain(img, ix, iy, g.abs())
    _, _, *index = band_warp.tap_index(h, w, ix, iy)
    base = (torch.arange(b, device=ix.device) * h * w).view(b, 1, 1)
    terms = torch.bincount(torch.cat([(i + base).reshape(-1) for i in index]),
                           minlength=b * h * w).reshape(b, h, w, 1)
    limit = 2 * (terms - 1).clamp(min=0) * F32_UNIT_ROUNDOFF * magnitude
    return limit, int(terms.max())


def img_grad_errors(img, ix, iy, g) -> dict:
    """K4 against its plain version: the largest difference, and the
    largest ratio of a pixel's difference to its limit
    (``img_grad_limit``)."""
    k_grad = band_warp.band_warp_img_grad(img, ix, iy, g)
    p_grad = band_warp.band_warp_img_grad_plain(img, ix, iy, g)
    limit, terms = img_grad_limit(img, ix, iy, g)
    diff = (k_grad - p_grad).abs()
    over = torch.where(diff == 0, 0.0, diff / limit)
    return {"img_grad": float(diff.max()),
            "img_grad_over_limit": float(over.max()),
            "img_grad_max": float(p_grad.abs().max()),
            "img_grad_terms": terms,
            "img_grad_finite": bool(torch.isfinite(k_grad).all())}


def img_grad_live_taps(ix, iy) -> int:
    """The taps of nonzero bilinear weight of (ix, iy), as K4 forms the
    weights: what its counting build must count as taps."""
    fx, fy = ix - ix.floor(), iy - iy.floor()
    return int(sum(int((w != 0).sum()) for w in (
        (1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)))


def check_warp(device: torch.device, batch: int, cfg: Config, seed: int,
               name_power: str, iters: int = 100) -> dict:
    """K2, K3 and K4 against their plain versions on three grids; times;
    the share of K4's taps that spill past its window, from its counting
    build (held to its limit too)."""
    rng = np.random.default_rng(seed + 5)
    h, w, c = cfg.height, cfg.width, 3
    img = torch.from_numpy(rng.uniform(0, 1, (batch, h, w, c)).astype(
        np.float32)).to(device)
    g = torch.from_numpy(rng.normal(size=(batch, h, w, c)).astype(
        np.float32)).to(device)
    geo = band_warp.band_geometry(h, w, c, h)
    out = {}
    grids = {"parallax": parallax_grid(rng, batch, h, w, device),
             "sheared": sheared_grid(batch, h, w, device),
             "smooth": smooth_grid(rng, batch, h, w, device)}
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
        e.update(img_grad_errors(img, ix, iy, g))
        print(f"  {name:8s} K4 max|grad| err {e['img_grad']:.3e} of "
              f"{e['img_grad_max']:.3e}, at most {e['img_grad_over_limit']:.4f}"
              f" of its pixel's limit (2 (n-1) 2^-24 sum|terms|, up to n = "
              f"{e['img_grad_terms']} terms)  finite "
              f"{e['img_grad_finite']}")
        require(e["img_grad_finite"],
                f"non-finite K4 output on the {name} grid")
        require(e["img_grad_over_limit"] <= 1.0,
                f"K4 error on the {name} grid")
        counted, n = band_warp.band_warp_img_grad_counted(img, ix, iy, g)
        taps = img_grad_live_taps(ix, iy)
        spill = n["spilled"] / max(n["taps"], 1)
        print(f"  {name:8s} K4's counting build: {100 * spill:.3f}% of "
              f"{n['taps']} taps of nonzero weight spill past the windows "
              f"(counted on the card); the windows hold "
              f"{n['window_floats'] / img.numel():.3f}x the image's floats")
        require(n["taps"] == taps, f"K4's counting build counted "
                f"{n['taps']} taps on the {name} grid, not {taps}")
        diff = (counted - band_warp.band_warp_img_grad_plain(
            img, ix, iy, g)).abs()
        require(bool(torch.isfinite(counted).all()) and bool(
            (diff <= img_grad_limit(img, ix, iy, g)[0]).all()),
            f"K4's counting build outside its limit on the {name} grid")
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
        t["img_b2b"], t["img_host"] = time_ms(
            lambda: band_warp.band_warp_img_grad(img, ix, iy, g), iters)
        t["img"] = device_ms(
            lambda: band_warp.band_warp_img_grad(img, ix, iy, g), iters)
        t["img_plain"] = device_ms(
            lambda: band_warp.band_warp_img_grad_plain(img, ix, iy, g), 10)
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
        # grid_sample's input-only backward: bilinear (0), border (1)
        t["img_library"] = device_ms(
            lambda: torch.ops.aten.grid_sampler_2d_backward(
                g_nchw, nchw, grid, 0, 1, True, [True, False]), iters)
        n_out = ix.numel()
        bounds = {"fwd": warp_bound_ms(batch, h, w, c, n_out, False),
                  "bwd": warp_bound_ms(batch, h, w, c, n_out, True),
                  "img": img_grad_bound_ms(batch, h, w, c, n_out)}
        for k, kernel, library in (
                ("fwd", "K2", "F.grid_sample forward"),
                ("bwd", "K3", "F.grid_sample grid backward"),
                ("img", "K4", "grid_sampler_2d_backward input-only")):
            bound, by = bounds[k]
            print(f"  {name:8s} {kernel} kernel_ms "
                  f"{t[k]:.4f} behind a spin  (wrapper host ms "
                  f"{t[k + '_host']:.4f}; back to back {t[k + '_b2b']:.4f})"
                  f"  plain_ms {t[k + '_plain']:.4f}  {library}"
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
    ms = device_ms(lambda: band_warp.band_warp_fwd(img, ix, iy), iters)
    host_ms = time_ms(lambda: band_warp.band_warp_fwd(img, ix, iy), iters)[1]
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
    print(f"  plane sweep K2 kernel_ms {ms:.4f} (host_ms {host_ms:.4f})  "
          f"plain_ms {plain_ms:.4f}  "
          f"F.grid_sample forward ms {library_ms:.4f}  bound_ms "
          f"{bound_ms:.4f} ({by})  share of bound {bound_ms / ms:.3f}  "
          f"[{name_power}]")
    clamped = x["clamped"]
    del x, img, ix, iy, nchw
    torch.cuda.empty_cache()     # the plain version's gigabytes of gathers
    return {"max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": by, "clamped": clamped}


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


def selfsup_launches(cfg: Config) -> dict:
    """Launches per self-supervised step on the card: K1 once; K2 and K3 for
    every warp; with res_pose the re-warps' K2, K3 and K4."""
    res = RES_WARPS_PER_STEP if cfg.res_pose else 0
    return launches_of(polar_preprocess=1,
                       band_warp_fwd=WARPS_PER_STEP + res,
                       band_warp_bwd=WARPS_PER_STEP + res,
                       band_warp_img_grad=res)


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
        saved = (band_warp.band_warp_fwd, band_warp.band_warp_bwd,
                 band_warp.band_warp_img_grad)
        if plain:
            band_warp.band_warp_fwd = band_warp.band_warp_fwd_plain
            band_warp.band_warp_bwd = band_warp.band_warp_bwd_plain
            band_warp.band_warp_img_grad = band_warp.band_warp_img_grad_plain
        try:
            loss = float(step(st, batch, gen)["loss"])
        finally:
            (band_warp.band_warp_fwd, band_warp.band_warp_bwd,
             band_warp.band_warp_img_grad) = saved
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
    want = ({k: v * n for k, v in selfsup_launches(cfg).items()}
            if device.type == "cuda" else launches_of())
    require(launches == want, f"self-supervised launches {launches}, "
            f"expected {want}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    n_waits = prof = None
    if device.type == "cuda":     # the step's host waits, for phase 9
        prof = profiled_step(lambda: step(st, batch, gen))
        n_waits = prof["idle"]["n_waits"]
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
            "n_waits": n_waits, **check,
            # K4's kernel time in the profiled step, and the step's device
            # time (the launcher's zeroing is a memset beside it)
            "k4_ms": None if prof is None else sum(
                ms for k, ms, _ in prof["top"] if "band_warp_img_grad" in k),
            "device_ms": None if prof is None else prof["device_ms"]}


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
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses, times, window, launches = run_steps(step, st, batch, gen, steps,
                                                device)
    n = steps + 1
    want = launches_of(polar_preprocess=n if cuda else 0)
    require(launches == want, f"supervised launches {launches}, expected "
            f"{want}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    return {"losses": losses, "ms_per_step": 1e3 * float(np.median(times)),
            "images_per_s": batch_size * steps / window,
            "launches": launches,
            "max_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else None)}


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
        require(launches == launches_of(polar_preprocess=want),
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


# --- phase 9: the teacher-student run --------------------------------------

# The student step at STUDENT_CFG: K1 once (the teacher's depth net); K2 for
# the 4 scales x 2 source frames of the teacher's and of the student's
# photometric warps, and once per 16-bin chunk of the cost volume's 96 bins
# (the lanes kernel); K3 the backward of the warps that carry a gradient:
# both models' in the unfrozen step, the student's alone in the frozen one.
SWEEP_CHUNKS = PUBLISHED.num_depth_bins // 16
STUDENT_LAUNCHES = launches_of(
    polar_preprocess=1, band_warp_fwd=2 * WARPS_PER_STEP + SWEEP_CHUNKS,
    band_warp_fwd_lanes=SWEEP_CHUNKS, band_warp_bwd=2 * WARPS_PER_STEP)
FROZEN_LAUNCHES = dict(STUDENT_LAUNCHES, band_warp_bwd=WARPS_PER_STEP)
# the student's infer step (an eval batch): K1 and the sweep
STUDENT_INFER_LAUNCHES = launches_of(polar_preprocess=1,
                                     band_warp_fwd=SWEEP_CHUNKS,
                                     band_warp_fwd_lanes=SWEEP_CHUNKS)
# The JAX package's limit between its banded plane sweep and the exact one
# on the pixels that survive the edge mask (tests/test_band_warp.py:143-182,
# small poses): measured here at full width, reported, not enforced, since
# the band clamps wherever a pose's vertical parallax leaves 8 rows.
SWEEP_XLA_TOL = 3e-5
# The command line's teacher-student and self-supervised runs
STUDENT_CLI = (("--train_student", 24, 2),
               ("--depth_supervision_only false", 12, 1))


def student_cfg() -> Config:
    return PUBLISHED.replace(train_student=True, depth_supervision_only=False)


def _student_step_grads(cfg, weights, batch, device, seed, frozen,
                        plain=False, scale=None, jiggle=None):
    """(loss, gradients) of the first student step from weights."""
    model = student.StudentModel.from_config(cfg)
    model.load_state_dict(weights)
    model.to(device)
    with torch.no_grad():
        gen = torch.Generator(device=device).manual_seed(jiggle or 0)
        for prm in model.parameters():
            if scale is not None:
                prm.mul_(scale)
            if jiggle is not None:
                sign = torch.randint(0, 2, prm.shape, generator=gen,
                                     device=device) * 2 - 1
                prm.mul_(1.0 + sign * 2.0 ** -20)
    st = state.create_train_state(model, cfg)
    step = student.make_student_train_step(model, cfg, freeze_teacher=frozen)
    gen = torch.Generator(device=device).manual_seed(seed)
    saved = band_warp.band_warp_fwd, band_warp.band_warp_bwd
    if plain:
        band_warp.band_warp_fwd = band_warp.band_warp_fwd_plain
        band_warp.band_warp_bwd = band_warp.band_warp_bwd_plain
    try:
        _, logs = step(st, student.initial_trackers(cfg, device), batch, gen)
        loss = float(logs["loss"])
    finally:
        band_warp.band_warp_fwd, band_warp.band_warp_bwd = saved
    grads = _grads(model)
    del model, st
    return loss, grads


def plain_warp_student_step(cfg: Config, weights: dict, batch: dict, device,
                            seed: int) -> dict:
    """The first student step with the kernels against the same step with
    the plain warps (photometric warps and plane sweep) on the card, from
    the same weights, batch and draws.  Each gradient must lie within
    STEP_GRAD_RTOL of its max abs plus NOISE_MULT times its float32 spread:
    the change of the kernel step's gradients from the weights scaled by
    1 + 2^-20, as in phase 6; for the student's leaves (``encoder.``,
    ``depth.``, behind the plane sweep, where train-mode BatchNorm
    normalises a uniform scale away) the larger of that and the change
    from each weight element multiplied by 1 + or - 2^-20 at random
    (tests/test_torch_student.py)."""
    loss_k, g_k = _student_step_grads(cfg, weights, batch, device, seed,
                                      False)
    loss_p, g_p = _student_step_grads(cfg, weights, batch, device, seed,
                                      False, plain=True)
    spread = {k: 0.0 for k in g_k}
    for kw in ({"scale": 1 + 2 ** -20}, {"jiggle": 1}):
        _, g_r = _student_step_grads(cfg, weights, batch, device, seed,
                                     False, **kw)
        for k in g_k:
            if "scale" in kw or k.startswith(("encoder.", "depth.")):
                spread[k] = max(spread[k],
                                float((g_k[k] - g_r[k]).abs().max()))
        del g_r
    ratios = {k: float((g_k[k] - g_p[k]).abs().max()) / (
        STEP_GRAD_RTOL * float(g_p[k].abs().max()) + NOISE_MULT * spread[k]
        + 1e-30) for k in g_p}
    worst = max(ratios, key=ratios.get)
    rel = {k: float((g_k[k] - g_p[k]).abs().max())
           / max(float(g_p[k].abs().max()), 1e-30) for k in g_p}
    return {"loss_kernel": loss_k, "loss_plain": loss_p,
            "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
            "grad_err_over_limit": ratios[worst], "grad_worst": worst,
            "grad_rel_err_median": float(np.median(list(rel.values())))}


def sweep_check(model: student.StudentModel, cfg: Config, batch: dict,
                device, seed: int) -> dict:
    """The cost volume at full width through K2 (8-row band) against the
    same sweep with K2's plain version (must be equal) and against the
    exact "xla" route: the largest difference on the pixels both keep, the
    share of those beyond SWEEP_XLA_TOL, and the share of the sweep's
    samples whose source row the band clamps.  Features of the batch's
    frames 0 and -1 through the student's extractor; the lookup poses are
    the synthetic scenes' own (SyntheticHammer.relative_pose)."""
    b = batch["color_frames"].shape[0]
    gen = SyntheticHammer(cfg.height, cfg.width, seed=cfg.seed + seed)
    poses = torch.from_numpy(np.stack([
        gen.relative_pose(i, -cfg.offset, 0) for i in range(b)])[:, None]
    ).to(device)
    K4, inv_K4 = student.quarter_intrinsics(batch["K"])
    frames = batch["color_frames"].float() / 255.0
    with torch.no_grad(), float32():
        extractor = model.encoder._FeatureExtractor_0
        _, f1 = extractor(frames[:, 0].permute(0, 3, 1, 2))
        _, look = extractor(frames[:, 1].permute(0, 3, 1, 2))
        cur = f1.permute(0, 2, 3, 1).contiguous()
        look = look.permute(0, 2, 3, 1).contiguous()[:, None]
        bins = cost_volume.compute_depth_bins(cfg.min_depth, cfg.max_depth,
                                              cfg.num_depth_bins,
                                              device=device)
        args = (cur, look, poses, K4, inv_K4, bins, 16)
        k2, miss_k2 = cost_volume.build_cost_volume(*args, "auto")
        saved = band_warp.band_warp_fwd
        band_warp.band_warp_fwd = band_warp.band_warp_fwd_plain
        try:
            plain, _ = cost_volume.build_cost_volume(*args, "auto")
        finally:
            band_warp.band_warp_fwd = saved
        xla, miss_xla = cost_volume.build_cost_volume(*args, "xla")
        keep = (miss_k2 == 0) & (miss_xla == 0)
        diff = (k2 - xla).abs()[keep]
        h, w, c = cur.shape[1:]
        cam, P = cost_volume.sweep_setup(K4, inv_K4, poses, h, w)
        geo = band_warp.band_geometry(h, w, c, 16 * h, k=8)
        clamped = 0.0
        for i in range(0, cfg.num_depth_bins, 16):   # the sweep's chunks
            _, _, grid = cost_volume.sweep_grid(cam, P, bins[i:i + 16], h, w)
            _, iy, _ = band_warp.prep(look[:, 0].shape, grid, geo["k"],
                                      geo["step"], True, geo["wp"])
            _, iy_all, _ = band_warp.prep(look[:, 0].shape, grid, h, 1, True)
            clamped += float((iy != iy_all).float().mean())
    out = {"plain_err": float((k2 - plain).abs().max()),
           "xla_err": float(diff.max()) if diff.numel() else 0.0,
           "xla_beyond_tol": float((diff > SWEEP_XLA_TOL).float().mean())
           if diff.numel() else 0.0,
           "kept": float(keep.float().mean()),
           "missing_equal": bool(torch.equal(miss_k2, miss_xla)),
           "clamped": clamped / (cfg.num_depth_bins // 16),
           "finite": bool(torch.isfinite(k2).all())}
    require(out["finite"], "non-finite cost volume through K2")
    require(out["plain_err"] <= WARP_TOL, "cost volume through K2 vs its "
            f"plain version: {out['plain_err']:.3e}")
    return out


def profiled_step(run) -> dict:
    """One call of run() (a train step, no host read of its result) under
    torch.profiler, host and card, annotated as STEP_SPAN: the device time
    by kernel (``device_top``) and, from the step's own trace, its idle
    share and the host calls that wait on the card (``device_idle``)."""
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            with torch.profiler.record_function(STEP_SPAN):
                run()
        top = device_top(prof, n=1000)
        return {**top, "idle": device_idle(os.path.join(tmp, "trace.json"),
                                           STEP_SPAN)}


def train_student(device, cfg: Config, batch_size: int, steps: int,
                  seed: int) -> dict:
    """1 + steps teacher-student steps, a frozen-teacher step, the launch
    counts of each, the kernel step against the plain-warp step, the sweep
    against its plain version and the exact route, and the sweep's share of
    a profiled step."""
    device = torch.device(device)
    rng = np.random.default_rng(seed + 9)
    model = student.StudentModel.from_config(cfg)
    weights = seeded_state_dict(cfg, seed, model)
    model.load_state_dict(weights)
    model.to(device)
    st = state.create_train_state(model, cfg)
    step = student.make_student_train_step(model, cfg)
    frozen = student.make_student_train_step(model, cfg, freeze_teacher=True)
    batch = train_batch(rng, batch_size, cfg, device)
    batch.pop("color")
    gen = torch.Generator(device=device).manual_seed(seed)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    trackers = student.initial_trackers(cfg, device)
    build.reset_launch_counts()
    trackers, logs = step(st, trackers, batch, gen)
    losses, times = [float(logs["loss"])], []
    window = time.perf_counter()
    for _ in range(steps):
        start = time.perf_counter()
        trackers, logs = step(st, trackers, batch, gen)
        losses.append(float(logs["loss"]))       # waits for the step
        times.append(time.perf_counter() - start)
    window = time.perf_counter() - window
    launches = dict(build.launch_counts)
    n = steps + 1
    want = ({k: v * n for k, v in STUDENT_LAUNCHES.items()} if cuda
            else launches_of())
    require(launches == want, f"student launches {launches}, expected "
            f"{want}")
    require(all(np.isfinite(losses)), f"non-finite student loss {losses}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    moved = [float(t) for t in trackers]
    require(all(np.isfinite(moved)) and moved != [cfg.min_depth,
                                                  cfg.max_depth],
            f"trackers {moved}")

    build.reset_launch_counts()
    start = time.perf_counter()
    trackers_f, logs_f = frozen(st, trackers, batch, gen)
    frozen_loss = float(logs_f["loss"])
    frozen_ms = 1e3 * (time.perf_counter() - start)
    launches_f = dict(build.launch_counts)
    want_f = FROZEN_LAUNCHES if cuda else launches_of()
    require(launches_f == want_f, f"frozen-teacher launches {launches_f}, "
            f"expected {want_f}")
    require(np.isfinite(frozen_loss) and all(
        torch.equal(a, b) for a, b in zip(trackers, trackers_f)),
        "the frozen step's loss is not finite or it moved the trackers")

    profile = None
    if cuda:
        pr = profiled_step(lambda: step(st, trackers, batch, gen))
        sweep_ms = sum(ms for k, ms, _ in pr["top"]
                       if "band_warp_fwd_lanes" in k)
        profile = {"sweep_ms": sweep_ms, "device_ms": pr["device_ms"],
                   "share": sweep_ms / max(pr["device_ms"], 1e-30),
                   "n_waits": pr["idle"]["n_waits"],
                   "idle_share": pr["idle"]["idle_share"]}
    sweep = sweep_check(model, cfg, batch, device, seed)
    del model, st, step, frozen
    if cuda:
        torch.cuda.empty_cache()
    check = plain_warp_student_step(cfg, weights, batch, device, seed)
    require(check["loss_rel_err"] <= STEP_LOSS_RTOL,
            f"kernel vs plain-warp student step loss: "
            f"{check['loss_rel_err']:.3e}")
    require(check["grad_err_over_limit"] <= 1.0,
            f"kernel vs plain-warp student step gradients: "
            f"{check['grad_worst']} at {check['grad_err_over_limit']:.3f} of "
            f"its limit")
    return {"losses": losses, "ms_per_step": 1e3 * float(np.median(times)),
            "images_per_s": batch_size * steps / window,
            "launches": launches, "launches_per_step": {
                k: v / n for k, v in launches.items()},
            "frozen_ms": frozen_ms, "frozen_loss": frozen_loss,
            "launches_frozen": launches_f, "max_memory_bytes": peak,
            "trackers": moved, "profile": profile, "sweep": sweep, **check}


def student_cli(device, runs=STUDENT_CLI) -> list[dict]:
    """The command line's teacher-student and self-supervised runs on
    synthetic scenes: every epoch's loss finite, the last table's "all" row
    finite over every scene, the last checkpoint written (with the
    student's trackers), and the kernels launched as many times as the
    train steps and eval batches need."""
    device = torch.device(device)
    out = []
    for flags, scenes, epochs in runs:
        with tempfile.TemporaryDirectory() as tmp:
            build.reset_launch_counts()
            start = time.perf_counter()
            alt, results = cli.train([
                *flags.split(), "--synthetic", str(scenes), "--num_epochs",
                str(epochs), "--device", str(device), "--log_dir", tmp])
            wall = time.perf_counter() - start
            launches = dict(build.launch_counts)
            cfg = alt.cfg
            run = os.path.join(tmp, cfg.model_name)
            with open(os.path.join(run, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            ep = [r for r in rows if r["mode"] == "train_epoch"]
            require(len(ep) == epochs and all(
                np.isfinite(v) for r in ep for k, v in r.items()
                if k.startswith("loss") or k.startswith("mono_loss")),
                f"{flags}: train_epoch rows {ep}")
            spe = scenes // cfg.batch_size
            last = results[f"epoch_{epochs - 1}"]["all"]
            require(last["frames"] == scenes and all(
                np.isfinite(v) for v in last.values()),
                f"{flags}: the last table's 'all' row {last}")
            saved = torch.load(os.path.join(
                run, "checkpoints", f"step_{spe * epochs}",
                checkpoint.STATE_FILE), map_location="cpu",
                weights_only=True)
            counts = dict(alt.counts)
            require(counts == {"train_steps": spe * epochs,
                               "eval_batches": spe * (1 + epochs)},
                    f"{flags}: counts {counts}")
            if cfg.train_student:
                require(saved["extra"] is not None and all(
                    np.isfinite(float(t)) for t in saved["extra"]["trackers"]),
                    f"{flags}: the checkpoint's trackers {saved['extra']}")
                per_step, per_eval = STUDENT_LAUNCHES, STUDENT_INFER_LAUNCHES
            else:
                per_step = selfsup_launches(cfg)
                per_eval = launches_of(polar_preprocess=1)
            want = ({k: per_step[k] * counts["train_steps"]
                     + per_eval[k] * counts["eval_batches"]
                     for k in per_step} if device.type == "cuda"
                    else launches_of())
            require(launches == want, f"{flags}: launches {launches}, "
                    f"expected {want}")
            out.append({"flags": flags, "scenes": scenes, "epochs": epochs,
                        "wall_s": wall, "losses": [r["loss"] for r in ep],
                        "all": last, "launches": launches})
    return out


# --- phase 10: deploy -------------------------------------------------------

# The loaded program against Predictor on the same weights and inputs: the
# same operations, the same kernel and the same cuDNN calls, so bit for bit
# expected; the limit is relative to each depth.
EXPORT_RTOL = 1e-6
# The AR sweep's frames (the reference's default); the GIF holds the sweep
# forward, then reversed, at 300 ms a frame (cli.ar)
AR_FRAMES = 30
AR_FRAME_MS = 300
# Adam's first two bias-corrected steps move each parameter by at most the
# learning rate and 1.0014 of it (the default betas), so a grafted leaf stays
# within this many learning rates of the .npz
ADAM_TWO_STEPS = 2.01

# The reference's module names of a PolarDepthNet state_dict (reference
# pre_encoders.py, depth_decoder.py, resnet_encoder.py): the inverse of
# models/reference_import.py, written here apart from it.
_REF_CONV_BLOCK = {
    "TorchConv_0.Conv_0.weight": "conv.weight",
    "TorchConv_0.Conv_0.bias": "conv.bias",
    "BatchNorm_0.weight": "bn.weight", "BatchNorm_0.bias": "bn.bias",
    "BatchNorm_0.running_mean": "bn.running_mean",
    "BatchNorm_0.running_var": "bn.running_var"}
_REF_SHALLOW = {"ConvBNReLUDrop_0": "Conv1", "ResidualBlock_0": "ResBlock1",
                "ConvBNReLUDrop_1": "Conv2", "ResidualBlock_1": "ResBlock2",
                "ConvBNReLUDrop_2": "Conv3", "ResidualBlock_2": "ResBlock3"}
_REF_JOINT = {"ConvBNReLUDrop_0": "fc1", "ConvBNReLUDrop_1": "fc2",
              "ConvBNReLUDrop_2": "Conv1", "ConvBNReLUDrop_3": "Conv2",
              **{f"ResidualBlock_{i}": f"ResBlock{i + 1}" for i in range(6)}}
_REF_RESNET = {"Conv_0": "conv1", "BatchNorm_0": "bn1", "Conv_1": "conv2",
               "BatchNorm_1": "bn2", "Conv_2": "downsample.0",
               "BatchNorm_2": "downsample.1"}


def _ref_pre_encoder_key(rest: str, blocks: dict) -> str:
    """'ResidualBlock_1.ConvBNReLUDrop_0.BatchNorm_0.weight' ->
    'ResBlock2.conv1.bn.weight'."""
    block, rest = rest.split(".", 1)
    theirs = blocks[block]
    if block.startswith("ResidualBlock_"):
        sub, rest = rest.split(".", 1)
        theirs += f".conv{int(sub.rsplit('_', 1)[1]) + 1}"
    return f"{theirs}.{_REF_CONV_BLOCK[rest]}"


def reference_key(key: str, scales) -> tuple[str, str] | None:
    """A state_dict key of PolarDepthNet in the separate-encoder layout ->
    (component file, the reference's key); None for a BatchNorm's batch
    count, which the import does not read, and for the attention, of which
    the reference saves no file."""
    comp, rest = key.split(".", 1)
    if rest.endswith("num_batches_tracked") or comp == "cross_modal_attention":
        return None
    if comp == "normals_encoder":
        return comp, _ref_pre_encoder_key(
            rest.removeprefix("ShallowEncoder_0."), _REF_SHALLOW)
    if comp == "xolp_encoder":
        return comp, _ref_pre_encoder_key(rest, _REF_SHALLOW)
    if comp == "joint_encoder":
        return comp, _ref_pre_encoder_key(rest, _REF_JOINT)
    if comp == "rgb_encoder":
        parts = rest.split(".")
        if parts[0].startswith("BasicBlock_"):
            i = int(parts[0].rsplit("_", 1)[1])
            return comp, (f"encoder.layer{i // 2 + 1}.{i % 2}."
                          f"{_REF_RESNET[parts[1]]}.{parts[2]}")
        return comp, f"encoder.{_REF_RESNET[parts[0]]}.{parts[1]}"
    if comp == "mono_depth":
        name, rest = rest.split(".", 1)
        k = int(name.rsplit("_", 1)[1])
        leaf = rest.rsplit(".", 1)[1]
        if name.startswith("ConvBlockELU_"):
            return comp, f"decoder.{k}.conv.conv.{leaf}"
        scale = sorted(scales, reverse=True)[k]
        return comp, f"decoder.{10 + list(scales).index(scale)}.conv.{leaf}"
    raise KeyError(key)


def write_reference_pth(state_dict: dict, cfg: Config, out_dir: str) -> list:
    """The reference's per-component .pth files (weights_<epoch>/) of a
    PolarDepthNet state_dict; returns the components written."""
    params, stats = jax_from_state_dict(state_dict, fused_encoders=False)
    files: dict = {}
    for key, value in state_dict_from_jax(params, stats,
                                          fused_encoders=False).items():
        ref = reference_key(key, tuple(cfg.scales))
        if ref is not None:
            files.setdefault(ref[0], {})[ref[1]] = value
    for comp, sd in files.items():
        torch.save(sd, os.path.join(out_dir, f"{comp}.pth"))
    return sorted(files)


def pretrained_npz(path: str, seed: int) -> dict:
    """Seeded random weights under the keys of torchvision's resnet18
    state_dict, as scripts/convert_torch_resnet18.py writes them."""
    rng = np.random.default_rng(seed)
    raw = {}

    def conv(name, cout, cin, k):
        raw[name] = rng.normal(0, 0.05, (cout, cin, k, k)).astype(np.float32)

    def bn(prefix, c):
        raw[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        raw[f"{prefix}.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        raw[f"{prefix}.running_mean"] = rng.normal(0, 0.1, c).astype(
            np.float32)
        raw[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for layer, c in enumerate((64, 128, 256, 512), start=1):
        for b in range(2):
            first = cin if b == 0 else c
            conv(f"layer{layer}.{b}.conv1.weight", c, first, 3)
            bn(f"layer{layer}.{b}.bn1", c)
            conv(f"layer{layer}.{b}.conv2.weight", c, c, 3)
            bn(f"layer{layer}.{b}.bn2", c)
            if b == 0 and first != c:
                conv(f"layer{layer}.{b}.downsample.0.weight", c, first, 1)
                bn(f"layer{layer}.{b}.downsample.1", c)
        cin = c
    raw["fc.weight"] = rng.normal(0, 0.01, (1000, 512)).astype(np.float32)
    raw["fc.bias"] = np.zeros(1000, np.float32)
    np.savez(path, **raw)
    return raw


def _rgb_encoder_source() -> dict:
    """The torchvision key of each parameter and statistic of the shallow
    RGB encoder (the forward map of reference_key)."""
    cfg = PUBLISHED
    out = {}
    for key in build_model(cfg).state_dict():
        if key.startswith("rgb_encoder."):
            ref = reference_key(key, cfg.scales)
            if ref is not None:
                out[key] = ref[1].removeprefix("encoder.")
    return out


def gif_durations(path: str) -> list:
    """The display time of each stored frame of a GIF, in ms."""
    from PIL import Image, ImageSequence
    with Image.open(path) as im:
        return [f.info["duration"] for f in ImageSequence.Iterator(im)]


def export_round_trip(cfg: Config, weights: dict, device, rng, tmp: str,
                      out: dict):
    """cfg's model with weights exported with a symbolic batch (exactly one
    polar-preprocess node), saved under tmp, loaded fresh, and held against
    Predictor at cfg's batch and at 3, K1 once per call.  Fills out's
    export_s, nodes, meta and rel_err; returns (a function of a host batch
    running the loaded program, the Predictor)."""
    on_card = torch.device(device).type == "cuda"
    start = time.perf_counter()
    program = make_export(cfg, weights, device=device)
    out["export_s"] = time.perf_counter() - start
    out["nodes"] = preprocess_nodes(program)
    require(out["nodes"] == 1, f"the exported graph holds {out['nodes']}"
            " polar-preprocess nodes, expected 1")
    path = os.path.join(tmp, "model.pt2")
    save_artifact(program, path, cfg)
    with open(path + ".json") as f:
        out["meta"] = json.load(f)
    del program
    loaded = load_module(path)
    predictor = Predictor(cfg, weights, device=device)

    def run_program(batch):
        return loaded(*(torch.as_tensor(batch[k]).to(device)
                        for k in ("color", "pol"))).cpu().numpy()

    out["rel_err"] = {}
    for b in (cfg.batch_size, 3):
        batch = random_batch(rng, b, cfg)
        before = build.launch_counts["polar_preprocess"]
        got = run_program(batch)
        added = build.launch_counts["polar_preprocess"] - before
        require(added == int(on_card), f"the loaded program launched K1 "
                f"{added} times in one call at batch {b}")
        want = predictor.predict(batch)
        require(got.shape == want.shape == (b, cfg.height, cfg.width, 1),
                f"program depth {got.shape}, Predictor's {want.shape}")
        err = float(np.max(np.abs(got - want) / np.abs(want)))
        out["rel_err"][b] = err
        require(err <= EXPORT_RTOL, f"loaded program vs Predictor at "
                f"batch {b}: relative error {err:.3e}")
    return run_program, predictor


def deploy(device, cfg: Config = PUBLISHED, requests: int = 5,
           seed: int = 0, ar_frames: int = AR_FRAMES) -> dict:
    """The published model in and out of the port through its entry points:
    an exported program with a symbolic batch, saved and loaded fresh,
    against Predictor at the published batch and at 3, then both timed in
    turns; reference .pth files of the same weights through evaluate
    --reference_weights (and --save_pred_disps) against evaluate --weights;
    ImageNet-shaped ResNet18 weights through train --weights_init
    pretrained; and pointcloud, analyze and ar on the predictions."""
    device = torch.device(device)
    rng = np.random.default_rng(seed + 10)
    weights = seeded_state_dict(cfg, seed)
    common = ["--height", str(cfg.height), "--width", str(cfg.width),
              "--batch_size", str(cfg.batch_size), "--device", str(device)]
    quiet = {"log_fn": lambda *_: None}
    out = {}
    build.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        run_program, predictor = export_round_trip(cfg, weights, device, rng,
                                                   tmp, out)
        batch = random_batch(rng, cfg.batch_size, cfg)
        run_program(batch)
        predictor.predict(batch)
        out["program_ms"], out["predictor_ms"] = [], []
        for _ in range(requests):
            for fn, key in ((run_program, "program_ms"),
                            (predictor.predict, "predictor_ms")):
                start = time.perf_counter()
                fn(batch)
                out[key].append(1e3 * (time.perf_counter() - start))
        del run_program, predictor

        # reference .pth files of the same weights
        ref_dir = os.path.join(tmp, "weights_ref")
        os.makedirs(ref_dir)
        out["components"] = write_reference_pth(weights, cfg, ref_dir)
        model = build_model(cfg)
        load_reference_components(ref_dir, model, log=lambda *_: None)
        require(all(torch.equal(v, weights[k])
                    for k, v in model.state_dict().items()),
                "the .pth files do not load back to the weights")
        trainer = Trainer(cfg, 1, device=device, **quiet)
        trainer.model.load_state_dict(weights)
        step_dir = checkpoint.save(os.path.join(tmp, "ckpt"), trainer.state,
                                   cfg)
        del trainer
        one_batch = [*common, "--synthetic", str(cfg.batch_size)]
        _, by_weights = cli.evaluate([*one_batch, "--weights", step_dir])
        disp_dir = os.path.join(tmp, "disps")
        _, by_ref = cli.evaluate([*one_batch, "--reference_weights", ref_dir,
                                  "--save_pred_disps", "--eval_out_dir",
                                  disp_dir])
        out["ref_rel_diff"] = _table_rel_diff(by_ref, by_weights)
        require(out["ref_rel_diff"] <= EVAL_TABLE_RTOL,
                f"evaluate --reference_weights vs --weights: "
                f"{out['ref_rel_diff']:.3e}")
        disps = np.load(os.path.join(
            disp_dir, f"disps_{cfg.dataset}_{cfg.split}_split.npy"))

        # ImageNet-shaped weights into the RGB encoder, then two steps
        npz = os.path.join(tmp, "resnet18.npz")
        raw = pretrained_npz(npz, seed)
        sources = _rgb_encoder_source()
        init = Trainer(cfg.replace(weights_init="pretrained",
                                   pretrained_weights_path=npz), 1,
                       device=device, **quiet).model.state_dict()
        require(all(np.array_equal(init[k].cpu().numpy(), raw[t])
                    for k, t in sources.items()),
                "weights_init pretrained: a grafted leaf differs from the "
                ".npz")
        trained, _ = cli.train([
            *common, "--synthetic", str(2 * cfg.batch_size), "--num_epochs",
            "1", "--log_dir", os.path.join(tmp, "pre"), "--weights_init",
            "pretrained", "--pretrained_weights_path", npz])
        require(trained.state.step == 2, f"{trained.state.step} steps")
        sd = trained.model.state_dict()
        moved = {k: float(np.abs(sd[k].cpu().numpy() - raw[t]).max())
                 for k, t in sources.items() if "running" not in k}
        out["pretrained_moved"] = max(moved.values())
        require(0 < out["pretrained_moved"]
                <= ADAM_TWO_STEPS * cfg.learning_rate,
                f"grafted leaves moved by up to {out['pretrained_moved']:.3e}"
                f" in two steps (limit {ADAM_TWO_STEPS} x lr)")
        del trained

        # pointcloud -> analyze -> ar on the predictions
        pc_dir = os.path.join(tmp, "pc")
        depth = cli.pointcloud([*one_batch, "--weights", step_dir, "--out",
                                pc_dir])
        # the same frames, in the order of the iterator's next epoch
        require(disps.shape == depth.shape and all(
            any(np.allclose(d, 1.0 / e, rtol=EXPORT_RTOL, atol=0)
                for e in depth) for d in disps),
            "--save_pred_disps differs from 1 / pointcloud's depth")
        points = [len(read_ply(os.path.join(pc_dir, f"cloud_{i:03d}.ply"))[0])
                  for i in range(depth.shape[0])]
        valid = [int((d > 0).sum()) for d in depth]
        require(points == valid, f"PLY points {points}, valid pixels {valid}")
        with open(cli.analyze(["--pred_dir", pc_dir])) as f:
            rows = [ln for ln in f if ln.startswith("| 0")]
        require(len(rows) == depth.shape[0],
                f"{len(rows)} report rows for {depth.shape[0]} frames")
        gif = cli.ar(["--pred_dir", pc_dir, "--num_frames", str(ar_frames)])
        durations = gif_durations(gif)
        # PIL merges identical consecutive frames and adds their durations
        require(sum(durations) == 2 * ar_frames * AR_FRAME_MS,
                f"GIF durations {durations}")
        # the same sweep with the ground truth as the prediction, across
        # the middle of the frame: the logo shows and moves, so every
        # frame differs from the one before but at the sweep's turn
        for tag in ("rgb", "mask", "depth_gt"):
            shutil.copy(os.path.join(pc_dir, f"000_{tag}.png"),
                        os.path.join(pc_dir, f"gt_{tag}.png"))
        shutil.copy(os.path.join(pc_dir, "000_depth_gt.png"),
                    os.path.join(pc_dir, "gt_depth_pred.png"))
        gt_durations = gif_durations(cli.ar([
            "--pred_dir", pc_dir, "--name", "gt", "--out",
            os.path.join(pc_dir, "gt.gif"), "--num_frames", str(ar_frames),
            "--y_start", str(cfg.height // 2), "--x_start",
            str(cfg.width // 4)]))
        require(len(gt_durations) == 2 * ar_frames - 1,
                f"the ground truth's GIF has {len(gt_durations)} distinct "
                f"frames, expected {2 * ar_frames - 1}")
        out.update(points=points, report_rows=len(rows),
                   gif_frames=len(durations), gif_ms=sum(durations),
                   gt_gif_frames=len(gt_durations))
    out["launches"] = dict(build.launch_counts)
    return out


# --- phases 11 and 12: the attention variant and the residual poses ---------

# The command line's runs: the published run with the attention for one
# epoch, and the self-supervised run with the residual-pose pass
ATTENTION_CLI_SCENES = 24
RES_POSE_CLI = (("--depth_supervision_only false --res_pose", 12, 1),)


def attention_cfg() -> Config:
    return PUBLISHED.replace(use_attention=True)


def res_pose_cfg() -> Config:
    return PUBLISHED.replace(depth_supervision_only=False, res_pose=True)


def attention_cli(device, flags=(),
                  scenes: int = ATTENTION_CLI_SCENES) -> dict:
    """``train --use_attention --synthetic <scenes> --num_epochs 1`` in
    process (PUBLISHED unless flags say otherwise): the epoch's loss
    finite, the last table's "all" row finite over every scene, the
    checkpoint holding the attention's weights, and K1 launched once per
    train step, eval batch and logged image."""
    device = torch.device(device)
    with tempfile.TemporaryDirectory() as tmp:
        build.reset_launch_counts()
        start = time.perf_counter()
        trainer, results = cli.train([
            "--use_attention", *flags, "--synthetic", str(scenes),
            "--num_epochs", "1", "--device", str(device), "--log_dir", tmp])
        wall = time.perf_counter() - start
        launches = dict(build.launch_counts)
        run = os.path.join(tmp, trainer.cfg.model_name)
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        train_rows = [r for r in rows if r["mode"] == "train"]
        require(len(train_rows) == 1 and all(
            np.isfinite(v) for k, v in train_rows[0].items()
            if k.startswith("loss")), f"train rows {train_rows}")
        last = results["epoch_0"]["all"]
        require(last["frames"] == scenes and all(
            np.isfinite(v) for v in last.values()),
            f"the last table's 'all' row {last}")
        steps = scenes // trainer.cfg.batch_size
        saved = torch.load(os.path.join(
            run, "checkpoints", f"step_{steps}", checkpoint.STATE_FILE),
            map_location="cpu", weights_only=True)["model"]
        require(any(k.startswith("cross_modal_attention.") for k in saved),
                "the checkpoint holds no attention weights")
        counts = dict(trainer.counts)
        want = launches_of(polar_preprocess=sum(counts.values())
                           if device.type == "cuda" else 0)
        require(launches == want, f"launches {launches}, expected {want}")
    return {"wall_s": wall, "loss": train_rows[0]["loss"], "all": last,
            "launches": launches, "counts": counts}


def serve_in_turns(device, cfgs: dict, requests: int, seed: int) -> dict:
    """{name: ms of each of ``requests`` calls} of each config's Predictor
    on one batch, the configs called in turns after a warm-up of each, so
    that the card's state is the same for all."""
    first = next(iter(cfgs.values()))
    batch = random_batch(np.random.default_rng(seed + 12), first.batch_size,
                         first)
    predictors = {name: Predictor(c, seeded_state_dict(c, seed),
                                  device=device)
                  for name, c in cfgs.items()}
    for p in predictors.values():
        p.predict(batch)
    out = {name: [] for name in cfgs}
    for _ in range(requests):
        for name, p in predictors.items():
            start = time.perf_counter()
            p.predict(batch)
            out[name].append(1e3 * (time.perf_counter() - start))
    return out


def attention_phase(device, cfg: Config, requests: int, steps: int,
                    seed: int, cli_flags=(),
                    cli_scenes: int = ATTENTION_CLI_SCENES) -> dict:
    """The arch1++_attention variant (cfg, with use_attention): served
    through Predictor, and in turns with the same model without the
    attention on one batch; one warm-up and ``steps`` supervised steps;
    its export round trip; and the command line's run."""
    out = {"serve": serve(device, cfg, requests=requests, seed=seed),
           "turns": serve_in_turns(
               device, {"attention": cfg,
                        "without": cfg.replace(use_attention=False)},
               requests, seed),
           "train": train_supervised(device, cfg, cfg.batch_size, steps,
                                     seed),
           "export": {}}
    with tempfile.TemporaryDirectory() as tmp:
        export_round_trip(cfg, seeded_state_dict(cfg, seed), device,
                          np.random.default_rng(seed + 11), tmp,
                          out["export"])
    out["cli"] = attention_cli(device, cli_flags, cli_scenes)
    return out


# --- phase 13: precision ---------------------------------------------------

# The published supervised step in turns, TF32_PAIRS pairs: as its entry
# point runs it (float32), and its body (the step without the entry point's
# float32()) under TF32-on flags set here, measurement only.  The command
# line's evaluate under TF32-on flags against the same run inside float32():
# the same float32 computation, so the table, and the disparities that
# --save_pred_disps writes, within PRECISION_RTOL.  Its control, the fault
# the check must see: the same evaluate with every module's forward under
# TF32-on flags, inside the entry points, whose disparities must differ by
# more than PRECISION_RTOL (its table, a mean over 12 scenes, moves less
# and is printed).
TF32_PAIRS = 5
PRECISION_RTOL = 1e-5
EVAL_ARGV = ("evaluate", "--synthetic", "12", "--save_pred_disps")


def tf32_flags() -> tuple[bool, bool]:
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def set_tf32_flags(cudnn: bool, matmul: bool) -> None:
    """Through the flags the port's float32() reads, each written only
    where it differs, as float32() writes them."""
    if torch.backends.cudnn.allow_tf32 != cudnn:
        torch.backends.cudnn.allow_tf32 = cudnn
    if torch.backends.cuda.matmul.allow_tf32 != matmul:
        torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def tf32_on():
    """Both TF32 flags on for the block; the caller's back after it."""
    saved = tf32_flags()
    set_tf32_flags(True, True)
    try:
        yield
    finally:
        set_tf32_flags(*saved)


@contextlib.contextmanager
def tf32_in_every_module():
    """Both TF32 flags on at every module's forward, the entry points'
    float32() notwithstanding (a global forward pre-hook); the caller's
    flags back after the block."""
    saved = tf32_flags()
    handle = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda module, args: set_tf32_flags(True, True))
    try:
        yield
    finally:
        handle.remove()
        set_tf32_flags(*saved)


def tf32_turns(device, cfg: Config, batch_size: int, pairs: int,
               seed: int) -> dict:
    """ms of the published supervised step (synchronize to loss read) in
    turns: the entry point's step (float32) and its body under TF32-on
    flags, after a warm-up of each; the last loss of each."""
    device = torch.device(device)
    rng = np.random.default_rng(seed + 7)
    model = build_model(cfg)
    model.load_state_dict(seeded_state_dict(cfg, seed))
    model.to(device)
    st = state.create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    body = step.__wrapped__       # the step without its entry point's float32
    full = train_batch(rng, batch_size, cfg, device)
    batch = {k: full[k] for k in ("color", "pol", "depth", "K")}
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"float32": [], "tf32": [], "loss": {}}

    def timed(name, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out["loss"][name] = float(fn(st, batch, gen)["loss"])
        return 1e3 * (time.perf_counter() - start)

    for i in range(pairs + 1):           # the first pair warms up
        ms = timed("float32", step)
        with tf32_on():
            ms_tf32 = timed("tf32", body)
        if i:
            out["float32"].append(ms)
            out["tf32"].append(ms_tf32)
    return out


def cli_evaluate(argv) -> tuple[dict, np.ndarray]:
    """``cli.main(["evaluate", ..., "--save_pred_disps"])`` in process ->
    the table its evaluate command returned, and the disparities it
    saved."""
    tables = []
    command = cli.COMMANDS["evaluate"]
    cli.COMMANDS["evaluate"] = lambda a: tables.append(command(a)[1])
    with tempfile.TemporaryDirectory() as tmp:
        try:
            rc = cli.main([*argv, "--eval_out_dir", tmp])
        finally:
            cli.COMMANDS["evaluate"] = command
        require(rc == 0 and len(tables) == 1, f"cli.main {argv}: rc {rc}")
        saved = [f for f in os.listdir(tmp) if f.endswith(".npy")]
        require(len(saved) == 1, f"cli.main {argv} saved {saved}")
        return tables[0], np.load(os.path.join(tmp, saved[0]))


def _rel_diff(a: np.ndarray, b: np.ndarray) -> float:
    require(a.shape == b.shape, f"shapes {a.shape} vs {b.shape}")
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def precision_check(device) -> dict:
    """The command line's evaluate (PUBLISHED, 12 synthetic scenes, random
    weights from cfg.seed) under TF32-on global flags against the same run
    inside float32(): the entry points compute float32 either way, and
    leave the caller's flags as they were.  The control: the same run with
    its modules under TF32, which the check must tell apart."""
    argv = (*EVAL_ARGV, "--device", str(device))
    with tf32_on():
        on, on_disps = cli_evaluate(argv)
        after = tf32_flags()
    with float32():
        off, off_disps = cli_evaluate(argv)
    with tf32_in_every_module():
        tf32, tf32_disps = cli_evaluate(argv)
    out = {"table": _table_rel_diff(on, off),
           "disps": _rel_diff(on_disps, off_disps),
           "table_tf32": _table_rel_diff(tf32, off),
           "disps_tf32": _rel_diff(tf32_disps, off_disps),
           "flags_after": after, "abs_rel": on["all"]["abs_rel"],
           "abs_rel_tf32": tf32["all"]["abs_rel"], "n": off_disps.size}
    require(after == (True, True), f"cli.main left the TF32 flags {after}")
    for k in ("table", "disps"):
        require(out[k] <= PRECISION_RTOL, f"evaluate under TF32-on flags vs "
                f"float32(): relative difference of the {k} {out[k]:.3e}")
    require(out["disps_tf32"] > PRECISION_RTOL, f"evaluate with its modules "
            f"under TF32 vs float32(): relative difference of the "
            f"disparities {out['disps_tf32']:.3e}, within the check's "
            f"limit, so the check cannot tell TF32 apart")
    return out


# --- phase 14 ---------------------------------------------------------------

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
        # torch's own flags stay: every entry point computes float32 itself
        print(f"  torch's global flags, left as they are: torch.backends."
              f"cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}, "
              f"torch.backends.cuda.matmul.allow_tf32 = "
              f"{torch.backends.cuda.matmul.allow_tf32}")
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
        sweep = check_plane_sweep(device, cfg.batch_size, args.seed,
                                  name_power)
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
    with phase("9 teacher-student training"):
        sc = student_cfg()
        ts = train_student(device, sc, cfg.batch_size, args.steps, args.seed)
        print(f"  {args.steps} steps of {cfg.batch_size}x{sc.height}x"
              f"{sc.width}, frames {tuple(sc.frame_ids)}, matching "
              f"{sc.matching_ids}, {sc.num_depth_bins} bins: "
              f"{ts['ms_per_step']:.2f} ms/step (median), "
              f"{ts['images_per_s']:.2f} images/s over the timed window, "
              f"peak memory {ts['max_memory_bytes'] / 2 ** 30:.2f} GiB  "
              f"[{name_power}]")
        print(f"  losses {['%.6f' % x for x in ts['losses']]}; trackers "
              f"{ts['trackers']}")
        print(f"  launches {ts['launches']} ({ts['launches_per_step']} per "
              f"step)")
        print(f"  one frozen-teacher step: {ts['frozen_ms']:.2f} ms (one "
              f"call, synchronize to synchronize), loss "
              f"{ts['frozen_loss']:.6f}, launches {ts['launches_frozen']}, "
              f"trackers kept  [{name_power}]")
        pr = ts["profile"]
        print(f"  the sweep's {SWEEP_CHUNKS} K2 launches in one profiled "
              f"step: {pr['sweep_ms']:.4f} ms of {pr['device_ms']:.2f} ms of "
              f"device time (share {pr['share']:.5f}); the step's host "
              f"calls that wait on the card: {pr['n_waits']} (the "
              f"self-supervised step's: {ss['n_waits']}); idle share "
              f"{pr['idle_share']:.4f} under the profiler  [{name_power}]")
        print(f"  step with the plain warps: loss {ts['loss_plain']:.7f} vs "
              f"{ts['loss_kernel']:.7f} (rel err {ts['loss_rel_err']:.3e}, "
              f"limit {STEP_LOSS_RTOL}); gradients: worst "
              f"{ts['grad_worst']} at {ts['grad_err_over_limit']:.3f} of "
              f"its limit; median relative err "
              f"{ts['grad_rel_err_median']:.3e}")
        sw = ts["sweep"]
        print(f"  cost volume through K2 vs its plain version: max |diff| "
              f"{sw['plain_err']:.3e} (limit {WARP_TOL}); vs the exact "
              f"'xla' route on the {100 * sw['kept']:.2f}% of entries both "
              f"keep: max |diff| {sw['xla_err']:.3e}, "
              f"{100 * sw['xla_beyond_tol']:.4f}% beyond {SWEEP_XLA_TOL}; "
              f"missing masks equal {sw['missing_equal']}; the band clamps "
              f"{100 * sw['clamped']:.4f}% of the sweep's samples")
        for r in student_cli(device):
            print(f"  train {r['flags']} --synthetic {r['scenes']} "
                  f"--num_epochs {r['epochs']}: {r['wall_s']:.2f} s in all, "
                  f"losses per epoch {['%.6f' % x for x in r['losses']]}, "
                  f"last table's all row abs_rel {r['all']['abs_rel']:.5f}, "
                  f"launches {r['launches']}  [{name_power}]")
    with phase("10 deploy"):
        dp = deploy(device, cfg, requests=args.requests, seed=args.seed)
        m = dp["meta"]
        print(f"  export {dp['export_s']:.2f} s: {dp['nodes']} "
              f"polar_preprocess node, inputs {m['inputs']}, output "
              f"{m['output']}, platforms {m['platforms']}")
        errs = ", ".join(f"batch {b} {e:.3e}"
                         for b, e in dp["rel_err"].items())
        print(f"  loaded program vs Predictor, max relative error: {errs} "
              f"(limit {EXPORT_RTOL}); K1 once per call")
        print(f"  {args.requests} requests of {cfg.batch_size}x{cfg.height}x"
              f"{cfg.width} in turns: loaded program "
              f"{np.median(dp['program_ms']):.2f} ms (median; "
              f"{['%.2f' % x for x in dp['program_ms']]}), Predictor "
              f"{np.median(dp['predictor_ms']):.2f} ms "
              f"({['%.2f' % x for x in dp['predictor_ms']]})  [{name_power}]")
        print(f"  reference .pth {dp['components']}: evaluate "
              f"--reference_weights vs --weights, largest relative "
              f"difference {dp['ref_rel_diff']:.3e} (limit "
              f"{EVAL_TABLE_RTOL}); --save_pred_disps = 1 / depth")
        print(f"  weights_init pretrained: the RGB encoder's grafted leaves "
              f"equal the .npz, then moved by at most "
              f"{dp['pretrained_moved']:.3e} in two steps")
        print(f"  pointcloud: PLY points {dp['points']} = valid pixels; "
              f"analyze: {dp['report_rows']} frame rows; ar: a GIF of "
              f"{dp['gif_frames']} distinct frames, {dp['gif_ms']} ms = "
              f"2 x {AR_FRAMES} frames x {AR_FRAME_MS} ms; with the ground "
              f"truth as the prediction {dp['gt_gif_frames']} distinct "
              f"frames")
        print(f"  launches {dp['launches']}")
    with phase("11 attention"):
        at = attention_phase(device, attention_cfg(), args.requests,
                             args.steps, args.seed)
        sa, ta, ea, ca = at["serve"], at["train"], at["export"], at["cli"]
        print(f"  serve: {args.requests} requests of {cfg.batch_size}x"
              f"{cfg.height}x{cfg.width}: {sa['ms_per_request']:.2f} "
              f"ms/request (median), {sa['images_per_s']:.1f} images/s; max "
              f"|depth - plain preprocess| {sa['err_plain']:.3e} m, max "
              f"|depth - CPU| {sa['err_cpu']:.3e} m (limit {DEPTH_TOL}); "
              f"launches {sa['launches']}  [{name_power}]")
        tu = at["turns"]
        print(f"  {args.requests} requests of one batch in turns: with the "
              f"attention {np.median(tu['attention']):.2f} ms (median; "
              f"{['%.2f' % x for x in tu['attention']]}), without "
              f"{np.median(tu['without']):.2f} ms "
              f"({['%.2f' % x for x in tu['without']]})  [{name_power}]")
        print(f"  supervised step: {ta['ms_per_step']:.2f} ms/step (median), "
              f"{ta['images_per_s']:.2f} images/s over the timed window, "
              f"peak memory {ta['max_memory_bytes'] / 2 ** 30:.2f} GiB (the "
              f"published step's {sv['max_memory_bytes'] / 2 ** 30:.2f}); "
              f"losses {['%.6f' % x for x in ta['losses']]}  [{name_power}]")
        errs = ", ".join(f"batch {b} {e:.3e}"
                         for b, e in ea["rel_err"].items())
        print(f"  export {ea['export_s']:.2f} s, {ea['nodes']} "
              f"polar_preprocess node; loaded program vs Predictor, max "
              f"relative error: {errs} (limit {EXPORT_RTOL})")
        print(f"  train --use_attention --synthetic {ATTENTION_CLI_SCENES} "
              f"--num_epochs 1: {ca['wall_s']:.2f} s in all, loss "
              f"{ca['loss']:.6f}, all row abs_rel {ca['all']['abs_rel']:.5f},"
              f" launches {ca['launches']} = {ca['counts']}  [{name_power}]")
    with phase("12 res_pose"):
        rp = train_selfsup(device, res_pose_cfg(), cfg.batch_size,
                           args.steps, args.seed)
        print(f"  {args.steps} self-supervised steps with res_pose of "
              f"{cfg.batch_size}x{cfg.height}x{cfg.width}: "
              f"{rp['ms_per_step']:.2f} ms/step (median; phase 6 without it "
              f"{ss['ms_per_step']:.2f}), {rp['images_per_s']:.2f} images/s "
              f"over the timed window, peak memory "
              f"{rp['max_memory_bytes'] / 2 ** 30:.2f} GiB  [{name_power}]")
        print(f"  losses {['%.6f' % x for x in rp['losses']]}")
        print(f"  launches {rp['launches']} ({rp['launches_per_step']} per "
              f"step)")
        print(f"  K4 in one profiled step: {rp['k4_ms']:.4f} ms of "
              f"{rp['device_ms']:.2f} ms of device time (share "
              f"{rp['k4_ms'] / rp['device_ms']:.5f})  [{name_power}]")
        print(f"  step with the plain warps: loss {rp['loss_plain']:.7f} vs "
              f"{rp['loss_kernel']:.7f} (rel err {rp['loss_rel_err']:.3e}, "
              f"limit {STEP_LOSS_RTOL}); gradients: worst "
              f"{rp['grad_worst']} at {rp['grad_err_over_limit']:.3f} of "
              f"its limit; median relative err "
              f"{rp['grad_rel_err_median']:.3e}")
        for r in student_cli(device, RES_POSE_CLI):
            print(f"  train {r['flags']} --synthetic {r['scenes']} "
                  f"--num_epochs {r['epochs']}: {r['wall_s']:.2f} s in all, "
                  f"losses per epoch {['%.6f' % x for x in r['losses']]}, "
                  f"last table's all row abs_rel {r['all']['abs_rel']:.5f}, "
                  f"launches {r['launches']}  [{name_power}]")
    with phase("13 precision"):
        tt = tf32_turns(device, cfg, cfg.batch_size, TF32_PAIRS, args.seed)
        print(f"  {TF32_PAIRS} pairs in turns: the entry point's step "
              f"(float32) {['%.2f' % x for x in tt['float32']]} ms (median "
              f"{np.median(tt['float32']):.2f}), its body under TF32-on "
              f"flags {['%.2f' % x for x in tt['tf32']]} ms (median "
              f"{np.median(tt['tf32']):.2f}); last losses "
              f"{tt['loss']['float32']:.6f} and {tt['loss']['tf32']:.6f}  "
              f"[{name_power}]")
        pc = precision_check(device)
        print(f"  cli.main {list(EVAL_ARGV)} under TF32-on flags vs inside "
              f"float32(): largest relative difference of the tables "
              f"{pc['table']:.3e}, of the {pc['n']} disparities "
              f"{pc['disps']:.3e} (limit {PRECISION_RTOL}); flags after the "
              f"command {pc['flags_after']}; abs_rel {pc['abs_rel']:.5f}")
        print(f"  control: the same command with its modules under TF32: "
              f"largest relative difference of the disparities "
              f"{pc['disps_tf32']:.3e} (must exceed {PRECISION_RTOL}), of "
              f"the tables {pc['table_tf32']:.3e}; abs_rel "
              f"{pc['abs_rel_tf32']:.5f}  [{name_power}]")
    with phase("14 result"):
        par = wp["parallax"]
        warp_err = max(max(v["errors"]["out"], v["errors"]["dix"],
                           v["errors"]["diy"]) for v in wp.values())
        kernels = [{
            "name": "polar_preprocess", "route": "cuda",
            "source": "polardepth_tpu_torch/csrc/polar_preprocess.cu",
            "replaces": "polardepth_tpu/ops/pallas/polar_preprocess.py:239",
            "launches": (s["launches"]["polar_preprocess"]
                         + dp["launches"]["polar_preprocess"]),
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
        kernels.append({
            "name": "band_warp_img_grad", "route": "cuda",
            "source": "polardepth_tpu_torch/csrc/band_warp.cu",
            "replaces": "none: the image cotangent of the custom VJP at "
                        "polardepth_tpu/ops/pallas/band_warp.py:350",
            "launches": rp["launches"]["band_warp_img_grad"],
            "max_abs_err": max(v["errors"]["img_grad"] for v in wp.values()),
            "ms": par["times"]["img"], "host_ms": par["times"]["img_host"],
            "plain_ms": par["times"]["img_plain"],
            "bound_ms": par["bounds"]["img"][0],
            "bound_by": par["bounds"]["img"][1],
            "library_ms": par["times"]["img_library"],
            "grids": {name: {"ms": v["times"]["img"],
                             "library_ms": v["times"]["img_library"]}
                      for name, v in wp.items()}})
        kernels.append({
            "name": "band_warp_fwd_lanes", "route": "cuda",
            "source": "polardepth_tpu_torch/csrc/band_warp.cu",
            "replaces": "polardepth_tpu/ops/pallas/band_warp.py:376",
            "launches": ts["launches"]["band_warp_fwd_lanes"],
            "max_abs_err": max(sweep["max_abs_err"], sw["plain_err"]),
            "ms": sweep["ms"], "host_ms": sweep["host_ms"],
            "plain_ms": sweep["plain_ms"], "bound_ms": sweep["bound_ms"],
            "bound_by": sweep["bound_by"],
            "library_ms": sweep["library_ms"]})
        print(f"  card: {name_power}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(result_line(device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
