"""The port stands alone: it and chip_smoke.py import nothing of JAX, flax,
ml_dtypes, orbax or the JAX package, and chip_smoke.py's serving and result
phases run through on the CPU at a tiny size."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "orbax", "polardepth_tpu")


def _port_files():
    return sorted((ROOT / "polardepth_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_no_forbidden_import_in_the_source():
    offenders = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if n.split(".")[0] in FORBIDDEN]
    assert len(_port_files()) > 10
    assert not offenders, offenders


def test_port_runs_with_jax_unimportable():
    """A fresh interpreter in which importing any of FORBIDDEN fails imports
    every module of the port and chip_smoke.py, and serves one request of
    the published model on the CPU."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "polardepth_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        for name in {modules!r} + ["chip_smoke"]:
            importlib.import_module(name)
        import numpy as np, torch
        import chip_smoke
        from polardepth_tpu_torch.config import PUBLISHED
        from polardepth_tpu_torch.train.trainer import Predictor
        cfg = PUBLISHED.replace(height=64, width=96)
        weights = chip_smoke.seeded_state_dict(cfg, 0)
        batch = chip_smoke.random_batch(np.random.default_rng(0), 1, cfg)
        depth = Predictor(cfg, weights, device="cpu").predict(batch)
        assert depth.shape == (1, 64, 96, 1) and np.isfinite(depth).all()
        leaked = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().startswith("OK")


def test_chip_smoke_serve_and_result_phases_on_cpu():
    """Phases 4 and 5 of chip_smoke.py with device="cpu" at 64x96: on the
    CPU the wrapper takes the plain version, so the kernel counts no
    launch, and the depth equals the plain-preprocess run exactly."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from polardepth_tpu_torch.config import PUBLISHED
    cfg = PUBLISHED.replace(height=64, width=96)
    s = chip_smoke.serve("cpu", cfg, batch=1, requests=2, seed=0)
    assert s["launches"] == {"polar_preprocess": 0, "band_warp_fwd": 0,
                             "band_warp_bwd": 0}
    assert s["err_plain"] == 0.0 and s["err_cpu"] == 0.0
    assert cfg.min_depth <= s["depth_range"][0] <= s["depth_range"][1] \
        <= cfg.max_depth
    assert s["ms_per_request"] > 0
    line = chip_smoke.result_line("cpu")
    assert line == {"ok": True, "device": {"platform": "cpu", "kind": "cpu",
                                           "count": 1}}


def test_chip_smoke_training_phases_on_cpu():
    """Phases 6 and 7 of chip_smoke.py with device="cpu" at batch 2, 64x96:
    finite losses, no kernel launch on the CPU, and the plain-warp step
    equal to the main one."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from polardepth_tpu_torch.config import PUBLISHED
    cfg = PUBLISHED.replace(height=64, width=96)
    ss = chip_smoke.train_selfsup(
        "cpu", cfg.replace(depth_supervision_only=False), 2, 1, 0)
    assert len(ss["losses"]) == 2 and np.isfinite(ss["losses"]).all()
    assert set(ss["launches"].values()) == {0}
    assert ss["loss_rel_err"] == 0.0 and ss["grad_err_over_limit"] <= 1.0
    sv = chip_smoke.train_supervised("cpu", cfg, 2, 1, 0)
    assert len(sv["losses"]) == 2 and np.isfinite(sv["losses"]).all()
    assert sv["ms_per_step"] > 0 and set(sv["launches"].values()) == {0}


def test_chip_smoke_plane_sweep_inputs_on_cpu():
    """Phase 5's plane-sweep operands at a small size: the bins stacked on
    rows, coordinates inside the image and each row's 8-row band, and the
    band warp of the grid equal to K2's function on them."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from polardepth_tpu_torch.ops import band_warp
    b, h, w, c, bins = 2, 20, 30, 8, 4
    x = chip_smoke.plane_sweep_inputs(np.random.default_rng(0), b, h, w, c,
                                      bins, "cpu")
    assert x["img"].shape == (b, h, w, c)
    assert x["grid"].shape == (b, bins * h, w, 2)
    ix, iy = x["ix"], x["iy"]
    assert ix.shape == iy.shape == (b, bins * h, w)
    assert float(ix.min()) >= 0 and float(ix.max()) <= w - 1
    assert float(iy.min()) >= 0 and float(iy.max()) <= h - 1
    span = iy.amax(dim=2) - torch.floor(iy).amin(dim=2)
    assert float(span.max()) <= 7
    assert 0.0 <= x["clamped"] < 0.5
    out = band_warp.band_warp(x["img"], x["grid"], k=8)
    assert torch.equal(out, band_warp.band_warp_fwd(x["img"], ix, iy))


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    """No result line and a non-zero exit: here, where there is no card,
    and from a directory that holds chip_smoke.py alone."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [(alone, tmp_path)]
    if not torch.cuda.is_available():
        runs.append((ROOT / "chip_smoke.py", ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in runs:
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, timeout=300, cwd=cwd, env=env)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
