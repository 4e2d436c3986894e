"""Command-line entry points of the port (polardepth_tpu/cli.py).

  python -m polardepth_tpu_torch train    [flags]  - training: the published
        supervised run (with --use_attention the arch1++_attention
        variant), or with --depth_supervision_only false the
        self-supervised one (with --res_pose its residual-pose pass), or
        with --train_student the ManyDepth teacher-student one
  python -m polardepth_tpu_torch evaluate [flags]  - per-material eval table
        of --weights (a checkpoint) or --reference_weights (the
        reference's .pth files); --save_pred_disps writes the disparities
  python -m polardepth_tpu_torch pointcloud [flags] - PLY clouds and the
        prediction PNGs of one eval batch
  python -m polardepth_tpu_torch export [flags]     - the preprocess and
        infer graph as one torch.export program (.pt2)
  python -m polardepth_tpu_torch analyze --pred_dir D - per-frame error
        heatmaps and a per-material RMS report from pointcloud's PNGs
  python -m polardepth_tpu_torch ar --pred_dir D    - the depth-aware AR
        occlusion GIF from pointcloud's PNGs

Flag names are those of the JAX package's CLI (the reference's
MonodepthOptions, options.py:13-380), for every field of the port's Config,
so that train_supervised_GT.sh maps one to one.  --synthetic N substitutes N
generated scenes for the HAMMER dataset; --device picks the device (the
card by default).  Every command computes in float32, TF32 off, whatever
torch's global flags say (utils/precision.py).  A flag of a path the port
does not have yet raises instead of being ignored.  As in the JAX package,
--use_attention acts on the supervised net alone and --res_pose on the
self-supervised step alone; other paths ignore them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from polardepth_tpu_torch.config import Config
from polardepth_tpu_torch.utils.precision import float32

SPLITS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "splits")


def _bool(v) -> bool:
    """Boolean flag parsing (argparse's type=bool takes any non-empty
    string as True)."""
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "y", "t")


def _add_common_flags(p: argparse.ArgumentParser) -> None:
    d = Config()
    for name in ("data_path", "data_path_val", "log_dir", "model_name",
                 "dataset", "split", "eval_split", "modality",
                 "depth_modality", "checkpoint_dir", "overfit_scene",
                 "weights_init", "pretrained_weights_path"):
        p.add_argument(f"--{name}", type=str, default=getattr(d, name))
    for name in ("height", "width", "offset", "batch_size", "num_epochs",
                 "scheduler_step_size", "seed", "save_frequency",
                 "log_frequency", "num_depth_bins", "num_matching_frames",
                 "freeze_teacher_epoch"):
        p.add_argument(f"--{name}", type=int, default=getattr(d, name))
    for name in ("min_depth", "max_depth", "learning_rate",
                 "normals_loss_weight", "disparity_smoothness",
                 "dropout_rate", "host_cache_gb"):
        p.add_argument(f"--{name}", type=float, default=getattr(d, name))
    for name in ("augment_xolp", "augment_normals", "fused_encoders"):
        p.add_argument(f"--{name}", action="store_true",
                       default=getattr(d, name))
        p.add_argument(f"--no_{name}", dest=name, action="store_false")
    for name in ("depth_supervision", "depth_supervision_only"):
        p.add_argument(f"--{name}", type=_bool, default=getattr(d, name))
    for name in ("overfit", "avg_reprojection", "v1_multiscale", "no_ssim",
                 "disable_automasking", "supervise_pose",
                 "enable_12channels", "train_student", "pose_input",
                 "use_future_frame", "no_matching_augmentation",
                 "disable_motion_masking", "res_pose", "use_attention"):
        p.add_argument(f"--{name}", action="store_true",
                       default=getattr(d, name))
    p.add_argument("--warp_impl", type=str, default=d.warp_impl,
                   help="full-res reprojection sampler: auto (the band-warp "
                        "kernel) | patch | flat4 (see ops/warp.py)")
    p.add_argument("--depth_binning", type=str, default=d.depth_binning,
                   help="cost-volume depth bins: linear | inverse")
    p.add_argument("--cv_warp_impl", type=str, default=d.cv_warp_impl,
                   help="plane-sweep sampler: auto (the band-warp kernel, "
                        "8-row band) | xla (the exact gather, zeros padding)")
    p.add_argument("--decode_backend", type=str, default=d.decode_backend,
                   help="host PNG decode: cv2, the only one the port has")
    p.add_argument("--random_flip", type=_bool, default=None,
                   help="random horizontal flip of training samples "
                        "(default: on for KITTI-family datasets, off for "
                        "HAMMER)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic scenes instead of HAMMER data")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model (default: the card)")
    # a path of the JAX package that the port does not have yet: accepted
    # only to refuse it
    p.add_argument("--train_dpt", action="store_true", default=False)


def _refuse_unported(a) -> None:
    if a.train_dpt:
        raise NotImplementedError("--train_dpt: not ported yet")
    if a.decode_backend != "cv2":
        raise NotImplementedError(
            f"--decode_backend {a.decode_backend}: not ported yet (the port "
            "decodes PNGs with cv2 only)")


def _config_from_args(a) -> Config:
    _refuse_unported(a)
    fields = set(Config.__dataclass_fields__)
    kw = {k: v for k, v in vars(a).items() if k in fields}
    if kw.get("random_flip") is None:
        # the reference's MonoDataset (KITTI family) flips half the
        # training samples; HAMMER's IndoorDataset hardwires do_flip=False
        kw["random_flip"] = kw.get("dataset", "HAMMER") != "HAMMER"
    return Config(**kw)


def _make_data(cfg: Config, a, part: str):
    """(BatchIterator, steps_per_epoch) of a split part."""
    from polardepth_tpu_torch.data.pipeline import BatchIterator
    cache = int(cfg.host_cache_gb * 2 ** 30)
    if a.synthetic:
        from polardepth_tpu_torch.data.synthetic import SyntheticHammer
        gen = SyntheticHammer(cfg.height, cfg.width, seed=cfg.seed
                              + (0 if part == "train" else 10_000))

        def load(i):
            return gen.sample(int(i))

        it = BatchIterator(load, a.synthetic, cfg.batch_size,
                           shuffle=(part == "train"), seed=cfg.seed,
                           cache_bytes=cache)
        return it, max(len(it), 1)
    if cfg.dataset != "HAMMER":
        raise NotImplementedError(f"dataset {cfg.dataset!r}: not ported yet")

    from polardepth_tpu_torch.data.hammer import (
        HammerIndex, HammerLoader, read_split)
    if cfg.overfit and cfg.overfit_scene:
        scenes = [cfg.overfit_scene]
    else:
        split = cfg.split if part != "test" else cfg.eval_split
        scenes = read_split(SPLITS_DIR, split, part)
    data_path = cfg.data_path if part != "test" else (cfg.data_path_val
                                                      or cfg.data_path)
    frame_ids = (0,) if cfg.depth_supervision_only else tuple(cfg.frame_ids)
    index = HammerIndex(data_path, scenes, frame_ids, cfg.offset,
                        cfg.modality, cfg.depth_modality)
    loader = HammerLoader(index, backend=cfg.decode_backend)

    def load(i):
        s = loader.load(int(i))
        s["K"] = loader.intrinsics_for(index.entries[int(i)][0],
                                       cfg.width, cfg.height)
        s["inv_K"] = np.linalg.pinv(s["K"]).astype(np.float32)
        return s

    it = BatchIterator(load, len(index), cfg.batch_size,
                       shuffle=(part == "train"), seed=cfg.seed,
                       cache_bytes=cache)
    return it, max(len(it), 1)


def _make_multiframe_data(cfg: Config, a, part: str):
    """(callable giving an iterator of multi-frame batches, steps per
    epoch) for the self-supervised and teacher-student paths
    (polardepth_tpu/cli.py:417-466): color_frames (B, F, H, W, 3) and
    rel_poses (B, F, 4, 4) in frame_ids order beside each sample's own
    keys.  Synthetic batches come in order, as SyntheticHammer.batch_frames
    gives them; HAMMER samples are shuffled for training."""
    from polardepth_tpu_torch.data.pipeline import BatchIterator
    frame_ids = tuple(cfg.frame_ids)
    cache = int(cfg.host_cache_gb * 2 ** 30)
    if a.synthetic:
        from polardepth_tpu_torch.data.synthetic import SyntheticHammer
        gen = SyntheticHammer(cfg.height, cfg.width, seed=cfg.seed)
        n = max(a.synthetic // cfg.batch_size, 1) * cfg.batch_size
        it = BatchIterator(
            lambda i: gen.sample_frames(int(i), frame_ids, cfg.offset),
            n, cfg.batch_size, shuffle=False, cache_bytes=cache)
        return (lambda: iter(it)), len(it)
    if cfg.dataset != "HAMMER":
        raise NotImplementedError(f"dataset {cfg.dataset!r}: not ported yet")

    from polardepth_tpu_torch.data.hammer import (
        HammerIndex, HammerLoader, read_split)
    scenes = ([cfg.overfit_scene] if cfg.overfit and cfg.overfit_scene
              else read_split(SPLITS_DIR, cfg.split, part))
    index = HammerIndex(cfg.data_path, scenes, frame_ids, cfg.offset,
                        cfg.modality, cfg.depth_modality)
    loader = HammerLoader(index, backend=cfg.decode_backend)

    def load(i):
        i = int(i)
        base, center = index.entries[i]
        s = loader.load(i, 0)
        frames, rels = [s["color"]], [np.eye(4, dtype=np.float32)]
        for f in frame_ids:
            if f == 0:
                continue
            frames.append(loader.load(i, f)["color"])
            rels.append(loader.relative_pose(base, center + f * cfg.offset,
                                             center))
        s["color_frames"] = np.stack(frames)
        s["rel_poses"] = np.stack(rels)
        s["K"] = loader.intrinsics_for(base, cfg.width, cfg.height)
        s["inv_K"] = np.linalg.pinv(s["K"]).astype(np.float32)
        return s

    it = BatchIterator(load, len(index), cfg.batch_size,
                       shuffle=(part == "train"), seed=cfg.seed,
                       cache_bytes=cache)
    return (lambda: iter(it)), max(len(it), 1)


def _train_alternative_path(cfg: Config, a, writer):
    """The self-supervised and teacher-student runs through AltTrainer
    (polardepth_tpu/cli.py:468-600, without its DPT branch); returns
    (trainer, the fit's tables)."""
    from polardepth_tpu_torch.train.loop import make_alt_trainer
    if cfg.train_student and not a.synthetic and cfg.dataset != "HAMMER":
        raise ValueError(
            "the teacher-student (cost-volume) path consumes GT relative "
            "poses, which only HAMMER provides; train KITTI-family data "
            "through the self-supervised path instead")
    train_fn, spe = _make_multiframe_data(cfg, a, "train")
    eval_fn, _ = _make_multiframe_data(
        cfg, a, "val" if not a.synthetic else "train")
    alt = make_alt_trainer(cfg, spe, device=a.device)
    ckpt_dir = cfg.checkpoint_dir or os.path.join(
        cfg.log_dir, cfg.model_name, "checkpoints")
    return alt, alt.fit(train_fn, eval_fn, cfg.num_epochs, ckpt_dir, writer,
                        spe)


def train(argv):
    """Train as the flags say; returns (trainer, the fit's tables
    {"initial": ..., "epoch_<e>": ...}).  The trainer is a Trainer on the
    published path, else an AltTrainer."""
    p = argparse.ArgumentParser("polardepth_tpu_torch train")
    _add_common_flags(p)
    a = p.parse_args(argv)
    cfg = _config_from_args(a)
    from polardepth_tpu_torch.train.trainer import Trainer
    from polardepth_tpu_torch.utils.logging import MetricWriter

    log_dir = os.path.join(cfg.log_dir, cfg.model_name)
    writer = MetricWriter(log_dir)
    try:
        if cfg.train_student or not cfg.depth_supervision_only:
            return _train_alternative_path(cfg, a, writer)
        train_it, spe = _make_data(cfg, a, "train")
        # the synthetic eval set is the train set, as in the JAX CLI
        eval_it, _ = _make_data(cfg, a, "val" if not a.synthetic else "train")
        trainer = Trainer(cfg, steps_per_epoch=spe, device=a.device)
        ckpt_dir = cfg.checkpoint_dir or os.path.join(log_dir, "checkpoints")
        results = trainer.fit(train_it, lambda: iter(eval_it),
                              cfg.num_epochs, ckpt_dir, writer=writer)
        for table in results.values():
            for slice_name, row in table.items():
                writer.scalars(f"test_{slice_name}", trainer.epoch,
                               {k: v for k, v in row.items()
                                if k != "frames"})
    finally:
        writer.close()
    return trainer, results


def _add_weights_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--weights", type=str, default="",
                   help="a checkpoint step directory (step_<N>) to load")
    p.add_argument("--reference_weights", type=str, default="",
                   help="a reference weights_<epoch>/ directory of "
                        "per-component .pth files (reference "
                        "evaluation.py:290-311)")


def _published_trainer(argv, name: str, add_flags=None):
    """(flags, cfg, eval BatchIterator, Trainer with the weights the flags
    name) of the published model, for the commands that predict."""
    p = argparse.ArgumentParser(f"polardepth_tpu_torch {name}")
    _add_common_flags(p)
    _add_weights_flags(p)
    if add_flags is not None:
        add_flags(p)
    a = p.parse_args(argv)
    if a.train_student:
        # the JAX package's commands build the published Trainer whatever
        # the flags say; it has no student evaluation
        raise NotImplementedError(f"{name} --train_student: not ported yet")
    cfg = _config_from_args(a)
    eval_it, spe = _make_data(cfg, a, "test" if not a.synthetic else "train")
    return a, cfg, eval_it, _trainer_with_weights(cfg, a, spe)


def _trainer_with_weights(cfg: Config, a, steps_per_epoch: int):
    """The published Trainer with the weights of --weights, then of
    --reference_weights."""
    from polardepth_tpu_torch.train import checkpoint as ckpt
    from polardepth_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, steps_per_epoch=steps_per_epoch, device=a.device)
    if a.weights:
        ckpt.restore(a.weights, trainer.state)
    if a.reference_weights:
        from polardepth_tpu_torch.models.reference_import import (
            load_reference_components)
        load_reference_components(a.reference_weights, trainer.model)
    return trainer


def evaluate(argv):
    """The per-material table of the weights the flags name, printed;
    returns (trainer, table).  With --save_pred_disps, also one .npy of the
    scaled disparities (1/depth) over the split (polardepth_tpu/cli.py:
    633-679)."""
    def flags(p):
        p.add_argument("--post_process", action="store_true", default=False,
                       help="flip-averaged eval (the Monodepth "
                            "post-processing)")
        p.add_argument("--save_pred_disps", action="store_true",
                       default=False,
                       help="also save the predicted scaled disparities as "
                            "one .npy (reference options.py "
                            "--save_pred_disps)")
        p.add_argument("--eval_out_dir", type=str, default="",
                       help="where --save_pred_disps writes (default: the "
                            "working directory)")

    a, cfg, eval_it, trainer = _published_trainer(argv, "evaluate", flags)
    table = trainer.evaluate(iter(eval_it))
    if a.save_pred_disps:
        disps = [1.0 / trainer.predict(b) for b in eval_it]
        out_dir = a.eval_out_dir or "."
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"disps_{cfg.dataset}_{a.split or 'test'}_split.npy")
        np.save(path, np.concatenate(disps, axis=0))
        print(f"saved predicted disparities to {path}")
    return trainer, table


def pointcloud(argv):
    """PLY clouds and the four prediction PNGs of every frame of the first
    eval batch (polardepth_tpu/cli.py:682-710); returns the depth."""
    a, cfg, eval_it, trainer = _published_trainer(
        argv, "pointcloud",
        lambda p: p.add_argument("--out", type=str, default="pointclouds"))
    from polardepth_tpu_torch.eval.pointcloud import (
        depth_to_pointcloud, export_prediction_pngs, write_ply)

    batch = next(iter(eval_it))
    depth = trainer.predict(batch)
    K = batch["K"][0]
    for i in range(depth.shape[0]):
        pts, cols = depth_to_pointcloud(
            depth[i], batch["color"][i], fx=K[0, 0], fy=K[1, 1],
            cx=K[0, 2], cy=K[1, 2])
        write_ply(os.path.join(a.out, f"cloud_{i:03d}.ply"), pts, cols)
        export_prediction_pngs(a.out, f"{i:03d}", batch["color"][i],
                               batch["mask"][i], depth[i],
                               batch["depth_gt"][i], cfg.max_depth)
    print(f"wrote {depth.shape[0]} clouds to {a.out}")
    return depth


def export(argv):
    """The preprocess and infer graph of the weights the flags name as one
    torch.export program, <out> and <out>.json (eval/export.py;
    polardepth_tpu/cli.py:713-758); returns the program."""
    p = argparse.ArgumentParser("polardepth_tpu_torch export")
    _add_common_flags(p)
    _add_weights_flags(p)
    p.add_argument("--out", type=str, default="model.pt2")
    p.add_argument("--batch", type=int, default=0,
                   help="fixed batch size; 0 = symbolic (any batch)")
    a = p.parse_args(argv)
    cfg = _config_from_args(a)
    from polardepth_tpu_torch.eval.export import make_export, save_artifact

    trainer = _trainer_with_weights(cfg, a, 1)
    program = make_export(cfg, trainer.model.state_dict(),
                          batch=a.batch or None, device=a.device)
    save_artifact(program, a.out, cfg)
    with open(a.out + ".json") as f:
        meta = json.load(f)
    print(f"wrote {a.out} (+.json): inputs {meta['inputs']} platforms "
          f"{meta['platforms']}")
    return program


def _frame_names(pred_dir: str) -> list:
    return sorted(f[: -len("_depth_pred.png")] for f in os.listdir(pred_dir)
                  if f.endswith("_depth_pred.png"))


def _read_png(pred_dir: str, name: str, tag: str):
    import cv2
    path = os.path.join(pred_dir, f"{name}_{tag}.png")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return img


def analyze(argv):
    """The 2-D visual analysis of saved predictions (the reference's
    analysis_2d/visual_analysis.ipynb; polardepth_tpu/cli.py:761-833):
    per-frame |error| heatmaps and masked-error renderings and a
    per-material RMS markdown table, from the PNGs ``pointcloud`` writes
    (<name>_{rgb,mask,depth_pred,depth_gt}.png, depths uint16 mm).
    Returns the report's path."""
    import cv2
    p = argparse.ArgumentParser("polardepth_tpu_torch analyze")
    p.add_argument("--pred_dir", type=str, required=True,
                   help="dir of <name>_{rgb,mask,depth_pred,depth_gt}.png")
    p.add_argument("--out", type=str, default="",
                   help="output dir (default: <pred_dir>/analysis)")
    p.add_argument("--min_depth", type=float, default=0.1)
    p.add_argument("--max_depth", type=float, default=2.0)
    a = p.parse_args(argv)
    from polardepth_tpu_torch.eval.analysis import (
        error_maps, per_material_rms, render_error_heatmap)
    from polardepth_tpu_torch.utils.colormap import colormap_plasma

    out_dir = a.out or os.path.join(a.pred_dir, "analysis")
    names = _frame_names(a.pred_dir)
    if not names:
        raise FileNotFoundError(f"no *_depth_pred.png in {a.pred_dir}")
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    agg: dict = {}
    for name in names:
        pred = _read_png(a.pred_dir, name, "depth_pred").astype(
            np.float32) / 1000.0
        gt = _read_png(a.pred_dir, name, "depth_gt").astype(
            np.float32) / 1000.0
        mask = _read_png(a.pred_dir, name, "mask")
        heat = render_error_heatmap(pred, gt, a.min_depth, a.max_depth)
        cv2.imwrite(os.path.join(out_dir, f"{name}_error.png"),
                    (heat[..., ::-1] * 255).astype(np.uint8))
        maps = error_maps(pred, gt, a.min_depth, a.max_depth)
        obj = maps["abs"] * ((mask >= 20) & (mask <= 160))
        cv2.imwrite(os.path.join(out_dir, f"{name}_error_objects.png"),
                    (colormap_plasma(obj)[..., ::-1] * 255).astype(np.uint8))
        rms = per_material_rms(pred, gt, mask, a.min_depth, a.max_depth)
        rows.append((name, rms))
        for k, v in rms.items():
            if np.isfinite(v):
                agg.setdefault(k, []).append(v)

    mats = [k for k in rows[0][1] if k in agg]
    lines = ["# 2-D visual analysis", "",
             f"{len(names)} frames from `{a.pred_dir}`; RMS depth error (m) "
             f"per material slice, valid range "
             f"[{a.min_depth}, {a.max_depth}] m.", "",
             "| frame | " + " | ".join(mats) + " |",
             "|---|" + "---|" * len(mats)]
    for name, rms in rows:
        lines.append("| " + name + " | " + " | ".join(
            f"{rms[m]:.4f}" if np.isfinite(rms.get(m, float("nan")))
            else "-" for m in mats) + " |")
    lines.append("| **mean** | " + " | ".join(
        f"{np.mean(agg[m]):.4f}" for m in mats) + " |")
    lines += ["", "Per-frame artifacts: `<name>_error.png` (|error| "
              "heatmap), `<name>_error_objects.png` (objects-masked)."]
    report = os.path.join(out_dir, "report.md")
    with open(report, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {report} (+{2 * len(names)} heatmaps)")
    return report


def _placeholder_logo(size: int = 64) -> np.ndarray:
    """A filled ring with alpha, RGBA."""
    yy, xx = np.mgrid[:size, :size]
    r2 = (yy - size / 2) ** 2 + (xx - size / 2) ** 2
    ring = (r2 < (size * 0.45) ** 2) & (r2 > (size * 0.2) ** 2)
    logo = np.zeros((size, size, 4), np.uint8)
    logo[ring] = (40, 90, 220, 255)
    return logo


def ar(argv):
    """The depth-aware AR occlusion demo (reference ar_visualization/
    main.py:223-237; polardepth_tpu/cli.py:836-918): from the PNGs
    ``pointcloud`` writes, a logo composited at the background depth and
    swept across the frame, occluded by scene pixels whose predicted depth
    is closer, as an animated GIF (the sweep forward, then reversed).
    Returns the GIF's path."""
    import cv2
    p = argparse.ArgumentParser("polardepth_tpu_torch ar")
    p.add_argument("--pred_dir", type=str, required=True,
                   help="dir of <name>_{rgb,mask,depth_pred,depth_gt}.png "
                        "(from pointcloud)")
    p.add_argument("--name", type=str, default="",
                   help="frame name prefix (default: the first found)")
    p.add_argument("--logo", type=str, default="",
                   help="RGBA logo PNG (default: a generated placeholder)")
    p.add_argument("--out", type=str, default="",
                   help="output GIF (default: <pred_dir>/ar/depth_check.gif)")
    # the reference's sweep parameters (main.py:228-234)
    p.add_argument("--y_start", type=int, default=225)
    p.add_argument("--x_start", type=int, default=260)
    p.add_argument("--num_frames", type=int, default=30)
    p.add_argument("--pixel_movement_y", type=int, default=0)
    p.add_argument("--pixel_movement_x", type=int, default=3)
    p.add_argument("--logo_pixel_height", type=int, default=15)
    a = p.parse_args(argv)
    from polardepth_tpu_torch.apps.ar import render_ar_gif

    name = a.name
    if not name:
        names = _frame_names(a.pred_dir)
        if not names:
            raise FileNotFoundError(f"no *_depth_pred.png in {a.pred_dir}")
        name = names[0]
    rgb = _read_png(a.pred_dir, name, "rgb")[..., ::-1]
    mask = _read_png(a.pred_dir, name, "mask")
    pred = _read_png(a.pred_dir, name, "depth_pred").astype(
        np.float32) / 1000.0
    gt = _read_png(a.pred_dir, name, "depth_gt").astype(np.float32) / 1000.0
    h, w = pred.shape[:2]
    if a.logo:
        logo = cv2.imread(a.logo, cv2.IMREAD_UNCHANGED)
        if logo is None:
            raise FileNotFoundError(a.logo)
        if logo.shape[-1] == 4:
            logo = np.concatenate([logo[..., 2::-1], logo[..., 3:]], axis=-1)
        else:
            logo = logo[..., ::-1]
    else:
        logo = _placeholder_logo()
    ys = [a.y_start + i * a.pixel_movement_y for i in range(a.num_frames)]
    xs = [a.x_start + i * a.pixel_movement_x for i in range(a.num_frames)]
    positions = [(int(np.clip(y, 0, h - 1)), int(np.clip(x, 0, w - 1)))
                 for y, x in zip(ys, xs)]
    positions = positions + positions[::-1]  # the reference's forward+reverse
    out = a.out or os.path.join(a.pred_dir, "ar", "depth_check.gif")
    render_ar_gif(out, rgb, pred, gt, (mask > 0).astype(np.uint8), logo,
                  positions, duration_ms=300,
                  logo_pixel_height=a.logo_pixel_height)
    print(f"wrote {out} ({len(positions)} frames)")
    return out


COMMANDS = {"train": train, "evaluate": evaluate, "pointcloud": pointcloud,
            "export": export, "analyze": analyze, "ar": ar}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 1
    with float32():
        COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
