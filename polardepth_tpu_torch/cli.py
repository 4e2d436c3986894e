"""Command-line entry points of the port (polardepth_tpu/cli.py).

  python -m polardepth_tpu_torch train    [flags]  - supervised training
  python -m polardepth_tpu_torch evaluate [flags]  - per-material eval table

Flag names are those of the JAX package's CLI (the reference's
MonodepthOptions, options.py:13-380), for every field of the port's Config,
so that train_supervised_GT.sh maps one to one.  --synthetic N substitutes N
generated scenes for the HAMMER dataset; --device picks the device (the
card by default).  A flag of a path the port does not have yet raises
instead of being ignored.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from polardepth_tpu_torch.config import Config

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
                 "depth_modality", "checkpoint_dir", "overfit_scene"):
        p.add_argument(f"--{name}", type=str, default=getattr(d, name))
    for name in ("height", "width", "offset", "batch_size", "num_epochs",
                 "scheduler_step_size", "seed", "save_frequency",
                 "log_frequency"):
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
                 "enable_12channels"):
        p.add_argument(f"--{name}", action="store_true",
                       default=getattr(d, name))
    p.add_argument("--warp_impl", type=str, default=d.warp_impl,
                   help="full-res reprojection sampler: auto (the band-warp "
                        "kernel) | patch | flat4 (see ops/warp.py)")
    p.add_argument("--decode_backend", type=str, default=d.decode_backend,
                   help="host PNG decode; the port has cv2 only")
    p.add_argument("--random_flip", type=_bool, default=None,
                   help="random horizontal flip of training samples "
                        "(default: on for KITTI-family datasets, off for "
                        "HAMMER)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic scenes instead of HAMMER data")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model (default: the card)")
    # paths of the JAX package that the port does not have yet: accepted
    # only to refuse them
    for name in ("train_student", "train_dpt", "res_pose", "use_attention"):
        p.add_argument(f"--{name}", action="store_true", default=False)


def _refuse_unported(a) -> None:
    for name in ("train_student", "train_dpt", "res_pose", "use_attention"):
        if getattr(a, name):
            raise NotImplementedError(f"--{name}: not ported yet")
    if not a.depth_supervision_only:
        raise NotImplementedError(
            "--depth_supervision_only false (the self-supervised loop, "
            "AltTrainer): not ported yet")
    if getattr(a, "reference_weights", ""):
        raise NotImplementedError("--reference_weights: not ported yet")


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


def train(argv):
    """Train as the flags say; returns (trainer, the fit's tables
    {"initial": ..., "epoch_<e>": ...})."""
    p = argparse.ArgumentParser("polardepth_tpu_torch train")
    _add_common_flags(p)
    a = p.parse_args(argv)
    cfg = _config_from_args(a)
    from polardepth_tpu_torch.train.trainer import Trainer
    from polardepth_tpu_torch.utils.logging import MetricWriter

    log_dir = os.path.join(cfg.log_dir, cfg.model_name)
    writer = MetricWriter(log_dir)
    try:
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


def evaluate(argv):
    """The per-material table of the weights the flags name, printed;
    returns (trainer, table)."""
    p = argparse.ArgumentParser("polardepth_tpu_torch evaluate")
    _add_common_flags(p)
    p.add_argument("--weights", type=str, default="",
                   help="a checkpoint step directory (step_<N>) to load")
    p.add_argument("--reference_weights", type=str, default="",
                   help="reference .pth weights: not ported yet")
    p.add_argument("--post_process", action="store_true", default=False,
                   help="flip-averaged eval (the Monodepth post-processing)")
    a = p.parse_args(argv)
    cfg = _config_from_args(a)
    from polardepth_tpu_torch.train import checkpoint as ckpt
    from polardepth_tpu_torch.train.trainer import Trainer

    eval_it, spe = _make_data(cfg, a, "test" if not a.synthetic else "train")
    trainer = Trainer(cfg, steps_per_epoch=spe, device=a.device)
    if a.weights:
        ckpt.restore(a.weights, trainer.state)
    return trainer, trainer.evaluate(iter(eval_it))


COMMANDS = {"train": train, "evaluate": evaluate}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        print("commands:", ", ".join(COMMANDS))
        return 1
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
