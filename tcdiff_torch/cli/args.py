"""The flags of `cli.train`: the port of `tcdiff_tpu/cli/args.py`, the
reference's `args.py:4-68` surface with the same names and defaults, and
the JAX package's extras.

Differences from the JAX package's flags:

  * `--device {cuda,cpu}` (default cuda) chooses where the model runs; it
    takes the place of the JAX package's TCDIFF_PLATFORM variable;
  * `--dp` and `--tp` are the data- and tensor-parallel sizes of the
    (dp, tp) mesh: dp x tp must be the world size of the process group
    (one process a rank, launched by `torchrun --nproc_per_node D*T -m
    tcdiff_torch.cli.train --dp D --tp T ...`; dp=-1: the world over tp);
    another value, or a tp that does not divide the model's heads,
    raises ValueError when `TCDiff` builds its mesh and splits its state;
  * `--scan_steps` above 1 (TPU dispatch machinery, which the port does
    not need) raises NotImplementedError instead of being ignored.
"""

from __future__ import annotations

import argparse
import dataclasses

from tcdiff_torch.config import TCDiffConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="tcdiff_torch trainer/sampler")

    # Project
    parser.add_argument("--project", default="./runs/train")
    parser.add_argument("--exp_name", default="exp")

    # Dataset
    parser.add_argument("--data_path", type=str, default="./data/AIOZ_Dataset/")
    parser.add_argument("--processed_data_dir", type=str, default="./data/dataset_backups/")
    parser.add_argument("--batch_size", type=int, default=37)
    parser.add_argument("--window_size", type=int, default=150)
    parser.add_argument("--force_reload", action="store_true", default=False)
    parser.add_argument("--no_cache", action="store_true", default=False)
    parser.add_argument("--required_dancer_num", type=int, default=4)
    parser.add_argument("--split_file", type=str, default=None,
                        help="dancer-count split file (list of sequence names)")

    # Output
    parser.add_argument("--vis_fk_out", type=str, default=None,
                        help="dir for FK pkl exports (Blender pipeline input)")
    parser.add_argument("--render_dir", type=str, default="./renders/")
    parser.add_argument("--wandb_pj_name", type=str, default="TCDiff")
    parser.add_argument("--no_render", dest="render", action="store_false", default=True)

    # Training
    parser.add_argument("--learning-rate", dest="learning_rate", type=float, default=5e-5)
    parser.add_argument("--epochs", type=int, default=10000)
    parser.add_argument("--save_interval", type=int, default=50)
    parser.add_argument("--ema_interval", type=int, default=1)
    parser.add_argument("--scan_steps", type=int, default=1,
                        help="train steps a dispatch in the JAX package; only 1 here")
    parser.add_argument("--checkpoint", type=str, default="")

    # Validation / test
    parser.add_argument("--traj_checkpoint", type=str, default=None)
    parser.add_argument("--render_count", type=int, default=30)
    parser.add_argument("--sample_mode", default="normal", choices=["normal", "long", "footwork", "ddpm"],
                        help="sampler: DDIM / sliced long-form DDIM / footwork adaptor / DDPM")
    parser.add_argument("--mode", default="train",
                        choices=["train", "val_without_TrajModel", "test", "eval", "generate"])
    parser.add_argument("--wav", type=str, default=None, help="input audio for --mode generate")
    parser.add_argument("--streaming", action="store_true", default=False,
                        help="generate causally slice by slice (low latency)")
    parser.add_argument("--eval_during_train", action="store_true", default=False,
                        help="compute quality metrics every save_interval epochs")
    parser.add_argument("--traj_source", default="gt", choices=["gt", "dbn", "both"],
                        help="--mode eval trajectory setting: ground-truth (stage isolation), "
                             "DBN rollout+Kalman (full pipeline, paper-comparable), or both")

    # extras
    parser.add_argument("--synthetic", action="store_true", default=False,
                        help="run on a generated synthetic dataset (no AIOZ on disk)")
    parser.add_argument("--synthetic_size", type=int, default=16)
    parser.add_argument("--dp", type=int, default=-1,
                        help="data-parallel size: -1 or the number of ranks torchrun started")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel size: the train state split over tp ranks (dp x tp = the world)")
    parser.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--remat", action="store_true", default=False,
                        help="recompute each decoder layer's forward in the backward (less memory)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="record a torch.profiler trace of the second epoch here")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model runs (the card unless cpu is asked for)")
    return parser


def check_ported(opt) -> None:
    """Raise NotImplementedError for a flag whose path the port does not
    have, naming the ROADMAP item that set it aside."""
    if opt.scan_steps > 1:
        raise NotImplementedError(f"--scan_steps {opt.scan_steps}: several train steps a dispatch is the JAX "
                                  f"package's TPU dispatch machinery, which the port does not carry "
                                  f"(ROADMAP queue 1 item 6)")


def parse_train_opt(argv=None):
    opt = build_parser().parse_args(argv)
    check_ported(opt)
    return opt


def config_from_opt(opt) -> TCDiffConfig:
    """Fold the parsed flags into the typed config tree: the model's
    dancers and frames, the trainer's counts and the data paths, which
    `TCDiff` reads from the tree alone."""
    cfg = TCDiffConfig()
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, dancer_num=opt.required_dancer_num, seq_len=opt.window_size),
        train=dataclasses.replace(cfg.train, batch_size=opt.batch_size, learning_rate=opt.learning_rate,
                                  epochs=opt.epochs, save_interval=opt.save_interval,
                                  ema_interval=opt.ema_interval, seed=opt.seed, compute_dtype=opt.compute_dtype,
                                  dp=opt.dp, tp=opt.tp, remat=opt.remat),
        data=dataclasses.replace(cfg.data, data_path=opt.data_path, processed_data_dir=opt.processed_data_dir),
    )
