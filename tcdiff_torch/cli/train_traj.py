"""Entry point: `python -m tcdiff_torch.cli.train_traj`, the DBN trainer.

The port of `tcdiff_tpu/cli/train_traj.py`, which mirrors the reference's
`TrajDecoder/train_traj.py` and `TrajDecoder/options/option_traj.py:3-70`.
It trains on the card unless `--device cpu` is given; `--synthetic` trains
on seeded stand-in data, otherwise on a dataset that `create_dataset`
wrote under `--data_path`; `--checkpoint` resumes from a checkpoint the
trainer wrote. `--dp N` under `torchrun --nproc_per_node N -m
tcdiff_torch.cli.train_traj --dp N ...` trains data-parallel over N ranks
(the batch size is the global one; rank 0 writes the files).
"""

from __future__ import annotations

import argparse

from tcdiff_torch.config import TrajDecoderConfig
from tcdiff_torch.utils.paths import maybe_init_multihost


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tcdiff_torch DBN (TrajDecoder) trainer")
    # the reference's option_traj surface
    p.add_argument("--data_path", type=str, default="./data/AIOZ_Dataset/")
    p.add_argument("--out_dir", type=str, default="./runs/traj")
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--nfeats", type=int, default=2)
    p.add_argument("--trans_layer", type=int, default=6)
    p.add_argument("--window_size", type=int, default=100)
    p.add_argument("--step", type=int, default=25)
    p.add_argument("--total_iter", type=int, default=800_000)
    p.add_argument("--print_iter", type=int, default=5000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--gamma", type=float, default=0.05)
    p.add_argument("--lr_scheduler", type=int, nargs="+", default=[60_000])
    p.add_argument("--weight_decay", type=float, default=1e-6)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--required_dancer_num", type=int, default=3)
    p.add_argument("--split_file", type=str, default=None)
    # the port's
    p.add_argument("--synthetic", action="store_true", default=False)
    p.add_argument("--synthetic_size", type=int, default=16)
    p.add_argument("--seq_len", type=int, default=150)
    p.add_argument("--render", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dp", type=int, default=-1, help="data-parallel size: -1 or the number of ranks torchrun started")
    return p


def main(argv=None):
    opt = build_parser().parse_args(argv)
    device = maybe_init_multihost(opt.device)  # joins torchrun's group, if any
    cfg = TrajDecoderConfig(
        nfeats=opt.nfeats, trans_layer=opt.trans_layer, window_size=opt.window_size, step=opt.step,
        total_iter=opt.total_iter, print_iter=opt.print_iter, batch_size=opt.batch_size, lr=opt.lr,
        gamma=opt.gamma, lr_milestones=tuple(opt.lr_scheduler), weight_decay=opt.weight_decay, seed=opt.seed,
    )
    from tcdiff_torch.trajdecoder.dataset import SyntheticTrajDataset, TrajDataset
    from tcdiff_torch.trajdecoder.trainer import TrajTrainer

    trainer = TrajTrainer(cfg, dancer_num=opt.required_dancer_num, device=device, dp=opt.dp)
    if opt.checkpoint:
        trainer.restore(opt.checkpoint)

    if opt.synthetic:
        train_ds = SyntheticTrajDataset(opt.synthetic_size, opt.required_dancer_num, opt.seq_len, seed=opt.seed,
                                        device=trainer.device)
        test_ds = SyntheticTrajDataset(max(2, opt.synthetic_size // 4), opt.required_dancer_num, opt.seq_len,
                                       seed=opt.seed + 1, normalizer=train_ds.normalizer, device=trainer.device)
    else:
        from tcdiff_torch.data.dataset import load_split_file

        split = load_split_file(opt.split_file) if opt.split_file else None
        train_ds = TrajDataset(opt.data_path, train=True, required_dancer_num=opt.required_dancer_num,
                               split_file=split, device=trainer.device)
        test_ds = TrajDataset(opt.data_path, train=False, required_dancer_num=opt.required_dancer_num,
                              split_file=split, normalizer=train_ds.normalizer, device=trainer.device)

    trainer.train(train_ds, test_ds, out_dir=f"{opt.out_dir}/{opt.exp_name}", render=opt.render)
    return trainer


if __name__ == "__main__":
    main()
