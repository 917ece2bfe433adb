"""Entry point: `python -m tcdiff_torch.cli.train --mode
{train,val_without_TrajModel,test,eval,generate} [--device cpu]`.

The port of `tcdiff_tpu/cli/train.py`, the reference's `train.py:8-25`
dispatch over the `TCDiff` class. The model runs on the card unless
`--device cpu` is given; without a card the first allocation raises.

Data and tensor parallelism: `torchrun --nproc_per_node D*T -m
tcdiff_torch.cli.train --dp D --tp T ...` starts one process a rank of the
(dp, tp) mesh; each joins the group first (`utils.paths.
maybe_init_multihost`: NCCL on `cuda:{LOCAL_RANK}`, gloo with `--device
cpu`), and rank 0 names the run directory for all.
"""

from __future__ import annotations

import json
import os

import torch.distributed as dist

from tcdiff_torch.cli.args import config_from_opt, parse_train_opt
from tcdiff_torch.parallel.comm import collective_counts
from tcdiff_torch.train.orchestrator import TCDiff
from tcdiff_torch.utils.logging import get_logger
from tcdiff_torch.utils.paths import increment_path, maybe_init_multihost
from tcdiff_torch.utils.profiling import trace


def main(argv=None) -> TCDiff:
    opt = parse_train_opt(argv)
    device = maybe_init_multihost(opt.device)  # joins torchrun's group, if any
    if dist.is_initialized():
        get_logger().info("parallel: rank %d of %d (dp %d x tp %d), backend %s, device %s", dist.get_rank(),
                          dist.get_world_size(), dist.get_world_size() // opt.tp, opt.tp, dist.get_backend(),
                          device)
    cfg = config_from_opt(opt)
    if opt.mode == "train" and not opt.checkpoint:
        # run directories that never clobber, as the reference's increment_path;
        # rank 0's choice, so that every rank names the same one
        name = [os.path.basename(str(increment_path(os.path.join(opt.project, opt.exp_name))))]
        if dist.is_initialized():
            dist.broadcast_object_list(name, src=0)
        opt.exp_name = name[0]
    runner = TCDiff(cfg, checkpoint_path=opt.checkpoint or None, use_ema_for_eval=opt.mode != "train",
                    device=device)
    if opt.mode == "train":
        runner.train_loop(opt)  # records its own trace of epoch 2 with --profile_dir
        if dist.is_initialized():
            get_logger().info("parallel: collectives issued %s", json.dumps(collective_counts()))
        return runner
    with trace(opt.profile_dir):
        if opt.mode == "val_without_TrajModel":
            runner.given_trajectory_generation_loop(opt)
        elif opt.mode == "test":
            runner.test_loop(opt)
        elif opt.mode == "eval":
            runner.evaluate_loop(opt)
        elif opt.mode == "generate":
            if not opt.wav:
                raise ValueError("--mode generate needs --wav <file>")
            if runner.normalizer is None:  # no checkpoint: the synthetic data's stats
                runner.normalizer = runner.load_datasets(opt)[0].normalizer
            if opt.streaming:
                runner.generate_streaming(opt.wav, opt)
            else:
                runner.generate(opt.wav, opt)
    return runner


if __name__ == "__main__":
    main()
