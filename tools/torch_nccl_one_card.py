"""Try NCCL with two ranks on one card, and print what it says.

    python3 tools/torch_nccl_one_card.py     # on a machine with one CUDA card

Two spawned processes join an NCCL group (a file:// store in a temporary
directory), both on cuda:0, and all-reduce one tensor. NCCL is expected to
refuse ("Duplicate GPU detected"): that is why the port's two-rank runs on
one card (chip_smoke.py's dp phase, the cuda-marked test) use gloo. Each
rank prints the exception it got, or the all-reduce's result; the script
exits 0 once both ranks have ended (or were ended after 120 s).
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, store: str) -> None:
    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=store, rank=rank, world_size=2)
        t = torch.ones(4, device="cuda:0") * (rank + 1)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print(f"rank {rank}: all_reduce returned {t.tolist()}", flush=True)
    except Exception as e:  # the message is what this tool reports
        print(f"rank {rank}: {type(e).__name__}: {e}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, NCCL {torch.cuda.nccl.version()}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=("file://" + os.path.join(tmp, "store"),), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + 120
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    print("the ranks did not end within 120 s; ending them", flush=True)
                    break
        except mp.ProcessExitedException as e:
            print(f"a rank exited: {e}", flush=True)
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
