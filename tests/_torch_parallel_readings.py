"""The readings behind the gradient rules of the port's parallel tests:
each gradient of `_torch_parallel.train_step_dropout` (two steps at
dropout 0.1) on dp = 2, tp = 2 and dp = 2 x tp = 2 gloo ranks against one
process, as max |g - ref| / max |ref| tensor by tensor, for the payloads
of the seeds given (seed 11 is tests/test_torch_tensor_parallel.py's own).
One JSON line per (seed, mesh, step): the worst three tensors.

    JAX_PLATFORMS=cpu python tests/_torch_parallel_readings.py 11 1 2 3 4 5
"""

import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import _torch_parallel as tp  # noqa: E402

MESHES = (("dp2", 2, 1), ("tp2", 1, 2), ("dp2xtp2", 2, 2))


def payload(seed: int, batch: int = 4) -> dict:
    """tests/test_torch_tensor_parallel.py's dropout payload from `seed`."""
    rng = np.random.default_rng(seed)
    m = tp.TRAIN_MODEL
    return {"x": (rng.normal(size=(batch, m["dancer_num"], m["seq_len"], 151)) * 0.3).astype(np.float32),
            "cond": rng.normal(size=(batch, 2 * m["seq_len"] + 1, m["cond_feature_dim"])).astype(np.float32)}


def main(seeds) -> None:
    for seed in seeds:
        p = payload(seed)
        lone = tp.train_step_dropout(None, p)
        for label, dp, tpn in MESHES:
            with tempfile.TemporaryDirectory() as tmp:
                got = tp.run_ranks("train_step_dropout", tmp, p, dp=dp, tp=tpn)[0]
            for step, ref in enumerate(lone["grads"]):
                errs = {n: ((got["grads"][step][n] - r).abs().max() / r.abs().max()).item()
                        for n, r in ref.items() if r.abs().max() > 0}
                worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
                print(json.dumps({"seed": seed, "mesh": label, "step": step + 1,
                                  "worst": [[n, float(f"{e:.3g}")] for n, e in worst]}), flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or [11])
