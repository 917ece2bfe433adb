"""Faults planted under the timed path, for the tests that show the
comparison turning `correct` false (`benchmark/tests/test_benchmark_faults.py`)
and for the readings that bound the limits from above
(`benchmark/tools/control.py`). A run plants them through `Run.faults`
in every rank's process; the command line cannot."""

from __future__ import annotations

import contextlib


def _answer_altered():
    """Every served clip's rotation channels moved by 0.02 where the sampler
    returns them."""
    from tcdiff_torch.diffusion.gaussian import GaussianDiffusion

    inner = GaussianDiffusion._ddim_loop

    def altered(self, *a, **k):
        x = inner(self, *a, **k)
        return x + 0.02 * (x.new_tensor([0.0] * 6 + [1.0] * (x.shape[-1] - 6)))

    GaussianDiffusion._ddim_loop = altered
    return lambda: setattr(GaussianDiffusion, "_ddim_loop", inner)


def _state_unchanged():
    """The optimizer step returns the parameters as they were."""
    from tcdiff_torch.optim.adan import Adan

    inner = Adan.step
    Adan.step = lambda self, closure=None: None
    return lambda: setattr(Adan, "step", inner)


def _half_batch():
    """The loss over the first half of the rows alone, its mean taken over
    them."""
    from tcdiff_torch.diffusion.gaussian import GaussianDiffusion

    inner = GaussianDiffusion.loss

    def half(self, x, cond, generator=None, t=None, noise=None, keep_mask=None, rows=None, trj_dist=None):
        h = x.shape[0] // 2
        return inner(self, x[:h], cond[:h], generator, t, noise, keep_mask, None, trj_dist)

    GaussianDiffusion.loss = half
    return lambda: setattr(GaussianDiffusion, "loss", inner)


def _no_exchange():
    """The gradient all-reduce across the ranks left out."""
    import tcdiff_torch.train.train_step as ts

    inner = ts.all_reduce_grads_
    ts.all_reduce_grads_ = lambda grads, mesh: None
    return lambda: setattr(ts, "all_reduce_grads_", inner)


DROPPED_LEAF = "seqTransDecoder.stack.1.linear1.weight"


def _leaf_zeroed():
    """A backward that drops a leaf: the gradient of one decoder layer's
    feed-forward weight (`DROPPED_LEAF`) comes out zero."""
    import torch
    from tcdiff_torch.diffusion.gaussian import GaussianDiffusion

    inner, hooks = GaussianDiffusion.loss, {}

    def dropping(self, *a, **k):
        p = self.model.get_parameter(DROPPED_LEAF)
        if id(p) not in hooks:
            hooks[id(p)] = p.register_hook(torch.zeros_like)
        return inner(self, *a, **k)

    def undo():
        GaussianDiffusion.loss = inner
        for h in hooks.values():
            h.remove()

    GaussianDiffusion.loss = dropping
    return undo


def _jax_in_rank1():
    """Rank 1's process loads a module named `jax` (an empty stand-in) and
    keeps it: the refusal of a run whose processes hold JAX has to cover
    every rank's process, not only the one that prints."""
    import sys
    import types

    import torch.distributed as dist

    if dist.is_initialized() and dist.get_rank() == 1:
        sys.modules["jax"] = types.ModuleType("jax")
    return lambda: None


FAULTS = {"answer_altered": _answer_altered, "state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "leaf_zeroed": _leaf_zeroed, "jax_in_rank1": _jax_in_rank1}


@contextlib.contextmanager
def planted(names):
    """The named faults in place while the block runs, then taken out."""
    undo = [FAULTS[name]() for name in names]
    try:
        yield
    finally:
        for restore in reversed(undo):
            restore()
