"""The port's `generate_streaming` (tcdiff_torch/train/orchestrator.py)
against the JAX package's `TCDiff.generate_streaming`, on the CPU, from the
start and resumed mid-song, on the set-up of tests/test_torch_generate.py
(the same tiny decoder, DBN, normalizer and tolerance, 3e-5).

The JAX method's own per-call jit is swapped for the identity, so that
each slice can take its noise (the sampler stays jitted); the JAX stream
sampler's in-loop draws come from its key (1000 + slice) and are handed to
the port.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tcdiff_tpu.train import orchestrator as jorch  # noqa: E402
from tcdiff_torch.train import orchestrator as orch  # noqa: E402
from tests.test_torch_generate import DN, NF, SEQ, STEPS, TOL, _noise, _wav, stack  # noqa: E402,F401


def _prev_noise(i: int) -> np.ndarray:
    """The JAX stream sampler's in-loop draws for slice i (key 1000 + i):
    (k_init, k_scan) = split(key); each step splits k_scan once more."""
    key = jax.random.split(jax.random.key(1000 + i))[1]
    out = []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (1, SEQ // 2, DN, NF), jnp.float32)))
    return np.stack(out).reshape(STEPS, 1, SEQ // 2 * DN, NF)


class _StreamNoise:
    """In place of the JAX diffusion: its jitted stream sampler with each
    slice's noise injected, in order."""

    def __init__(self, runner, noise, first: int):
        self.fn, self.noise, self.i = runner.jitted["ddim_sample_stream"], noise, first

    def ddim_sample_stream(self, params, shape, cond, rng, x_0, prev_tail):
        noise, self.i = self.noise[self.i], self.i + 1
        return self.fn(params, shape, cond, rng, x_0, prev_tail, {k: noise[k] for k in ("init", "steps")})


@pytest.mark.parametrize("resume", [False, True])
def test_generate_streaming_matches_jax(stack, tmp_path, monkeypatch, resume):
    """1.2 s, 3 slices; resumed at slice 2 from the uninterrupted run's
    tail of slice 1, which it then continues bit for bit."""
    runner, diffusion, traj_model, normalizer = stack
    wav = _wav(tmp_path, 1.2, 8)
    noise = [dict(_noise(1, 20 + i), prev=_prev_noise(i)) for i in range(3)]
    slices = {}
    full = orch.generate_streaming(wav, diffusion, traj_model, normalizer, noise=noise,
                                   on_slice=lambda i, s4: slices.update({i: s4}))
    assert sorted(slices) == [0, 1, 2] and full.shape == (32, DN, NF)
    resume_tail = None
    if resume:
        resume_tail = slices[1][:, SEQ // 2:].reshape(1, SEQ // 2 * DN, NF)
        out = orch.generate_streaming(wav, diffusion, traj_model, normalizer, noise=noise, resume_from=2,
                                      resume_tail=resume_tail)
        assert torch.equal(out, full[-SEQ // 2:])
    else:
        out = full

    eager = types.ModuleType("jax_eager")
    eager.__dict__.update(jax.__dict__)
    eager.jit = lambda fn, **kw: fn
    monkeypatch.setattr(jorch, "jax", eager)
    monkeypatch.setattr(jorch, "render_sample", lambda *a, **k: None)
    monkeypatch.setattr(runner, "diffusion", _StreamNoise(runner, noise, 2 if resume else 0))
    ref = runner.generate_streaming(wav, types.SimpleNamespace(), resume_from=2 if resume else 0,
                                    resume_tail=None if resume_tail is None else resume_tail.numpy())
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # the slices' trajectory is the whole song's rollout, filtered
    report = {}
    orch.generate(wav, diffusion, traj_model, normalizer, noise=_noise(3, 1), report=report)
    np.testing.assert_array_equal(full[..., 4:6].numpy(), report["traj"][:, :32].transpose(0, 1).numpy())
