"""Data-parallel sampling in the port against the JAX package's dp mesh and
against one process, on the CPU with two gloo ranks.

The ranks are spawned once for the file (`tests/_torch_parallel.py`,
`sample_cases`); the JAX references run here on the 8-device CPU mesh of
tests/conftest.py (`make_mesh(dp=2)`), at tests/test_sharded_long_sampling
.py's sizes (1 layer, d=32, 8 frames x 2 dancers, 4 DDIM steps over 10
timesteps). Cases:

  * `long_ddim_sample_sharded` of 4 slices (2 a rank) and of 2 slices
    (one a rank: the one-slice quirk is decided on the global count, so
    the trajectory x_0 is kept), on injected noise: within 3e-5 of JAX's
    `long_ddim_sample_sharded` (XLA's and PyTorch's f32 sums in another
    order) and within 1e-5 of the port's own `long_ddim_sample` in one
    process, each rank holding its slices of it;
  * the same at 4 slices with its noise drawn from a generator: the draws
    are made at the global shape, so the song is the one process's;
  * normal-mode `TCDiff._sample` over the ranks (tests/_torch_tcdiff.py's
    tiny configuration, 4 clips): within 1e-5 of one process, on every
    rank, and the same inside `alone()`, where each rank samples the whole
    batch by itself.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parallel as tp  # noqa: E402
from tcdiff_tpu.config import DanceDecoderConfig as JaxDecoderConfig  # noqa: E402
from tcdiff_tpu.config import DiffusionConfig as JaxDiffusionConfig  # noqa: E402
from tcdiff_tpu.diffusion import GaussianDiffusion as JaxDiffusion  # noqa: E402
from tcdiff_tpu.models import DanceDecoder as JaxDecoder  # noqa: E402
from tcdiff_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402

JAX_TOL, PORT_TOL = 3e-5, 1e-5
N_CLIPS = 4


def _tcdiff_payload():
    cfg = tp.TCDIFF_MODEL
    rng = np.random.default_rng(4)
    tokens = cfg["seq_len"] * cfg["dancer_num"]
    return {"cond": rng.normal(size=(N_CLIPS, 2 * cfg["seq_len"] + 1, 438)).astype(np.float32),
            "x_0": (rng.normal(size=(N_CLIPS, tokens, 3)) * 0.2).astype(np.float32)}


def _tcdiff_lone(p):
    """Normal-mode `_sample` in one process, from the generator seed the
    ranks use."""
    from tcdiff_torch.config import DanceDecoderConfig, DiffusionConfig, TCDiffConfig, TrainConfig
    from tcdiff_torch.train.orchestrator import TCDiff

    cfg = TCDiffConfig(model=DanceDecoderConfig(**tp.TCDIFF_MODEL), diffusion=DiffusionConfig(**tp.TCDIFF_DIFF),
                       train=TrainConfig(batch_size=4))
    runner = TCDiff(cfg, device="cpu")
    assert runner.mesh.world == 1 and runner.mesh.group is None
    return runner._sample(p["cond"], p["x_0"], torch.Generator().manual_seed(5))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if len(jax.devices()) < 2:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    jcfg = JaxDecoderConfig(**tp.LONG_MODEL)
    jmodel = JaxDecoder(jcfg)
    tokens = jcfg.seq_len * jcfg.dancer_num
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, tokens, jcfg.nfeats)),
                                  jnp.zeros((1, 2 * jcfg.seq_len + 1, jcfg.cond_feature_dim)),
                                  jnp.zeros((1,), jnp.int32))["params"]
    long_payload = tp.long_payload(jax.tree.map(np.asarray, params))
    tcdiff_payload = _tcdiff_payload()
    started = tp.start_ranks("sample_cases", tmp_path_factory.mktemp("ranks"),
                             {"long": long_payload, "tcdiff": tcdiff_payload})
    # the references, while the ranks run
    diff = JaxDiffusion(jmodel, JaxDiffusionConfig(**tp.LONG_DIFF))
    mesh = jax_make_mesh(dp=2, tp=1)
    jax_long = {}
    for n, c in long_payload["cases"].items():
        out = diff.long_ddim_sample_sharded(params, c["shape"], jnp.asarray(c["cond"]), jax.random.key(1), mesh,
                                            x_0=jnp.asarray(c["x_0"]), noise=c["noise"])
        assert not out.sharding.is_fully_replicated
        jax_long[n] = np.asarray(out)
    refs = {"jax_long": jax_long, "port_long": tp.long_sampler_plain(long_payload),
            "tcdiff": _tcdiff_lone(tcdiff_payload)}
    return {"ranks": tp.join_ranks(started), "cases": long_payload["cases"], **refs}


@pytest.mark.parametrize("n", [4, 2])
def test_sharded_long_sampler_matches_jax_sharded(run, n):
    for r, res in enumerate(run["ranks"]):
        got = res["long"][n]["full"].numpy()
        assert got.shape == run["cases"][n]["shape"]
        np.testing.assert_allclose(got, run["jax_long"][n], atol=JAX_TOL, rtol=0, err_msg=f"rank {r}")


@pytest.mark.parametrize("n", [4, 2])
def test_sharded_long_sampler_matches_one_process(run, n):
    ref = run["port_long"][n]
    per = n // tp.WORLD
    for r, res in enumerate(run["ranks"]):
        assert (res["long"][n]["full"] - ref).abs().max().item() <= PORT_TOL, r
        assert torch.equal(res["long"][n]["local"], res["long"][n]["full"][r * per:(r + 1) * per])
    # the one-slice quirk, decided on the global count: x_0's XY is kept in
    # channels 4, 5 of every slice, on the rank holding one slice too
    x_0 = torch.from_numpy(run["cases"][n]["x_0"])
    assert torch.equal(run["ranks"][1]["long"][n]["local"][..., 4:6], x_0[per:, :, 0:2])


def test_sharded_long_sampler_draws_at_the_global_shape(run):
    ref = run["port_long"]["generator"]
    for r, res in enumerate(run["ranks"]):
        assert (res["long"]["generator"] - ref).abs().max().item() <= PORT_TOL, r


def test_tcdiff_normal_sampling_over_dp_matches_one_process(run):
    ref = run["tcdiff"]
    for r, res in enumerate(run["ranks"]):
        got = res["tcdiff"]
        assert got["dp"] == tp.WORLD and got["sharded"].shape == ref.shape
        assert (got["sharded"] - ref).abs().max().item() <= PORT_TOL, r
        assert (got["alone"] - ref).abs().max().item() <= PORT_TOL, r
