"""The frozen reference (`benchmark/reference`) against the port's plain
path (its CPU versions) at a small width in float32: the SMPL FK, a DDIM
request on the same noise, and three train steps on the same draws
(loss, the first gradient's norms, the parameters and EMA after them).
Tolerances: float32 sums in another order through 2 layers; Adan turns
round-off into moves of up to lr where a moment nearly cancels, so the
parameters are held by the norm of each tensor's change, as the cells'
comparison holds them."""

import json
import os
import statistics

import torch

from benchmark import spec
from benchmark.reference import diffusion as rd
from benchmark.reference.model import ReferenceDecoder
from benchmark.weights import make_weights
from _tiny import TINY_MODEL

CONF = json.load(open(os.path.join(spec.HERE, "configs", "tcdiff-g3.json")))
M = dict(CONF["model"], **TINY_MODEL)


def _pair():
    from benchmark import program

    w = make_weights(7, M, "cpu")
    ref = ReferenceDecoder(M)
    ref.load_state_dict(w, strict=False)
    model, diffusion = program.build(M, dict(CONF, precision="float32"), 7, "cpu")
    return ref, model, diffusion


def test_forward_kinematics_matches_the_port():
    from tcdiff_torch.geometry.skeleton import smpl_fk_from_6d

    g = torch.Generator().manual_seed(0)
    r6, root = torch.randn(6, 24, 6, generator=g), torch.randn(6, 3, generator=g)
    assert (smpl_fk_from_6d(r6, root) - rd.forward_kinematics(r6, root)).abs().max() < 1e-5


def test_ddim_request_matches_the_port():
    ref, _, diffusion = _pair()
    b, tokens = 3, M["seq_len"] * M["dancer_num"]
    g = torch.Generator().manual_seed(1)
    cond = torch.randn(b, 2 * M["seq_len"] + 1, M["cond_feature_dim"], generator=g)
    x_0 = 0.1 * torch.randn(b, tokens, 3, generator=g)
    out = diffusion.ddim_sample((b, tokens, M["nfeats"]), cond, generator=torch.Generator().manual_seed(9), x_0=x_0)
    g2 = torch.Generator().manual_seed(9)
    x_t = torch.randn((b, tokens, M["nfeats"]), generator=g2)
    want = rd.ddim_sample(ref, CONF["diffusion"], cond, x_0, x_t,
                          lambda i: torch.randn((b, tokens, M["nfeats"]), generator=g2))
    assert (out - want).abs().max() < 2e-4


def test_train_steps_match_the_port():
    from benchmark import program

    ref, model, diffusion = _pair()
    state, step = program.train_step(diffusion, CONF, "cpu")
    g = torch.Generator().manual_seed(2)
    batches = [(0.3 * torch.randn(4, M["dancer_num"], M["seq_len"], M["nfeats"], generator=g),
                torch.randn(4, 2 * M["seq_len"] + 1, M["cond_feature_dim"], generator=g)) for _ in range(3)]
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    gen, losses = torch.Generator().manual_seed(11), []
    for i, (x, c) in enumerate(batches):
        state, m = step(state, x, c, gen)
        losses.append(m["total"].item())
        if i == 0:
            grads = {k: state.optimizer.state[p]["prev_grad"].norm().item() for k, p in model.named_parameters()}
    got = rd.train_steps(ref, M, CONF["diffusion"], CONF["train"], batches, 11, block_rows=3)
    assert max(abs(a - b) / b for a, b in zip(losses, got["loss"])) < 1e-4
    assert max(abs(grads[k] - v) / max(v, 1e-6) for k, v in got["grad_norms"].items()) < 1e-4
    params = dict(ref.named_parameters())
    change = {k: ((p - start[k]).norm().item(), (params[k] - start[k]).norm().item())
              for k, p in model.named_parameters()}
    assert statistics.median(abs(a - b) / b for a, b in change.values()) < 0.01
    assert max((state.ema_params[k] - got["ema"][k]).abs().max().item() for k in params) < 1e-5
