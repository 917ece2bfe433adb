"""Adan (Adaptive Nesterov Momentum) as a torch optimizer.

PyTorch counterpart of `tcdiff_tpu/optim/adan.py`, with the reference's
quirks:

  * on the first step the moment buffers stay zero, so the only effect is
    the weight-decay shrink `p /= (1 + wd * lr)`;
  * bias corrections use the post-increment step count;
  * decoupled weight decay is a division after the gradient step.

A parameter without a gradient is updated as with a zero gradient (the JAX
package's gradient tree holds zeros there), so it still decays. The update
runs over all parameters of a group at once with `torch._foreach_*`.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


class Adan(torch.optim.Optimizer):
    def __init__(self, params: Iterable, lr: float, betas: Tuple[float, float, float] = (0.02, 0.08, 0.01),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adan.step takes no closure")
        for group in self.param_groups:
            ps = group["params"]
            if not ps:
                continue
            lr, (b1, b2, b3), eps, wd = group["lr"], group["betas"], group["eps"], group["weight_decay"]
            for p in ps:
                if not self.state[p]:
                    self.state[p] = {k: torch.zeros_like(p) for k in ("m", "v", "n", "prev_grad")}
            m, v, n, pg = ([self.state[p][k] for p in ps] for k in ("m", "v", "n", "prev_grad"))
            g = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
            count = group.get("step", 0)
            if count > 0:  # the moments stay zero on the first step
                diff = torch._foreach_sub(g, pg)
                torch._foreach_mul_(m, 1 - b1)
                torch._foreach_add_(m, g, alpha=b1)
                torch._foreach_mul_(v, 1 - b2)
                torch._foreach_add_(v, diff, alpha=b2)
                nt = torch._foreach_add(g, diff, alpha=1 - b2)
                torch._foreach_mul_(nt, nt)
                torch._foreach_mul_(n, 1 - b3)
                torch._foreach_add_(n, nt, alpha=b3)
            count += 1
            group["step"] = count
            cm, cv, cn = (1.0 / (1.0 - (1.0 - b) ** count) for b in (b1, b2, b3))
            # new_p = (p - lr * (m*cm + (1-b2)*v*cv) / (sqrt(n*cn) + eps)) / (1 + wd*lr)
            denom = torch._foreach_mul(n, cn)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_mul(m, cm)
            torch._foreach_add_(upd, v, alpha=(1 - b2) * cv)
            torch._foreach_div_(upd, denom)
            new_p = torch._foreach_add(ps, upd, alpha=-lr)
            torch._foreach_div_(new_p, 1.0 + wd * lr)
            torch._foreach_copy_(ps, new_p)
            torch._foreach_copy_(pg, g)
