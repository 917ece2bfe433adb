"""Test-only entry: run a model's kernels through their plain versions.

The serving and train paths send CUDA tensors to the CUDA kernels. To hold
a whole path against the plain PyTorch versions on the same CUDA tensors,
`plain_blocks(model)` swaps the kernel functions of every submodule that
calls one (decoder layers, their attention modules, the cond encoder's)
for the plain ones inside a `with` block; launches made there do not
count.
"""

from __future__ import annotations

import contextlib

from tcdiff_torch.ops.attention import attention_plain
from tcdiff_torch.ops.ca_block import ca_block_plain, ca_kv_plain
from tcdiff_torch.ops.ca_block_train import ca_block_train_plain
from tcdiff_torch.ops.ff_block import ff_block_plain, ff_tail_plain
from tcdiff_torch.ops.ff_block_train import ff_tail_train_plain
from tcdiff_torch.ops.layer import layer_plain
from tcdiff_torch.ops.layernorm import layernorm_plain
from tcdiff_torch.ops.ln_matmul import ln_matmul_plain
from tcdiff_torch.ops.ln_rotary_matmul import ln_rotary_matmul_plain
from tcdiff_torch.ops.sa_block import sa_block_plain
from tcdiff_torch.ops.sa_block_train import sa_block_train_plain

_PLAIN = {
    "sa_block_fn": sa_block_plain,
    "ff_tail_fn": ff_tail_plain,
    "ff_block_fn": ff_block_plain,
    "ca_block_fn": ca_block_plain,
    "ca_kv_fn": ca_kv_plain,
    "layer_fn": layer_plain,
    "ln_matmul_fn": ln_matmul_plain,
    "ln_rotary_fn": ln_rotary_matmul_plain,
    "layernorm_fn": layernorm_plain,
    "attention_fn": attention_plain,
    "sa_train_fn": sa_block_train_plain,
    "ca_train_fn": ca_block_train_plain,
    "ff_train_fn": ff_tail_train_plain,
}


@contextlib.contextmanager
def plain_blocks(model):
    saved = [(m, name, getattr(m, name)) for m in model.modules() for name in _PLAIN if hasattr(m, name)]
    try:
        for m, name, _ in saved:
            setattr(m, name, _PLAIN[name])
        yield model
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
