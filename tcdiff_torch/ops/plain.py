"""Test-only entry: run a model's blocks through their plain versions.

The serving and train paths send CUDA tensors to the CUDA kernels. To hold
a whole path against the plain PyTorch versions on the same CUDA tensors,
`plain_blocks(model)` swaps each decoder layer's block functions for the
plain ones inside a `with` block; launches made there do not count.
"""

from __future__ import annotations

import contextlib

from tcdiff_torch.ops.ca_block_train import ca_block_train_plain
from tcdiff_torch.ops.ff_block import ff_tail_plain
from tcdiff_torch.ops.ff_block_train import ff_tail_train_plain
from tcdiff_torch.ops.sa_block import sa_block_plain
from tcdiff_torch.ops.sa_block_train import sa_block_train_plain

_PLAIN = {
    "sa_block_fn": sa_block_plain,
    "ff_tail_fn": ff_tail_plain,
    "sa_train_fn": sa_block_train_plain,
    "ca_train_fn": ca_block_train_plain,
    "ff_train_fn": ff_tail_train_plain,
}


@contextlib.contextmanager
def plain_blocks(model):
    layers = list(model.layers)
    saved = [{name: getattr(layer, name) for name in _PLAIN} for layer in layers]
    try:
        for layer in layers:
            for name, fn in _PLAIN.items():
                setattr(layer, name, fn)
        yield model
    finally:
        for layer, fns in zip(layers, saved):
            for name, fn in fns.items():
                setattr(layer, name, fn)
