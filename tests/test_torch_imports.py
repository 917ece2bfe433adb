"""A static scan of the port: no JAX, flax or optax, and nothing of
tcdiff_tpu, not even its numpy-only modules (the machine with the GPU has
no JAX, and importing any module of tcdiff_tpu runs its package's
__init__)."""

import ast
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parent.parent / "tcdiff_torch"
ENTRY = Path(__file__).resolve().parent.parent / "chip_smoke.py"


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    return sorted(PORT.rglob("*.py")) + [ENTRY]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_and_only_numpy_modules_of_tcdiff_tpu(path):
    for mod in _imports(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "optax", "tcdiff_tpu"), f"{path}: imports {mod}"


def test_scan_sees_the_port():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"models/dance_decoder.py", "ops/sa_block.py", "ops/ff_block.py",
            "diffusion/gaussian.py", "ops/sa_block_train.py", "ops/ca_block_train.py",
            "ops/ff_block_train.py", "train/train_step.py", "optim/adan.py",
            "geometry/skeleton.py", "config.py", "ops/attention.py", "ops/layernorm.py", "ops/ln_matmul.py",
            "ops/ln_rotary_matmul.py", "diffusion/masks.py", "ops/ca_block.py", "ops/layer.py",
            "data/audio.py", "data/features.py", "data/normalizer.py", "trajdecoder/model.py",
            "trajdecoder/rollout.py", "trajdecoder/kalman.py", "trajdecoder/postprocess.py",
            "trajdecoder/streaming.py", "interop/from_jax.py", "train/orchestrator.py",
            "utils/logging.py", "utils/profiling.py", "utils/paths.py", "utils/checkpoint.py",
            "geometry/rotations.py", "data/dataset.py", "data/synthetic.py", "data/create_dataset.py",
            "data/native_loader.py", "trajdecoder/dataset.py", "trajdecoder/trainer.py",
            "cli/train_traj.py", "eval/geometric.py", "eval/metrics.py", "viz/render.py", "viz/traj_render.py",
            "viz/postprocess.py", "export/split_pkl.py", "export/bvh.py", "export/fbx_export.py",
            "export/blender_launch.py", "cli/args.py", "cli/train.py"} <= names
