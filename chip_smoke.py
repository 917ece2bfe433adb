"""Drive the PyTorch port (tcdiff_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each printed as it runs; any failure exits non-zero before the
last line:
  1. the card's name and power limit (nvidia-smi); no card -> exit 2;
  2. build the CUDA kernels from tcdiff_torch/csrc, one nvcc per source,
     all at once;
  3. hold each serving kernel (K1, K2) against its plain PyTorch version
     at the serving shapes (b=8 doubled CFG batch, L=450, d=512), in bf16
     and f32, and time both; count the launches of one bf16 K1 call and
     one K2 call under torch.profiler (4 each: K1's q/k/v projections are
     one grouped launch; the LayerNorm after K1's fc and after K2's W2 runs
     in that product's epilogue, so each makes one row-kernel launch);
     then K1's and K2's products alone through the projection's entry
     point (ops/gemm.py), bf16: q/k/v grouped 3600x1536x512, fc
     3600x512x512, W1 3600x1024x512, W2 3600x512x1024, W3 3600x512x512,
     each held against its plain version, its device time and TFLOP/s
     beside its bound and torch.matmul's time (a yardstick only); then the
     wgmma + TMA body (ops/gemm.gemm_wg) at K8's, K2b's and K9's
     products: K8's q||k||v (3 x 3600x512x512 in one launch) and
     3600x512x512, K2b's W1 3600x1024x512 (bias+GELU) and W2
     3600x512x1024 (bias), K9's linear1 3600x1024x512 and linear3
     3600x512x512 (the product rounded before the bias), each against its
     plain version, its device time and TFLOP/s beside its bound,
     mma.sync's and torch.matmul's time, its grid and waves, and the plans
     at N = 512, 1024 and 1536;
  4. the same for the per-op kernels K8 (both forms), K9, K10 and K11
     (450x450 self-attention with and without TRPE, 450x152
     cross-attention, the cond encoder's 150x150), with the one PyTorch
     call that computes the same function where there is one (F.layer_norm
     for K10, F.scaled_dot_product_attention for K11 without TRPE); then
     K10's row body alone at 3600x512 in bf16, with an f32 input, and at
     the train's 28800 rows: device time beside F.layer_norm's, GB/s and
     the share of the bound, and the body templated on d=512 by name;
     then (4c) the attention's two bf16 bodies at the main path's calls:
     K1's at 256 and 128 rows x 8 heads at 450x450, the train forward at
     256 rows, 600x600 and 600x152, dropout 0.1 and 0, each on the body
     the rule picks and on mma.sync (q one element off a 16-byte
     boundary), each held against the plain version (the train forward's
     lse too, and its dropout mask bit for bit), device ms beside the
     bound, each call's launches on the body attention_plan names;
  5. the same for the block kernels K2b and K7 (each with and without the
     FiLM rows) and K6 (with and without its FF section), Lm=152; K6's
     bf16 device time, and one call under torch.profiler: 10 device
     kernels with the FF section (7 without), one LayerNorm row kernel,
     the folds of the LayerNorms into the fc and W2 epilogues by name;
     then K8 (weights apart and joined, the rot-only form), K2b (with and
     without FiLM) and K9 (linear1 and linear3) alone in bf16 (the row
     kernel, then the products on the wgmma body): each against its plain
     version, its device time, one call's device kernels by name (K8 and
     K9: 2, K2b: 3, no mma.sync and no PyTorch kernel), and the host us a
     call spends on tensor maps;
  5b. K7 over the hoisted k/v (ops/ca_block.ca_kv, the default's
     cross-attention site) at b = 8 and at the benchmark's 256 rows (L =
     450, 150 music + 2 time rows read apart, d = 512) against its plain
     version in bf16 and f32; in bf16 its device time beside its bound,
     the plain site's (PyTorch's kernels over the joined k/v) and K7 over a
     152-row memory's, and one call's 3 device kernels, none named attn_*;
  6. hold each train kernel (K3, K4, K5) against its plain version at the
     main path's train shapes (b=64, L=450, Lm=152, d=512), in bf16 and
     f32, dropout 0.1 with the same seeds: the output and every gradient
     under one cotangent; time the forward and forward+backward of both;
     then the train attention alone (K3's 450x450, K4's 450x152), bf16,
     forward + backward against the plain chain, its backward twice bit for
     bit, timed beside F.scaled_dot_product_attention (a yardstick only);
     then K5's and K3's backward products alone at M = b L = 28800 through
     ops/gemm.py, bf16: the input gradients dy4, dad, dy, dO, dr (the
     joined form), dyv and the weight gradients dW3, dW2, dW1, dWfc, dWq,
     dWk, dWv, each held against its plain version, its device time (the
     ordered reduction included, and the reduction's own from
     torch.profiler) and TFLOP/s beside its bound and torch.matmul's time
     (a yardstick only); each weight gradient twice, bit for bit;
     then the bodies K4 and K7 were redesigned around, alone (ops/
     train_common.py, ops/gemm.py): the three train row kernels at 28800
     rows of 512, rate 0.1 (device time alone from torch.profiler, GB/s,
     share of the byte bound), K4's memory cotangent dmem = rot_m^T(dk.Wk)
     + dv.Wv and K7's q = rot(LN(x)).Wq beside torch.matmul of the same
     products; then one bf16 K4 fwd+bwd call under torch.profiler, listed
     by device kernel (7 launches forward, 20 backward; no memory-side
     rows_bwd or rot_rows), the attention's share at rate 0.1 and 0 and its
     kernels' registers (cuobjdump), and one bf16 K7 call with FiLM rows
     (4 device kernels, no PyTorch kernel);
  7. serve 3 requests (batch 4 each: 3 dancers x 5 s of motion) through
     GaussianDiffusion.ddim_sample on a full-width bf16 DanceDecoder with
     seeded random weights, check the outputs and the kernels' launch
     counts; profile one more request (its bf16 projections must be the
     tensor-core kernel, never the FMA body); time the FiLM residual
     outside and inside K1 in turns; run one request in f32 through the kernels and
     through the plain versions on the same noise and compare; hold one
     bf16 CFG denoiser forward against the plain versions;
  8. the per-op serving configuration (ServingKernels.per_op: K8-K11 on,
     K1/K2 off): one long_ddim_sample request over 4 slices of one song
     after a warm-up, with the launch counts of K8-K11 and the count of
     K8's and K9's products on each body (all on wgmma); then f32 requests
     through the kernels and the plain versions on the same noise: one with
     a trj_dist (K11's TRPE form), one with the k/v cache off (K8's
     rot-only form);
  9. the other samplers once each in the default configuration:
     ddim_sample_footwork, ddim_sample_stream over two slices,
     ddim_sample(forecast_every=2) with its K1/K2 launch counts, and
     partial_denoise (the DDPM loop) from t=100;
 10. generate: wav to dance through tcdiff_torch.train.orchestrator.generate
     on a seeded 20 s song (clicks on a 120 BPM grid over noise) at full
     width: the bf16 denoiser in the default configuration (K1/K7/K2), the
     DBN (TrajDecoder) and a normalizer fit on seeded data, all with seeded
     random weights; 7 slices, 20 DBN windows, a 600-frame trajectory. Each
     stage's time (features, DBN rollout, Kalman, sampling) and s-motion/s;
     the output checked, K1, K7 over the hoisted k/v and K2 each launched
     8 x 50 times and no other serving kernel; the request from its features once more under
     torch.profiler; the DBN on the card against the same DBN on the CPU
     with the TF32 flags at PyTorch's defaults (one window, then the rollout
     and the Kalman filter, the error printed window by window), and one
     window with TF32 on, which must not change its bits; an f32 request
     through the kernels against the plain versions on the same noise; then
     generate_streaming over the song's first 3 slices (the time at which
     each slice is ready), whose trajectory must equal the full rollout's
     first frames;
 11. the block kernels' configurations (layer_fuse with and without its FF
     section: K6; ff_tail off, with fuse_film and with ln_matmul: K2b; the
     k/v cache off with ca_block: K7): one bf16 ddim_sample request of
     batch 4 each with its launch counts (K2b's products, and K9's with
     ln_matmul, counted by body: all on wgmma), the layer_fuse and
     ff_tail-off requests once more
     under torch.profiler, K7 with the operands the ca_block request gives
     it (4 device kernels, no PyTorch kernel), and an f32 request through
     the kernels and the plain versions on the same noise;
 12. train: 1 warm-up and 3 timed steps (loss, backward, Adan, EMA) of the
     full-width bf16 DanceDecoder at batch 64, dropout 0.1, on seeded
     synthetic motion and music; check a finite loss, finite parameters
     and the train kernels' launch counts (8 layers x 4 steps, forward and
     backward); profile one more step (no bf16 product may run on the FMA
     body, gemm_kernel); then two f32 steps at batch 4 through the kernels
     and two through the plain versions on the same weights and draws: each step's
     loss and gradients, and the parameters after the second Adan step;
 12b. the JAX package's opt-in configurations: two bf16 train steps at
     batch 64 without and with remat from one state and generator seed
     (losses and parameters bit for bit, else within grad_tolerance and
     the f32 check's parameter rule; peak memory and step times of both;
     K3-K5's forward launched twice a layer and step under remat); one f32
     loss and backward at batch 8 with a trj_dist (TRPE: the
     self-attention block in plain math, K4/K5 on the card) against the
     port on the CPU, at test_torch_train.py's whole-step 3e-4 rule; the int8 product
     (torch._int_mm) at 3600x512 -> 512 and -> 1024 against the plain
     int32 product, equal; one bf16 request each of the default, the
     default with ca_block off, ServingKernels(int8=True) (relative error
     against the default with ca_block off in (0, 0.05), 3200 int8
     products, no block kernel) and ln_bf16 (its
     largest difference, and one LayerNorm site against the CPU within
     2^-5 of its largest output), on one injected noise, with their wall
     times;
 13. data: training from the data on disk. A seeded raw AIOZ-GDance tree
     (3 dancers, four 20 s train songs and one 10 s test song, Y-up motion
     at 30 fps, wavs at the feature rate) in a temporary directory, through
     create_dataset (124 + 11 slices, feats438 on the host, a spawned pool);
     AIOZDataset built on the card and on the CPU, train and test: the
     packed channels and the normalized poses card vs CPU within 1e-5 (in
     the data's units), the contacts equal off a 1e-5 band about the 0.01
     threshold (the flips counted), the npz cache bit for bit; the DBN
     trained from the TrajDataset by TrajTrainer (full width, 8 iterations,
     the batch clamped to the 124 slices, one checkpoint and one eval
     rollout at the end; ms per iteration, finite losses), its checkpoint
     reloaded by load_reference_traj giving the trained network's window
     bit for bit, one dropout-0 step card vs CPU (losses 1e-5 relative,
     gradients 1e-4 of each tensor's largest); then the denoiser's
     train_loop (bf16, full width, batch 64, 2 epochs of one step) over the
     AIOZDataset through the native prefetcher (a numpy fallback fails),
     K3/K4/K5 launched 8 x steps times each way, finite loss and
     parameters, its checkpoint restored bit for bit (parameters, EMA, Adan
     moments, step), steps/s with the host IO, and one step (its batch read
     by the prefetcher) under torch.profiler for the device's idle share;
 14. the CLI: `tcdiff_torch.cli.train.main` in its five modes on the data
     phase's raw tree, processed cache and DBN checkpoint, at full width
     (3 dancers, 8 layers, d=512) in bf16: `--mode train` (batch 64, one
     epoch: one step, its checkpoint, the train-time render's sampling
     of 2 clips with --no_render), `--mode eval --traj_source both` from
     that checkpoint over the 11 test slices (eval.json printed, every
     value finite, the gt and dbn sets different), `--mode test` with
     --vis_fk_out (11 FK pkls; one split into per-dancer pkls and
     exported to BVH, their shapes checked), `--mode
     val_without_TrajModel --sample_mode long` (the 11 slices stitched on
     the card), `--mode generate` on a seeded 10 s song (3 slices); K1,
     K7 over the hoisted k/v and K2 400 launches a sampling call and no
     other serving kernel,
     K3/K4/K5 8 each way in the train step; the test clips' metrics
     (`evaluate`) and stitch card vs CPU; each mode's wall time;
 15. data parallelism (`tcdiff_torch.parallel`): the one-process
     references first, then two ranks spawned on the one card over gloo
     (chosen and printed: NCCL refuses two ranks on one device), full
     width: two train steps at global batch 64 in bf16 and 8 in f32 (32
     and 4 a rank, K3-K5 16 each way a rank), `long_ddim_sample_sharded`
     of 8 slices (4 a rank, 50 steps, injected noise, bf16 and f32), the
     normal-mode `TCDiff._sample` of 8 clips and two DBN iterations; each
     rank holds its results against one process (the loss and step-1
     gradients to `grad_tolerance`, the parameters after step 1 to
     `tolerance`, after step 2 the two-step rule; the samples to
     `tolerance` in bf16 and F32_PATH_TOL in f32; the DBN to the data
     phase's DBN rule), prints its launch counts (K1/K7/K2 400 a sampling call), and
     every rank's parameters and EMA must be bit-identical; then `python
     -m torch.distributed.run --standalone --nproc_per_node 1 -m
     tcdiff_torch.cli.train --dp 1` with the CLI phase's train flags over
     NCCL, whose checkpoint must equal the CLI phase's bit for bit and
     whose log must show its gradient all-reduce and metric mean issued
     over NCCL;
 17. tensor parallelism (`tcdiff_torch.parallel.sharding_rules`): the
     ranks of a (1, 2) and of a (2, 2) mesh spawned on the one card over
     gloo; one process computes the references on the plain train path
     (`plain_blocks`, the arithmetic the tp layers split) and the spread
     of bf16 between its kernel path and that plain path; then the (1, 2)
     ranks run two train steps at full width, dropout 0.1, in bf16 at
     global batch 16 and in f32 at 8, and `TCDiff._sample` of 4 clips at
     tp = 2, and decoder layer 0 with final_layer forward and backward in
     bf16 and f32 (`tp_layer`); then the (2, 2) ranks two f32 steps at 8.
     Each rank holds its steps against one process (in f32 the dp phase's
     rules, the cond encoder's key biases aside at step 2; in bf16 the loss
     and the step-1 parameters at the dp rules, the gradients read tensor
     by tensor beside one process's own kernel-vs-plain spread), the layer's
     output and every gradient within 2e-2 (bf16) or 1e-5 (f32) of its
     norm, a rule that a zeroed or sign-flipped gradient must fail, its
     parameters to exactly the JAX rule's 30,815,537 of
     61,428,181, K3-K5 to 0 launches, the tp sample to one process's bits
     with K1/K7/K2 400 launches; every rank's whole state bit-identical; the
     step wall ms of each rank beside one process's, the peak memory and
     the phase's seconds are printed;
 18. a line of JSON with every kernel's figures (K1/K7/K2's launches count
     the CLI phase's, both dp ranks', the opt-in phase's and both tp
     ranks' sampling, K3-K5's the train phase's, the opt-in phase's, the
     train loop's, the CLI's and both dp ranks'), the card's line, and the
     last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tcdiff_torch import (
    DanceDecoderConfig, DiffusionConfig, ServingKernels, TCDiffConfig, TrainConfig, TrajDecoderConfig,
)
from tcdiff_torch.data import dataset as data_ds
from tcdiff_torch.data.audio import save_wav
from tcdiff_torch.data.create_dataset import create_dataset
from tcdiff_torch.data.features import SR
from tcdiff_torch.data.native_loader import PrefetchingBatches
from tcdiff_torch.data.normalizer import Normalizer
from tcdiff_torch.data.synthetic import synthetic_motion
from tcdiff_torch.interop.from_jax import load_reference_traj
from tcdiff_torch.cli import train as cli_train
from tcdiff_torch.diffusion.gaussian import GaussianDiffusion
from tcdiff_torch.eval import geometric as eval_geometric
from tcdiff_torch.eval import metrics as eval_metrics
from tcdiff_torch.export.bvh import pkl_to_bvh
from tcdiff_torch.export.split_pkl import split_pkl_file
from tcdiff_torch.models.dance_decoder import DanceDecoder, _lin, _ln
from tcdiff_torch.models.rotary import angle_table, apply_rotary
from tcdiff_torch.ops import (
    _build, attention, ca_block, ca_block_train, ff_block, ff_block_train, gemm, int8, layer, layernorm, ln_matmul,
    ln_rotary_matmul, sa_block, sa_block_train,
)
from tcdiff_torch.ops.plain import plain_blocks
from tcdiff_torch.ops import train_common
from tcdiff_torch.ops._common import ln_f32, mm_f32
from tcdiff_torch.ops.train_common import weight_splits
from tcdiff_torch.optim.adan import Adan
from tcdiff_torch.parallel import all_gather_rows, init_distributed, make_mesh, shard_batch
from tcdiff_torch.parallel import comm as tp_comm
from tcdiff_torch.parallel.sharding_rules import shard_train_state, whole_tensor
from tcdiff_torch.train import orchestrator
from tcdiff_torch.train.state import create_train_state
from tcdiff_torch.train.train_step import make_train_step
from tcdiff_torch.trajdecoder import TrajDecoder, autoregressive_rollout, kalman_smooth_batch
from tcdiff_torch.trajdecoder.dataset import SyntheticTrajDataset, TrajDataset
from tcdiff_torch.trajdecoder.trainer import TrajTrainer, make_traj_optimizer, make_traj_train_step
from tcdiff_torch.utils.checkpoint import restore_train_state
from tcdiff_torch.viz import postprocess as viz_post

B, L, D, H, FF = 8, 450, 512, 8, 1024  # serving shapes: CFG-doubled batch of 4
HD = H * 64
LM = 152  # cross-attention memory: 150 music rows + 2 time tokens
REQUESTS, REQ_BATCH, CLIP_S = 3, 4, 5.0
# the serving kernels of the default configuration, each 8 layers x 50
# steps a sampling call: K1, K7 over the hoisted k/v (counted as K7) and K2
DEFAULT_SITES = ("sa_block", "ca_block", "ff_tail")
F32_PATH_TOL = 1e-3  # f32 whole 50-step path, kernels vs plain (sums in another order)
SONG_S, SONG_SLICES, SONG_WINDOWS, SONG_FRAMES = 20.0, 7, 20, 600  # the generate phase's song
DBN_WINDOW_TOL = 1e-5  # one DBN window, card vs CPU, share of its largest output
DBN_ROLLOUT_TOL = 1e-4  # the rollout and the Kalman filter, card vs CPU, share of the largest value
TRAIN_BATCH, TRAIN_STEPS = 64, 3  # bench.py's train default; + 1 warm-up step
F32_STEP_BATCH = 4
REMAT_STEPS = 2  # the opt-in phase: bf16 train steps at TRAIN_BATCH with and without remat
TRPE_BATCH = 8  # the opt-in phase's f32 TRPE loss and backward, card vs CPU
# tests/test_torch_train.py's whole-step f32 rule. Its 3e-5 for one small
# layer does not hold at full width: the card's and the CPU's f32 sums in
# other orders put cond_projection.0's gradient (a sum over 1200 music
# tokens of 876-wide rows) 4.1e-5 of its scale apart
TRAIN_F32_TOL = 3e-4
INT8_REL_BOUND = 0.05  # tests/test_int8.py's model-level bound on int8 against exact
# the data phase: a raw AIOZ tree of 3 dancers, 4 train songs of 20 s and
# one test song of 10 s (31 slices a train song, 11 test)
DATA_TRAIN_S, DATA_TEST_S, DATA_TRAIN_SONGS = 20.0, 10.0, 4
DATA_SLICES = (4 * 31, 11)
DATA_TOL = 1e-5  # the packed channels, card vs CPU; and the normalized ones in the data's units
DBN_ITERS = DBN_PRINT = 8  # one checkpoint and one eval rollout, at the last iteration
LOOP_BATCH, LOOP_EPOCHS = 64, 2  # 124 slices: one batch of 64 an epoch
CLI_SONG_S = 10.0  # the CLI phase's generate: 3 slices
RATE = 0.1  # the config's dropout
LC = 150  # cond encoder tokens: 301 music frames packed in pairs
KERNELS = ("sa_block", "ff_tail", "ff_block", "ca_block", "layer", "ln_rotary_matmul", "ln_matmul", "layernorm",
           "attention", "sa_block_train", "ca_block_train", "ff_tail_train")
BUILD = KERNELS + ("gemm", "train_rows")  # and the entry points of the products and the train row kernels alone
SERVING_OPS = {  # the per-op kernels' wrappers, by kernel name
    "ln_rotary_matmul": ln_rotary_matmul.ln_rotary_matmul, "ln_matmul": ln_matmul.ln_matmul,
    "layernorm": layernorm.layernorm, "attention": attention.attention,
}
SERVING_BLOCKS = {  # the block kernels' wrappers, by kernel name
    "sa_block": sa_block.sa_block, "ff_tail": ff_block.ff_tail, "ff_block": ff_block.ff_block,
    "ca_block": ca_block.ca_block, "layer": layer.layer,
}
WG_LIBS = {"ff_block": "K2b", "ln_rotary_matmul": "K8", "ln_matmul": "K9"}  # the kernels on the wgmma body
REPLACES = {
    "sa_block": "tcdiff_tpu/ops/fused_sa_block.py:75",
    "ff_tail": "tcdiff_tpu/ops/fused_ff_block.py:88",
    "ff_block": "tcdiff_tpu/ops/fused_ff_block.py:67",
    "ca_block": "tcdiff_tpu/ops/fused_ca_block.py:41",
    "layer": "tcdiff_tpu/ops/fused_layer.py:78",
    "ln_rotary_matmul": "tcdiff_tpu/ops/fused_ln_rotary_matmul.py:55",
    "ln_matmul": "tcdiff_tpu/ops/fused_ln_matmul.py:30",
    "layernorm": "tcdiff_tpu/ops/fused_layernorm.py:26",
    "attention": "tcdiff_tpu/ops/fused_attention.py:38",
    "sa_block_train": "tcdiff_tpu/ops/fused_sa_block_train.py:474",
    "ca_block_train": "tcdiff_tpu/ops/fused_ca_block_train.py:244",
    "ff_tail_train": "tcdiff_tpu/ops/fused_ff_block_train.py:261",
}
# H100 SXM data-sheet peaks at 700 W: dense bf16 tensor cores, f32 outside
# the tensor cores, HBM3
PEAK_BF16, PEAK_F32, HBM_RATE = 989e12, 67e12, 3.35e12


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def tolerance(dtype, ref: torch.Tensor) -> float:
    """f32: 1e-4 of the output scale (the sums run in another order).
    bf16: 4 bf16 ulps of the largest output (2^-5 of it): q/k/v, the
    attention weights and the outputs are each rounded to bf16, and a
    rounding that lands on the other side moves an output by an ulp."""
    scale = max(1.0, ref.abs().max().item())
    return (2.0**-5 if dtype == torch.bfloat16 else 1e-4) * scale


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of fn() in ms, from CUDA events around each call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 50) -> float:
    """Device time of one fn() in ms: reps calls queued behind a spin
    kernel, so that the device runs them back to back, between two CUDA
    events; the spin doubles until it outlasts the host's enqueueing."""
    fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()  # the spin still ran when the last call was queued
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        check(cycles < 2**31, "device_ms: the host never got ahead of the device")
        cycles *= 2


def grad_tolerance(dtype, ref: torch.Tensor) -> float:
    """A gradient: f32 1e-4 of its largest value (sums in another order);
    bf16 2^-4 of it, since the plain version's autograd rounds dP, dO and
    the weight-gradient operands to bf16 at other points than the kernels."""
    scale = max(ref.abs().max().item(), 1e-6)
    return (2.0**-4 if dtype == torch.bfloat16 else 1e-4) * scale


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16) -> dict:
    """The least time the card could take: the larger of the time of the
    work at `peak` (the bf16 tensor cores unless given) and the HBM time of
    reading each input and writing each output once."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return dict(bound_ms=1e3 * max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


LEAD_SPINS = 32  # short spin kernels ahead of each profiled call (device_kernels)


def device_kernels(fn, accept=None, attempts: int = 3):
    """Run fn() once under torch.profiler. Returns the wall seconds and the
    device kernels it ran, [(name without arguments, start us, end us)] in
    order of start. On the card a session drops its first device events:
    now and then one early in a process, several in every session late in
    a long one (K7's check then read no kernel of its call ten times in a
    row). So each session starts with a pause and LEAD_SPINS short spin
    kernels, which take that loss and are left out of the reading. Where a
    reading still holds no device events, or `accept(kernels)` does not
    hold, fn() runs again, after a pause that grows from 0.1 s to 1 s,
    `attempts` times at most, each rejected reading noted on stderr; the
    last reading is returned either way, for the caller's check to judge."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    last = None
    for attempt in range(attempts):
        if attempt:
            torch.cuda.synchronize()
            time.sleep(min(1.0, 0.1 * 2 ** (attempt - 1)))
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(0.01)
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(10_000)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = sorted(((re.sub(r"\(.*\)$", "", e.name.replace("void ", "")).replace("__nv_bfloat16", "bf16"),
                           e.time_range.start, e.time_range.end) for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name
                          and not getattr(e, "is_user_annotation", False) and "#" not in e.name),
                         key=lambda k: k[1])
        if kernels:
            last = wall, kernels
            if accept is None or accept(kernels):
                break
        print(f"device_kernels: reading {attempt + 1} of {attempts} held {len(kernels)} device kernels; "
              f"{'reading again' if attempt + 1 < attempts else 'no more readings'}", file=sys.stderr)
    if last is None:
        raise SmokeFailure("the profiler saw no device events")
    return last


def device_profile(fn):
    """Run fn() once under torch.profiler. Returns the wall seconds, the
    device's busy seconds (the union of kernel intervals) and [(kernel
    name without arguments, ms, calls)], the most time first."""
    wall, kernels = device_kernels(fn)
    busy, (_, cur_s, cur_e) = 0.0, kernels[0]
    for _, s0, e0 in kernels[1:]:
        if s0 > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy = (busy + cur_e - cur_s) / 1e6
    by = collections.defaultdict(lambda: [0.0, 0])
    for name, s0, e0 in kernels:
        by[name][0] += (e0 - s0) / 1e3
        by[name][1] += 1
    return wall, busy, sorted(((k, ms, n) for k, (ms, n) in by.items()), key=lambda r: -r[1])


def our_kernels(fn, expect: int) -> dict:
    """{name: calls} of the hand-written kernels (namespace tcd) that one
    fn() runs, from torch.profiler (profiled again, three times at most,
    while a reading holds other than `expect` of them)."""
    _, kernels = device_kernels(fn, accept=lambda ks: sum("tcd::" in n for n, _, _ in ks) == expect)
    return dict(collections.Counter(n for n, _, _ in kernels if "tcd::" in n))


def calls(kernels: dict, part: str) -> int:
    """The calls of the kernels whose name holds `part`."""
    return sum(c for n, c in kernels.items() if part in n)


def print_profile(label: str, fn) -> None:
    """Profile fn() (one request) and print its device busy time, idle
    share and the 12 largest kernels by device time; return the table of
    device_profile."""
    wall, busy, table = device_profile(fn)
    total = sum(ms for _, ms, _ in table)
    print(f"{label} under torch.profiler: {wall:.3f} s wall, device busy {busy:.3f} s (idle share "
          f"{1 - busy / wall:.3f}), kernel time {total / 1e3:.3f} s; by kernel (ms, calls, share of kernel time):")
    for name, ms, calls in table[:12]:
        print(f"  {name[:100]}: {ms:.1f} ms, {calls}, {ms / total:.3f}")
    return table


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def compare_kernels(gen: torch.Generator) -> dict:
    """Phase 3. Returns the main-path (bf16) figures of each kernel."""
    dev = "cuda"
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    ln = lambda: (1.0 + rnd(D, std=0.1), rnd(D, std=0.1))
    angles = angle_table(L, D, dev)
    dist = torch.randint(0, 10, (B, L, L), generator=gen, device=dev, dtype=torch.int32)
    figures = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        x = rnd(B, L, D).to(dtype)
        w = lambda o, i: rnd(o, i, std=i**-0.5).to(dtype)
        s1, b1 = ln()
        s2, b2 = ln()
        wq, wk, wv, wfc = w(H * 64, D), w(H * 64, D), w(H * 64, D), w(D, H * 64)
        table = rnd(10, H * 64).to(dtype)
        fs, fb = rnd(B, D, std=0.1).to(dtype), rnd(B, D, std=0.1).to(dtype)
        for film in (False, True):
            for trpe in (False, True):
                args = (x, s1, b1, angles, wq, wk, wv, wfc, s2, b2,
                        table if trpe else None, dist if trpe else None,
                        fs if film else None, fb if film else None)
                out = sa_block.sa_block(*args, nhead=H)
                ref = sa_block.sa_block_plain(*args, nhead=H)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                tol = tolerance(dtype, ref)
                ms = time_ms(lambda: sa_block.sa_block(*args, nhead=H))
                plain_ms = time_ms(lambda: sa_block.sa_block_plain(*args, nhead=H))
                print(f"K1 sa_block {name} film={film} trpe={trpe}: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
                check(torch.isfinite(out).all().item(), "K1 output not finite")
                check(err <= tol, f"K1 {name} film={film} trpe={trpe} disagrees: {err} > {tol}")
                if dtype == torch.bfloat16 and film and not trpe:  # the serving variant
                    flops = 8 * B * L * D * HD + 4 * B * L * L * HD
                    dev_ms = device_ms(lambda: sa_block.sa_block(*args, nhead=H))
                    ours = our_kernels(lambda: sa_block.sa_block(*args, nhead=H), 4)
                    n_launch = sum(ours.values())
                    print(f"K1 sa_block bf16 film=True: device {dev_ms:.4f} ms a call (calls queued back to "
                          f"back), {flops / dev_ms / 1e9:.1f} TFLOP/s; {n_launch} launches a call: {ours}")
                    check(n_launch == 4, f"K1 made {n_launch} launches, expected 4")
                    check(calls(ours, "gemm_wg_kernel") == 1 and calls(ours, "gemm_wg_ln_kernel") == 1,
                          "K1's projections are not the grouped q/k/v launch and fc with its LayerNorm fold, "
                          "both on the wgmma body")
                    check(calls(ours, "ln_rows_kernel") == 1, "K1 launches a row kernel after its fc")
                    figures["sa_block"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                               **bound(flops, nbytes(*args, out)), library_ms=None,
                                               device_ms=dev_ms, launches_per_call=n_launch)

        s3, b3 = ln()
        s4, b4 = ln()
        w1, w2, w3 = w(FF, D), w(D, FF), w(D, D)
        bb1, bb2, bb3 = rnd(FF, std=0.1), rnd(D, std=0.1), rnd(D, std=0.1)
        args = (x, s3, b3, w1, bb1, w2, bb2, fs, fb, s4, b4, w3, bb3)
        out = ff_block.ff_tail(*args)
        ref = ff_block.ff_tail_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tolerance(dtype, ref)
        ms = time_ms(lambda: ff_block.ff_tail(*args))
        plain_ms = time_ms(lambda: ff_block.ff_tail_plain(*args))
        print(f"K2 ff_tail {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        check(torch.isfinite(out).all().item(), "K2 output not finite")
        check(err <= tol, f"K2 {name} disagrees: {err} > {tol}")
        if dtype == torch.bfloat16:
            flops = 4 * B * L * D * FF + 2 * B * L * D * D
            dev_ms = device_ms(lambda: ff_block.ff_tail(*args))
            ours = our_kernels(lambda: ff_block.ff_tail(*args), 4)
            print(f"K2 ff_tail bf16: device {dev_ms:.4f} ms a call (calls queued back to back), "
                  f"{flops / dev_ms / 1e9:.1f} TFLOP/s; {sum(ours.values())} launches a call: {ours}")
            check(sum(ours.values()) == 4 and calls(ours, "gemm_wg_ln_kernel") == 1
                  and calls(ours, "gemm_wg_kernel") == 2,
                  "K2 is not LN3, W1, W2 with its LayerNorm fold and W3, on the wgmma body")
            check(calls(ours, "ln_rows_kernel") == 1, "K2 launches a row kernel after its W2")
            figures["ff_tail"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      **bound(flops, nbytes(*args, out)), library_ms=None, device_ms=dev_ms)
    return figures


CELL_ROWS = 256 * L  # the benchmark cell sample.g3.b128: 128 clips under CFG, 450 tokens each


def compare_gemms(gen: torch.Generator) -> dict:
    """Phase 3b: K1's and K2's products alone at the rows of the benchmark
    cell sample.g3.b128 (M = 256 x 450 = 115,200, d=512, ff=1024), bf16,
    each on the body the blocks run it on (ops/gemm.gemm_wg and, for the
    LayerNorm folds, gemm_ln_wg: the wgmma body by its rule) and on the
    mma.sync body it replaced (ops/gemm.gemm, gemm_ln): each held against
    its plain version; the body the per-body counts show; its device time
    (calls queued back to back) and TFLOP/s beside mma.sync's, its bound
    and torch.matmul's time on the same operands (the product alone, a
    yardstick only). Returns {kernel: {product: figures}}."""
    dev, M = "cuda", CELL_ROWS
    bf16 = torch.bfloat16
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    w = lambda o, i: rnd(o, i, std=i**-0.5).to(bf16)
    r, y, o, y3, y4 = (rnd(M, D).to(bf16) for _ in range(5))
    h = rnd(M, FF).to(bf16)
    x = rnd(M, D).to(bf16)
    fs, fb = rnd(M // L, D, std=0.1), rnd(M // L, D, std=0.1)
    s2, b2n, s4, b4 = 1 + rnd(D, std=0.1), rnd(D, std=0.1), 1 + rnd(D, std=0.1), rnd(D, std=0.1)
    wq, wk, wv, wfc, w1, w2, w3 = w(HD, D), w(HD, D), w(HD, D), w(D, HD), w(FF, D), w(D, FF), w(D, D)
    b1, b2, b3 = rnd(FF, std=0.1), rnd(D, std=0.1), rnd(D, std=0.1)
    rry, wqkv = torch.stack((r, r, y)), torch.stack((wq, wk, wv)).transpose(1, 2)  # the library's operands
    fc_kw = dict(eps=1e-6, resid=x, film_scale=fs, film_shift=fb, L=L)
    w2_kw = dict(eps=1e-5, form="film_pre", prod_bias=b2, resid=x, film_scale=fs, film_shift=fb, L=L)
    # (kernel, product, the path's call, mma.sync's, the plain version, N, K, bytes of the inputs read once
    #  and of the output, the library's call: the product alone, bf16 out)
    cases = (
        ("sa_block", "q/k/v grouped", lambda: gemm.gemm_wg([r, r, y], [wq, wk, wv]),
         lambda: gemm.gemm([r, r, y], [wq, wk, wv]), lambda: gemm.gemm_plain([r, r, y], [wq, wk, wv]), 3 * HD, D,
         nbytes(r, y, wq, wk, wv) + 2 * M * 3 * HD, lambda: torch.matmul(rry, wqkv)),
        ("sa_block", "fc + post-LN + FiLM", lambda: gemm.gemm_ln_wg(o, wfc, s2, b2n, **fc_kw),
         lambda: gemm.gemm_ln(o, wfc, s2, b2n, **fc_kw), lambda: gemm.gemm_ln_plain(o, wfc, s2, b2n, **fc_kw), D, HD,
         nbytes(o, wfc, s2, b2n, x, fs, fb) + 2 * M * D, lambda: torch.matmul(o, wfc.t())),
        ("ff_tail", "W1 bias+GELU", lambda: gemm.gemm_wg(y3, w1, "bias_gelu", b1),
         lambda: gemm.gemm(y3, w1, "bias_gelu", b1), lambda: gemm.gemm_plain(y3, w1, "bias_gelu", b1), FF, D,
         nbytes(y3, w1, b1) + 2 * M * FF, lambda: torch.matmul(y3, w1.t())),
        ("ff_tail", "W2 bias+FiLM+LN4", lambda: gemm.gemm_ln_wg(h, w2, s4, b4, **w2_kw),
         lambda: gemm.gemm_ln(h, w2, s4, b4, **w2_kw), lambda: gemm.gemm_ln_plain(h, w2, s4, b4, **w2_kw), D, FF,
         nbytes(h, w2, b2, x, fs, fb, s4, b4) + 2 * M * D, lambda: torch.matmul(h, w2.t())),
        ("ff_tail", "W3 bias", lambda: gemm.gemm_wg(y4, w3, "bias", b3), lambda: gemm.gemm(y4, w3, "bias", b3),
         lambda: gemm.gemm_plain(y4, w3, "bias", b3), D, D, nbytes(y4, w3, b3) + 2 * M * D,
         lambda: torch.matmul(y4, w3.t())),
    )
    figures = collections.defaultdict(dict)
    for kernel, label, call, mma_call, plain, N, K, io_bytes, library in cases:
        ref = plain()
        before = gemm.body_launches("gemm")
        out = call()
        torch.cuda.synchronize()
        after = gemm.body_launches("gemm")
        body = [k for k in after if after[k] != before[k]]
        outs, refs = (out, ref) if isinstance(out, list) else ([out], [ref])
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs, refs))
        tol = min(tolerance(bf16, b.float()) for b in refs)
        check(all(torch.isfinite(a).all().item() for a in outs), f"GEMM {label} output not finite")
        check(err <= tol, f"GEMM {label} disagrees: {err} > {tol}")
        check(body == ["wgmma"] and after["wgmma"] - before["wgmma"] == 1,
              f"GEMM {label}: not one launch of the wgmma body ({before} -> {after})")
        mma_out = mma_call()
        mma_err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(mma_out if isinstance(mma_out, list) else [mma_out], refs))
        check(mma_err <= tol, f"GEMM {label} on mma.sync disagrees: {mma_err} > {tol}")
        del out, mma_out
        flops = 2 * M * N * K
        ms, mma_ms, lib_ms = device_ms(call, reps=10), device_ms(mma_call, reps=10), device_ms(library, reps=10)
        b = bound(flops, io_bytes)
        print(f"GEMM {label} {M}x{N}x{K} bf16 on {body[0]}: max_abs_err {err:.3e} (tol {tol:.3e}) kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s); mma.sync {mma_ms:.4f} ms "
              f"({flops / mma_ms / 1e9:.1f} TFLOP/s); bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
              f"torch.matmul {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s)")
        figures[kernel][label] = dict(shape=[M, N, K], body=body[0], max_abs_err=err, ms=ms,
                                      tflops=flops / ms / 1e9, mma_ms=mma_ms, mma_tflops=flops / mma_ms / 1e9,
                                      library_ms=lib_ms, **b)
    return figures


def compare_wgmma(gen: torch.Generator) -> dict:
    """Phase 3c: the wgmma + TMA body (ops/gemm.gemm_wg, csrc/gemm_wgmma.cuh)
    at K8's, K2b's and K9's product shapes (M = b L = 3600, d=512, ff=1024),
    bf16: K8's q||k||v (three products of N=512 in one launch, each with its
    own A) and one product of 3600x512x512, K2b's W1 (3600x1024x512,
    bias+GELU) and W2 (3600x512x1024, bias), K9's linear1 (3600x1024x512)
    and linear3 (3600x512x512) with the product rounded before the bias.
    Each held against its plain version; its device
    time (calls queued back to back) and TFLOP/s beside its bound,
    mma.sync's (ops/gemm.gemm, the body it replaces on this path) and
    torch.matmul's (a yardstick only), and the grid and waves of its plan.
    Returns {kernel: {product: figures}}."""
    dev, M = "cuda", B * L
    bf16 = torch.bfloat16
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    w = lambda o, i: rnd(o, i, std=i**-0.5).to(bf16)
    r, y, h = rnd(M, D).to(bf16), rnd(M, D).to(bf16), rnd(M, FF).to(bf16)
    wq, wk, wv, w1, w2, w3 = w(HD, D), w(HD, D), w(HD, D), w(FF, D), w(D, FF), w(D, D)
    b1, b2, b3 = rnd(FF, std=0.1), rnd(D, std=0.1), rnd(D, std=0.1)
    rry, wqkv = torch.stack((r, r, y)), torch.stack((wq, wk, wv)).transpose(1, 2)  # the library's operands
    bf = 2
    # (kernel, product, gemm_wg's args, mma.sync's, N, K, bytes of the inputs, the library's call)
    cases = (
        ("ln_rotary_matmul", "q||k||v grouped", ([r, r, y], [wq, wk, wv]), ([r, r, y], [wq, wk, wv]), 3 * HD, D,
         nbytes(r, y, wq, wk, wv), lambda: torch.matmul(rry, wqkv)),
        ("ln_rotary_matmul", "q alone", (r, wq), (r, wq), HD, D, nbytes(r, wq), lambda: torch.matmul(r, wq.t())),
        ("ff_block", "W1 bias+GELU", (y, w1, "bias_gelu", b1), (y, w1, "bias_gelu", b1), FF, D, nbytes(y, w1, b1),
         lambda: torch.matmul(y, w1.t())),
        ("ff_block", "W2 bias", (h, w2, "bias", b2), (h, w2, "bias", b2), D, FF, nbytes(h, w2, b2),
         lambda: torch.matmul(h, w2.t())),
        ("ln_matmul", "linear1 bias_rounded", (y, w1, "bias_rounded", b1), (y, w1, "bias_rounded", b1), FF, D,
         nbytes(y, w1, b1), lambda: torch.matmul(y, w1.t())),
        ("ln_matmul", "linear3 bias_rounded", (y, w3, "bias_rounded", b3), (y, w3, "bias_rounded", b3), D, D,
         nbytes(y, w3, b3), lambda: torch.matmul(y, w3.t())),
    )
    figures = collections.defaultdict(dict)
    for kernel, label, args, mma_args, N, K, in_bytes, library in cases:
        out, ref = gemm.gemm_wg(*args), gemm.gemm_plain(*args)
        torch.cuda.synchronize()
        outs, refs = (out, ref) if isinstance(out, list) else ([out], [ref])
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs, refs))
        tol = min(tolerance(bf16, b.float()) for b in refs)
        check(all(torch.isfinite(a).all().item() for a in outs), f"wgmma {label} output not finite")
        check(err <= tol, f"wgmma {label} disagrees: {err} > {tol}")
        flops = 2 * M * N * K
        ms, mma_ms, lib_ms = device_ms(lambda: gemm.gemm_wg(*args)), device_ms(lambda: gemm.gemm(*mma_args)), \
            device_ms(library)
        b = bound(flops, in_bytes + M * N * bf)
        ns = [a.shape[0] for a in args[1]] if isinstance(args[1], list) else [N]
        plan = gemm.gemm_plan(M, ns, K)
        print(f"wgmma {label} {M}x{N}x{K} bf16: max_abs_err {err:.3e} (tol {tol:.3e}) {1e3 * ms:.1f} us "
              f"({flops / ms / 1e9:.1f} TFLOP/s), bound {1e3 * b['bound_ms']:.1f} us ({b['bound_by']}); mma.sync "
              f"{1e3 * mma_ms:.1f} us ({flops / mma_ms / 1e9:.1f}), torch.matmul {1e3 * lib_ms:.1f} us "
              f"({flops / lib_ms / 1e9:.1f}); {plan['tile'][0]}x{plan['tile'][1]} tiles, grid {plan['grid']}, "
              f"{plan['blocks']} blocks, {plan['waves']:.2f} waves")
        figures[kernel][label] = dict(shape=[M, N, K], max_abs_err=err, ms=ms, tflops=flops / ms / 1e9,
                                      mma_ms=mma_ms, library_ms=lib_ms, grid=list(plan["grid"]),
                                      waves=plan["waves"], **b)
    for n in (512, 1024, 1536):
        plan = gemm.gemm_plan(M, [n], D)
        print(f"wgmma plan at M={M}, N={n}, K={D}: {plan['tile'][0]}x{plan['tile'][1]} tiles, grid {plan['grid']}, "
              f"{plan['blocks']} blocks, {plan['waves']:.2f} waves of 132 SMs")
    return figures


def check_one_call(fn, want: int, what: str, wg: int, rows: int) -> list:
    """One bf16 call fn() under torch.profiler (read again up to 10 times
    while the profiler drops an event): exactly `want` device kernels, `wg`
    of them the wgmma body, `rows` row kernels, none of them
    gemm_mma_kernel or a PyTorch kernel. Returns [(kernel, us)]."""
    fn()
    torch.cuda.synchronize()
    _, kernels = device_kernels(fn, accept=lambda ks: len(ks) == want, attempts=10)
    kernels = [(n, e - s) for n, s, e in kernels]
    print(f"{what}: {len(kernels)} device kernels a call: " + ", ".join(f"{n.replace('tcd::', '')} {us:.1f} us"
                                                                    for n, us in kernels))
    check(len(kernels) == want, f"{what} ran {len(kernels)} device kernels, expected {want}")
    check(all("tcd::" in n for n, _ in kernels), f"{what} ran a PyTorch kernel")
    check(sum("gemm_wg_kernel" in n for n, _ in kernels) == wg, f"{what}: not {wg} wgmma launches")
    check(sum("ln_rows_kernel" in n for n, _ in kernels) == rows, f"{what}: not {rows} row kernels")
    check(not any("gemm_mma_kernel" in n for n, _ in kernels), f"{what} ran the mma.sync body")
    return kernels


def compare_wgmma_kernels(gen: torch.Generator) -> dict:
    """Phase 5b: K8 (self q/k/v with q's and k's weights apart, as the per-op
    path calls it, and joined; the rot-only cross query), K2b (with and
    without FiLM rows) and K9 (norm3 -> linear1 and norm4 -> linear3) alone
    at the serving shape, bf16, operands in the kernels' dtypes (no wrapper
    cast): the row body, then the products on the wgmma body. Device time a
    call (calls queued back to back) beside its bound, its device kernels by
    name under torch.profiler (K8 and K9: the row kernel and one wgmma
    launch; K2b: the row kernel and two wgmma launches; no mma.sync and no
    PyTorch kernel), each against the plain version. K9 takes a bias of ~8,
    where the rounding order shows: at most 1% of its outputs off the plain
    version's bits, and the sum rounded once (F.linear's order) off them in
    more than 2%. Then the host us a call spends on tensor maps. Returns
    extra figures for K8, K2b and K9."""
    dev, bf16 = "cuda", torch.bfloat16
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    w = lambda o, i: rnd(o, i, std=i**-0.5).to(bf16)
    x, s, b = rnd(B, L, D).to(bf16), 1.0 + rnd(D, std=0.1), rnd(D, std=0.1)
    ang = angle_table(L, D, dev)
    wq, wk, wv, w1, w2, w3 = w(HD, D), w(HD, D), w(HD, D), w(FF, D), w(D, FF), w(D, D)
    b1, b2, b3, fs, fb = rnd(FF, std=0.1), rnd(D, std=0.1), rnd(D, std=0.1), rnd(B, D, std=0.1), rnd(B, D, std=0.1)
    c1, c3 = rnd(FF, std=8.0), rnd(D, std=8.0)  # K9's biases
    k8, wqk = ln_rotary_matmul.ln_rotary_matmul, torch.cat([wq, wk])
    k9, k9_plain = ln_matmul.ln_matmul, ln_matmul.ln_matmul_plain
    M = B * L
    # (kernel, label, call, plain, wgmma launches, the products' operations,
    # the inputs each read once)
    calls = (
        ("ln_rotary_matmul", "self q/k/v, weights apart", lambda: k8(x, s, b, ang, (wq, wk), wv),
         lambda: ln_rotary_matmul.ln_rotary_matmul_plain(x, s, b, ang, (wq, wk), wv), 1, 2 * M * D * 3 * HD,
         (x, s, b, ang, wq, wk, wv)),
        ("ln_rotary_matmul", "self q/k/v, joined", lambda: k8(x, s, b, ang, wqk, wv),
         lambda: ln_rotary_matmul.ln_rotary_matmul_plain(x, s, b, ang, wqk, wv), 1, 2 * M * D * 3 * HD,
         (x, s, b, ang, wqk, wv)),
        ("ln_rotary_matmul", "rot-only cross q", lambda: k8(x, s, b, ang, wq),
         lambda: ln_rotary_matmul.ln_rotary_matmul_plain(x, s, b, ang, wq), 1, 2 * M * D * HD, (x, s, b, ang, wq)),
        ("ff_block", "film=False", lambda: ff_block.ff_block(x, s, b, w1, b1, w2, b2),
         lambda: ff_block.ff_block_plain(x, s, b, w1, b1, w2, b2), 2, 4 * M * D * FF, (x, s, b, w1, b1, w2, b2)),
        ("ff_block", "film=True", lambda: ff_block.ff_block(x, s, b, w1, b1, w2, b2, fs, fb),
         lambda: ff_block.ff_block_plain(x, s, b, w1, b1, w2, b2, fs, fb), 2, 4 * M * D * FF,
         (x, s, b, w1, b1, w2, b2, fs, fb)),
        ("ln_matmul", "norm3->linear1", lambda: k9(x, s, b, w1, c1), lambda: k9_plain(x, s, b, w1, c1), 1,
         2 * M * D * FF, (x, s, b, w1, c1)),
        ("ln_matmul", "norm4->linear3", lambda: k9(x, s, b, w3, c3), lambda: k9_plain(x, s, b, w3, c3), 1,
         2 * M * D * D, (x, s, b, w3, c3)),
    )
    flat = lambda o: [t for part in (o if isinstance(o, tuple) else (o,))
                      for t in (part if isinstance(part, tuple) else (part,))]
    figures = collections.defaultdict(dict)
    for kernel, label, call, plain, wg, flops, inputs in calls:
        name = WG_LIBS[kernel]
        refs = flat(plain())
        outs = flat(call())
        torch.cuda.synchronize()
        err = max((o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs))
        tol = min(tolerance(bf16, r.float()) for r in refs)
        check(err <= tol, f"{name} {label} disagrees with its plain version: {err} > {tol}")
        bits = {}
        if kernel == "ln_matmul":
            y, wn, bn = ln_f32(x, s, b, 1e-5).to(bf16), inputs[3], inputs[4]
            other = (mm_f32(y, wn) + bn).to(bf16)
            bits = dict(off_bits=(outs[0] != refs[0]).float().mean().item(),
                        linear_off_bits=(other != refs[0]).float().mean().item())
            print(f"{name} {label} bf16, bias ~8: {bits['off_bits']:.4%} of the outputs off the plain version's "
                  f"bits (at most 1%), F.linear's order off them in {bits['linear_off_bits']:.2%} (more than 2%)")
            check(bits["off_bits"] <= 0.01, f"{name} {label}: {bits['off_bits']:.4%} of the outputs off the bits")
            check(bits["linear_off_bits"] > 0.02, f"{name} {label}: the rounding order does not show")
        ms = device_ms(call, reps=20)
        kernels = check_one_call(call, wg + 1, f"{name} {label} bf16", wg, 1)
        bnd = bound(flops, nbytes(*inputs, *refs))
        print(f"{name} {label} bf16: max_abs_err {err:.3e} (tol {tol:.3e}); device {1e3 * ms:.1f} us a call "
              f"(calls queued back to back), bound {1e3 * bnd['bound_ms']:.1f} us ({bnd['bound_by']})")
        figures[kernel][label] = dict(device_ms=ms, max_abs_err=err, kernels_us={n: us for n, us in kernels},
                                      **bnd, **bits)

    # the host time a call spends on tensor maps (cached: lookups only)
    for kernel, lib, fn in (("ln_rotary_matmul", "ln_rotary_matmul", lambda: k8(x, s, b, ang, (wq, wk), wv)),
                            ("ff_block", "ff_block", lambda: ff_block.ff_block(x, s, b, w1, b1, w2, b2)),
                            ("ln_matmul", "ln_matmul", lambda: k9(x, s, b, w1, b1))):
        fn()
        torch.cuda.synchronize()
        before = gemm.tma_stats(lib)
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        after = gemm.tma_stats(lib)
        per = (after["us"] - before["us"]) / 100
        print(f"{kernel}: tensor maps {per:.2f} host us a call ({(after['lookups'] - before['lookups']) / 100:.0f} "
              f"lookups, {after['encodes'] - before['encodes']} encodes in 100 calls); {after['encodes']} encoded "
              f"since the library loaded, {after['us']:.0f} us in all")
        figures[kernel]["tma_host_us_per_call"] = per
    return figures


def measure(figures: dict, name: str, label: str, dtype, kernel, plain, flops: float, io_bytes: int,
            library=None, peak: float = PEAK_BF16, main: bool = False) -> None:
    """Hold kernel() against plain() (the same inputs), time both (and
    library(), the one PyTorch call of the same function, where given);
    record the figures of the main-path bf16 variant under `name`, with
    the device times of kernel() and library() (20 calls queued back to
    back)."""
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    err = max((o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs))
    tol = min(tolerance(dtype, r.float()) for r in refs)
    check(all(torch.isfinite(o).all().item() for o in outs), f"{name} {label} output not finite")
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    lib_ms = None if library is None else time_ms(library)
    dname = "bf16" if dtype == torch.bfloat16 else "f32"
    lib = "" if lib_ms is None else f" library {lib_ms:.3f} ms (kernel / library {ms / lib_ms:.2f})"
    print(f"{name} {label} {dname}: max_abs_err {err:.3e} (tol {tol:.3e}) kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s) plain {plain_ms:.3f} ms{lib}")
    check(err <= tol, f"{name} {label} {dname} disagrees: {err} > {tol}")
    if main and dtype == torch.bfloat16:
        dev_ms = device_ms(kernel, reps=20)
        lib_dev_ms = None if library is None else device_ms(library, reps=20)
        lib = "" if lib_dev_ms is None else f", library {1e3 * lib_dev_ms:.1f} us"
        print(f"{name} {label} {dname}: device {1e3 * dev_ms:.1f} us a call (calls queued back to back){lib}")
        figures[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound(flops, io_bytes, peak),
                             library_ms=lib_ms, device_ms=dev_ms, library_device_ms=lib_dev_ms)


def compare_serving_ops(gen: torch.Generator) -> dict:
    """Phase 4: K8-K11 at the per-op path's shapes (b=8, L=450, d=512, 8x64
    heads, ff=1024). Returns the main-path (bf16) figures of each."""
    dev = "cuda"
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    ln = lambda: (1.0 + rnd(D, std=0.1), rnd(D, std=0.1))
    angles = angle_table(L, D, dev)
    M = B * L
    figures = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = rnd(B, L, D).to(dtype)
        w = lambda o, i: rnd(o, i, std=i**-0.5).to(dtype)
        s, b = ln()

        # K10: the SBI-MSA post-attention LayerNorm (eps 1e-6); ~7 f32
        # operations an element; F.layer_norm takes its affine in x's dtype,
        # cast once outside the timed call
        sx, bx = s.to(dtype), b.to(dtype)
        measure(figures, "layernorm", "post-attention LN", dtype,
                lambda: layernorm.layernorm(x, s, b, 1e-6), lambda: layernorm.layernorm_plain(x, s, b, 1e-6),
                7 * M * D, nbytes(x, s, b, x),
                library=lambda: F.layer_norm(x, (D,), sx, bx, 1e-6), peak=PEAK_F32, main=True)

        # K9: norm3 -> linear1 (the main variant) and norm4 -> linear3
        for n, label in ((FF, "norm3->linear1"), (D, "norm4->linear3")):
            wn, bn = w(n, D), rnd(n, std=0.1)
            out_bytes = M * n * x.element_size()
            measure(figures, "ln_matmul", label, dtype,
                    lambda: ln_matmul.ln_matmul(x, s, b, wn, bn), lambda: ln_matmul.ln_matmul_plain(x, s, b, wn, bn),
                    2 * M * D * n, nbytes(x, s, b, wn, bn) + out_bytes, main=n == FF)

        # K8: self-attention q/k (rotated) and v (the main variant); the
        # cross-attention query's rot-only form
        wr, wp, wq = w(2 * HD, D), w(HD, D), w(HD, D)
        cos_sin = 2 * L * D * x.element_size()
        measure(figures, "ln_rotary_matmul", "self q/k/v", dtype,
                lambda: ln_rotary_matmul.ln_rotary_matmul(x, s, b, angles, wr, wp),
                lambda: ln_rotary_matmul.ln_rotary_matmul_plain(x, s, b, angles, wr, wp),
                2 * M * D * 3 * HD, nbytes(x, s, b, wr, wp) + cos_sin + 3 * M * HD * x.element_size(), main=True)
        measure(figures, "ln_rotary_matmul", "rot-only cross q", dtype,
                lambda: ln_rotary_matmul.ln_rotary_matmul(x, s, b, angles, wq),
                lambda: ln_rotary_matmul.ln_rotary_matmul_plain(x, s, b, angles, wq),
                2 * M * D * HD, nbytes(x, s, b, wq) + cos_sin + M * HD * x.element_size())

        # K11 on (b, h, L, dk) views of (b, L, h*dk) projections, as the path
        # passes them; the all-heads entry is the same kernel
        heads = lambda n: rnd(B, n, HD).to(dtype).view(B, n, H, HD // H).transpose(1, 2)
        table = rnd(H, 10, HD // H).to(dtype)
        dist = torch.randint(0, 10, (B, L, L), generator=gen, device=dev, dtype=torch.int32)
        scale = (HD // H) ** -0.5
        for lq, lk, label, trpe in ((L, L, "self 450x450", False), (L, L, "self 450x450 TRPE", True),
                                    (L, LM, "cross 450x152", False), (LC, LC, "cond encoder 150x150", False)):
            q, k, v = heads(lq), heads(lk), heads(lk)
            tab, dd = (table, dist) if trpe else (None, None)
            flops = 4 * B * H * lq * lk * (HD // H) + (2 * B * H * lq * (HD // H) * 10 if trpe else 0)
            sdpa = None if trpe else (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v, scale=scale))
            measure(figures, "attention", label, dtype,
                    lambda q=q, k=k, v=v, tab=tab, dd=dd: attention.attention(q, k, v, scale, tab, dd),
                    lambda q=q, k=k, v=v, tab=tab, dd=dd: attention.attention_plain(q, k, v, scale, tab, dd),
                    flops, nbytes(q, k, v, tab, dd) + q.numel() * q.element_size(), library=sdpa,
                    main=label == "self 450x450")
    return figures


def off16(t: torch.Tensor) -> torch.Tensor:
    """t's values one element past a 16-byte boundary, the same strides: a
    view TMA cannot address, which the attention runs on mma.sync."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def attn_call(call: str, lib: str, fn, hold, aligned: bool, rows: int, lq: int, lk: int) -> dict:
    """One bf16 attention call of 8 x 64 heads: fn() once, its launches of
    each body by `lib`'s count against the body attention_plan names,
    hold(out) (which checks the output and returns its errors), then its
    device time beside the bound (the operations at PEAK_BF16, q, k, v and
    o once at HBM_RATE). Prints and returns the row."""
    before = attention.attn_body_launches(lib)
    out = fn()
    torch.cuda.synchronize()
    after = attention.attn_body_launches(lib)
    ran = {k: after[k] - before[k] for k in after}
    plan = attention.attention_plan(torch.bfloat16, 64, False, aligned, lq, rows, H)["body"]
    check(ran == {b: int(b == plan) for b in ("mma.sync", "wgmma")},
          f"attention {call}: launched {ran}, the rule names {plan}")
    errors = hold(out)
    ms = device_ms(fn, reps=20)
    flops = 4.0 * rows * H * lq * lk * 64
    b = 1e3 * max(flops / PEAK_BF16, 2.0 * rows * (2 * lq + 2 * lk) * HD / HBM_RATE)
    row = dict(call=call, device_ms=round(ms, 5), bound_ms=round(b, 5), share=round(b / ms, 4),
               tflops=round(flops / ms / 1e9, 1), bodies=ran, plan=plan, **errors)
    print(json.dumps(row), flush=True)
    return row


def held(what: str, dtype, out: torch.Tensor, ref: torch.Tensor) -> float:
    """out's largest error against ref, checked within tolerance(dtype)."""
    err, tol = (out.float() - ref.float()).abs().max().item(), tolerance(dtype, ref.float())
    check(err <= tol, f"{what} disagrees with the plain version: {err} > {tol}")
    return err


def compare_attention_bodies(gen: torch.Generator) -> list:
    """Phase 4c: the attention's two bf16 bodies at the main path's calls,
    8 x 64 heads on (b, L, h*dk) views: K1's self-attention at the serving
    cell's 256 rows (CFG) and 128 (layer 0's dedup) at 450 x 450; the train
    forward of K3 (600 x 600) and K4 (600 x 152) at the train cell's 256
    rows, dropout 0.1 and 0. Each call on the body the rule picks and on
    mma.sync (q one element off a 16-byte boundary, "off16"), through
    attn_call, held against the plain version: K1's output against
    attention_plain; the train forward's output against sa_block_train's
    plain chain and its lse (f32) against the log-sum-exp of the same
    logits, and at rate 0.1 its dropout mask, read from q = 0 against v
    one-hot over each 64 keys, bit for bit against train_common.keep_mask.
    Returns the rows."""
    dev, dk, bf = torch.device("cuda"), 64, torch.bfloat16
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(bf)
    rows_out = []
    for rows in (256, 128):
        x = [rnd(rows, L, HD) for _ in range(3)]
        heads = lambda t: t.view(rows, L, H, dk).transpose(1, 2)
        q, k, v = (heads(t) for t in x)
        ref = attention.attention_plain(q, k, v, dk**-0.5)
        for label, qq in (("", q), (" off16", heads(off16(x[0])))):
            call = f"k1 {rows} rows {L}x{L}{label}"
            rows_out.append(attn_call(call, "attention", lambda qq=qq: attention.attention(qq, k, v, dk**-0.5),
                                      lambda out, call=call: dict(max_abs_err=held(call, bf, out, ref)),
                                      attention.tma_aligned(qq, k, v), rows, L, L))
        del x, q, k, v, ref

    rows, lq, chunk = 256, 600, 32
    seeds = torch.randint(0, 2**32, (rows,), generator=gen, device=dev, dtype=torch.int64)
    salts = train_common.SALT_ATTN + torch.arange(H, dtype=torch.int64)
    heads = lambda t: t.view(t.shape[0], t.shape[1], H, dk).transpose(1, 2)
    fwd = lambda q, k, v, rate: sa_block_train.attention_train_fwd(q, k, v, seeds, nhead=H, rate=rate)

    def kept(q0, k, lk: int, rate: float) -> torch.Tensor:
        """The forward's dropout mask (rows, H, lq, lk) with q = q0 (zeros):
        every probability 1 / lk before dropout, so o[i, c] against v
        one-hot over keys 64 blk.. is nonzero iff key 64 blk + c is kept."""
        mask = torch.empty(rows, H, lq, lk, dtype=torch.bool, device=dev)
        for blk in range(-(-lk // 64)):
            keys = torch.arange(64 * blk, min(64 * blk + 64, lk), device=dev)
            onehot = torch.zeros(lk, dk, device=dev)
            onehot[keys, keys - 64 * blk] = 1.0
            vb = onehot.repeat(1, H)[None].expand(rows, lk, HD).to(bf).contiguous()
            o = fwd(q0, k, vb, rate)[0].view(rows, lq, H, dk)[..., :keys.numel()]
            mask[..., 64 * blk:64 * blk + keys.numel()] = (o != 0).transpose(1, 2)
        return mask

    for lk in (600, 152):
        q, k, v = rnd(rows, lq, HD), rnd(rows, lk, HD), rnd(rows, lk, HD)
        scale_t = torch.tensor(1.0 / dk**0.5, dtype=bf)
        lse = torch.cat([torch.logsumexp(torch.matmul((heads(q[c:c + chunk]) * scale_t).float(),
                                                      heads(k[c:c + chunk]).float().transpose(-1, -2)), dim=-1)
                         for c in range(0, rows, chunk)])
        for rate in (0.1, 0.0):
            ref = torch.cat([sa_block_train.attention_plain(q[c:c + chunk], k[c:c + chunk], v[c:c + chunk],
                                                            seeds[c:c + chunk], H, rate)
                             for c in range(0, rows, chunk)])
            keep = None if rate == 0 else torch.cat([train_common.keep_mask(seeds[c:c + chunk], salts, lq, lk, rate)
                                                     for c in range(0, rows, chunk)])
            for label, qq, q0 in (("", q, torch.zeros_like(q)), (" off16", off16(q), off16(torch.zeros_like(q)))):
                call = f"train fwd {lq}x{lk} rate {rate}{label}"

                def hold(out, call=call, q0=q0, rate=rate, keep=keep):
                    errors = dict(max_abs_err=held(call, bf, out[0], ref), lse_err=held(call + " lse",
                                                                                      torch.float32, out[1], lse))
                    if keep is not None:
                        check(torch.equal(kept(q0, k, lk, rate), keep), f"{call}: the dropout mask differs")
                        errors["mask"] = "bit for bit"
                    return errors

                rows_out.append(attn_call(call, "sa_block_train", lambda qq=qq, rate=rate: fwd(qq, k, v, rate), hold,
                                          attention.tma_aligned(heads(qq), heads(k), heads(v)), rows, lq, lk))
            del ref, keep
        del q, k, v, lse
    return rows_out


def compare_ln_rows(gen: torch.Generator) -> dict:
    """Phase 4b: K10's row body (the LayerNorm stage of every kernel) at the
    rows the paths give it, d=512: 3600 rows in bf16 (K10 itself), 3600
    rows of f32 input with a bf16 output (the f32 fc output or FiLM
    residual of the unfused blocks, through ops/layernorm.ln_rows) and
    28800 rows in bf16 (the train forwards' rows). Each held against its
    plain version; its device time (calls queued back to back) beside
    F.layer_norm's on the same input, the bytes it must move over that
    time, and the share of the bound it reaches; then one call under
    torch.profiler, which must show the body templated on d = 512 (16
    elements a lane). Returns K10's extra figures."""
    bf16, f32 = torch.bfloat16, torch.float32
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device="cuda") * std
    s, b = 1.0 + rnd(D, std=0.1), rnd(D, std=0.1)
    extra = {}
    for label, rows, xdt in (("3600x512 bf16", B * L, bf16), ("3600x512 f32 in, bf16 out", B * L, f32),
                             ("28800x512 bf16 (train rows)", TRAIN_BATCH * L, bf16)):
        x = (2.0 * rnd(rows // L, L, D) + 0.5).to(xdt)
        if xdt == bf16:
            fn, plain = (lambda x=x: layernorm.layernorm(x, s, b, 1e-6)), (lambda x=x: layernorm.layernorm_plain(x, s, b, 1e-6))
        else:
            fn = lambda x=x: layernorm.ln_rows(x, s, b, 1e-6, dtype=bf16)[0]
            plain = lambda x=x: layernorm.ln_rows_plain(x, s, b, 1e-6, dtype=bf16)[0]
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        err, tol = (out.float() - ref.float()).abs().max().item(), tolerance(bf16, ref.float())
        check(torch.isfinite(out).all().item(), f"K10 rows {label}: output not finite")
        check(err <= tol, f"K10 rows {label} disagrees: {err} > {tol}")
        sx, bx = s.to(xdt), b.to(xdt)
        ms = device_ms(fn)
        lib_ms = device_ms(lambda x=x: F.layer_norm(x, (D,), sx, bx, 1e-6))
        io = nbytes(x, s, b, out)
        bnd = bound(7 * rows * D, io, PEAK_F32)
        print(f"K10 rows {label}: max_abs_err {err:.3e} (tol {tol:.3e}); device {1e3 * ms:.2f} us "
              f"({io / ms / 1e6:.0f} GB/s, {bnd['bound_ms'] / ms:.3f} of the bound {1e3 * bnd['bound_ms']:.2f} us, "
              f"{bnd['bound_by']}); F.layer_norm {1e3 * lib_ms:.2f} us (kernel / library {ms / lib_ms:.2f})")
        extra[label] = dict(device_ms=ms, library_device_ms=lib_ms, gb_s=io / ms / 1e6,
                            bound_share=bnd["bound_ms"] / ms, **bnd)
        if label == "3600x512 bf16":
            names = our_kernels(fn, 1)
            print(f"K10 at d={D}: {names}")
            check(calls(names, f"ln_rows_kernel<bf16, bf16, {D // 32}, true>") == 1,
                  f"K10 at d={D} did not run the body templated on {D // 32} elements a lane: {names}")
    return {"rows": extra, "device_ms": extra["3600x512 bf16"]["device_ms"],
            "library_device_ms": extra["3600x512 bf16"]["library_device_ms"]}


def compare_block_kernels(gen: torch.Generator) -> dict:
    """Phase 5: K2b (with and without the FiLM rows), K7 (the same) and K6
    (with and without its FF section) at the serving shapes (b=8, L=450,
    Lm=152, d=512, 8x64 heads, ff=1024). Returns the figures of the
    variant each configuration's main phase runs: K2b and K7 without FiLM
    (fuse_film's default), K6 with its FF section."""
    dev = "cuda"
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    ln = lambda: (1.0 + rnd(D, std=0.1), rnd(D, std=0.1))
    angles = angle_table(L, D, dev)
    M, Mm = B * L, B * LM
    figures = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = rnd(B, L, D).to(dtype)
        w = lambda o, i: rnd(o, i, std=i**-0.5).to(dtype)
        film = lambda: (rnd(B, D, std=0.1).to(dtype), rnd(B, D, std=0.1).to(dtype))
        fs, fb = film()

        # K2b: 4 M d ff of products
        ffa = (x, *ln(), w(FF, D), rnd(FF, std=0.1), w(D, FF), rnd(D, std=0.1))
        for with_film in (False, True):
            args = ffa + ((fs, fb) if with_film else (None, None))
            measure(figures, "ff_block", f"film={with_film}", dtype,
                    lambda args=args: ff_block.ff_block(*args), lambda args=args: ff_block.ff_block_plain(*args),
                    4 * M * D * FF, nbytes(*args) + nbytes(x), main=not with_film)

        # K7: q and fc 4 M d hd, k and v 4 Mm d hd, attention 4 b L Lm hd
        mem = rnd(B, LM, D).to(dtype)
        cab = (x, *ln(), angles, mem, apply_rotary(mem, angle_table(LM, D, dev)), w(HD, D), w(HD, D), w(HD, D),
               w(D, HD), *ln())
        cos_sin = 2 * L * D * x.element_size()
        for with_film in (False, True):
            args = cab + ((fs, fb) if with_film else (None, None))
            measure(figures, "ca_block", f"film={with_film}", dtype,
                    lambda args=args: ca_block.ca_block(*args, nhead=H),
                    lambda args=args: ca_block.ca_block_plain(*args, nhead=H),
                    4 * M * D * HD + 4 * Mm * D * HD + 4 * B * L * LM * HD,
                    nbytes(*args[:3], *args[4:]) + cos_sin + nbytes(x), main=not with_film)

        # K6 over k/v as the cache gives them: SA 8 M d hd + 4 b L^2 hd,
        # CA 4 M d hd + 4 b L Lm hd, FF and tail 4 M d ff + 2 M d d
        head = (x, angles, *ln(), w(HD, D), w(HD, D), w(HD, D), w(D, HD), *ln(), *film(),
                *ln(), w(HD, D), w(D, HD), *ln(), rnd(B, LM, HD).to(dtype), rnd(B, LM, HD).to(dtype), *film())
        ff = (*ln(), w(FF, D), rnd(FF, std=0.1), w(D, FF), rnd(D, std=0.1), *film(), *ln(), w(D, D), rnd(D, std=0.1))
        for include_ff in (True, False):
            args = head + (ff if include_ff else ())
            flops = 12 * M * D * HD + 4 * B * L * L * HD + 4 * B * L * LM * HD
            flops += (4 * M * D * FF + 2 * M * D * D) if include_ff else 0
            measure(figures, "layer", f"include_ff={include_ff}", dtype,
                    lambda args=args, i=include_ff: layer.layer(*args, nhead=H, include_ff=i),
                    lambda args=args, i=include_ff: layer.layer_plain(*args, nhead=H, include_ff=i),
                    flops, nbytes(args[0], *args[2:]) + cos_sin + nbytes(x), main=include_ff)
            if dtype == torch.bfloat16:
                figures["layer"].update(layer_launches(args, include_ff, flops))
    return figures


@torch.no_grad()
def compare_ca_kv(gen: torch.Generator) -> dict:
    """Phase 5b: K7 over the hoisted k/v (`ca_block.ca_kv`, the default's
    cross-attention site) at the serving shape (b = 8) and at the
    benchmark's 256 rows (128 clips under CFG): L = 450, 150 music rows and
    2 time rows (a strided view of all layers' projections, as the
    decoder's hoist makes them), d = 512, 8 x 64 heads. In bf16 and f32
    against its plain version; in bf16 its device time beside its bound
    (q and fc 4 M d hd, the attention 4 rows L Lk hd; x, the k/v, the
    weights and the output once), the plain site's (the decoder layer's
    cross-attention with ca_block off: PyTorch's kernels over the joined
    k/v, FiLM outside) and K7 over a memory of the same 152 rows (its k/v
    projections included), both bf16 paths' distance to the plain version
    in f32 (the kernel's no wider than the site's or its bf16 tolerance);
    and one call's device kernels by name: 3, every one hand-written, none
    named attn_* (the self-attention's name, which attn_roofline.sample
    counts). Returns {rows: figures}."""
    from tcdiff_torch.models.dance_decoder import FiLMTransformerDecoderLayer, _joined, featurewise_affine

    dev, lm = "cuda", LM - 2
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    torch.manual_seed(0)
    site = FiLMTransformerDecoderLayer(D, H, FF).to(dev).eval()
    ca, norm, plain = site.multihead_attn, site.norm2, ServingKernels(ca_block=False)
    angles = angle_table(L, D, dev)
    out = {}
    for rows in (B, 256):
        for dtype in (torch.bfloat16, torch.float32):
            w = lambda m: m.weight.to(dtype)
            x, t = rnd(rows, L, D).to(dtype), rnd(rows, D).to(dtype)
            fs, fb = site.film2(t)
            hoist = lambda: torch.einsum("btd,lhd->lbth", rnd(rows, 2, D).to(dtype),
                                         rnd(LAYERS, HD, D, std=D**-0.5).to(dtype))[3]
            kv = (rnd(rows, lm, HD).to(dtype), rnd(rows, lm, HD).to(dtype), hoist(), hoist())
            args = (x, norm.weight, norm.bias, angles, *kv, w(ca.w_qs), w(ca.fc), ca.layer_norm.weight,
                    ca.layer_norm.bias, fs.float(), fb.float())
            kernel = lambda args=args: ca_block.ca_kv(*args, nhead=H)
            M, Lk = rows * L, LM
            flops = 4 * M * D * HD + 4 * rows * L * Lk * HD
            io = 2 * nbytes(x) + nbytes(*kv, args[8], args[9]) + 2 * L * D * x.element_size()
            label = f"{rows} rows"
            measure(out, label, "ca_kv", dtype, kernel, lambda args=args: ca_block.ca_kv_plain(*args, nhead=H),
                    flops, io, main=True)
            if dtype != torch.bfloat16:
                continue

            def site_plain(x=x, kv=kv, fs=fs, fb=fb):
                q = ca.cross_q(x, norm, angles, plain, fused=False)
                return x + featurewise_affine(ca.attend(q, *_joined(kv), plain), (fs, fb))

            mem = rnd(rows, LM, D).to(dtype)
            k7 = (x, norm.weight, norm.bias, angles, mem, apply_rotary(mem, angle_table(LM, D, dev)), w(ca.w_qs),
                  w(ca.w_ks), w(ca.w_vs), w(ca.fc), ca.layer_norm.weight, ca.layer_norm.bias, fs.float(), fb.float())
            # both bf16 paths against the plain version in f32 on the same (rounded) operands: the site
            # rounds at more points (its fc output before the LayerNorm, its logits, its FiLM residual)
            ref32 = ca_block.ca_kv_plain(*(a.float() if torch.is_tensor(a) else a for a in args), nhead=H)
            err, site_err = ((f().float() - ref32).abs().max().item() for f in (kernel, site_plain))
            site_ms = device_ms(site_plain, reps=10)
            k7_ms = device_ms(lambda: ca_block.ca_block(*k7, nhead=H), reps=10)
            _, kernels = device_kernels(kernel, accept=lambda ks: len(ks) == 3, attempts=10)
            names = [re.sub(r"<.*$", "", n).split("::")[-1] for n, _, _ in kernels]
            fig = out[label]
            print(f"K7 over the hoisted k/v, {label} bf16: device {fig['device_ms']:.4f} ms (bound "
                  f"{fig['bound_ms']:.4f} ms, {fig['bound_by']}; {100 * fig['bound_ms'] / fig['device_ms']:.1f}% of "
                  f"it); the plain site {site_ms:.4f} ms ({site_ms / fig['device_ms']:.2f}x); max_abs_diff to f32 "
                  f"{err:.3e}, the plain site's {site_err:.3e}; K7 over a memory of {LM} rows {k7_ms:.4f} ms; "
                  f"device kernels a call: "
                  + ", ".join(f"{n} {e - s0:.1f} us" for n, (_, s0, e) in zip(names, kernels)))
            check(len(kernels) == 3 and all("tcd::" in n for n, _, _ in kernels),
                  f"K7 over the hoisted k/v ran {len(kernels)} device kernels, not 3 hand-written ones: {names}")
            check(not any(n.startswith("attn_") for n in names), f"K7 over the hoisted k/v launched {names}")
            check(err <= max(site_err, tolerance(dtype, ref32)), f"K7 over the hoisted k/v, {label}: {err} off f32, "
                  f"the plain site {site_err}")
            fig.update(plain_site_device_ms=site_ms, k7_memory_device_ms=k7_ms, device_kernels=names,
                       err_to_f32=err, plain_site_err_to_f32=site_err)
    del site
    torch.cuda.empty_cache()
    return out


def layer_launches(args, include_ff: bool, flops: float) -> dict:
    """K6 in bf16: its device time (calls queued back to back) beside the
    per-call time `measure` took, and one call under torch.profiler (FiLM
    rows in f32, as the kernel takes them, so that the wrapper launches no
    cast): with its FF section it must run 10 device kernels, exactly one
    of them a LayerNorm row kernel and three the LayerNorm folds
    (gemm_wg_ln_kernel); without, 7, one row kernel and two folds."""
    args = tuple(a.float() if a.dim() == 2 and a.shape[0] == B else a for a in args)  # the FiLM rows
    fn = lambda: layer.layer(*args, nhead=H, include_ff=include_ff)
    dev_ms = device_ms(fn)
    want, folds = (10, 3) if include_ff else (7, 2)
    _, kernels = device_kernels(fn, accept=lambda ks: len(ks) == want)
    names = collections.Counter(name for name, _, _ in kernels)
    print(f"K6 layer bf16 include_ff={include_ff}: device {dev_ms:.4f} ms a call (calls queued back to back), "
          f"{flops / dev_ms / 1e9:.1f} TFLOP/s; {len(kernels)} device kernels a call: {dict(names)}")
    check(len(kernels) == want, f"K6 include_ff={include_ff} ran {len(kernels)} device kernels, expected {want}")
    check(calls(names, "ln_rows_kernel") == 1, f"K6 ran {calls(names, 'ln_rows_kernel')} row kernels, expected 1")
    check(calls(names, "gemm_wg_ln_kernel") == folds, f"K6 ran {calls(names, 'gemm_wg_ln_kernel')} LayerNorm "
          f"folds on the wgmma body, expected {folds}")
    key = "" if include_ff else "_no_ff"
    return {f"device_ms{key}": dev_ms, f"device_kernels{key}": len(kernels)}


# The block kernels' configurations: (label, ServingKernels, the expected
# launches of one 50-step request over 8 layers). K6 runs on every layer but
# the CFG-dedup layer 0, which keeps K1, K7 over the hoisted k/v and K2;
# K2b and K7 run on every layer, K7 over the memory where the k/v cache is
# off (`ca_block` counts both forms).
STEPS, LAYERS = DiffusionConfig().sampling_timesteps, DanceDecoderConfig().num_layers
BLOCK_CONFIGS = (
    ("layer_fuse", ServingKernels(layer_fuse=True),
     dict(layer=(LAYERS - 1) * STEPS, sa_block=STEPS, ca_block=STEPS, ff_tail=STEPS)),
    ("layer_fuse, layer_fuse_ff off", ServingKernels(layer_fuse=True, layer_fuse_ff=False),
     dict(layer=(LAYERS - 1) * STEPS, sa_block=STEPS, ca_block=STEPS, ff_tail=LAYERS * STEPS)),
    ("ff_tail off", ServingKernels(ff_tail=False),
     dict(sa_block=LAYERS * STEPS, ca_block=LAYERS * STEPS, ff_block=LAYERS * STEPS)),
    ("ff_tail off, fuse_film", ServingKernels(ff_tail=False, fuse_film=True),
     dict(sa_block=LAYERS * STEPS, ca_block=LAYERS * STEPS, ff_block=LAYERS * STEPS)),
    ("ff_tail off, ln_matmul", ServingKernels(ff_tail=False, ln_matmul=True),
     dict(sa_block=LAYERS * STEPS, ca_block=LAYERS * STEPS, ff_block=LAYERS * STEPS, ln_matmul=LAYERS * STEPS)),
    ("ca_block, k/v cache off", ServingKernels(ca_block=True, kv_cache=False),
     dict(sa_block=LAYERS * STEPS, ff_tail=LAYERS * STEPS, ca_block=LAYERS * STEPS)),
)


def serving_launches() -> dict:
    return {name: fn.launches for name, fn in {**SERVING_BLOCKS, **SERVING_OPS}.items()}


def bodies_since(before: dict | None = None) -> dict:
    """{lib: {body: launches}} of the products of WG_LIBS' kernels on each
    body, since `before` (a reading of this function) or since they loaded."""
    now = {lib: gemm.body_launches(lib) for lib in WG_LIBS}
    return now if before is None else {lib: {k: n - before[lib][k] for k, n in now[lib].items()} for lib in now}


def check_bodies(label: str, bodies: dict, want: dict) -> None:
    """Every product of each kernel in `want` ({lib: products}) on wgmma,
    none on mma.sync."""
    for lib, n in want.items():
        print(f"{label}: {WG_LIBS[lib]}'s products by body {bodies[lib]} (expected all {n} on wgmma)")
        check(bodies[lib] == {"mma.sync": 0, "wgmma": n}, f"{label}: {WG_LIBS[lib]}'s products ran on {bodies[lib]}")


def check_request_k7(model, request) -> None:
    """K7 with the operands the ca_block configuration's request passes it:
    layer 0's first call of one more request, recorded, then run alone
    through check_k7_kernels."""
    layer, calls = model.layers[0], []

    def record(*args, **kw):
        if not calls:
            calls.append((args, kw))
        return ca_block.ca_block(*args, **kw)

    layer.ca_block_fn = record
    try:
        request()
    finally:
        layer.ca_block_fn = ca_block.ca_block
    args, kw = calls[0]
    check_k7_kernels(lambda: ca_block.ca_block(*args, **kw), "as the ca_block request calls it")


def serve_block_configs(gen: torch.Generator, card: str) -> dict:
    """Phase 11: one bf16 ddim_sample request of batch 4 through each of
    BLOCK_CONFIGS on the full-width model (a warm-up request first), with
    its launch counts; the layer_fuse request once more under
    torch.profiler; K7 alone with the operands of the ca_block request
    (check_request_k7); then one f32 request through the kernels and the plain
    versions on the same noise. Returns the launches of K6 (layer_fuse),
    K2b (ff_tail off) and K7 (ca_block, k/v cache off)."""
    cfg = DanceDecoderConfig(dancer_num=3)
    dcfg = DiffusionConfig()
    model = DanceDecoder(cfg, dtype=torch.bfloat16).init_random(torch.Generator().manual_seed(0))
    diff = GaussianDiffusion(model, dcfg)
    shape = (REQ_BATCH, cfg.tokens, cfg.nfeats)
    cond = torch.randn((REQ_BATCH, 2 * cfg.seq_len + 1, cfg.cond_feature_dim), generator=gen, device="cuda")
    x_0 = 0.1 * torch.randn((REQ_BATCH, cfg.tokens, 3), generator=gen, device="cuda")
    noise = {"init": torch.randn(shape, generator=gen, device="cuda"),
             "steps": torch.randn((dcfg.sampling_timesteps,) + shape, generator=gen, device="cuda")}
    launches = {}
    for label, kernels, want in BLOCK_CONFIGS:
        model.kernels, model.dtype = kernels, torch.bfloat16
        diff.ddim_sample(shape, cond, generator=gen, x_0=x_0)  # warm-up
        torch.cuda.synchronize()
        reset_serving_launches()
        bodies = bodies_since()
        t0 = time.perf_counter()
        out = diff.ddim_sample(shape, cond, generator=gen, x_0=x_0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: n for k, n in serving_launches().items() if n}
        bodies = bodies_since(bodies)
        check_output(out, x_0, shape)
        print(f"{label}: launches {counts} (expected {want})")
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        print(f"{label}: {seconds:.3f} s per request, {REQ_BATCH * CLIP_S / seconds:.2f} s-motion/s "
              f"(bf16 batch {REQ_BATCH}, kernels; {card})")
        if label == "layer_fuse":
            launches["layer"] = counts["layer"]
            print_profile(label, lambda: diff.ddim_sample(shape, cond, generator=gen, x_0=x_0))
        elif label == "ff_tail off":
            launches["ff_block"] = counts["ff_block"]
            check_bodies(label, bodies, {"ff_block": 2 * counts["ff_block"]})
            print_profile(label, lambda: diff.ddim_sample(shape, cond, generator=gen, x_0=x_0))
        elif label == "ff_tail off, ln_matmul":
            check_bodies(label, bodies, {"ff_block": 2 * counts["ff_block"], "ln_matmul": counts["ln_matmul"]})
        elif label == "ca_block, k/v cache off":
            launches["ca_block"] = counts["ca_block"]
            check_request_k7(model, lambda: diff.ddim_sample(shape, cond, generator=gen, x_0=x_0))

        model.dtype = torch.float32
        out_k = diff.ddim_sample(shape, cond, x_0=x_0, noise=noise)
        with plain_blocks(model):
            out_p = diff.ddim_sample(shape, cond, x_0=x_0, noise=noise)
        check_output(out_k, x_0, shape)
        err = (out_k - out_p).abs().max().item()
        print(f"{label}, f32, kernels vs plain on the same noise: max_abs_diff {err:.3e} (tol {F32_PATH_TOL:.0e})")
        check(err <= F32_PATH_TOL, f"{label}: f32 path disagrees: {err} > {F32_PATH_TOL}")
    del model, diff
    torch.cuda.empty_cache()
    return launches


def train_cases(gen: torch.Generator, dtype):
    """{name: (kernel, plain, args, indices of the differentiable args,
    keywords, fwd+bwd FLOPs)} at the main path's train shapes: b=64,
    L=450, Lm=152, d=512, so also its grids and split-row partials."""
    dev, b = "cuda", TRAIN_BATCH
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    w = lambda o, i: rnd(o, i, std=i**-0.5).to(dtype)
    ln = lambda: (1.0 + rnd(D, std=0.1), rnd(D, std=0.1))
    film = lambda: (rnd(b, D, std=0.1).to(dtype), rnd(b, D, std=0.1).to(dtype))
    seeds = lambda: torch.randint(0, 2**32, (b,), generator=gen, device=dev, dtype=torch.int64)
    M, Mm = b * L, b * LM
    sab = (rnd(b, L, D).to(dtype), *ln(), angle_table(L, D, dev), w(HD, D), w(HD, D), w(HD, D),
           w(D, HD), *ln(), *film(), seeds())
    cab = (rnd(b, L, D).to(dtype), rnd(b, LM, D).to(dtype), *ln(), angle_table(L, D, dev),
           angle_table(LM, D, dev), w(HD, D), w(HD, D), w(HD, D), w(D, HD), *ln(), *film(), seeds())
    ffb = (rnd(b, L, D).to(dtype), *ln(), w(FF, D), rnd(FF, std=0.1), w(D, FF), rnd(D, std=0.1),
           *film(), *ln(), w(D, D), rnd(D, std=0.1), seeds())
    attn = dict(nhead=H, rate=RATE)
    return {
        # forward: 8 M d hd of projections, 4 b L Lk hd of attention; the
        # backward twice both (input and weight gradients; dV, dP, dQ, dK)
        "sa_block_train": (sa_block_train.sa_block_train, sa_block_train.sa_block_train_plain, sab,
                           (0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11), attn,
                           24 * M * D * HD + 12 * b * L * L * HD),
        "ca_block_train": (ca_block_train.ca_block_train, ca_block_train.ca_block_train_plain, cab,
                           (0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 12, 13), attn,
                           12 * M * D * HD + 12 * Mm * D * HD + 12 * b * L * LM * HD),
        "ff_tail_train": (ff_block_train.ff_tail_train, ff_block_train.ff_tail_train_plain, ffb,
                          tuple(range(13)), dict(rate=RATE), 3 * (4 * M * D * FF + 2 * M * D * D)),
    }


def compare_train_kernels(gen: torch.Generator) -> dict:
    """Phase 6. Returns the bf16 figures of each train kernel."""
    figures = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = "bf16" if dtype == torch.bfloat16 else "f32"
        for name, (fn, plain, args, diff, kw, flops) in train_cases(gen, dtype).items():
            leaves = lambda: [a.detach().clone().requires_grad_(i in diff) if a.is_floating_point() else a
                              for i, a in enumerate(args)]
            lk, lp = leaves(), leaves()
            out = fn(*lk, **kw)
            ref = plain(*lp, **kw)
            cot = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
            grads = torch.autograd.grad(out, [lk[i] for i in diff], cot)
            grads_p = torch.autograd.grad(ref, [lp[i] for i in diff], cot)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = tolerance(dtype, ref.float())
            check(torch.isfinite(out).all().item(), f"{name} output not finite")
            check(err <= tol, f"{name} {dname} output disagrees: {err} > {tol}")
            worst = 0.0  # the largest gradient error as a share of its tolerance
            for i, g, gp in zip(diff, grads, grads_p):
                gerr = (g.float() - gp.float()).abs().max().item()
                gtol = grad_tolerance(dtype, gp.float())
                check(torch.isfinite(g).all().item(), f"{name} gradient {i} not finite")
                check(gerr <= gtol, f"{name} {dname} gradient of input {i} disagrees: {gerr} > {gtol}")
                worst = max(worst, gerr / gtol)
            diff_leaves = lambda ls: [ls[i] for i in diff]
            fwd_ms = time_ms(lambda: fn(*lk, **kw))
            plain_fwd_ms = time_ms(lambda: plain(*lp, **kw))
            ms = time_ms(lambda: torch.autograd.grad(fn(*lk, **kw), diff_leaves(lk), cot))
            plain_ms = time_ms(lambda: torch.autograd.grad(plain(*lp, **kw), diff_leaves(lp), cot))
            print(f"{name} {dname} rate {RATE}: output max_abs_err {err:.3e} (tol {tol:.3e}), every "
                  f"gradient within tolerance (largest error {worst:.3f} of its tolerance); "
                  f"fwd kernel {fwd_ms:.3f} ms plain {plain_fwd_ms:.3f} ms; "
                  f"fwd+bwd kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
            if dtype == torch.bfloat16:
                io = nbytes(*args, out, cot, *grads)  # inputs + cotangent read, output + gradients written
                dev_ms = device_ms(lambda: torch.autograd.grad(fn(*lk, **kw), diff_leaves(lk), cot), reps=5)
                print(f"{name} bf16: fwd+bwd device {dev_ms:.3f} ms a call (5 calls queued back to back)")
                figures[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound(flops, io),
                                     library_ms=None, fwd_ms=fwd_ms, plain_fwd_ms=plain_fwd_ms,
                                     grad_err_share_of_tol=worst, device_ms=dev_ms)
    return figures


def compare_train_attention(gen: torch.Generator) -> dict:
    """Phase 6b: the train blocks' attention alone, forward + backward, at
    the train shapes (b=64, 8x64 heads; K3's 450x450, K4's 450x152), bf16,
    dropout 0.1: held against the plain chain (the output and the gradients
    of q, k and v, each within 2^-5 of its largest value), a second
    backward on the same inputs bit for bit, and timed beside
    F.scaled_dot_product_attention forward + backward at rate 0 (a
    yardstick only: the port never calls it). Returns extra figures for
    K3 and K4."""
    dev, b, dk = "cuda", TRAIN_BATCH, HD // H
    bf16 = torch.bfloat16
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(bf16)
    figures = {}
    for name, lk in (("sa_block_train", L), ("ca_block_train", LM)):
        q, k, v, cot = rnd(b, L, HD), rnd(b, lk, HD), rnd(b, lk, HD), rnd(b, L, HD)
        seeds = torch.randint(0, 2**32, (b,), generator=gen, device=dev, dtype=torch.int64)
        leaves, leaves_p = ([t.clone().requires_grad_() for t in (q, k, v)] for _ in range(2))
        fn = lambda: sa_block_train.attention_train(*leaves, seeds, nhead=H, rate=RATE)
        plain = lambda: sa_block_train.attention_plain(*leaves_p, seeds, H, RATE)
        out, ref = fn(), plain()
        grads = torch.autograd.grad(out, leaves, cot)
        grads_p = torch.autograd.grad(ref, leaves_p, cot)
        again = torch.autograd.grad(fn(), leaves, cot)
        torch.cuda.synchronize()
        label = f"train attention {L}x{lk} bf16 rate {RATE}"
        errs = []
        for what, x, r in (("output", out, ref), *((f"d{c}", g, gp) for c, g, gp in zip("qkv", grads, grads_p))):
            err, tol = (x.float() - r.float()).abs().max().item(), 2.0**-5 * r.float().abs().max().item()
            check(torch.isfinite(x).all().item(), f"{label}: {what} not finite")
            check(err <= tol, f"{label}: {what} disagrees: {err} > {tol}")
            errs.append(f"{what} {err:.3e} (tol {tol:.3e})")
        check(all(torch.equal(g, g2) for g, g2 in zip(grads, again)), f"{label}: two backward runs differ")
        fwd_ms = time_ms(fn)
        ms = time_ms(lambda: torch.autograd.grad(fn(), leaves, cot))
        plain_ms = time_ms(lambda: torch.autograd.grad(plain(), leaves_p, cot))
        heads = lambda t: t.view(b, t.shape[1], H, dk).transpose(1, 2)
        ls = [t.clone().requires_grad_() for t in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(*(heads(t) for t in ls))
        sdpa_fwd_ms = time_ms(sdpa)
        sdpa_ms = time_ms(lambda: torch.autograd.grad(sdpa(), ls, heads(cot)))
        flops = 12 * b * L * lk * HD  # forward q.k, p.v; backward dv, dp, dq, dk
        print(f"{label}: max_abs_err {', '.join(errs)}; backward repeats bit for bit; fwd {fwd_ms:.3f} ms "
              f"(SDPA rate 0 {sdpa_fwd_ms:.3f}); fwd+bwd {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain "
              f"{plain_ms:.3f} ms, SDPA rate 0 {sdpa_ms:.3f} ms ({flops / sdpa_ms / 1e9:.1f} TFLOP/s; "
              f"kernel / SDPA {ms / sdpa_ms:.2f})")
        figures[name] = dict(attention_fwd_ms=fwd_ms, attention_ms=ms, attention_plain_ms=plain_ms,
                             attention_sdpa_fwd_ms=sdpa_fwd_ms, attention_sdpa_ms=sdpa_ms,
                             **{f"attention_{key}": val for key, val in bound(flops, nbytes(q, k, v, cot, out, *grads)).items()})
        del out, ref, grads, grads_p, again, leaves, leaves_p, ls
        torch.cuda.empty_cache()
    return figures


def compare_backward_gemms(gen: torch.Generator) -> dict:
    """Phase 6c: K5's and K3's backward products alone at the train shape
    (M = b L = 28800 rows, d = hd = 512, ff = 1024), bf16, through
    ops/gemm.py (the code K3-K5 run): each held against its plain version,
    its device time (calls queued back to back; a weight gradient with its
    ordered reduction, whose own device time comes from torch.profiler) and
    TFLOP/s beside its bound and torch.matmul's time on the same operands
    (a yardstick only); each weight gradient run twice, bit for bit.
    Returns {kernel: {product: figures}}."""
    dev, M = "cuda", TRAIN_BATCH * L
    bf16 = torch.bfloat16
    rnd = lambda *shape, std=1.0: (torch.randn(shape, generator=gen, device=dev) * std).to(bf16)
    w = lambda o, i: rnd(o, i, std=i**-0.5)
    g, dz, y4, y, dq, dk, dv, o, r = (rnd(M, D) for _ in range(9))
    du, ad = rnd(M, FF), rnd(M, FF)
    w1, w2, w3, wq, wk, wv, wfc = w(FF, D), w(D, FF), w(D, D), w(HD, D), w(HD, D), w(HD, D), w(D, HD)
    f32, bf = 4, 2  # output bytes per element

    def nn(a, b, epi, out_el):
        """An input gradient a . b: (the port's call, its plain version,
        (M, N, K), input bytes, output bytes, the library's call)."""
        joined = isinstance(a, list)
        a_cat, b_cat = (torch.cat(a, 1), torch.cat(b, 0)) if joined else (a, b)  # the library's operands
        return (lambda: gemm.gemm_nn(a, b, epi), lambda: gemm.gemm_nn_plain(a, b, epi),
                (M, b_cat.shape[1], a_cat.shape[1]), nbytes(*(a if joined else [a]), *(b if joined else [b])),
                M * b_cat.shape[1] * out_el, lambda: torch.matmul(a_cat, b_cat))

    def wg(a, x):
        """A weight gradient a^T . x over the M rows, as nn gives its parts."""
        return (lambda: gemm.wgrad(a, x), lambda: gemm.wgrad_plain(a, x), (a.shape[1], x.shape[1], M),
                nbytes(a, x), a.shape[1] * x.shape[1] * bf, lambda: torch.matmul(a.t(), x))

    cases = (
        ("ff_tail_train", "dy4 = g.W3", nn(g, w3, "store_f32", f32)),
        ("ff_tail_train", "dad = dz.W2", nn(dz, w2, "store_f32", f32)),
        ("ff_tail_train", "dy = du.W1", nn(du, w1, "store_f32", f32)),
        ("ff_tail_train", "dW3", wg(g, y4)),
        ("ff_tail_train", "dW2", wg(dz, ad)),
        ("ff_tail_train", "dW1", wg(du, y)),
        ("sa_block_train", "dO = dz.Wfc", nn(dz, wfc, "store", bf)),
        ("sa_block_train", "dr = dq.Wq + dk.Wk", nn([dq, dk], [wq, wk], "store_f32", f32)),
        ("sa_block_train", "dyv = dv.Wv", nn(dv, wv, "store_f32", f32)),
        ("sa_block_train", "dWfc", wg(dz, o)),
        ("sa_block_train", "dWq", wg(dq, r)),
        ("sa_block_train", "dWk", wg(dk, r)),
        ("sa_block_train", "dWv", wg(dv, y)),
    )
    figures = collections.defaultdict(dict)
    for kernel, label, (fn, plain, (m, n, k), in_bytes, out_bytes, library) in cases:
        is_wgrad = label.startswith("dW")
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tolerance(bf16, ref.float())
        check(torch.isfinite(out).all().item(), f"backward GEMM {label} output not finite")
        check(err <= tol, f"backward GEMM {label} disagrees: {err} > {tol}")
        check(not is_wgrad or torch.equal(out, fn()), f"backward GEMM {label}: two runs differ")
        flops = 2 * m * n * k
        ms, lib_ms = device_ms(fn), device_ms(library)
        b = bound(flops, in_bytes + out_bytes)
        chunks = f", {weight_splits(k, m, n)} row chunks and their ordered reduction" if is_wgrad else ""
        print(f"backward GEMM {label} {m}x{n}x{k} bf16{chunks}: max_abs_err {err:.3e} (tol {tol:.3e}) kernel "
              f"{1e3 * ms:.1f} us ({flops / ms / 1e9:.1f} TFLOP/s), bound {1e3 * b['bound_ms']:.1f} us "
              f"({b['bound_by']}), torch.matmul {1e3 * lib_ms:.1f} us ({flops / lib_ms / 1e9:.1f} TFLOP/s)")
        figures[kernel][label] = dict(shape=[m, n, k], max_abs_err=err, ms=ms, tflops=flops / ms / 1e9,
                                      library_ms=lib_ms, **b)
    # the reductions alone: one wgrad call each under the profiler, in order
    wgrads = [(kernel, label, parts[0]) for kernel, label, parts in cases if label.startswith("dW")]
    _, events = device_kernels(lambda: [fn() for _, _, fn in wgrads],
                               accept=lambda ks: sum("reduce_kernel" in n for n, _, _ in ks) == len(wgrads))
    reds = [(end - start) / 1e3 for name, start, end in events if "reduce_kernel" in name]
    check(len(reds) == len(wgrads), f"expected {len(wgrads)} reductions in the profile, saw {len(reds)}")
    for (kernel, label, _), red_ms in zip(wgrads, reds):
        figures[kernel][label]["reduce_ms"] = red_ms
    print("the ordered reductions alone (torch.profiler, one call each): "
          + ", ".join(f"{label} {1e3 * red_ms:.1f} us" for (_, label, _), red_ms in zip(wgrads, reds)))
    return figures


def kernel_us(fn, part: str, reps: int = 10) -> float:
    """The median device time in us of the kernels whose name holds `part`
    over `reps` calls of fn() under torch.profiler (each kernel's own
    interval: its time alone, without the wrapper's other launches). Two
    more calls run than the median needs, and the reading is taken again
    (10 times at most) while it holds fewer: the profiler now and then
    drops events on the card (device_kernels)."""
    fn()
    torch.cuda.synchronize()
    _, events = device_kernels(lambda: [fn() for _ in range(reps + 2)],
                               accept=lambda ks: sum(part in n for n, _, _ in ks) >= reps, attempts=10)
    times = [end - start for name, start, end in events if part in name]
    check(len(times) >= reps, f"the profiler saw {len(times)} launches of {part}, expected {reps} at least")
    return statistics.median(times)


def compare_new_bodies(gen: torch.Generator) -> dict:
    """Phase 6d: the bodies K4 and K7 were redesigned around, alone, bf16,
    through their test entries (ops/train_common.py, ops/gemm.py): the
    three train row kernels at the train rows (28800 x 512, rate 0.1, the
    forms K4 launches), each held against its plain version, its device
    time from torch.profiler (the kernel alone, without the partials'
    reductions the entry adds), GB/s and share of its byte bound; then
    K4's memory cotangent (9728 x 512, two products of K = 512 and rot^T
    between them) and K7's q projection with the LayerNorm and rotary in
    its prologue (3600 x 512 x 512), each held against its plain version
    and timed (calls queued back to back) beside torch.matmul of the same
    products (a yardstick only). Returns {kernel: {body: figures}}."""
    dev, bf16, b = "cuda", torch.bfloat16, TRAIN_BATCH
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    seeds = torch.randint(0, 2**32, (b,), generator=gen, device=dev, dtype=torch.int64)
    s, bias = 1.0 + rnd(D, std=0.1), rnd(D, std=0.1)
    fs, fb = rnd(b, D, std=0.1), rnd(b, D, std=0.1)
    z, x, g, dr = rnd(b, L, D), rnd(b, L, D).to(bf16), rnd(b, L, D).to(bf16), rnd(b, L, D)
    angles = angle_table(L, D, dev)
    nch = -(-L // train_common.RCH)
    part_bytes = lambda n: 4 * n * b * nch * D  # the f32 chunk partials of n parameter gradients, written
    tables = 2 * L * D * 2
    cases = (  # (label, kernel name, the entry, its plain version, its inputs' bytes, the design's scratch bytes)
        ("chain_top_fwd", "chain_top_fwd_kernel",
         lambda: train_common.chain_top_fwd(z, x, s, bias, fs, fb, seeds, rate=RATE),
         lambda: train_common.chain_top_fwd_plain(z, x, s, bias, fs, fb, seeds, rate=RATE),
         nbytes(z, x, s, bias, fs, fb, seeds), 0),
        ("chain_top_bwd", "chain_top_bwd_kernel",
         lambda: train_common.chain_top_bwd(g, z, s, bias, fs, seeds, rate=RATE),
         lambda: train_common.chain_top_bwd_plain(g, z, s, bias, fs, seeds, rate=RATE),
         nbytes(g, z, s, bias, fs, seeds), part_bytes(4)),
        ("rows_bwd (x side)", "rows_bwd_kernel",
         lambda: train_common.rows_bwd(dr, x, s, 1e-5, angles=angles, resid=g),
         lambda: train_common.rows_bwd_plain(dr, x, s, 1e-5, angles=angles, resid=g),
         nbytes(dr, x, s, g) + tables, part_bytes(2)),
    )
    figures = collections.defaultdict(dict)
    for label, name, fn, plain, in_bytes, scratch in cases:
        outs, refs = fn(), plain()
        outs, refs = (outs, refs) if isinstance(outs, tuple) else ((outs,), (refs,))
        io = in_bytes + nbytes(*outs)  # each input read once, each output written once
        torch.cuda.synchronize()
        err = 0.0
        for o, r in zip(outs, refs):
            if r is None:
                continue
            e, tol = (o.float() - r.float()).abs().max().item(), grad_tolerance(bf16, r.float())
            check(torch.isfinite(o).all().item(), f"{label}: output not finite")
            check(e <= tol, f"{label} disagrees with its plain version: {e} > {tol}")
            err = max(err, e)
        us = kernel_us(fn, name)
        bnd = bound(0, io)
        print(f"train row kernel {label} {b * L}x{D} bf16 rate {RATE}: max_abs_err {err:.3e}; device {us:.1f} us "
              f"alone ({io / us / 1e3:.0f} GB/s, {1e3 * bnd['bound_ms'] / us:.3f} of the byte bound "
              f"{1e3 * bnd['bound_ms']:.1f} us; its chunk partials, outside the bound, {scratch / 1e6:.1f} MB more)")
        figures["ca_block_train"][label] = dict(device_us=us, gb_s=io / us / 1e3, scratch_bytes=scratch,
                                                bound_share=1e3 * bnd["bound_ms"] / us, max_abs_err=err, **bnd)

    # K4's memory cotangent and K7's q projection
    w = lambda o, i: rnd(o, i, std=i**-0.5).to(bf16)
    mm = b * LM
    dk, dv, wk, wv = rnd(mm, HD).to(bf16), rnd(mm, HD).to(bf16), w(HD, D), w(HD, D)
    am = angle_table(LM, D, dev)
    xs, s1, b1, wq = rnd(B, L, D).to(bf16), 1.0 + rnd(D, std=0.1), rnd(D, std=0.1), w(HD, D)
    dkv, wkv = torch.cat((dk, dv), 1), torch.cat((wk, wv), 0)  # the library's operands
    bodies = (
        ("ca_block_train", "dmem = rot_m^T(dk.Wk) + dv.Wv", (mm, D, 2 * HD),
         lambda: gemm.gemm_nn_rot(dk, wk, dv, wv, am), lambda: gemm.gemm_nn_rot_plain(dk, wk, dv, wv, am),
         nbytes(dk, dv, wk, wv) + 2 * LM * D * 2 + mm * D * 2, lambda: torch.matmul(dkv, wkv)),
        ("ca_block", "q = rot(LN(x)).Wq", (B * L, HD, D),
         lambda: gemm.gemm_lnrot(xs, s1, b1, angles, wq), lambda: gemm.gemm_lnrot_plain(xs, s1, b1, angles, wq),
         nbytes(xs, s1, b1, wq) + tables + B * L * HD * 2, lambda: torch.matmul(xs, wq.t())),
    )
    for kernel, label, (m, n, k), fn, plain, io, library in bodies:
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        err, tol = (out.float() - ref.float()).abs().max().item(), tolerance(bf16, ref.float())
        check(torch.isfinite(out).all().item(), f"{label}: output not finite")
        check(err <= tol, f"{label} disagrees with its plain version: {err} > {tol}")
        flops = 2 * m * n * k
        ms, lib_ms = device_ms(fn), device_ms(library)
        bnd = bound(flops, io)
        print(f"{label} {m}x{n}x{k} bf16: max_abs_err {err:.3e} (tol {tol:.3e}) kernel {1e3 * ms:.1f} us "
              f"({flops / ms / 1e9:.1f} TFLOP/s), bound {1e3 * bnd['bound_ms']:.1f} us ({bnd['bound_by']}), "
              f"torch.matmul of the same products {1e3 * lib_ms:.1f} us")
        figures[kernel][label] = dict(shape=[m, n, k], max_abs_err=err, ms=ms, tflops=flops / ms / 1e9,
                                      library_ms=lib_ms, **bnd)
    return figures


def register_counts(lib: str, part: str) -> dict:
    """{kernel: registers} of the kernels of csrc/<lib>.cu whose name holds
    `part`, from cuobjdump -res-usage on the built library ({} where the
    toolkit has no cuobjdump)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        res = subprocess.run([tool, "-res-usage", str(_build._target(lib))], capture_output=True, text=True,
                             timeout=120)
    except (OSError, subprocess.SubprocessError):
        return {}
    regs, name = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and name and part in name:
            regs[name] = int(m.group(1))
    return regs


def check_k7_kernels(fn, what: str) -> int:
    """One bf16 K7 call fn() under torch.profiler: 4 device kernels, each a
    hand-written one (the wrapper casts and builds nothing), q the
    LayerNorm-prologue launch. Returns the count."""
    fn()  # the tables' first call builds them
    torch.cuda.synchronize()
    # on the card the profiler drops the events at a session's start
    # (device_kernels' lead-in takes that loss)
    _, kernels = device_kernels(fn, accept=lambda ks: len(ks) == 4, attempts=10)
    print(f"K7 ca_block bf16 {what}: {len(kernels)} device kernels a call: "
          + ", ".join(f"{n.replace('tcd::', '')} {e - s:.1f} us" for n, s, e in kernels))
    check(len(kernels) == 4, f"K7 ({what}) ran {len(kernels)} device kernels, expected 4")
    check(all("tcd::" in n for n, _, _ in kernels), f"K7's call ({what}) ran a PyTorch kernel")
    check(sum("gemm_lnrot_kernel" in n for n, _, _ in kernels) == 1, "K7's q is not the LayerNorm-prologue launch")
    return len(kernels)


def profile_k4_k7(gen: torch.Generator) -> dict:
    """Phase 6e: one bf16 K4 call at the train shape under torch.profiler,
    forward alone and forward + backward, listed by device kernel: 7
    launches forward and 20 backward, the memory side's rotary the row
    body with the LayerNorm off, dmem the one rot^T product, no memory-side
    rows_bwd and no rot_rows kernel; the attention's share of its device
    time at rate 0 and 0.1, and its kernels' registers (cuobjdump). Then
    one bf16 K7 call at the serving shape: 4 device kernels, each a
    hand-written one (no PyTorch kernel). Returns extra figures for K4 and
    K7."""
    figures = {}
    for rate in (RATE, 0.0):
        bf16 = torch.bfloat16
        fn, _, args, diff, kw, _ = train_cases(gen, bf16)["ca_block_train"]
        kw = dict(kw, rate=rate)
        args = tuple(a.float() if a.dim() == 2 and a.shape[0] == TRAIN_BATCH and a.is_floating_point() else a
                     for a in args)  # FiLM rows in f32, as the kernel takes them
        leaves = [a.detach().clone().requires_grad_(i in diff) if a.is_floating_point() else a
                  for i, a in enumerate(args)]
        out = fn(*leaves, **kw)
        cot = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
        step = lambda: torch.autograd.grad(fn(*leaves, **kw), [leaves[i] for i in diff], cot)
        step()
        torch.cuda.synchronize()
        ours = lambda ks: [k for k in ks if "tcd::" in k[0]]  # the wrapper's seed conversion runs PyTorch kernels
        _, fwd_all = device_kernels(lambda: fn(*leaves, **kw), accept=lambda ks: len(ours(ks)) == 7)
        _, both_all = device_kernels(step, accept=lambda ks: len(ours(ks)) == 27)
        fwd, both = ours(fwd_all), ours(both_all)
        bwd = both[len(fwd):]
        total = sum(e - s for _, s, e in both)
        attn = sum(e - s for n, s, e in both if "attn" in n)
        label = f"K4 ca_block_train bf16 rate {rate}"
        print(f"{label}: one fwd+bwd call, {len(fwd)} launches forward and {len(bwd)} backward, {total:.0f} us of "
              f"kernels, the attention {attn:.0f} us ({attn / total:.3f}); PyTorch kernels beside them "
              f"{len(both_all) - len(both)}")
        if rate == RATE:
            for part, events in (("forward", fwd), ("backward", bwd)):
                print(f"  {part}: " + ", ".join(f"{n.replace('tcd::', '')} {e - s:.1f}" for n, s, e in events))
            names = collections.Counter(n for n, _, _ in bwd)
            check(len(fwd) == 7, f"K4 made {len(fwd)} launches forward, expected 7")
            check(len(bwd) == 20, f"K4 made {len(bwd)} launches backward, expected 20")
            check(not any("rot_rows" in n for n, _, _ in both), "K4 still runs a rot_rows kernel")
            check(sum("ln_rows_kernel" in n and "false" in n for n, _, _ in fwd) == 1,
                  "K4's memory rotary is not the row body with the LayerNorm off")
            check(calls(names, "rows_bwd_kernel") == 1, f"K4's backward runs {calls(names, 'rows_bwd_kernel')} "
                  "rows_bwd kernels; the memory side's should be gone")
            check(calls(names, "gemm_rot_nn_kernel") == 1, "K4's dmem is not the one rot^T product")
            regs = register_counts("ca_block_train", "attn")
            print(f"  the attention kernels' registers (cuobjdump -res-usage): {regs or 'not measured'}")
            figures.update(profile_fwd_launches=len(fwd), profile_bwd_launches=len(bwd), attention_regs=regs)
        figures[f"attention_share_rate_{rate}"] = attn / total
        figures[f"kernel_us_rate_{rate}"] = total
        del out, leaves
        torch.cuda.empty_cache()

    # K7: one bf16 call (FiLM rows in f32, as the kernel takes them)
    dev = "cuda"
    rnd = lambda *shape, std=1.0: torch.randn(shape, generator=gen, device=dev) * std
    w = lambda o, i: rnd(o, i, std=i**-0.5).to(torch.bfloat16)
    mem = rnd(B, LM, D).to(torch.bfloat16)
    args = (rnd(B, L, D).to(torch.bfloat16), 1.0 + rnd(D, std=0.1), rnd(D, std=0.1), angle_table(L, D, dev), mem,
            apply_rotary(mem, angle_table(LM, D, dev)), w(HD, D), w(HD, D), w(HD, D), w(D, HD),
            1.0 + rnd(D, std=0.1), rnd(D, std=0.1), rnd(B, D, std=0.1), rnd(B, D, std=0.1))
    n = check_k7_kernels(lambda: ca_block.ca_block(*args, nhead=H), "film=True, operands in the kernel's dtypes")
    return {"ca_block_train": figures, "ca_block": {"device_kernels_film": n}}


def check_output(out: torch.Tensor, x_0: torch.Tensor, shape) -> None:
    check(tuple(out.shape) == tuple(shape), f"output shape {tuple(out.shape)} != {shape}")
    check(torch.isfinite(out).all().item(), "output not finite")
    check(torch.equal(out[..., 4:6], x_0[..., :2]), "XY channels differ from the trajectory")
    rest = torch.cat([out[..., :4], out[..., 6:]], dim=-1)
    check(rest.abs().max().item() <= 1.0, "a channel left [-1, 1]")


def serve(gen: torch.Generator) -> dict:
    """Phase 7: the serving path through ddim_sample."""
    cfg = DanceDecoderConfig(dancer_num=3)
    dcfg = DiffusionConfig()
    model = DanceDecoder(cfg, dtype=torch.bfloat16).init_random(torch.Generator().manual_seed(0))
    diff = GaussianDiffusion(model, dcfg)
    shape = (REQ_BATCH, cfg.tokens, cfg.nfeats)
    reqs = [
        (torch.randn((REQ_BATCH, 2 * cfg.seq_len + 1, cfg.cond_feature_dim), generator=gen, device="cuda"),
         0.1 * torch.randn((REQ_BATCH, cfg.tokens, 3), generator=gen, device="cuda"))
        for _ in range(REQUESTS)
    ]
    diff.ddim_sample(shape, reqs[0][0], generator=gen, x_0=reqs[0][1])  # warm-up
    torch.cuda.synchronize()

    reset_serving_launches()
    attn = attention.attn_body_launches("sa_block")
    t0 = time.perf_counter()
    outs = [diff.ddim_sample(shape, cond, generator=gen, x_0=x_0) for cond, x_0 in reqs]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: n for name, n in serving_launches().items() if n}
    attn = {k: n - attn[k] for k, n in attention.attn_body_launches("sa_block").items()}

    for out, (_, x_0) in zip(outs, reqs):
        check_output(out, x_0, shape)
    want = cfg.num_layers * dcfg.sampling_timesteps * REQUESTS
    print(f"main path: {REQUESTS} requests of batch {REQ_BATCH}, bf16: launches {launches} "
          f"(expected {want} each of {', '.join(DEFAULT_SITES)})")
    check(launches == dict.fromkeys(DEFAULT_SITES, want), f"main path launches {launches}, expected {want} each of "
          f"{DEFAULT_SITES}")
    print(f"main path: K1's attention by body {attn} (expected all {want} on wgmma)")
    check(attn == {"mma.sync": 0, "wgmma": want}, f"main path: K1's attention ran on {attn}")
    per_req = seconds / REQUESTS
    motion = REQUESTS * REQ_BATCH * CLIP_S
    print(f"main path: {per_req:.3f} s per request, {motion / seconds:.2f} s-motion/s (bf16, kernels)")
    table = print_profile("default path, one request",
                          lambda: diff.ddim_sample(shape, reqs[0][0], generator=gen, x_0=reqs[0][1]))
    check(any("gemm_wg_kernel" in name for name, _, _ in table), "no wgmma projection in the request")
    check(any("gemm_wg_ln_kernel" in name for name, _, _ in table), "no wgmma LayerNorm fold in the request")
    old = [name for name, _, _ in table if "gemm_mma_kernel" in name or "gemm_ln_kernel" in name]
    check(not old, f"the default request ran the mma.sync body: {old}")
    fma_nt = [name for name, _, _ in table if "gemm_kernel<bf16, false, true" in name]
    check(not fma_nt, f"bf16 projections ran on the FMA body: {fma_nt}")

    # the FiLM residual outside K1 (fuse_film off, the JAX package's
    # default) against inside (as every request ran before the flag
    # existed), in turns: off, on, on, off
    film_s = {False: [], True: []}
    for fuse in (False, True, True, False):
        model.kernels = ServingKernels(fuse_film=fuse)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diff.ddim_sample(shape, reqs[0][0], generator=gen, x_0=reqs[0][1])
        torch.cuda.synchronize()
        film_s[fuse].append(time.perf_counter() - t0)
    model.kernels = ServingKernels()
    print(f"default path, s per request in turns off/on/on/off: FiLM outside K1 (fuse_film off) "
          f"{film_s[False][0]:.3f} / {film_s[False][1]:.3f}, inside (fuse_film on) "
          f"{film_s[True][0]:.3f} / {film_s[True][1]:.3f} (bf16 batch {REQ_BATCH})")

    with plain_blocks(model):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diff.ddim_sample(shape, reqs[0][0], generator=gen, x_0=reqs[0][1])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    print(f"plain blocks: {plain_s:.3f} s per request, {REQ_BATCH * CLIP_S / plain_s:.2f} s-motion/s (bf16)")

    # f32, same injected noise: kernels against plain versions, whole path
    model.dtype = torch.float32
    cond, x_0 = reqs[0]
    noise = {"init": torch.randn(shape, generator=gen, device="cuda"),
             "steps": torch.randn((dcfg.sampling_timesteps,) + shape, generator=gen, device="cuda")}
    out_k = diff.ddim_sample(shape, cond, x_0=x_0, noise=noise)
    with plain_blocks(model):
        out_p = diff.ddim_sample(shape, cond, x_0=x_0, noise=noise)
    check_output(out_k, x_0, shape)
    err = (out_k - out_p).abs().max().item()
    print(f"f32 path, kernels vs plain on the same noise: max_abs_diff {err:.3e} (tol {F32_PATH_TOL:.0e})")
    check(err <= F32_PATH_TOL, f"f32 path disagrees: {err} > {F32_PATH_TOL}")

    # one bf16 CFG denoiser forward (one doubled-batch call, as every
    # sampling step makes it): kernels against plain versions
    model.dtype = torch.bfloat16
    x = torch.randn(shape, generator=gen, device="cuda")
    t_vec = torch.full((REQ_BATCH,), 500, device="cuda", dtype=torch.int32)
    out_k = diff.guided(x, cond, t_vec, 2.0, cond_cache=diff.encode_cond_cfg(cond))
    with plain_blocks(model):
        out_p = diff.guided(x, cond, t_vec, 2.0, cond_cache=diff.encode_cond_cfg(cond))
    err, tol = (out_k - out_p).abs().max().item(), 2.0**-5 * out_p.abs().max().item()
    print(f"bf16 CFG denoiser forward (batch {REQ_BATCH}, doubled to {2 * REQ_BATCH}), kernels vs plain: "
          f"max_abs_diff {err:.3e} (tol {tol:.3e}, 2^-5 of the largest output {out_p.abs().max().item():.3f})")
    check(torch.isfinite(out_k).all().item() and tuple(out_k.shape) == shape, "CFG forward output malformed")
    check(err <= tol, f"bf16 CFG denoiser forward disagrees: {err} > {tol}")
    return launches


def reset_serving_launches() -> None:
    for fn in (*SERVING_BLOCKS.values(), *SERVING_OPS.values()):
        fn.launches = 0


def serve_per_op(gen: torch.Generator) -> dict:
    """Phase 8: the per-op serving configuration. Returns the launches of
    K8-K11 in the long-form request."""
    cfg = DanceDecoderConfig(dancer_num=3)
    dcfg = DiffusionConfig()
    steps, layers = dcfg.sampling_timesteps, cfg.num_layers
    model = DanceDecoder(cfg, dtype=torch.bfloat16, kernels=ServingKernels.per_op(attention=1))
    model.init_random(torch.Generator().manual_seed(0))
    diff = GaussianDiffusion(model, dcfg)
    shape = (REQ_BATCH, cfg.tokens, cfg.nfeats)  # 4 consecutive slices of one song
    cond = torch.randn((REQ_BATCH, 2 * cfg.seq_len + 1, cfg.cond_feature_dim), generator=gen, device="cuda")
    x_0 = 0.1 * torch.randn((REQ_BATCH, cfg.tokens, 3), generator=gen, device="cuda")
    diff.long_ddim_sample(shape, cond, generator=gen, x_0=x_0)  # warm-up
    torch.cuda.synchronize()

    reset_serving_launches()
    bodies = bodies_since()
    maps = {lib: gemm.tma_stats(lib) for lib in ("ln_rotary_matmul", "ln_matmul")}
    t0 = time.perf_counter()
    out = diff.long_ddim_sample(shape, cond, generator=gen, x_0=x_0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in SERVING_OPS.items()}
    bodies = bodies_since(bodies)
    for lib, was in maps.items():
        now = gemm.tma_stats(lib)
        print(f"per-op path: {WG_LIBS[lib]}'s tensor maps in the request: {now['lookups'] - was['lookups']} "
              f"lookups, {now['encodes'] - was['encodes']} encodes, {now['us'] - was['us']:.0f} host us")
    check_output(out, x_0, shape)
    # per step: K8 once a layer (self-attention; the cached cross-attention
    # query is plain), K9 twice, K10 twice (self and cross post-LN), K11
    # twice; K11 also in the cond encoder's 2 layers, once a request
    want = {"ln_rotary_matmul": layers * steps, "ln_matmul": 2 * layers * steps,
            "layernorm": 2 * layers * steps, "attention": 2 * layers * steps + 2}
    print(f"per-op path: long_ddim_sample over {REQ_BATCH} slices, bf16: launches {launches} (expected {want}); "
          f"K1/K2 {sa_block.sa_block.launches}/{ff_block.ff_tail.launches} (expected 0)")
    check(launches == want, f"per-op launches {launches}, expected {want}")
    check_bodies("per-op path", bodies, {k: want[k] for k in ("ln_rotary_matmul", "ln_matmul")})
    check(sa_block.sa_block.launches == 0 and ff_block.ff_tail.launches == 0, "a block kernel ran in the per-op path")
    print(f"per-op path: {seconds:.3f} s per request, {REQ_BATCH * CLIP_S / seconds:.2f} s-motion/s "
          f"(slices x 5 s; bf16, kernels)")
    print_profile("per-op path", lambda: diff.long_ddim_sample(shape, cond, generator=gen, x_0=x_0))

    # f32, kernels against plain versions on the same noise: with a
    # trj_dist (K11's TRPE form), then with the k/v cache off (K8's rot-only
    # form on the cross-attention query, all-heads attention)
    model.dtype = torch.float32
    noise = {"init": torch.randn(shape, generator=gen, device="cuda"),
             "steps": torch.randn((steps,) + shape, generator=gen, device="cuda")}
    dist = torch.randint(0, 10, (REQ_BATCH, cfg.tokens, cfg.tokens), generator=gen, device="cuda")
    for label, kernels, trj_dist, k8 in (
            ("TRPE, k/v cache", ServingKernels.per_op(attention=1), dist, layers * steps),
            ("k/v cache off, all heads", ServingKernels.per_op(attention=2, kv_cache=False), None, 2 * layers * steps)):
        model.kernels = kernels
        reset_serving_launches()
        out_k = diff.ddim_sample(shape, cond, x_0=x_0, noise=noise, trj_dist=trj_dist)
        n8 = ln_rotary_matmul.ln_rotary_matmul.launches
        with plain_blocks(model):
            out_p = diff.ddim_sample(shape, cond, x_0=x_0, noise=noise, trj_dist=trj_dist)
        check_output(out_k, x_0, shape)
        err = (out_k - out_p).abs().max().item()
        print(f"per-op f32 path ({label}), kernels vs plain on the same noise: max_abs_diff {err:.3e} "
              f"(tol {F32_PATH_TOL:.0e}); K8 launches {n8} (expected {k8})")
        check(err <= F32_PATH_TOL, f"per-op f32 path ({label}) disagrees: {err} > {F32_PATH_TOL}")
        check(n8 == k8, f"K8 launched {n8} times in the f32 request ({label}), expected {k8}")
    del model, diff
    torch.cuda.empty_cache()
    return launches


def other_samplers(gen: torch.Generator) -> None:
    """Phase 9: the other samplers once each, default configuration, bf16."""
    cfg = DanceDecoderConfig(dancer_num=3)
    dcfg = DiffusionConfig()
    model = DanceDecoder(cfg, dtype=torch.bfloat16).init_random(torch.Generator().manual_seed(0))
    diff = GaussianDiffusion(model, dcfg)
    shape = (REQ_BATCH, cfg.tokens, cfg.nfeats)
    half = cfg.seq_len // 2
    conds = torch.randn((2, REQ_BATCH, 2 * cfg.seq_len + 1, cfg.cond_feature_dim), generator=gen, device="cuda")
    x_0 = 0.1 * torch.randn((REQ_BATCH, cfg.tokens, 3), generator=gen, device="cuda")
    t0 = time.perf_counter()

    # footwork: a reference motion (XY trajectory in its channels 0, 1)
    ref = (0.5 * torch.randn(shape, generator=gen, device="cuda")).clamp(-1, 1)
    check_output(diff.ddim_sample_footwork(shape, conds[0], generator=gen, x_0=ref), ref, shape)

    # streaming, two slices: the second's first half-window is the first's tail
    first = diff.ddim_sample_stream(shape, conds[0], generator=gen, x_0=x_0)
    tail = first.reshape(REQ_BATCH, cfg.seq_len, -1, cfg.nfeats)[:, half:].reshape(REQ_BATCH, -1, cfg.nfeats)
    second = diff.ddim_sample_stream(shape, conds[1], generator=gen, x_0=x_0, prev_tail=tail)
    for out in (first, second):
        check_output(out, x_0, shape)
    head = second.reshape(REQ_BATCH, cfg.seq_len, -1, cfg.nfeats)[:, :half, :, 6:]
    check(torch.equal(head, tail.reshape(REQ_BATCH, half, -1, cfg.nfeats)[..., 6:]),
          "the second stream slice does not start with the first one's tail")

    # forecast: the model runs at steps 0, 1, every 2nd and the last (27 of 50)
    reset_serving_launches()
    fc = diff.ddim_sample(shape, conds[0], generator=gen, x_0=x_0, forecast_every=2)
    steps = dcfg.sampling_timesteps
    runs = len(set(range(0, steps, 2)) | {1, steps - 1}) * cfg.num_layers
    counts = (sa_block.sa_block.launches, ff_block.ff_tail.launches)
    check_output(fc, x_0, shape)
    print(f"forecast_every=2: K1/K2 launches {counts} (expected {runs} each)")
    check(counts == (runs, runs), f"forecast launches {counts}, expected {runs} each")

    # partial denoise: noise the forecast's motion to t=100, 100 DDPM steps back
    pd = diff.partial_denoise(fc, conds[0], 100, generator=gen)
    check(tuple(pd.shape) == shape and torch.isfinite(pd).all().item(), "partial_denoise output not finite")
    check(pd.abs().max().item() <= 1.0, "partial_denoise left [-1, 1]")
    torch.cuda.synchronize()
    print(f"other samplers (footwork, 2 stream slices, forecast, partial denoise from t=100), bf16 batch "
          f"{REQ_BATCH}: {time.perf_counter() - t0:.1f} s")
    del model, diff
    torch.cuda.empty_cache()


def smoke_song(path: str, seconds: float = SONG_S) -> None:
    """`seconds` of quiet noise with a click on every beat of a 120 BPM
    grid, seeded, as a 16-bit wav at the features' rate."""
    rng = np.random.default_rng(0)
    y = rng.normal(size=int(seconds * SR)).astype(np.float32) * 1e-2
    for s in range(0, len(y), SR // 2):
        n = min(64, len(y) - s)
        y[s:s + n] += rng.normal(size=n).astype(np.float32) * 0.5
    save_wav(path, y, SR)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.cpu() - b.cpu()).abs().max().item()


def check_dbn(traj_model, normalizer, feats: np.ndarray, traj: torch.Tensor) -> None:
    """The DBN on the card against a copy on the CPU, same weights and
    music, f32, with the TF32 flags as the caller left them (PyTorch's
    defaults here): one window, then the whole rollout with the Kalman
    filter against `traj`, the generate request's. Then the window and
    the filter over it with TF32 on for cuBLAS and cuDNN, which the DBN and
    the filter turn off for themselves."""
    tcfg = traj_model.cfg
    cpu_model = copy.deepcopy(traj_model).to("cpu")
    seed = torch.from_numpy(orchestrator.circle_seed(normalizer, traj.shape[0], tcfg.window_size))
    music = torch.from_numpy(feats[None])
    win = (tcfg.window_size + tcfg.step) * 2
    ref = cpu_model(seed, music[:, :win])
    out = traj_model(seed.cuda(), music[:, :win].cuda())
    err, tol = max_err(out, ref), DBN_WINDOW_TOL * ref.abs().max().item()
    print(f"DBN, one window (1 x 3 x {tcfg.window_size} XY, {win} music frames), card vs CPU, f32, TF32 flags "
          f"cuBLAS {torch.backends.cuda.matmul.allow_tf32} cuDNN {torch.backends.cudnn.allow_tf32}: "
          f"max_abs_diff {err:.3e} (tol {tol:.3e}, {DBN_WINDOW_TOL:.0e} of the largest output "
          f"{ref.abs().max().item():.3f})")
    check(err <= tol, f"DBN window disagrees with the CPU: {err} > {tol}")
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = (mm.allow_tf32, cudnn.allow_tf32)
    filtered = kalman_smooth_batch(out)
    mm.allow_tf32 = cudnn.allow_tf32 = True
    try:
        tf32 = traj_model(seed.cuda(), music[:, :win].cuda())
        tf32_filtered = kalman_smooth_batch(tf32)
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = was
    same = torch.equal(tf32, out) and torch.equal(tf32_filtered, filtered)
    print(f"DBN, the same window and the Kalman filter over it with TF32 on for cuBLAS and cuDNN: bit for bit {same}")
    check(same, "the DBN's or the filter's output moved with the caller's TF32 flags")

    ref = kalman_smooth_batch(autoregressive_rollout(cpu_model, seed, music, tcfg.window_size, tcfg.step))[0]
    check(ref.shape == traj.shape, f"CPU trajectory {tuple(ref.shape)} != card's {tuple(traj.shape)}")
    err, tol = max_err(traj, ref), DBN_ROLLOUT_TOL * ref.abs().max().item()
    w, st = tcfg.window_size, tcfg.step
    growth = [max_err(traj[:, w + i * st:w + (i + 1) * st], ref[:, w + i * st:w + (i + 1) * st])
              for i in range((ref.shape[1] - w) // st)]
    print(f"DBN rollout ({len(growth)} windows) + Kalman ({ref.shape[1]} frames), card vs CPU: max_abs_diff "
          f"{err:.3e} (tol {tol:.3e}, {DBN_ROLLOUT_TOL:.0e} of the largest value {ref.abs().max().item():.3f}); "
          f"by window: {' '.join(f'{e:.1e}' for e in growth)}")
    check(err <= tol, f"DBN rollout disagrees with the CPU: {err} > {tol}")


def serve_generate(gen: torch.Generator, card: str) -> dict:
    """Phase 10: wav to dance through orchestrator.generate at full width,
    then the first slices through generate_streaming. Returns the launches
    of K1 and K2 in the one generate request."""
    song = _build.BUILD / "smoke_song.wav"
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    smoke_song(str(song))
    cfg = DanceDecoderConfig(dancer_num=3)
    dcfg = DiffusionConfig()
    model = DanceDecoder(cfg, dtype=torch.bfloat16).init_random(torch.Generator().manual_seed(0))
    diff = GaussianDiffusion(model, dcfg)
    traj_model = TrajDecoder(TrajDecoderConfig()).init_random(torch.Generator().manual_seed(1))
    normalizer = Normalizer.fit(torch.randn((64, cfg.seq_len, cfg.nfeats), generator=torch.Generator().manual_seed(2)),
                                device="cuda")
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32, cudnn.allow_tf32 = False, True  # PyTorch's defaults, as a user of generate has them
    try:
        reset_serving_launches()
        report = {}
        t0 = time.perf_counter()
        out = orchestrator.generate(str(song), diff, traj_model, normalizer, generator=gen, report=report)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: n for k, n in serving_launches().items() if n}
        n, traj = report["slices"], report["traj"]
        stages = ", ".join(f"{k} {v:.3f} s" for k, v in report["seconds"].items())
        print(f"generate ({SONG_S:.0f} s song, bf16, default kernels): {n} slices, {report['windows']} DBN windows, "
              f"trajectory {tuple(traj.shape)}; {seconds:.3f} s for the request ({stages}); "
              f"{n * CLIP_S / seconds:.2f} s-motion/s over the request, "
              f"{n * CLIP_S / report['seconds']['sampling']:.2f} over the sampling (slices x 5 s); {card}")
        check((n, report["windows"], traj.shape[1]) == (SONG_SLICES, SONG_WINDOWS, SONG_FRAMES),
              f"generate: {n} slices, {report['windows']} windows, {traj.shape[1]} frames, expected "
              f"{SONG_SLICES}, {SONG_WINDOWS}, {SONG_FRAMES}")
        check_output(out, report["x_0"], (n, cfg.tokens, cfg.nfeats))
        want = dict.fromkeys(DEFAULT_SITES, cfg.num_layers * dcfg.sampling_timesteps)
        print(f"generate: launches {counts} (expected {want})")
        check(counts == want, f"generate: launches {counts}, expected {want}")
        print_profile("generate request from its features (the DBN, Kalman and the sampling)",
                      lambda: orchestrator.generate_from_features(report["feats"], diff, traj_model, normalizer,
                                                                  generator=gen))

        check_dbn(traj_model, normalizer, report["feats"], traj)

        # f32, same injected noise: kernels against plain versions, whole request
        model.dtype = torch.float32
        shape = (n, cfg.tokens, cfg.nfeats)
        noise = {"init": torch.randn(shape, generator=gen, device="cuda"),
                 "steps": torch.randn((dcfg.sampling_timesteps,) + shape, generator=gen, device="cuda")}
        f32 = lambda: orchestrator.generate_from_features(report["feats"], diff, traj_model, normalizer, noise=noise)
        out_k = f32()
        with plain_blocks(model):
            out_p = f32()
        check_output(out_k, report["x_0"], shape)
        err = max_err(out_k, out_p)
        print(f"generate, f32, kernels vs plain on the same noise: max_abs_diff {err:.3e} (tol {F32_PATH_TOL:.0e})")
        check(err <= F32_PATH_TOL, f"generate: f32 path disagrees: {err} > {F32_PATH_TOL}")

        # streaming over the first 3 slices: its trajectory is the full rollout's
        model.dtype = torch.bfloat16
        sreport, ready = {}, []

        def on_slice(i, s4):
            torch.cuda.synchronize()
            ready.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        stream = orchestrator.generate_streaming(str(song), diff, traj_model, normalizer, generator=gen, slices=3,
                                                 on_slice=on_slice, report=sreport)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        frames = cfg.seq_len + 2 * (cfg.seq_len // 2)
        check(tuple(stream.shape) == (frames, cfg.dancer_num, cfg.nfeats) and torch.isfinite(stream).all().item(),
              f"generate_streaming: output {tuple(stream.shape)} malformed")
        same = torch.equal(stream[..., 4:6], traj[:, :frames].transpose(0, 1))
        stages = ", ".join(f"{k} {v:.3f} s" for k, v in sreport["seconds"].items())
        print(f"generate_streaming, first {sreport['slices']} slices ({frames} frames), bf16: {seconds:.3f} s "
              f"({stages}); "
              f"each slice ready after {' '.join(f'{t:.3f}' for t in ready)} s; "
              f"trajectory equal to the full rollout's first {frames} frames: {same}")
        check(same, "generate_streaming's trajectory differs from the full rollout's")
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = was
    del model, diff, traj_model
    torch.cuda.empty_cache()
    return {name: counts[name] for name in ("sa_block", "ff_tail")}


def train_launches() -> dict:
    return {name: (getattr(mod, name).launches, getattr(mod, name).bwd_launches)
            for mod, name in ((sa_block_train, "sa_block_train"), (ca_block_train, "ca_block_train"),
                              (ff_block_train, "ff_tail_train"))}


def reset_train_launches() -> None:
    for mod, name in ((sa_block_train, "sa_block_train"), (ca_block_train, "ca_block_train"),
                      (ff_block_train, "ff_tail_train")):
        getattr(mod, name).launches = getattr(mod, name).bwd_launches = 0


def make_trainer(cfg, dtype, mesh=None, remat: bool = False):
    """A full-width model with seeded random weights and its train step,
    with TrainConfig's Adan and EMA settings (over `mesh`, where given, the
    state split over its tp ranks; each decoder layer recomputed in the
    backward with `remat`)."""
    tcfg = TrainConfig()
    model = DanceDecoder(cfg, dtype=dtype, remat=remat).init_random(torch.Generator().manual_seed(0))
    opt = Adan(model.parameters(), lr=tcfg.learning_rate, betas=tcfg.adan_betas, eps=tcfg.adan_eps,
               weight_decay=tcfg.weight_decay)
    state = create_train_state(model, opt)
    if mesh is not None:
        shard_train_state(state, mesh)
    step = make_train_step(GaussianDiffusion(model, DiffusionConfig()), opt, ema_beta=tcfg.ema_beta,
                           ema_interval=tcfg.ema_interval, mesh=mesh)
    return model, state, step


def train_inputs(cfg, batch: int, seed: int):
    """bench.py's synthetic train batch: motion N(0, 0.3^2), music N(0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = 0.3 * torch.randn((batch, cfg.dancer_num, cfg.seq_len, cfg.nfeats), generator=g, device="cuda")
    cond = torch.randn((batch, 2 * cfg.seq_len + 1, cfg.cond_feature_dim), generator=g, device="cuda")
    return x, cond


def train(card: str) -> dict:
    """Phase 12: the train path. Returns the train kernels' launch counts."""
    cfg = DanceDecoderConfig(dancer_num=3)
    model, state, step = make_trainer(cfg, torch.bfloat16)
    x, cond = train_inputs(cfg, TRAIN_BATCH, 1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    reset_train_launches()
    state, m = step(state, x, cond, gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, x, cond, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = train_launches()
    want = cfg.num_layers * (TRAIN_STEPS + 1)
    metrics = {k: round(v.item(), 6) for k, v in m.items()}
    print(f"train on {card}: batch {TRAIN_BATCH} bf16, {TRAIN_STEPS} timed steps after 1 warm-up: "
          f"{TRAIN_STEPS / seconds:.3f} steps/s, {TRAIN_BATCH * TRAIN_STEPS / seconds:.2f} samples/s, "
          f"{1e3 * seconds / TRAIN_STEPS:.1f} ms/step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last metrics {metrics}")
    print(f"train: launches (forward, backward) {launches} (expected {want} each)")
    check(all(torch.isfinite(v).item() for v in m.values()), f"train metrics not finite: {metrics}")
    check(all(torch.isfinite(p).all().item() for p in model.parameters()), "parameters not finite")
    for name, (fwd, bwd) in launches.items():
        check(fwd == want and bwd == want, f"{name} launched ({fwd}, {bwd}) times, expected {want}")
    table = print_profile(f"one batch-{TRAIN_BATCH} bf16 train step", lambda: step(state, x, cond, gen))
    fma = [name for name, _, _ in table if "gemm_kernel<bf16" in name]
    check(not fma, f"bf16 products ran on the FMA body in a train step: {fma}")
    print("train step profile: every bf16 product on the tensor cores (no gemm_kernel<bf16>)")
    del model, state, step
    torch.cuda.empty_cache()

    # f32, two steps through the kernels and two through the plain versions:
    # same weights, inputs and generator seed, so the same t, noise, keep
    # mask and dropout seeds (and so the same hash masks). Adan's first step
    # only shrinks the weights; the second moves them by the moments, so
    # the parameters after it depend on both steps' gradients.
    model_k, state_k, step_k = make_trainer(cfg, torch.float32)
    model_p, state_p, step_p = make_trainer(cfg, torch.float32)
    start = {name: p.detach().clone() for name, p in model_p.named_parameters()}
    x, cond = train_inputs(cfg, F32_STEP_BATCH, 3)
    gen_k, gen_p = (torch.Generator(device="cuda").manual_seed(4) for _ in range(2))
    named_p = dict(model_p.named_parameters())
    for i in (1, 2):
        _, m_k = step_k(state_k, x, cond, gen_k)
        with plain_blocks(model_p):
            _, m_p = step_p(state_p, x, cond, gen_p)
        torch.cuda.synchronize()
        # loss: 1e-4 relative; each gradient: 1e-3 of its largest value (8
        # layers of f32 sums in another order, forward and back)
        loss_err = abs(m_k["total"].item() - m_p["total"].item()) / abs(m_p["total"].item())
        worst_grad, worst_name = 0.0, ""
        for name, pk in model_k.named_parameters():
            pp = named_p[name]
            if pp.grad is None:
                check(pk.grad is None, f"{name} has a gradient through the kernels only")
                continue
            share = (pk.grad - pp.grad).abs().max().item() / (1e-3 * max(pp.grad.abs().max().item(), 1e-12))
            if share > worst_grad:
                worst_grad, worst_name = share, name
        print(f"train f32 batch {F32_STEP_BATCH}, kernels vs plain, step {i}: loss {m_k['total'].item():.6f} "
              f"vs {m_p['total'].item():.6f} (rel diff {loss_err:.2e}, tol 1e-4); largest gradient "
              f"difference {worst_grad:.3f} of its tolerance ({worst_name})")
        check(loss_err <= 1e-4, f"f32 train loss of step {i} disagrees: {loss_err}")
        check(worst_grad <= 1.0, f"f32 train gradient of {worst_name} in step {i} disagrees "
                                 f"({worst_grad} of tolerance)")
    # Parameters after the second Adan step. Adan divides each moment by the
    # root of its second moment, so it moves an element by about lr whatever
    # the size of its gradient: where a gradient is small against its
    # tensor's largest, or its two steps' terms nearly cancel, the rounding
    # differences of f32 sums taken in another order become differences of
    # the order of lr. A wrong gradient moves most elements of its tensor
    # so, rounding few. Check: in each tensor at most 5% of the elements
    # differ by more than lr/10. This is the coarse check at the end of the
    # step; the gradients' own (1e-3 of the largest) is the fine one.
    lr = TrainConfig().learning_rate
    worst, worst_name, n_off, n_all, max_diff = 0.0, "", 0, 0, 0.0
    for name, pk in model_k.named_parameters():
        diff = (pk.detach() - named_p[name].detach()).abs()
        off = int((diff > 0.1 * lr).sum().item())
        n_off, n_all, max_diff = n_off + off, n_all + diff.numel(), max(max_diff, diff.max().item())
        if off / diff.numel() > worst:
            worst, worst_name = off / diff.numel(), name
    moved = max((p.detach() - start[n]).abs().max().item() for n, p in model_p.named_parameters())
    print(f"train f32: parameters after two Adan steps: {n_off} of {n_all} elements differ by more than "
          f"lr/10; largest share in a tensor {worst:.3e} (tol 5e-2; {worst_name}); largest difference "
          f"{max_diff / lr:.3e} x lr; largest move from the start {moved / lr:.3e} x lr")
    check(worst <= 5e-2, f"f32 parameters after two Adan steps disagree: {worst_name} {worst}")
    return launches


def remat_runs(card: str) -> dict:
    """The opt-in phase's remat part: REMAT_STEPS bf16 train steps at batch
    TRAIN_BATCH without remat, then with it, from the same weights, data
    and generator seed, one model on the card at a time. Returns the K3-K5
    launches of both runs."""
    cfg = DanceDecoderConfig(dancer_num=3)
    x, cond = train_inputs(cfg, TRAIN_BATCH, 1)
    runs, counts = {}, {}
    for remat in (False, True):
        model, state, step = make_trainer(cfg, torch.bfloat16, remat=remat)
        gen = torch.Generator(device="cuda").manual_seed(2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_train_launches()
        losses, times = [], []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, x, cond, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(m["total"].detach().cpu())
        counts[remat] = train_launches()
        runs[remat] = dict(losses=losses, times=times, peak=torch.cuda.max_memory_allocated() / 2**30,
                           params={n: p.detach().cpu() for n, p in model.named_parameters()})
        del model, state, step
        torch.cuda.empty_cache()
    for remat, r in runs.items():
        print(f"remat {'on' if remat else 'off'} on {card}: bf16 batch {TRAIN_BATCH}, {REMAT_STEPS} steps "
              f"{', '.join(f'{1e3 * s:.1f}' for s in r['times'])} ms ({1 / r['times'][-1]:.3f} steps/s at the "
              f"last); peak memory {r['peak']:.2f} GiB; losses {[round(v.item(), 6) for v in r['losses']]}; "
              f"K3-K5 launches (forward, backward) {counts[remat]}")
    off, on = runs[False], runs[True]
    layers = cfg.num_layers * REMAT_STEPS
    for name, (fwd, bwd) in counts[True].items():
        check((fwd, bwd) == (2 * layers, layers), f"remat: {name} launched ({fwd}, {bwd}), expected "
                                                  f"({2 * layers}, {layers}): each layer's forward twice a step")
    for name, (fwd, bwd) in counts[False].items():
        check((fwd, bwd) == (layers, layers), f"no remat: {name} launched ({fwd}, {bwd}), expected {layers} each")
    same = all(torch.equal(a, b) for a, b in zip(on["losses"], off["losses"])) and all(
        torch.equal(on["params"][n], t) for n, t in off["params"].items())
    if same:
        print(f"remat on {card}: losses and parameters after {REMAT_STEPS} steps equal those without remat bit for "
              f"bit (K3-K5 recompute their forward on the same seeds; their reductions run in a fixed order)")
    else:
        # the fallback the check allows: the losses to grad_tolerance, the
        # parameters to the f32 train check's rule after Adan's second step
        loss_share = max(abs(a - b).item() / grad_tolerance(torch.bfloat16, b) for a, b in zip(on["losses"],
                                                                                                 off["losses"]))
        lr = TrainConfig().learning_rate
        off_share = max(((on["params"][n] - t).abs() > 0.1 * lr).float().mean().item()
                        for n, t in off["params"].items())
        print(f"remat on {card}: not bit for bit; losses {loss_share:.3f} of grad_tolerance, the largest share of "
              f"a tensor's elements more than lr/10 apart {off_share:.3e} (tol 5e-2)")
        check(loss_share <= 1 and off_share <= 5e-2, "remat disagrees with the run without it")
    print(f"remat on {card}: peak memory {on['peak']:.2f} GiB against {off['peak']:.2f} GiB without "
          f"({on['peak'] / off['peak']:.3f}x); last step {1e3 * on['times'][-1]:.1f} against "
          f"{1e3 * off['times'][-1]:.1f} ms ({on['times'][-1] / off['times'][-1]:.3f}x)")
    return {name: tuple(a + b for a, b in zip(counts[False][name], counts[True][name])) for name in counts[True]}


def trpe_step(card: str) -> dict:
    """The opt-in phase's TRPE part: one f32 loss and backward at batch
    TRPE_BATCH with a trj_dist (the self-attention block in plain math,
    K4 and K5 on the card), against the port on the CPU on the same
    weights and injected t (< 64), noise and keep mask, dropout 0 (the
    card's and the CPU's generators draw differently). Returns K3-K5's
    launches on the card."""
    cfg = DanceDecoderConfig(dancer_num=3, dropout=0.0)
    rng = np.random.default_rng(7)
    b = TRPE_BATCH
    host = dict(
        x=(0.3 * rng.normal(size=(b, cfg.dancer_num, cfg.seq_len, cfg.nfeats))).astype(np.float32),
        cond=rng.normal(size=(b, 2 * cfg.seq_len + 1, cfg.cond_feature_dim)).astype(np.float32),
        t=rng.integers(0, 64, size=b), keep_mask=rng.uniform(size=b) < 0.75,
        noise=rng.normal(size=(b, cfg.seq_len, cfg.dancer_num, cfg.nfeats)).astype(np.float32),
        trj_dist=rng.integers(0, cfg.max_dancers, size=(b, cfg.tokens, cfg.tokens)),
    )
    card_model = DanceDecoder(cfg).init_random(torch.Generator().manual_seed(0))
    cpu_model = DanceDecoder(cfg, device="cpu")
    cpu_model.load_state_dict(card_model.state_dict())
    out, launches = {}, None
    for dev, model in (("cuda", card_model), ("cpu", cpu_model)):
        a = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        reset_train_launches()
        t0 = time.perf_counter()
        total, parts = GaussianDiffusion(model, DiffusionConfig(), device=dev).p_losses(
            a["x"], a["cond"], a["t"], noise=a["noise"], keep_mask=a["keep_mask"], trj_dist=a["trj_dist"])
        total.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = train_launches()
        parts = {k: v.item() for k, v in {**parts, "total": total}.items()}
        out[dev] = (parts, {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None},
                    time.perf_counter() - t0)
    (pk, gk, sk), (pp, gp, sp) = out["cuda"], out["cpu"]
    loss_share = max(abs(pk[k] - pp[k]) / (TRAIN_F32_TOL * (1 + abs(pp[k]))) for k in pp)
    check(set(gk) == set(gp), "TRPE: the card and the CPU give gradients to other parameters")
    shares = {n: ((gk[n] - g).abs() / (TRAIN_F32_TOL * (max(1.0, g.abs().max().item()) + g.abs()))).max().item()
              for n, g in gp.items()}
    worst = max(shares, key=shares.get)
    print(f"TRPE train on {card}: f32 batch {b}, loss and backward {1e3 * sk:.1f} ms (the CPU {1e3 * sp:.1f} ms); "
          f"loss {pk['total']:.6f} against the CPU's {pp['total']:.6f}; loss terms {loss_share:.3f} and the "
          f"largest gradient difference {shares[worst]:.3f} ({worst}) of test_torch_train.py's f32 rule "
          f"({TRAIN_F32_TOL:.0e} abs/rel); TRPE table gradient {gp['embeddings_table.weight'].abs().max().item():.3e}; "
          f"K3-K5 launches (forward, backward) {launches}")
    check(loss_share <= 1 and shares[worst] <= 1, "TRPE train step: the card disagrees with the CPU")
    check(gp["embeddings_table.weight"].abs().max().item() > 0, "TRPE: no gradient reached the table")
    check(launches["sa_block_train"] == (0, 0), "TRPE: K3 ran where the block is plain math")
    for name in ("ca_block_train", "ff_tail_train"):
        check(launches[name] == (cfg.num_layers, cfg.num_layers), f"TRPE: {name} launched {launches[name]}")
    del card_model
    torch.cuda.empty_cache()
    return launches


def int8_products(card: str, gen: torch.Generator) -> None:
    """The int8 product alone at the serving shapes of the FF's projections
    (3600 x 512 -> 512 and -> 1024): torch._int_mm on the card against the
    plain int32 product on the CPU (equal), the whole int8_dense likewise,
    timed beside the bf16 product of the same shape."""
    for n in (D, FF):
        x = torch.randn((B * L, D), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randn((n, D), generator=gen, device="cuda") / D**0.5
        xq, _ = int8.quantize_act(x)
        wq, sw = int8.quantize_weight(w)
        equal_mm = torch.equal(int8.int_mm(xq, wq).cpu(), int8.int_mm_plain(xq.cpu(), wq.cpu()))
        equal_dense = torch.equal(int8.int8_dense(x, wq, sw).cpu(), int8.int8_dense(x.cpu(), wq.cpu(), sw.cpu()))
        wb = w.to(torch.bfloat16)
        mm_ms = device_ms(lambda: int8.int_mm(xq, wq))
        dense_ms = device_ms(lambda: int8.int8_dense(x, wq, sw))
        bf16_ms = device_ms(lambda: F.linear(x, wb))
        flops = 2 * B * L * D * n
        print(f"int8 product {B * L}x{D} -> {n} on {card}: int32 sums equal the plain version's: {equal_mm}; "
              f"int8_dense equal: {equal_dense}; torch._int_mm {1e3 * mm_ms:.1f} us ({flops / mm_ms / 1e9:.1f} TOP/s), "
              f"int8_dense with its quantization {1e3 * dense_ms:.1f} us, bf16 F.linear {1e3 * bf16_ms:.1f} us")
        check(equal_mm and equal_dense, f"int8 product {n}: the card's differs from the plain version")


def serving_options(card: str, gen: torch.Generator) -> dict:
    """The opt-in phase's serving part: full-width bf16 requests (batch
    REQ_BATCH, CFG-doubled, 50-step DDIM, w = 2) on one injected noise:
    the default; ServingKernels(int8=True) (its relative error in (0,
    INT8_REL_BOUND) against the default with the plain cross-attention,
    ca_block off: the int8 path runs that site plain, its fc in int8, so
    the pair differs by int8 alone at that site; against the default
    itself, K7 over the hoisted k/v, printed too); ln_bf16 on (its largest
    difference from the default), with one LayerNorm site held against
    the CPU. Returns K1's, K7's and K2's launches over the default's and
    ln_bf16's requests."""
    cfg = DanceDecoderConfig(dancer_num=3)
    dcfg = DiffusionConfig()
    model = DanceDecoder(cfg, dtype=torch.bfloat16).init_random(torch.Generator().manual_seed(0))
    diff = GaussianDiffusion(model, dcfg)
    shape = (REQ_BATCH, cfg.tokens, cfg.nfeats)
    cond = torch.randn((REQ_BATCH, 2 * cfg.seq_len + 1, cfg.cond_feature_dim), generator=gen, device="cuda")
    x_0 = 0.1 * torch.randn((REQ_BATCH, cfg.tokens, 3), generator=gen, device="cuda")
    noise = {"init": torch.randn(shape, generator=gen, device="cuda"),
             "steps": torch.randn((dcfg.sampling_timesteps,) + shape, generator=gen, device="cuda")}

    def request(kernels: ServingKernels, ln_bf16: bool = False):
        model.kernels, model.ln_bf16 = kernels, ln_bf16
        reset_serving_launches()
        int8.int_mm.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = diff.ddim_sample(shape, cond, x_0=x_0, noise=noise)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_output(out, x_0, shape)
        return out, seconds, {k: n for k, n in serving_launches().items() if n}, int8.int_mm.launches

    request(ServingKernels(int8=True))  # warm-up: quantizes the weights once
    ref, ref_s, ref_counts, _ = request(ServingKernels())
    base = request(ServingKernels(ca_block=False))[0]
    q, q_s, q_counts, q_mm = request(ServingKernels(int8=True))
    ln, ln_s, ln_counts, _ = request(ServingKernels(), ln_bf16=True)
    model.kernels, model.ln_bf16 = ServingKernels(), False
    steps = cfg.num_layers * dcfg.sampling_timesteps
    rel, rel_k7 = (((q - r).norm() / r.norm()).item() for r in (base, ref))
    # one CFG forward, int8 against the default with ca_block off: the model-level error the bound is for
    x = torch.randn(shape, generator=gen, device="cuda")
    t_vec = torch.full((REQ_BATCH,), 500, device="cuda", dtype=torch.int32)
    fwd = {}
    for kernels in (ServingKernels(ca_block=False), ServingKernels(int8=True)):
        model.kernels = kernels
        with torch.no_grad():
            fwd[kernels.int8] = diff.guided(x, cond, t_vec, 2.0, cond_cache=diff.encode_cond_cfg(cond))
    model.kernels = ServingKernels()
    fwd_rel = ((fwd[True] - fwd[False]).norm() / fwd[False].norm()).item()
    print(f"int8 request on {card}: bf16, batch {REQ_BATCH}, 50 steps: {q_s:.3f} s against the default's "
          f"{ref_s:.3f} s; relative error against the default with ca_block off {rel:.4f} (bound {INT8_REL_BOUND}; "
          f"one CFG forward {fwd_rel:.4f}), against the default {rel_k7:.4f}; int8 products {q_mm} (expected "
          f"{8 * steps}: self-attention q, k, v, fc, cross-attention fc and FF linear1-3 a layer and step); block "
          f"kernel launches {q_counts or 'none'}")
    check(0 < rel < INT8_REL_BOUND, f"int8 request: relative error {rel} outside (0, {INT8_REL_BOUND})")
    check(q_mm == 8 * steps and not q_counts, f"int8 request: {q_mm} int8 products, kernels {q_counts}")
    want = dict.fromkeys(DEFAULT_SITES, steps)
    check(ref_counts == want and ln_counts == want, f"default/ln_bf16 launches {ref_counts} {ln_counts}")

    diff_max = (ln - ref).abs().max().item()
    xs = (3.0 + torch.randn((B, L, D), generator=gen, device="cuda")).to(torch.bfloat16)
    norm = model.layers[0].norm3
    norm_cpu = copy.deepcopy(norm).cpu()
    norm.ln_bf16 = norm_cpu.ln_bf16 = True
    with torch.no_grad():
        site, site_cpu = _ln(norm, xs, 1e-5).float().cpu(), _ln(norm_cpu, xs.cpu(), 1e-5).float()
    norm.ln_bf16 = False
    site_err, site_tol = (site - site_cpu).abs().max().item(), 2.0**-5 * site_cpu.abs().max().item()
    print(f"LN-bf16 request on {card}: {ln_s:.3f} s against the default's {ref_s:.3f} s; largest difference from "
          f"the default {diff_max:.4e} (outputs in [-1, 1]); K1/K7/K2 launches {ln_counts}; one LayerNorm site "
          f"({B}x{L}x{D} bf16, norm3) card against the CPU: max_abs_diff {site_err:.3e} (tol {site_tol:.3e})")
    check(site_err <= site_tol, f"LN-bf16 site: the card disagrees with the CPU ({site_err} > {site_tol})")
    check(diff_max > 0, "LN-bf16 changed nothing in a bf16 request")
    del model, diff
    torch.cuda.empty_cache()
    return {k: ref_counts.get(k, 0) + ln_counts.get(k, 0) for k in want}


def opt_in_phase(card: str, gen: torch.Generator) -> dict:
    """Phase 12b: the JAX package's opt-in configurations. Returns the
    block kernels' launches ({"serving": K1/K7/K2, "train": K3-K5 (fwd, bwd)})."""
    t0 = time.perf_counter()
    train = remat_runs(card)
    for name, (fwd, bwd) in trpe_step(card).items():
        train[name] = (train[name][0] + fwd, train[name][1] + bwd)
    int8_products(card, gen)
    serving = serving_options(card, gen)
    print(f"opt-in phase on {card}: {time.perf_counter() - t0:.1f} s")
    return {"serving": serving, "train": train}


def write_raw_tree(root: str) -> None:
    """A seeded raw AIOZ-GDance tree (`motions_smpl/<seq>.pkl` at 30 fps, Y-up;
    `musics438/<seq>.wav` at the feature rate; the split lists), as
    tests/test_e2e_files.py writes one: smooth synthetic motion, a 220 Hz
    tone over noise with a click every 0.5 s."""
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "motions_smpl"))
    os.makedirs(os.path.join(root, "musics438"))
    songs = [(f"train{i}", DATA_TRAIN_S) for i in range(DATA_TRAIN_SONGS)] + [("test0", DATA_TEST_S)]
    for i, (name, secs) in enumerate(songs):
        pos, q = synthetic_motion(1, 3, int(secs * 30), seed=100 + i)
        with open(os.path.join(root, "motions_smpl", f"{name}.pkl"), "wb") as f:
            pickle.dump({"root_trans": pos[0], "smpl_poses": q[0], "smpl_betas": np.zeros((3, 10), np.float32),
                         "meta": {"name": name}}, f)
        t = np.arange(int(secs * SR)) / SR
        y = 0.2 * np.sin(2 * np.pi * 220.0 * t) + 0.02 * rng.normal(size=t.shape)
        y[::SR // 2] = 0.9
        save_wav(os.path.join(root, "musics438", f"{name}.wav"), y.astype(np.float32), SR)
    with open(os.path.join(root, "train_split_sequence_names.txt"), "w") as f:
        f.writelines(f"{name}\n" for name, _ in songs[:-1])
    with open(os.path.join(root, "val_split_sequence_names.txt"), "w") as f:
        f.write("test0\n")


def check_dataset(root: str, split: str, mine, ref) -> None:
    """The split's packed channels (card vs CPU) within DATA_TOL, the
    contacts equal off the 1e-5 band about the threshold (the flips
    counted), and the normalized poses within DATA_TOL in the data's units
    (x range / 2 of each sample and channel for the train split's own
    fits; / scale of the train normalizer for the test split)."""
    arrays, _, _ = data_ds._load_slices(root, split == "train", 3, None, ("pos", "q"))
    pos = torch.from_numpy(np.stack(arrays["pos"]))
    q = torch.from_numpy(np.stack(arrays["q"]))
    q = q.reshape(q.shape[:3] + (24, 3))
    packed_cpu = data_ds._process_batch(pos, q)
    packed = data_ds._process_batch(pos.cuda(), q.cuda()).cpu()
    root_aa = data_ds.quaternion_to_axis_angle(data_ds.quat_multiply(
        torch.as_tensor(data_ds._YUP_TO_ZUP_QUAT), data_ds.axis_angle_to_quaternion(q[..., 0, :])))
    vel = data_ds._foot_velocity(data_ds.smpl_fk(torch.cat([root_aa[..., None, :], q[..., 1:, :]], dim=-2),
                                                 data_ds.rotate_points_x90(pos)))
    band = (vel - data_ds.CONTACT_VELOCITY).abs() <= 1e-5
    flips = packed[..., :4] != packed_cpu[..., :4]
    err = (packed[..., 4:] - packed_cpu[..., 4:]).abs().max().item()
    if split == "train":
        flat = packed_cpu.reshape(len(packed_cpu), -1, 151)
        half = ((flat.amax(1) - flat.amin(1)) / 2)[:, None, None, :]
    else:
        half = 1.0 / ref.normalizer.scale.cpu()
    norm_err = ((torch.from_numpy(mine.poses) - torch.from_numpy(ref.poses)).abs() * half)
    norm_err[..., :4][flips] = 0.0
    print(f"data: {split} split, {len(mine)} slices, card vs CPU: packed channels {err:.3e} (tol {DATA_TOL}), "
          f"normalized {norm_err.max().item():.3e} in the data's units (tol {DATA_TOL}); contacts "
          f"{packed[..., :4].mean().item():.3f} in contact, {int(flips.sum())} flipped, {int(band.sum())} "
          f"within 1e-5 of the threshold")
    check(err <= DATA_TOL, f"{split}: packed channels, card vs CPU, {err}")
    check(not (flips & ~band).any().item(), f"{split}: contacts differ off the threshold band")
    check(norm_err.max().item() <= DATA_TOL, f"{split}: normalized poses, card vs CPU, {norm_err.max().item()}")


def dbn_step_card_vs_cpu(ds) -> None:
    """One DBN step at dropout 0 on the card and on the CPU from the same
    weights, batch and injected window start: the losses within 1e-5
    relative, each gradient within 1e-4 of its tensor's largest value (the
    attention's key biases, zero in exact arithmetic, under 1e-6 of the
    network's largest gradient)."""
    cfg = TrajDecoderConfig(dropout=0.0)
    card = TrajDecoder(cfg).init_random(torch.Generator().manual_seed(3))
    cpu = TrajDecoder(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = next(ds.batches(min(16, len(ds))))
    metrics = []
    for model in (card, cpu):
        opt, sched = make_traj_optimizer(model, cfg)
        x = torch.as_tensor(batch["x"], device=model.device)
        cond = torch.as_tensor(batch["cond"], device=model.device)
        metrics.append(make_traj_train_step(model, opt, sched, cfg)(x, cond, None, start=17))
    loss_err = max(abs(metrics[0][k].item() - metrics[1][k].item()) / abs(metrics[1][k].item())
                   for k in ("recon", "dis_loss", "v_loss", "total"))
    grads = {n: p.grad.cpu() for n, p in card.named_parameters()}
    largest = max(p.grad.abs().max().item() for p in cpu.parameters())
    worst, worst_name = 0.0, ""
    for name, p in cpu.named_parameters():
        diff = (grads[name] - p.grad).abs().max().item()
        if name.endswith("attn.key.bias"):
            share = max(grads[name].abs().max().item(), p.grad.abs().max().item()) / (1e-6 * largest)
        else:
            share = diff / (1e-4 * max(p.grad.abs().max().item(), 1e-30))
        if share > worst:
            worst, worst_name = share, name
    print(f"dbn: one step at dropout 0, card vs CPU (batch 16, start 17): losses {loss_err:.2e} relative "
          f"(tol 1e-5); largest gradient difference {worst:.3f} of its tolerance ({worst_name})")
    check(loss_err <= 1e-5, f"DBN step losses, card vs CPU: {loss_err}")
    check(worst <= 1.0, f"DBN step gradient of {worst_name}, card vs CPU: {worst} of its tolerance")


def data_phase(card: str, work: str):
    """Phase 13: training from the data on disk, in the directory `work`.
    Returns the train kernels' (forward, backward) launch counts of the
    train loop, and what the CLI phase reuses: the raw tree, the processed
    cache's directory and the DBN's checkpoint directory."""
    t_phase = time.perf_counter()
    root = os.path.join(work, "AIOZ")
    write_raw_tree(root)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # a line a feature file
        create_dataset(types.SimpleNamespace(dataset_folder=root, root_path=root, stride=0.5, length=5.0,
                                             workers=None))
    slices = tuple(len(os.listdir(os.path.join(root, s, "feats438"))) for s in ("train", "test"))
    print(f"data: create_dataset wrote {slices[0]} train and {slices[1]} test slices (motion, wav, "
          f"feats438) in {time.perf_counter() - t0:.2f} s")
    check(slices == DATA_SLICES, f"create_dataset wrote {slices} slices, expected {DATA_SLICES}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_ds = data_ds.AIOZDataset(root, train=True)
    test_ds = data_ds.AIOZDataset(root, train=False, normalizer=train_ds.normalizer)
    torch.cuda.synchronize()
    print(f"data: AIOZDataset on the card, train and test, in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    train_cpu = data_ds.AIOZDataset(root, train=True, device="cpu")
    test_cpu = data_ds.AIOZDataset(root, train=False, normalizer=train_cpu.normalizer, device="cpu")
    print(f"data: the same on the CPU in {time.perf_counter() - t0:.3f} s")
    check_dataset(root, "train", train_ds, train_cpu)
    check_dataset(root, "test", test_ds, test_cpu)
    t0 = time.perf_counter()
    cache_dir = os.path.join(work, "cache")  # where cli.train's load_datasets reads it
    cache, test_cache = orchestrator.cache_paths(cache_dir, 3, None)
    train_ds.save_cache(cache)
    test_ds.save_cache(test_cache)
    back = data_ds.AIOZDataset.from_cache(cache)
    same = (np.array_equal(back.poses, train_ds.poses) and back.feature_files == train_ds.feature_files
            and back.wav_files == train_ds.wav_files
            and torch.equal(back.normalizer.scale, train_ds.normalizer.scale)
            and torch.equal(back.normalizer.offset, train_ds.normalizer.offset))
    print(f"data: save_cache / from_cache {'bit for bit' if same else 'DIFFER'} in "
          f"{time.perf_counter() - t0:.3f} s")
    check(same, "the dataset cache does not round-trip bit for bit")

    # the DBN: train, one checkpoint and one eval rollout, card vs CPU
    traj_train = TrajDataset(root, train=True)
    traj_test = TrajDataset(root, train=False, normalizer=traj_train.normalizer)
    cfg = TrajDecoderConfig(total_iter=DBN_ITERS, print_iter=DBN_PRINT)
    trainer = TrajTrainer(cfg)
    t0 = time.perf_counter()
    trainer.train(traj_train, traj_test, out_dir=os.path.join(work, "traj"))
    seconds = time.perf_counter() - t0
    ms = [1e3 * s for s in trainer.step_seconds]
    print(f"dbn on {card}: {DBN_ITERS} iterations at batch {min(cfg.batch_size, len(traj_train))} (clamped "
          f"from {cfg.batch_size} to the {len(traj_train)} slices) in {seconds:.2f} s with the checkpoint "
          f"and the eval rollout; ms/iteration median {statistics.median(ms):.1f}, first {ms[0]:.1f}; "
          f"losses {[round(v, 5) for v in trainer.losses]}")
    check(trainer.step == DBN_ITERS and len(trainer.checkpoints) == 1, "the DBN trainer's iterations")
    check(all(np.isfinite(trainer.losses)), f"DBN losses not finite: {trainer.losses}")
    check(trainer.last_eval is not None and np.isfinite(trainer.last_eval).all(), "the DBN eval rollout")
    fresh = load_reference_traj(TrajDecoder(cfg), trainer.checkpoints[0])
    batch = next(traj_test.batches(min(4, len(traj_test))))
    x = torch.as_tensor(batch["x"], device="cuda")[:, :, :cfg.window_size, :2]
    music = torch.as_tensor(batch["cond"], device="cuda")[:, :2 * (cfg.window_size + cfg.step)]
    check(torch.equal(fresh(x, music), trainer.model(x, music)),
          "the DBN checkpoint reloaded by load_reference_traj gives another window than the trained network")
    print(f"dbn: checkpoint {os.path.basename(trainer.checkpoints[0])} reloads through load_reference_traj "
          f"bit for bit; eval rollout {trainer.last_eval.shape}")
    dbn_step_card_vs_cpu(traj_train)

    # the denoiser's train loop over the dataset, through K3/K4/K5
    cfg = DanceDecoderConfig(dancer_num=3)
    model, state, step = make_trainer(cfg, torch.bfloat16)
    reset_train_launches()
    t0 = time.perf_counter()
    out = orchestrator.train_loop(state, step, train_ds, os.path.join(work, "run"), epochs=LOOP_EPOCHS,
                                  batch_size=LOOP_BATCH, save_interval=LOOP_EPOCHS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = train_launches()
    want = cfg.num_layers * out["steps"]
    print(f"train_loop on {card}: {out['steps']} steps of batch {LOOP_BATCH} bf16 over {len(train_ds)} "
          f"slices, loader {out['loader']}, in {seconds:.2f} s with the checkpoint: "
          f"{out['steps'] / seconds:.3f} steps/s including the host IO; logged steps/s "
          f"{out['metrics'].get('steps_per_sec', float('nan')):.3f}, loss {out['metrics'].get('total')}; "
          f"launches (forward, backward) {launches} (expected {want} each)")
    check(out["loader"] == "native", f"the train loop read its batches with {out['loader']}, not natively")
    check(out["steps"] >= 2 and len(out["checkpoints"]) == 1, f"train_loop: {out['steps']} steps, "
          f"{len(out['checkpoints'])} checkpoints")
    for name, (fwd, bwd) in launches.items():
        check(fwd == want and bwd == want, f"train_loop: {name} launched ({fwd}, {bwd}), expected {want}")
    check(np.isfinite(out["metrics"]["total"]), "train_loop loss not finite")
    check(all(torch.isfinite(p).all().item() for p in model.parameters()), "train_loop parameters not finite")
    _, fresh_state, _ = make_trainer(cfg, torch.bfloat16)
    t0 = time.perf_counter()
    fresh_state, _ = restore_train_state(out["checkpoints"][0], fresh_state)
    named = dict(fresh_state.model.named_parameters())
    same = fresh_state.step == state.step and fresh_state.optimizer.param_groups[0]["step"] == \
        state.optimizer.param_groups[0]["step"]
    for name, p in state.model.named_parameters():
        same = same and torch.equal(named[name], p) and torch.equal(fresh_state.ema_params[name],
                                                                     state.ema_params[name])
        for k in ("m", "v", "n", "prev_grad"):
            same = same and torch.equal(fresh_state.optimizer.state[named[name]][k], state.optimizer.state[p][k])
    print(f"train_loop: checkpoint {os.path.basename(out['checkpoints'][0])} "
          f"({os.path.getsize(out['checkpoints'][0]) / 2**20:.0f} MiB) restores the parameters, EMA, Adan "
          f"moments and step {'bit for bit' if same else 'WITH DIFFERENCES'} in {time.perf_counter() - t0:.2f} s")
    check(same, "restore_train_state does not give back the saved state bit for bit")
    del fresh_state

    gen = torch.Generator(device="cuda").manual_seed(7)
    item = np.load(train_ds.feature_files[0], mmap_mode="r").shape

    def one_step():
        batch = next(iter(PrefetchingBatches(train_ds, LOOP_BATCH, item_shape=item)))
        step(state, torch.as_tensor(batch["x"], device="cuda"), torch.as_tensor(batch["cond"], device="cuda"),
             gen)

    print_profile(f"one train_loop step (batch {LOOP_BATCH} read by the prefetcher, then the step)", one_step)
    del model, state, step
    torch.cuda.empty_cache()
    print(f"data phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, {"root": root, "cache_dir": cache_dir, "dbn_dir": os.path.dirname(trainer.checkpoints[0])}


def cli_launches(before: dict, label: str, calls: int) -> dict:
    """The serving kernels' launches since `before`: K1, K7 over the hoisted
    k/v and K2 each 8 layers x 50 DDIM steps a sampling call, no other
    serving kernel."""
    now = serving_launches()
    got = {name: now[name] - before[name] for name in now}
    want = DanceDecoderConfig().num_layers * DiffusionConfig().sampling_timesteps * calls
    mine = sum(got[name] for name in DEFAULT_SITES)
    print(f"cli {label}: K1/K7/K2 launches {'/'.join(str(got[n]) for n in DEFAULT_SITES)} (expected {want} each: "
          f"{calls} sampling call(s)); other serving kernels {sum(got.values()) - mine}")
    check(all(got[name] == want for name in DEFAULT_SITES), f"cli {label}: K1/K7/K2 launched {got}, expected {want} "
          f"each")
    check(sum(got.values()) == mine, f"cli {label}: another serving kernel ran: {got}")
    return got


def check_eval_report(report: dict) -> None:
    """Every value finite; the gt and dbn sets of the same keys, differing."""
    dbn = report["dbn_traj"]
    flat = {k: v for k, v in report.items() if isinstance(v, float)}
    check(report["traj_source"] == "both" and set(flat) == set(dbn), f"eval.json keys: {sorted(report)}")
    check(all(np.isfinite(v) for v in (*flat.values(), *dbn.values())), f"eval.json not finite: {report}")
    check(any(flat[k] != dbn[k] for k in flat), "eval.json: the gt and dbn sets are equal")


def metrics_card_vs_cpu(gen: np.ndarray, ref: np.ndarray, music) -> None:
    """`evaluate` of generated FK joints (N, dn, T, 24, 3) on the card
    against the CPU: the kinetic features within 1e-5 of their largest
    value, the geometric feature matrices equal off MARGIN_BAND about their
    thresholds (the flips inside the band counted), the report's values
    within 1e-4 relative (FID_g and diversity_g equal where no feature
    flipped)."""
    cpu = torch.from_numpy(gen)
    kin_cpu = eval_metrics.kinetic_features(cpu)
    kin_err = max_err(eval_metrics.kinetic_features(cpu.cuda()), kin_cpu) / kin_cpu.abs().max().item()
    margins = eval_geometric.geometric_feature_margins(cpu)
    frames = eval_geometric.geometric_feature_frames(cpu.cuda()).cpu()
    off_band = eval_geometric.flips_off_band(frames, margins > 0, margins)
    flips = int((frames != (margins > 0)).sum())
    t0 = time.perf_counter()
    want = eval_metrics.evaluate(gen, ref, music_feats=music, gen_roots=gen[..., 0, :])
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = eval_metrics.evaluate(torch.from_numpy(gen).cuda(), torch.from_numpy(ref).cuda(), music_feats=music,
                                gen_roots=torch.from_numpy(gen[..., 0, :]).cuda())
    t_card = time.perf_counter() - t0
    rel = {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()}
    print(f"cli metrics of {gen.shape[0]} generated groups, card vs CPU: kinetic features {kin_err:.2e} of the "
          f"largest (tol 1e-5); geometric {frames.numel()} entries, {flips} flipped, {off_band} off the "
          f"{eval_geometric.MARGIN_BAND} band (tol 0); report relative differences "
          f"{ {k: float(f'{v:.2e}') for k, v in rel.items()} }; evaluate {t_card:.2f} s on the card "
          f"(host parts included), {t_cpu:.2f} s on the CPU")
    check(kin_err <= 1e-5, f"kinetic features, card vs CPU: {kin_err}")
    check(off_band == 0, f"{off_band} geometric features differ off the threshold band")
    for k, r in rel.items():
        check(r <= (1e-4 if k not in ("fid_g", "div_g") or flips else 1e-6), f"evaluate {k}, card vs CPU: {r}")


CLI_TRAIN = ["--mode", "train", "--batch_size", str(LOOP_BATCH), "--save_interval", "1"]


def cli_common(work: str, data: dict, runs: str) -> list:
    """The CLI phase's flags of every mode: the data phase's tree, cache and
    3 dancers, the run directory `runs`/cli, bf16, one pass of each loop."""
    return ["--data_path", data["root"], "--processed_data_dir", data["cache_dir"], "--required_dancer_num", "3",
            "--project", runs, "--exp_name", "cli", "--render_dir", os.path.join(work, "cli_renders"),
            "--no_render", "--compute_dtype", "bfloat16", "--epochs", "1"]


def cli_train_flags(work: str, data: dict, runs: str) -> list:
    return CLI_TRAIN + cli_common(work, data, runs)


def cli_phase(card: str, work: str, data: dict) -> tuple:
    """Phase 14: `python -m tcdiff_torch.cli.train` in its five modes, at
    full width (3 dancers, 8 layers, d=512, bf16), on the data phase's
    seeded tree, processed cache and DBN checkpoint. Returns the serving
    kernels' launches and the train kernels' (forward, backward) ones."""
    t_phase = time.perf_counter()
    runs, fk = os.path.join(work, "cli_runs"), os.path.join(work, "cli_fk")
    song = _build.BUILD / "cli_song.wav"
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    smoke_song(str(song), CLI_SONG_S)
    common = cli_common(work, data, runs)
    ckpt = ["--checkpoint", os.path.join(runs, "cli", "checkpoints"), "--traj_checkpoint", data["dbn_dir"]]
    seconds, launches = {}, collections.Counter()

    def run(label: str, argv: list, calls: int):
        reset_train_launches()
        before = serving_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner = cli_train.main(argv + common)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        launches.update(cli_launches(before, label, calls))
        return runner

    runner = run("train", CLI_TRAIN, 1)  # one step, then the train-time render's sampling of 2 clips
    train_counts = train_launches()
    want = runner.cfg.model.num_layers * runner.state.step
    print(f"cli train: {runner.state.step} step(s) of batch {LOOP_BATCH}, K3/K4/K5 launches (forward, backward) "
          f"{train_counts} (expected {want} each); checkpoint "
          f"{sorted(os.listdir(os.path.join(runs, 'cli', 'checkpoints')))}")
    check(runner.state.step == 1 and runner.model.dtype == torch.bfloat16, "cli train: one bf16 step")
    for name, (fwd, bwd) in train_counts.items():
        check(fwd == want and bwd == want, f"cli train: {name} launched ({fwd}, {bwd}), expected {want}")
    check(all(torch.isfinite(p).all().item() for p in runner.model.parameters()), "cli train: parameters")
    del runner
    torch.cuda.empty_cache()

    run("eval", ["--mode", "eval", "--traj_source", "both", *ckpt], 2)
    with open(os.path.join(runs, "cli", "eval.json")) as f:
        report = json.load(f)
    print(f"cli eval.json ({DATA_SLICES[1]} test slices): {json.dumps(report)}")
    check_eval_report(report)

    test_fk = os.path.join(fk, "test")
    run("test", ["--mode", "test", "--vis_fk_out", test_fk, *ckpt], 1)
    pkls = sorted(os.listdir(test_fk))
    check(len(pkls) == DATA_SLICES[1], f"cli test wrote {len(pkls)} pkls")
    with open(os.path.join(test_fk, pkls[0]), "rb") as f:
        first = pickle.load(f)
    split = split_pkl_file(os.path.join(test_fk, pkls[0]), os.path.join(fk, "split"), pkls[0])
    bvhs = [pkl_to_bvh(p, os.path.join(fk, "bvh")) for p in split]
    with open(bvhs[0]) as f:
        text = f.read()
    with open(split[0], "rb") as f:
        sub = pickle.load(f)
    print(f"cli test: {len(pkls)} FK pkls, {pkls[0]}: smpl_poses {first['smpl_poses'].shape}, smpl_trans "
          f"{first['smpl_trans'].shape}, full_pose {first['full_pose'].shape}; split into {len(split)} "
          f"(smpl_poses {sub['smpl_poses'].shape}), {len(bvhs)} BVH files ({len(text)} bytes each)")
    check(first["smpl_poses"].shape == (450, 72) and first["smpl_trans"].shape == (450, 3)
          and first["full_pose"].shape == (3, 150, 24, 3), "cli test: the FK pkl's shapes")
    check(len(split) == 3 and sub["smpl_poses"].shape == (150, 72) and sub["full_pose"].shape == (1, 150, 24, 3),
          "cli test: the split pkls' shapes")
    check(text.startswith("HIERARCHY") and "Frames: 150\n" in text, "cli test: the BVH file")

    # the test mode's generated joints: the metrics and the stitch, card vs CPU
    clips = []
    for name in pkls:
        with open(os.path.join(test_fk, name), "rb") as f:
            clips.append(pickle.load(f))
    gen_joints = np.stack([c["full_pose"] for c in clips]).astype(np.float32)
    test_ds = data_ds.AIOZDataset.from_cache(orchestrator.cache_paths(data["cache_dir"], 3, None)[1])
    gt = np.stack([test_ds.get(i)[0] for i in range(len(test_ds))])
    gt_flat = torch.from_numpy(np.ascontiguousarray(gt.transpose(0, 2, 1, 3).reshape(len(gt), -1, 151))).cuda()
    ref_joints = viz_post.postprocess_sample(gt_flat, test_ds.normalizer, 3).poses
    metrics_card_vs_cpu(gen_joints, ref_joints, [test_ds.get(i)[1] for i in range(len(test_ds))])
    pos = torch.from_numpy(np.stack([c["smpl_trans"] for c in clips]).reshape(len(clips), 150, 3, 3))
    q = torch.from_numpy(np.stack([c["smpl_poses"] for c in clips]).reshape(len(clips), 150, 3, 24, 3))
    cpu_p, cpu_q = viz_post.stitch_long(pos, q)
    card_p, card_q = viz_post.stitch_long(pos.cuda(), q.cuda())
    err = max(max_err(card_p, cpu_p) / cpu_p.abs().max().item(), max_err(card_q, cpu_q) / cpu_q.abs().max().item())
    print(f"cli stitch_long of the {len(clips)} test clips, card vs CPU: {err:.2e} of the largest value "
          f"(tol 1e-5), {tuple(card_q.shape)}")
    check(err <= 1e-5, f"stitch_long, card vs CPU: {err}")

    val_fk = os.path.join(fk, "val")
    run("val_long", ["--mode", "val_without_TrajModel", "--sample_mode", "long", "--vis_fk_out", val_fk, *ckpt], 1)
    (val_pkl,) = os.listdir(val_fk)
    with open(os.path.join(val_fk, val_pkl), "rb") as f:
        val = pickle.load(f)
    frames = 150 + 75 * (DATA_SLICES[1] - 1)
    print(f"cli val_without_TrajModel --sample_mode long: {val_pkl}, the {DATA_SLICES[1]} test slices stitched "
          f"on the card: full_pose {val['full_pose'].shape}")
    check(val["full_pose"].shape == (3, frames, 24, 3) and np.isfinite(val["full_pose"]).all(), "cli val long")

    gen_fk = os.path.join(fk, "gen")
    run("generate", ["--mode", "generate", "--wav", str(song), "--vis_fk_out", gen_fk, *ckpt], 1)
    (gen_pkl,) = os.listdir(gen_fk)
    with open(os.path.join(gen_fk, gen_pkl), "rb") as f:
        gen_out = pickle.load(f)
    print(f"cli generate on a {CLI_SONG_S:.0f} s song: {gen_pkl}, full_pose {gen_out['full_pose'].shape}")
    check(gen_out["full_pose"].shape == (3, 300, 24, 3) and np.isfinite(gen_out["full_pose"]).all(),
          "cli generate: 3 slices stitched into 300 frames")
    total = time.perf_counter() - t_phase
    print(f"cli phase on {card}: wall seconds by mode "
          f"{ {k: round(v, 2) for k, v in seconds.items()} }, phase {total:.1f} s")
    return dict(launches), train_counts


DP_RANKS = 2  # two ranks on the one card, over gloo (NCCL refuses two ranks on one device)
DP_BATCH, DP_F32_BATCH = 64, 8  # global train batches: 32 and 4 a rank
DP_SLICES, DP_CLIPS = 8, 8  # the sharded long sampler's slices, normal-mode sampling's clips
DP_DBN_ITEMS, DP_DBN_ITERS = 32, 2  # the DBN's synthetic set (one global batch of 32) and its iterations
DP_SEED = 21
# the f32 DBN's gradients against float64's, each within this share of its
# tensor's largest value: twice the spread one f32 process showed (the music
# projection's first weight gradient 7.0e-3 from float64; NVIDIA H100 80GB
# HBM3, 700.00 W), which f32's summation order sets whatever the ranks
DP_DBN_F32_GRAD_TOL = 2 * 7.0e-3


def dp_inputs(cfg):
    """The dp phase's seeded global inputs, drawn on the card: the long
    sampler's cond, trajectory and injected noise, the normal sampler's cond
    and trajectory."""
    g = torch.Generator(device="cuda").manual_seed(DP_SEED)
    tokens, steps = cfg.seq_len * cfg.dancer_num, DiffusionConfig().sampling_timesteps
    r = lambda *shape, std=1.0: std * torch.randn(shape, generator=g, device="cuda")
    return {"long_cond": r(DP_SLICES, 2 * cfg.seq_len + 1, cfg.cond_feature_dim),
            "long_x0": r(DP_SLICES, tokens, 3, std=0.2),
            "long_noise": {"init": r(DP_SLICES, tokens, cfg.nfeats), "steps": r(steps, DP_SLICES, tokens, cfg.nfeats)},
            "cond": r(DP_CLIPS, 2 * cfg.seq_len + 1, cfg.cond_feature_dim), "x0": r(DP_CLIPS, tokens, 3, std=0.2)}


def dp_tcdiff(device, tp: int = 1):
    """The full-width bf16 `TCDiff` (3 dancers), seeded weights; dp = -1
    (the world over tp)."""
    cfg = TCDiffConfig()
    cfg = dataclasses.replace(cfg.with_dancers(3),
                              train=dataclasses.replace(cfg.train, compute_dtype="bfloat16", tp=tp))
    return orchestrator.TCDiff(cfg, use_ema_for_eval=False, device=device)


def dp_dbn(device, dp: int, dtype):
    """The DBN trainer (its config's sizes, its network in `dtype`) and its
    synthetic set. In float32 on the card the music projection's first
    weight gradient cancels heavily: one process's lies 7.0e-3 of its
    largest value from the float64 one (an NVIDIA H100 80GB HBM3), so f32
    runs of one function in two summation orders differ past the 1e-4
    rule of `dbn_step_card_vs_cpu`. In float64 that rule holds the dp logic
    itself (the draws, the gathered LSTM input, the all-reduce); the f32
    network, the one users train, is held against float64 at
    DP_DBN_F32_GRAD_TOL."""
    trainer = TrajTrainer(TrajDecoderConfig(), dancer_num=3, device=device, dp=dp)
    trainer.model.to(dtype)  # the optimizer keeps the same parameters, now in dtype
    return trainer, SyntheticTrajDataset(DP_DBN_ITEMS, 3, 150, seed=DP_SEED, device=trainer.device)


def dp_work(mesh, work: str) -> dict:
    """Every path of the dp phase on `mesh` (None: one process): two train
    steps in bf16 at DP_BATCH and in f32 at DP_F32_BATCH, the long sampler
    over DP_SLICES slices (bf16 and f32), normal-mode `TCDiff._sample` of
    DP_CLIPS clips and DP_DBN_ITERS DBN iterations. Returns the losses,
    gradients and parameters, samples and launch counts (tensors on the
    host)."""
    cfg = DanceDecoderConfig(dancer_num=3)
    dev = torch.device("cuda", 0)
    host = lambda named: {n: t.detach().cpu() for n, t in named}
    out = {"launches": {}}
    for dtype, batch in ((torch.bfloat16, DP_BATCH), (torch.float32, DP_F32_BATCH)):
        model, state, step = make_trainer(cfg, dtype, mesh)
        x, cond = train_inputs(cfg, batch, DP_SEED)
        if mesh is not None:
            x, cond = shard_batch((x, cond), mesh)
        gen = torch.Generator(device="cuda").manual_seed(DP_SEED)
        reset_train_launches()
        res = {"metrics": []}
        for i in range(2):
            state, m = step(state, x, cond, gen)
            res["metrics"].append({k: v.item() for k, v in m.items()})
            if i == 0:
                res["grads1"] = host((n, p.grad) for n, p in model.named_parameters() if p.grad is not None)
                res["params1"] = host(model.named_parameters())
        res["params2"] = host(model.named_parameters())
        res["ema2"] = {n: e.float().cpu() for n, e in state.ema_params.items()}
        out[f"train_{dtype}"] = res
        out["launches"][f"train_{dtype}"] = train_launches()
        del model, state, step
        torch.cuda.empty_cache()

    inp = dp_inputs(cfg)
    for dtype in (torch.bfloat16, torch.float32):
        model = DanceDecoder(cfg, dtype=dtype, device=dev).init_random(torch.Generator().manual_seed(DP_SEED))
        diff = GaussianDiffusion(model, DiffusionConfig(), device=dev)
        shape = (DP_SLICES, cfg.seq_len * cfg.dancer_num, cfg.nfeats)
        before = serving_launches()
        if mesh is None:
            song = diff.long_ddim_sample(shape, inp["long_cond"], x_0=inp["long_x0"], noise=inp["long_noise"])
        else:
            song = all_gather_rows(diff.long_ddim_sample_sharded(shape, inp["long_cond"], mesh, x_0=inp["long_x0"],
                                                                 noise=inp["long_noise"]), mesh)
        out[f"long_{dtype}"] = song.cpu()
        out["launches"][f"long_{dtype}"] = {k: v - before[k] for k, v in serving_launches().items()}
        del model, diff
    runner = dp_tcdiff(dev)
    before = serving_launches()
    out["sample"] = runner._sample(inp["cond"], inp["x0"], torch.Generator(device="cuda").manual_seed(DP_SEED)).cpu()
    out["launches"]["sample"] = {k: v - before[k] for k, v in serving_launches().items()}
    out["sample_dp"] = runner.mesh.world
    del runner
    torch.cuda.empty_cache()

    # the DBN in float64 and in float32: one iteration (its gradients, from
    # the same weights), then the next (`train` starts its batch order anew:
    # the same batch again)
    for key, dtype in (("dbn", torch.float64), ("dbn_f32", torch.float32)):
        trainer, ds = dp_dbn(dev, -1 if mesh is None else mesh.world, dtype)
        run_dir = os.path.join(work, f"dp_{key}_{mesh is None}")
        trainer.train(ds, total_iter=1, out_dir=run_dir, batch_size=DP_DBN_ITEMS)
        grads = host((n, p.grad) for n, p in trainer.model.named_parameters())
        trainer.train(ds, total_iter=DP_DBN_ITERS, out_dir=run_dir, batch_size=DP_DBN_ITEMS)
        out[key] = {"losses": trainer.losses, "params": host(trainer.model.named_parameters()), "grads": grads}
    return out


def dbn_errs(d: dict, rd: dict, grad_rule: float) -> dict:
    """A DBN run `d` against the reference `rd` (`dp_work`'s "dbn" entries),
    `dbn_step_card_vs_cpu`'s rule with its gradient share `grad_rule`: the
    losses relative (shares of DATA_TOL), each gradient of the first
    iteration as a share of grad_rule x its largest value, but the
    attention's key biases: a key bias shifts every logit of a softmax row
    alike, so the loss does not depend on it and its gradient is rounding
    in both runs; reported as a share of the network's largest gradient,
    not compared (AdamW moves it by about lr x the sign of that rounding).
    The parameters after the iterations: each tensor's share of elements
    more than lr/10 apart."""
    key_bias = lambda n: n.endswith("attn.key.bias")
    largest = max(t.abs().max().item() for t in rd["grads"].values())
    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(d["losses"], rd["losses"])) / DATA_TOL,
        "grads": _worst({n: (d["grads"][n] - t).abs().max().item() / (grad_rule * max(t.abs().max().item(), 1e-30))
                         for n, t in rd["grads"].items() if not key_bias(n)}),
        "key_bias_grad": max(max(d["grads"][n].abs().max().item(), t.abs().max().item()) / largest
                             for n, t in rd["grads"].items() if key_bias(n)),
        "params_off": _worst({n: ((d["params"][n].double() - t.double()).abs() > 0.1 * TrajDecoderConfig().lr)
                              .float().mean().item() for n, t in rd["params"].items() if not key_bias(n)}),
        "digest": _digest(d["params"]),
    }


def _worst(shares: dict) -> tuple:
    """(the largest share, its tensor's name)."""
    name = max(shares, key=shares.get)
    return shares[name], name


def _top(shares: dict, n: int = 4) -> list:
    """The n largest (name, share) pairs."""
    return sorted(shares.items(), key=lambda kv: -kv[1])[:n]


def _digest(named: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(named):
        h.update(name.encode())
        h.update(named[name].numpy().tobytes())
    return h.hexdigest()


def _key_bias(name: str, t: torch.Tensor, keep: bool) -> torch.Tensor:
    """The cond encoder's packed q/k/v bias without its key third (keep
    False) or that third alone (keep True); any other tensor as it is."""
    if not name.endswith("self_attn.in_proj_bias"):
        return t
    q, k, v = t.chunk(3)
    return k if keep else torch.cat([q, v])


def rel_errs(g: dict, r: dict) -> dict:
    """{name: ||g - r|| / ||r||} of each gradient of r, the cond encoder's
    key-bias third left out (`_key_bias`: its gradient is zero in exact
    arithmetic, and rounding alone in both runs). A gradient zeroed reads
    1, one of flipped sign 2."""
    out = {}
    for n, t in r.items():
        a, b = _key_bias(n, g[n], False).double(), _key_bias(n, t, False).double()
        out[n] = ((a - b).norm() / b.norm()).item() if b.norm() > 0 else float(a.norm() > 0)
    return out


def rel_summary(rel: dict) -> dict:
    """The median, the largest and the worst tensors of `rel_errs`."""
    return {"median": statistics.median(rel.values()), "top": _top(rel, 3)}


def train_errs(g: dict, r: dict, dtype, key_bias: bool = False) -> dict:
    """Two train steps `g` against one process's `r`, as shares of the
    rules (dp_work's entries): the losses and the step-1 gradients to
    `grad_tolerance`, the parameters after step 1 to `tolerance`, after
    step 2 the share of each tensor's elements more than lr/10 apart; and
    the digest of the parameters and EMA after step 2. With `key_bias`
    (runs whose f32 sums differ in order, as tp's split products do) the
    cond encoder's key biases are left out of the step-2 rule, as
    `dbn_errs` leaves the DBN's out: a key bias shifts every logit of a
    softmax row alike, so its gradient is rounding in both runs, and Adan's
    second step, which divides by the root of that gradient's square,
    moves it by about lr x the sign of the rounding; their step-1 gradient
    is reported as a share of the largest gradient. Where the runs kept
    their step-2 gradients (`tp_work`), each step's gradients are also
    read tensor by tensor as `rel_errs` (all of them, and the four largest
    step-2 shares of parameters off)."""
    cut = (lambda n, t: _key_bias(n, t, False)) if key_bias else (lambda n, t: t)
    out = {
        "loss": [abs(a["total"] - b["total"]) / grad_tolerance(dtype, torch.tensor(b["total"]))
                 for a, b in zip(g["metrics"], r["metrics"])],
        "grads1": _worst({n: (g["grads1"][n] - t).abs().max().item() / grad_tolerance(dtype, t)
                          for n, t in r["grads1"].items()}),
        "params1": _worst({n: (g["params1"][n] - t).abs().max().item() / tolerance(dtype, t)
                           for n, t in r["params1"].items()}),
        "params2_off": _worst({n: ((cut(n, g["params2"][n]) - cut(n, t)).abs() > 0.1 * TrainConfig().learning_rate)
                               .float().mean().item() for n, t in r["params2"].items()}),
        "digest": _digest({**g["params2"], **{f"ema.{n}": t for n, t in g["ema2"].items()}}),
    }
    if "grads2" in r:
        for step in ("grads1", "grads2"):
            out[f"{step}_rel_all"] = rel_errs(g[step], r[step])
        off = {n: ((g["params2"][n] - t).abs() > 0.1 * TrainConfig().learning_rate).float().mean().item()
               for n, t in r["params2"].items()}
        out["params2_off_top"] = _top(off)
    if key_bias:
        largest = max(t.abs().max().item() for t in r["grads1"].values())
        out["key_bias_grad"] = max(max(_key_bias(n, g["grads1"][n], True).abs().max().item(),
                                       _key_bias(n, t, True).abs().max().item()) / largest
                                   for n, t in r["grads1"].items() if n.endswith("self_attn.in_proj_bias"))
    return out


def _dp_rank(rank: int, store: str, work: str) -> None:
    """One rank of the dp phase (a spawned process): join the gloo group of
    DP_RANKS on card 0, run `dp_work` on the mesh, wait for the one-process
    references (`work`/dp_ref.pt, which the parent computes meanwhile),
    hold each result against them, and save the errors, launch counts and
    digests of its state to `work`/dp_rank{rank}.pt."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_RANKS), LOCAL_RANK=str(rank))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed("cuda:0", backend="gloo", init_method=store)
    try:
        mesh = make_mesh(DP_RANKS, 1, device=dev)
        print(f"dp rank {rank}/{mesh.world}: backend {mesh.backend}, device {dev}", flush=True)
        got = dp_work(mesh, work)
        ref_path, t0 = os.path.join(work, "dp_ref.pt"), time.perf_counter()
        while not os.path.exists(ref_path):
            check(time.perf_counter() - t0 < 600, "the one-process references did not come within 600 s")
            time.sleep(0.5)
        ref = torch.load(ref_path, map_location="cpu", weights_only=False, mmap=True)
        errs = {}
        for dtype in (torch.bfloat16, torch.float32):
            errs[f"train_{dtype}"] = train_errs(got[f"train_{dtype}"], ref[f"train_{dtype}"], dtype)
            song, want = got[f"long_{dtype}"], ref[f"long_{dtype}"]
            tol = F32_PATH_TOL if dtype == torch.float32 else tolerance(dtype, want)
            errs[f"long_{dtype}"] = (song - want).abs().max().item() / tol
        errs["sample"] = (got["sample"] - ref["sample"]).abs().max().item() / tolerance(torch.bfloat16, ref["sample"])
        # the DBN (its config's dropout 0.1): in float64 against float64 at
        # `dbn_step_card_vs_cpu`'s 1e-4; in float32 against float64 at
        # DP_DBN_F32_GRAD_TOL
        errs["dbn"] = dbn_errs(got["dbn"], ref["dbn"], 1e-4)
        errs["dbn_f32"] = dbn_errs(got["dbn_f32"], ref["dbn"], DP_DBN_F32_GRAD_TOL)
        print(f"dp rank {rank}: launches {got['launches']}", flush=True)
        torch.save({"errs": errs, "launches": got["launches"], "sample_dp": got["sample_dp"]},
                   os.path.join(work, f"dp_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def nccl_world1_start(work: str, data: dict) -> tuple:
    """Start `python -m torch.distributed.run --standalone --nproc_per_node
    1 -m tcdiff_torch.cli.train --mode train --dp 1` on the data phase's
    tree, with the CLI phase's train flags: NCCL at world size 1 (an
    all-reduce over one rank, divided by 1). A thread waits for it and
    notes its wall time when it exits; `nccl_world1_check` joins it."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
            "-m", "tcdiff_torch.cli.train", "--dp", "1", *cli_train_flags(work, data, os.path.join(work, "nccl_runs"))]
    log = open(os.path.join(work, "nccl_world1.log"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT)
    wall = []
    waiter = threading.Thread(target=lambda: (proc.wait(), wall.append(time.perf_counter() - t0)), daemon=True)
    waiter.start()
    return proc, log, waiter, wall


def nccl_world1_check(card: str, work: str, started: tuple) -> None:
    """Wait for `nccl_world1_start`'s run: its checkpoint must equal the CLI
    phase's non-distributed one bit for bit (parameters, EMA, Adan), and its
    log must show a gradient all-reduce a step and the metrics' mean issued
    over NCCL (`parallel.comm.collective_counts`)."""
    proc, log, waiter, wall = started
    try:
        waiter.join(timeout=600)
        check(not waiter.is_alive(), "torchrun cli.train --dp 1 did not exit within 600 s")
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    rc, seconds = proc.returncode, wall[0]
    with open(log.name) as f:
        out = f.read()
    check(rc == 0, f"torchrun cli.train --dp 1 exited {rc}:\n{out[-3000:]}")
    check("backend nccl" in out, "torchrun cli.train: the NCCL backend was not reported")
    issued = re.findall(r"parallel: collectives issued (\{.*\})", out)
    check(len(issued) == 1, "torchrun cli.train: the collectives it issued were not reported")
    issued = json.loads(issued[0])
    runs = os.path.join(work, "nccl_runs")
    mine = torch.load(os.path.join(runs, "cli", "checkpoints", "ckpt_1.pt"), map_location="cpu", weights_only=False)
    ref = torch.load(os.path.join(work, "cli_runs", "cli", "checkpoints", "ckpt_1.pt"), map_location="cpu",
                     weights_only=False)
    diffs = []
    for key in ("model_state_dict", "ema_state_dict"):
        diffs += [f"{key}.{n}" for n, t in ref[key].items() if not torch.equal(mine[key][n], t)]
    for i, st in ref["optimizer_state_dict"]["state"].items():
        diffs += [f"adan.{i}.{k}" for k, t in st.items()
                  if torch.is_tensor(t) and not torch.equal(mine["optimizer_state_dict"]["state"][i][k], t)]
    print(f"dp: torchrun --nproc_per_node 1 cli.train --dp 1 over NCCL on {card}: step {mine['step']}, "
          f"{len(ref['model_state_dict'])} parameters, EMA and Adan moments against the non-distributed CLI "
          f"run's checkpoint: {len(diffs)} differ (tol: bit for bit); collectives issued {issued}; "
          f"{seconds:.1f} s wall from its start to its exit, beside the gloo ranks")
    check(mine["step"] == ref["step"] == 1 and not diffs, f"NCCL world-1 step differs from the plain one: {diffs[:5]}")
    check(issued.get("all_reduce_grads_ nccl") == mine["step"] and issued.get("all_reduce_mean nccl", 0) >= 1,
          f"torchrun cli.train --dp 1: expected one gradient all-reduce a step and the metrics' mean over NCCL, "
          f"issued {issued}")


def check_dp_ranks(results: list, t_ranks: float) -> None:
    """Each rank's errors against one process, launch counts and state
    digests (`_dp_rank`'s results, in rank order)."""
    want_serving = DanceDecoderConfig().num_layers * DiffusionConfig().sampling_timesteps
    want_train = DanceDecoderConfig().num_layers * 2
    for r, res in enumerate(results):
        e = res["errs"]
        print(f"dp rank {r} against one process (shares of each tolerance): train bf16 batch {DP_BATCH} "
              f"{ {k: v for k, v in e['train_torch.bfloat16'].items() if k != 'digest'} }, f32 batch "
              f"{DP_F32_BATCH} { {k: v for k, v in e['train_torch.float32'].items() if k != 'digest'} }; "
              f"long {DP_SLICES} slices bf16 {e['long_torch.bfloat16']:.3e}, f32 {e['long_torch.float32']:.3e}; "
              f"_sample of {DP_CLIPS} over dp={res['sample_dp']} {e['sample']:.3e}; DBN f64 "
              f"{ {k: v for k, v in e['dbn'].items() if k != 'digest'} }, DBN f32 against f64 "
              f"{ {k: v for k, v in e['dbn_f32'].items() if k != 'digest'} }")
        check(res["sample_dp"] == DP_RANKS, f"rank {r}: TCDiff's mesh has dp={res['sample_dp']}")
        for dtype in ("torch.bfloat16", "torch.float32"):
            t = e[f"train_{dtype}"]
            check(max(t["loss"]) <= 1 and t["grads1"][0] <= 1 and t["params1"][0] <= 1
                  and t["params2_off"][0] <= 5e-2, f"rank {r}: the dp train steps in {dtype} disagree: {t}")
            check(e[f"long_{dtype}"] <= 1, f"rank {r}: the sharded long sampler in {dtype} disagrees")
        check(e["sample"] <= 1, f"rank {r}: dp _sample disagrees with one process")
        d = e["dbn"]
        check(d["loss"] <= 1 and d["grads"][0] <= 1 and d["params_off"][0] <= 5e-2,
              f"rank {r}: the dp DBN disagrees: {d}")
        d = e["dbn_f32"]
        check(d["loss"] <= 1 and d["grads"][0] <= 1 and d["params_off"][0] <= 5e-2,
              f"rank {r}: the f32 dp DBN disagrees with float64: {d}")
        for label, counts in res["launches"].items():
            if label.startswith("train"):
                check(all(f == b == want_train for f, b in counts.values()),
                      f"rank {r} {label}: K3-K5 launched {counts}, expected {want_train} each way")
            else:
                check(all(counts[n] == want_serving for n in DEFAULT_SITES)
                      and sum(counts.values()) == len(DEFAULT_SITES) * want_serving,
                      f"rank {r} {label}: serving launches {counts}, expected K1/K7/K2 {want_serving} each")
    for key in ("train_torch.bfloat16", "train_torch.float32", "dbn", "dbn_f32"):
        digests = {res["errs"][key]["digest"] for res in results}
        check(len(digests) == 1, f"{key}: the ranks' parameters differ")
    print(f"dp: every rank's parameters and EMA bit-identical (sha256) after the bf16, f32 and DBN f64/f32 steps; "
          f"K1/K7/K2 {want_serving} launches a sampling call a rank, K3-K5 {want_train} each way for two steps a "
          f"rank; ranks {t_ranks:.1f} s wall", flush=True)


def dp_phase(card: str, work: str, data: dict) -> dict:
    """Phase 15: data parallelism. Two ranks on the one card over gloo
    (spawned after the kernels are built) and, beside them, NCCL at world
    size 1 through torchrun and `cli.train`, while this process computes
    the one-process references. Returns the serving and train kernels'
    launches in the ranks' runs, summed over the ranks (each rank's are
    checked)."""
    t_phase = time.perf_counter()
    print(f"dp: spawning {DP_RANKS} ranks on card 0, backend gloo (chosen: NCCL refuses two ranks on one "
          f"device)", flush=True)
    store = "file://" + os.path.join(work, "dp_store")
    ctx = torch.multiprocessing.start_processes(_dp_rank, args=(store, work), nprocs=DP_RANKS, join=False,
                                                start_method="spawn")
    t0 = time.perf_counter()
    nccl = None
    try:
        nccl = nccl_world1_start(work, data)
        ref = dp_work(None, work)
        ref.pop("launches")
        e = dbn_errs(ref.pop("dbn_f32"), ref["dbn"], DP_DBN_F32_GRAD_TOL)
        print(f"dp: one process's f32 DBN against float64 (the spread f32 rounding alone gives; shares of "
              f"the f32 rules) { {k: v for k, v in e.items() if k != 'digest'} }", flush=True)
        tmp = os.path.join(work, "dp_ref.pt.tmp")
        torch.save(ref, tmp)
        os.replace(tmp, os.path.join(work, "dp_ref.pt"))  # the ranks wait for this name
        del ref
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t0
        print(f"dp: the one-process references in {t_ref:.1f} s, while the ranks ran", flush=True)
        try:
            while not ctx.join(timeout=5):
                check(time.perf_counter() - t0 < 600, "the dp ranks did not finish within 600 s")
        except torch.multiprocessing.ProcessRaisedException as e:
            raise SmokeFailure(f"a dp rank failed:\n{e}") from None
        except torch.multiprocessing.ProcessExitedException as e:
            raise SmokeFailure(f"a dp rank exited: {e}") from None
        t_ranks = time.perf_counter() - t0
        results = [torch.load(os.path.join(work, f"dp_rank{r}.pt"), weights_only=False) for r in range(DP_RANKS)]
        check_dp_ranks(results, t_ranks)
        nccl_world1_check(card, work, nccl)
    finally:  # every process this phase started ends with it
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
        if nccl is not None:
            if nccl[0].poll() is None:
                nccl[0].kill()
            nccl[1].close()
    print(f"dp phase on {card}: {time.perf_counter() - t_phase:.1f} s (references {t_ref:.1f} s, ranks "
          f"{t_ranks:.1f} s)")
    runs = [(label, c) for res in results for label, c in res["launches"].items()]
    serving = {k: sum(c[k] for label, c in runs if not label.startswith("train")) for k in serving_launches()}
    train = {k: tuple(sum(c[k][i] for label, c in runs if label.startswith("train")) for i in (0, 1))
             for k in train_launches()}
    return {"serving": serving, "train": train}


TP = 2  # tensor-parallel ranks on the one card, over gloo (NCCL refuses two ranks on one device)
TP_BATCH, TP_F32_BATCH = 16, 8  # global train batches of the tp phase, bf16 and f32
TP_CLIPS = 4  # TCDiff._sample's clips under tp
TP_SEED = 23
FULL_PARAMS, TP_HELD = 61_428_181, 30_815_537  # the full-width model's parameters; a tp = 2 rank's (the JAX rule)


def _whole_named(model, named) -> dict:
    """{name: tensor on the host} of tensors by parameter name, each whole:
    gathered over the tp ranks where its parameter is split (a collective)."""
    params = dict(model.named_parameters())
    out = {}
    for n, t in named:
        shard = getattr(params[n], "tp_shard", None)
        out[n] = (t if shard is None else whole_tensor(t, shard)).detach().to("cpu", torch.float32, copy=True)
    return out


def time_tp_collectives() -> dict:
    """Wrap the port's two tp collectives (`parallel.comm.tp_sum`, which the
    reduces and the copies' backward call, and `tp_parts`, which the
    gathers call) in this process: each call on a tp group is counted with
    its f32 wire bytes and its seconds, the card synchronised first (the
    wait) and then the collective (the wire: the host copies and gloo).
    Returns the live {name: [calls, bytes, wait s, wire s]}."""
    stats = {}

    def timed(name, fn):
        def run(t, mesh):
            if mesh is None or mesh.tp_group is None:
                return fn(t, mesh)
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(t, mesh)
            st = stats.setdefault(name, [0, 0, 0.0, 0.0])
            st[0] += 1
            st[1] += 4 * t.numel()
            st[2] += t1 - t0
            st[3] += time.perf_counter() - t1
            return out
        return run

    for name in ("tp_sum", "tp_parts"):
        setattr(tp_comm, name, timed(name, getattr(tp_comm, name)))
    return stats


def tp_work(mesh, dtypes, plain: bool = True, comm: dict | None = None) -> dict:
    """Two train steps at each (dtype, global batch) of `dtypes` at full
    width, dropout 0.1, on `mesh` (its state split over the tp ranks) or,
    with mesh None, in one process through the plain versions
    (`plain_blocks`: the arithmetic the tp layers split; through the
    kernels with `plain` False). Returns, for each dtype, the metrics and
    wall ms of both steps, the whole gradients of both steps, the parameters after step 1,
    the parameters and EMA after step 2, the parameters this process holds,
    its peak memory above what it held before (the parent holds earlier
    phases' tensors), and K3-K5's launches; with `comm` (a reading of
    `time_tp_collectives`), the collectives of the two steps."""
    cfg = DanceDecoderConfig(dancer_num=3)
    out = {}
    for dtype, batch in dtypes:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model, state, step = make_trainer(cfg, dtype, mesh)
        x, cond = train_inputs(cfg, batch, TP_SEED)
        if mesh is not None:
            x, cond = shard_batch((x, cond), mesh)
        gen = torch.Generator(device="cuda").manual_seed(TP_SEED)
        reset_train_launches()
        res = {"metrics": [], "ms": [], "held": sum(p.numel() for p in model.parameters()), "comm": {}}
        with (plain_blocks(model) if mesh is None and plain else contextlib.nullcontext()):
            for i in range(2):
                torch.cuda.synchronize()
                before = copy.deepcopy(comm or {})
                t0 = time.perf_counter()
                state, m = step(state, x, cond, gen)
                res["metrics"].append({k: v.item() for k, v in m.items()})
                res["ms"].append(1e3 * (time.perf_counter() - t0))
                for k, v in (comm or {}).items():
                    was = before.get(k, [0, 0, 0.0, 0.0])
                    res["comm"][k] = [a + b - c for a, b, c in zip(res["comm"].get(k, [0, 0, 0.0, 0.0]), v, was)]
                res[f"grads{i + 1}"] = _whole_named(model, ((n, p.grad) for n, p in model.named_parameters()
                                                            if p.grad is not None))
                if i == 0:
                    res["params1"] = _whole_named(model, model.named_parameters())
        res["params2"] = _whole_named(model, model.named_parameters())
        res["ema2"] = _whole_named(model, state.ema_params.items())
        res["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        res["launches"] = train_launches()
        out[f"train_{dtype}"] = res
        del model, state, step
    torch.cuda.empty_cache()
    return out


def tp_sample(device, tp: int) -> dict:
    """Normal-mode `TCDiff._sample` of TP_CLIPS clips from the full-width
    bf16 TCDiff of cfg.train.tp = tp (under tp, a whole serving model of the
    gathered weights): the sample on the host and K1/K7/K2's launches."""
    runner = dp_tcdiff(device, tp=tp)
    cfg = runner.cfg.model
    g = torch.Generator(device="cuda").manual_seed(TP_SEED)
    cond = torch.randn((TP_CLIPS, 2 * cfg.seq_len + 1, cfg.cond_feature_dim), generator=g, device="cuda")
    x0 = 0.2 * torch.randn((TP_CLIPS, cfg.seq_len * cfg.dancer_num, 3), generator=g, device="cuda")
    before = serving_launches()
    sample = runner._sample(cond, x0, torch.Generator(device="cuda").manual_seed(TP_SEED)).cpu()
    return {"sample": sample, "launches": {k: v - before[k] for k, v in serving_launches().items()},
            "tp": runner.mesh.tp}


def _wait_for(path: str, what: str) -> None:
    t0 = time.perf_counter()
    while not os.path.exists(path):
        check(time.perf_counter() - t0 < 600, f"{what} did not come within 600 s")
        time.sleep(0.5)


def _tp_rank(rank: int, dp: int, store: str, work: str) -> None:
    """One rank of the tp phase (a spawned process) on a (dp, TP) mesh over
    gloo on card 0: wait for its turn (`work`/tp_go{dp}), run `tp_work` (the
    bf16 and f32 steps at tp alone; f32 under dp x tp) and, at dp = 1,
    `tp_sample`; hold each against the one-process references
    (`work`/tp_ref.pt) and save the errors, counts and times to
    `work`/tp{dp}_rank{rank}.pt."""
    world = dp * TP
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(max(1, 8 // world))  # the host's 8 cores over the group that runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed("cuda:0", backend="gloo", init_method=store)
    try:
        mesh = make_mesh(dp, TP, device=dev)
        _wait_for(os.path.join(work, f"tp_go{dp}"), "the tp phase's turn")
        dtypes = ((torch.bfloat16, TP_BATCH), (torch.float32, TP_F32_BATCH)) if dp == 1 else \
            ((torch.float32, TP_F32_BATCH),)
        got = tp_work(mesh, dtypes, comm=time_tp_collectives())
        sample = tp_sample(dev, TP) if dp == 1 else None
        ref = torch.load(os.path.join(work, "tp_ref.pt"), map_location="cpu", weights_only=False, mmap=True)
        res = {"dp": mesh.world, "tp": mesh.tp, "tp_rank": mesh.tp_rank, "errs": {}, "train": {}}
        for key, g in got.items():
            dtype = torch.bfloat16 if "bfloat16" in key else torch.float32
            res["errs"][key] = train_errs(g, ref[key], dtype, key_bias=True)
            res["train"][key] = {k: g[k] for k in ("ms", "held", "peak_gib", "launches", "comm")}
        if dp == 1:
            res["layer"], res["control"] = {}, {}
            for dtype in (torch.bfloat16, torch.float32):
                lay, want = tp_layer(mesh, dtype), ref[f"layer_{dtype}"]
                rel = rel_errs(lay, want)
                res["layer"][str(dtype)] = {"worst": _worst(rel), "top": _top(rel)}
                if rank == 0:
                    res["control"][str(dtype)] = tp_layer_control(lay, want)
        if sample is not None:
            res["sample_equal"] = torch.equal(sample["sample"], ref["sample"]["sample"])
            res["sample_err"] = (sample["sample"] - ref["sample"]["sample"]).abs().max().item()
            res["sample_launches"], res["sample_tp"] = sample["launches"], sample["tp"]
        torch.save(res, os.path.join(work, f"tp{dp}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


TP_LAYER_BATCH = 8  # the layer check's batch
# one decoder layer and final_layer at full width against one process's
# plain path (`tp_layer`): each output and gradient within this of its norm
# (`rel_errs`; the readings behind it: PERF.md, PR 17)
TP_LAYER_REL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# gradients a tp rank zeroes and flips in its own copy of the layer check,
# which the rule must refuse (`tp_layer_control`)
TP_CONTROL = ("final_layer.weight", "seqTransDecoder.stack.0.linear1.weight", "seqTransDecoder.stack.0.norm3.weight",
              "dx")


def tp_rule(key: str) -> dict:
    """The largest shares a tp step may reach against one process. f32: the
    dp phase's (loss and step-1 gradients 1, step-1 parameters 1, step-2
    parameters off 5e-2). bf16: the loss and the step-1 parameters at the
    dp rules. Its gradients are read (`rel_errs`) but held nowhere: two
    correct bf16 roundings of this 8-layer step, one process's kernel path
    and its plain path, differ on most gradients by more than half their
    norm, so a zeroed gradient reads much as a sound one; the bf16 split is
    held a layer at a time instead (`tp_layer`)."""
    if "bfloat16" not in key:
        return {"loss": 1.0, "grads1": 1.0, "params1": 1.0, "params2_off": 5e-2}
    return {"loss": 1.0, "params1": 1.0}


def tp_passes(e: dict, rule: dict) -> bool:
    """Whether the errors `e` (`train_errs`) keep within `rule` (`tp_rule`)."""
    return all((max(e[k]) if k == "loss" else e[k][0]) <= v for k, v in rule.items())


def tp_layer(mesh, dtype) -> dict:
    """Decoder layer 0 of the full-width model (its split linears, its three
    blocks over this rank's heads and FF columns, dropout 0.1) and
    final_layer (split on its input) forward and backward in `dtype`, on
    `mesh` (the state split over its tp ranks) or, with mesh None, in one
    process on the plain path: the output and the gradients of x, the
    memory, t and every parameter that has one, whole, on the host. A
    layer's bf16 roundings do not compound over depth as a whole step's
    do, so this holds the split's bf16 arithmetic."""
    cfg = DanceDecoderConfig(dancer_num=3)
    model, _, _ = make_trainer(cfg, dtype, mesh)
    layer = model.layers[0]
    g = torch.Generator(device="cuda").manual_seed(TP_SEED)
    rand = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    b, d = TP_LAYER_BATCH, cfg.latent_dim
    x, mem, t = (rand(*shape).to(dtype).requires_grad_()
                 for shape in ((b, cfg.tokens, d), (b, 2 * cfg.seq_len + 1, d), (b, d)))
    draws = layer.train_draws(g, x.shape, cfg.dropout)
    with (plain_blocks(model) if mesh is None else contextlib.nullcontext()):
        out = _lin(model.final_layer, layer.forward_train(x, mem, t, None, draws, cfg.dropout,
                                                          mesh=model.tp_mesh)).float()
    (out * rand(*out.shape)).sum().backward()
    res = {"out": out.detach().cpu(), **{k: v.grad.float().cpu() for k, v in (("dx", x), ("dmem", mem), ("dt", t))}}
    res.update(_whole_named(model, ((n, p.grad) for n, p in model.named_parameters() if p.grad is not None)))
    del model
    torch.cuda.empty_cache()
    return res


def tp_layer_control(got: dict, ref: dict) -> dict:
    """The layer rule against faults it must see: `got` with each of
    TP_CONTROL zeroed, or of flipped sign. Returns {"name fault": the worst
    relative error}, each of which must exceed TP_LAYER_REL."""
    out = {}
    for name in TP_CONTROL:
        for fault, fn in (("zeroed", torch.zeros_like), ("flipped", torch.neg)):
            out[f"{name} {fault}"] = _worst(rel_errs({**got, name: fn(got[name])}, ref))[0]
    return out


def check_tp_ranks(results: list, ref: dict, dp: int) -> None:
    """Each rank's steps against one process (`tp_rule`) and, at dp = 1,
    its layer (`tp_layer`, TP_LAYER_REL) with the layer rule's control
    (rank 0: each fault refused), K3-K5's launches (none: the tp layers run
    no train kernel), the parameters it holds, the state digests across the
    ranks and, at dp = 1, the tp sample bit-equal to one process's with
    K1/K7/K2 400 launches."""
    want_serving = DanceDecoderConfig().num_layers * DiffusionConfig().sampling_timesteps
    for r, res in enumerate(results):
        check((res["dp"], res["tp"]) == (dp, TP), f"tp rank {r}: mesh dp={res['dp']} tp={res['tp']}")
        for key, e in res["errs"].items():
            t = res["train"][key]
            shown = {k: v for k, v in e.items() if k != "digest" and not k.endswith("_rel_all")}
            rel = {k[:-4]: rel_summary(v) for k, v in e.items() if k.endswith("_rel_all")}
            print(f"tp (dp {dp} x tp {TP}) rank {r} (tp index {res['tp_rank']}) {key} against one process on the "
                  f"plain path (shares of each tolerance): {shown}; relative gradient errors {rel}; "
                  f"step wall ms {[round(v, 1) for v in t['ms']]} (one process {[round(v, 1) for v in ref[key]['ms']]}"
                  f"); peak {t['peak_gib']:.2f} GiB (one process {ref[key]['peak_gib']:.2f}); holds {t['held']} of "
                  f"{ref[key]['held']} parameters; K3-K5 launches {t['launches']}; tp collectives of the two steps "
                  f"[calls, f32 MB, s waiting for the card, s on the wire] "
                  f"{ {k: [v[0], round(v[1] / 1e6, 1), round(v[2], 3), round(v[3], 3)] for k, v in t['comm'].items()} }",
                  flush=True)
            rule = tp_rule(key)
            check(tp_passes(e, rule), f"tp rank {r}: the {key} steps disagree with one process: {e}; rule {rule}")
            check(t["held"] == TP_HELD and ref[key]["held"] == FULL_PARAMS,
                  f"tp rank {r}: holds {t['held']} parameters, expected {TP_HELD} of {FULL_PARAMS}")
            check(all(f == b == 0 for f, b in t["launches"].values()),
                  f"tp rank {r}: the train kernels ran under tp: {t['launches']}")
        for dtype in (torch.bfloat16, torch.float32):
            if "layer" not in res:
                break
            lay, lim = res["layer"][str(dtype)], TP_LAYER_REL[dtype]
            print(f"tp rank {r}: decoder layer 0 + final_layer in {dtype} against one process's plain path, the "
                  f"output and every gradient (relative errors, limit {lim}): worst {lay['worst']}, top "
                  f"{lay['top']}", flush=True)
            check(lay["worst"][0] <= lim, f"tp rank {r}: the {dtype} layer disagrees with one process: {lay}")
            if str(dtype) in res["control"]:
                ctl = res["control"][str(dtype)]
                print(f"tp rank {r}: the {dtype} layer rule's control, an output or gradient zeroed or of flipped "
                      f"sign (each must read above {lim}): {ctl}", flush=True)
                check(all(v > lim for v in ctl.values()), f"the {dtype} layer rule passes a fault: {ctl}")
        if dp == 1:
            counts = res["sample_launches"]
            print(f"tp rank {r}: TCDiff._sample of {TP_CLIPS} clips at tp={res['sample_tp']} (whole serving model, "
                  f"gathered weights) against one process: bit-equal {res['sample_equal']} (largest difference "
                  f"{res['sample_err']:.3e}); serving launches {counts}", flush=True)
            check(res["sample_equal"], f"tp rank {r}: the tp sample differs from one process's")
            check(all(counts[n] == want_serving for n in DEFAULT_SITES)
                  and sum(counts.values()) == len(DEFAULT_SITES) * want_serving,
                  f"tp rank {r}: serving launches {counts}, expected K1/K7/K2 {want_serving} each")
    for key in results[0]["errs"]:
        digests = {res["errs"][key]["digest"] for res in results}
        check(len(digests) == 1, f"tp (dp {dp}) {key}: the ranks' whole parameters and EMA differ")


def tp_phase(card: str, work: str) -> dict:
    """Phase 17: tensor parallelism. The ranks of a (1, TP) mesh and of a
    (2, TP) mesh are spawned on the one card over gloo at once; this
    process computes the one-process references on the plain train path,
    then the tp ranks run (bf16 and f32 steps, TCDiff._sample), then the dp
    x tp ranks (f32 steps). Returns K1/K7/K2's launches in the tp ranks'
    sampling, summed over the ranks."""
    t_phase = time.perf_counter()
    print(f"tp: spawning {TP} ranks of a (1, {TP}) mesh and {2 * TP} of a (2, {TP}) mesh on card 0, backend gloo",
          flush=True)
    groups = {dp: torch.multiprocessing.start_processes(_tp_rank, args=(dp, "file://" + os.path.join(work, f"tp_store{dp}"),
                                                                     work), nprocs=dp * TP, join=False,
                                                        start_method="spawn")
              for dp in (1, 2)}
    times = {}
    try:
        t0 = time.perf_counter()
        ref = tp_work(None, ((torch.bfloat16, TP_BATCH), (torch.float32, TP_F32_BATCH)))
        for key in ("train_torch.bfloat16", "train_torch.float32"):
            check(all(f == b == 0 for f, b in ref[key]["launches"].values()), "the plain reference launched a kernel")
        key = "train_torch.bfloat16"
        kernels = tp_work(None, ((torch.bfloat16, TP_BATCH),), plain=False)[key]
        spread = train_errs(kernels, ref[key], torch.bfloat16, key_bias=True)
        del kernels
        rel = {step: rel_summary(spread.pop(f"{step}_rel_all")) for step in ("grads1", "grads2")}
        print(f"tp: one process's bf16 spread, its kernel path against its plain path (shares of the dp rules) "
              f"{ {k: v for k, v in spread.items() if k != 'digest'} }; relative gradient errors (`rel_errs`) {rel}",
              flush=True)
        for dtype in (torch.bfloat16, torch.float32):
            ref[f"layer_{dtype}"] = tp_layer(None, dtype)
        ref["sample"] = tp_sample(torch.device("cuda", 0), 1)
        tmp = os.path.join(work, "tp_ref.pt.tmp")
        torch.save(ref, tmp)
        os.replace(tmp, os.path.join(work, "tp_ref.pt"))
        times["references"] = time.perf_counter() - t0
        results = {}
        for dp, ctx in groups.items():
            t0 = time.perf_counter()
            open(os.path.join(work, f"tp_go{dp}"), "w").close()
            try:
                while not ctx.join(timeout=5):
                    check(time.perf_counter() - t0 < 600, f"the (dp {dp}, tp {TP}) ranks did not finish within 600 s")
            except torch.multiprocessing.ProcessRaisedException as e:
                raise SmokeFailure(f"a tp rank failed:\n{e}") from None
            except torch.multiprocessing.ProcessExitedException as e:
                raise SmokeFailure(f"a tp rank exited: {e}") from None
            times[f"ranks dp {dp}"] = time.perf_counter() - t0
            results[dp] = [torch.load(os.path.join(work, f"tp{dp}_rank{r}.pt"), weights_only=False)
                           for r in range(dp * TP)]
            check_tp_ranks(results[dp], ref, dp)
    finally:  # every process this phase started ends with it
        for ctx in groups.values():
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    print(f"tp phase on {card}: {time.perf_counter() - t_phase:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in times.items())}); K3-K5 0 launches on every tp rank, "
          f"K1/K7/K2 {DanceDecoderConfig().num_layers * DiffusionConfig().sampling_timesteps} a sampling call a rank",
          flush=True)
    return {k: sum(res["sample_launches"][k] for res in results[1]) for k in serving_launches()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    try:
        card = card_line()
        print(f"card: {card}")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        t0 = time.perf_counter()
        _build.build_all(BUILD)
        for name in BUILD:
            _build.load(name)
        print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

        gen = torch.Generator(device="cuda").manual_seed(0)
        figures = compare_kernels(gen)
        for name, products in compare_gemms(gen).items():
            figures[name]["products"] = products
        wgmma_products = compare_wgmma(gen)
        figures.update(compare_serving_ops(gen))
        figures["attention"]["bodies"] = compare_attention_bodies(gen)
        figures["layernorm"].update(compare_ln_rows(gen))
        figures.update(compare_block_kernels(gen))
        figures["ca_block"]["over_cache"] = compare_ca_kv(gen)
        for name, extra in compare_wgmma_kernels(gen).items():
            figures[name].update(extra, wgmma_products=wgmma_products[name])
        figures.update(compare_train_kernels(gen))
        for name, extra in compare_train_attention(gen).items():
            figures[name].update(extra)
        for name, products in compare_backward_gemms(gen).items():
            figures[name]["bwd_products"] = products
        for name, bodies in compare_new_bodies(gen).items():
            figures[name]["bodies"] = bodies
        for name, extra in profile_k4_k7(gen).items():
            figures[name].update(extra)
        launches = serve(gen)
        t0 = time.perf_counter()
        launches.update(serve_per_op(gen))
        other_samplers(gen)
        print(f"per-op path and other samplers took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for name, n in serve_generate(gen, card).items():
            launches[name] += n
        print(f"generate phase took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for name, n in serve_block_configs(gen, card).items():
            launches[name] = launches.get(name, 0) + n
        print(f"block-kernel configurations took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_counts = train(card)
        print(f"train phase took {time.perf_counter() - t0:.1f} s")
        opt_in = opt_in_phase(card, gen)
        work = tempfile.mkdtemp(prefix="tcdiff_data_")
        try:
            loop_counts, data = data_phase(card, work)
            cli_serving, cli_counts = cli_phase(card, work, data)
            dp_counts = dp_phase(card, work, data)
            tp_counts = tp_phase(card, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    for name, n in cli_serving.items():
        launches[name] += n + dp_counts["serving"][name] + opt_in["serving"].get(name, 0) + tp_counts.get(name, 0)
    launches.update({name: fwd + loop_counts[name][0] + cli_counts[name][0] + dp_counts["train"][name][0]
                     + opt_in["train"][name][0] for name, (fwd, _) in train_counts.items()})
    bwd = {name: {"bwd_launches": b + loop_counts[name][1] + cli_counts[name][1] + dp_counts["train"][name][1]
                  + opt_in["train"][name][1]} for name, (_, b) in train_counts.items()}
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s, the kernels' build included")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"tcdiff_torch/csrc/{name}.cu",
         "replaces": REPLACES[name], "launches": launches[name], **figures[name], **bwd.get(name, {})}
        for name in KERNELS
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
