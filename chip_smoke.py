#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

1. builds the hand-written CUDA kernels from src/repro_torch/csrc (nvcc,
   sm_90a) and prints the build seconds and the compiler's register report;
2. prints the card's name and power limit (nvidia-smi);
3. kernel phase: holds each kernel against its plain PyTorch version on the
   card, at the main path's shapes and at the shape sweeps of
   tests/test_kernels.py (swa_attention in both dtype routes: bf16 on the
   tensor cores, f32 on the CUDA cores; rmsnorm also with a gain per head,
   w [G, D], at mamba2-780m's and jamba's gated-norm shapes, at every
   [D] width of the main paths in both dtypes, on each side of each of
   its route edges and on unaligned views, printing the route and design
   the built library reports for each main-path width; swa_attention also
   with queries and keys of different lengths and queries at an offset,
   at whisper-base's encoder, cross-attention and decode shapes), and times
   kernel, plain version and the PyTorch library call that computes the
   same function (yardstick only; for the [G, D] route two calls,
   F.rms_norm then the product with 1 + w); and holds the gradients of
   the rmsnorm (w [D] and [G, D]) and swa_attention autograd Functions
   (kernel forward, explicit backward formula) against torch.autograd of
   the plain versions;
4. serve phase: qwen2.5-3b at full published width, random weights from a
   seeded CUDA generator, serve(batch=4, prompt_len=128, new_tokens=32);
   the rmsnorm kernel must run exactly 73 times per decode step;
5. prefill phase: make_prefill on a [2, 1024] prompt (36 swa_attention and
   73 rmsnorm launches), logits held against the same prefill through the
   plain versions, and against step-by-step decode over the same prompt;
   two faulty-cache controls show that the decode-vs-prefill gate fails
   when the cache is wrong;
6. moe_serve phase: qwen3-moe-30b-a3b at full published width (48
   layers, 128 experts top-8, 30.5 B parameters in bf16, random from a
   seeded CUDA generator): the serve of phase 4 (97 rmsnorm launches a
   decode step, no swa_attention), a [2, 1024] prefill at the config's
   capacity factor (97 rmsnorm and 48 swa_attention launches) held against
   the plain versions with the flipped routing choices counted, decode
   against prefill at capacity factor 8 over CONTROL_POSITIONS positions
   with the two faulty-cache controls, moe_ffn at the decode and prefill
   shapes under torch.cuda.set_sync_debug_mode("error"), and a profile of
   a prefill and a decode step with the device time by group;
7. vlm phase: qwen2-vl-2b at full published width (M-RoPE, 256 patch
   embeddings): a [2, 1024] prefill with patch embeddings (57 rmsnorm and
   28 swa_attention launches) held against the plain versions, the same
   weights and inputs without M-RoPE as a control that must fail that
   contract, a profile of the prefill, and the serve of phase 4 (57
   rmsnorm launches a decode step);
8. ssm phase: mamba2-780m at full published width and depth (48 layers,
   48 heads of 64, state 128, 857 M parameters, random from a seeded CUDA
   generator): the serve of phase 4 (97 rmsnorm launches a decode step,
   no swa_attention), a [2, 1024] prefill (97 rmsnorm launches, 48 of
   them with the gated norm's [48, 64] weight) held against the plain
   versions, decode against prefill over CONTROL_POSITIONS positions with
   two faulty-state controls (every cache zeroed, the SSM states zeroed),
   both in bf16 and with f32 activations, the gates on the f32 run
   (SSM_GATED), a profile of a prefill and a decode step with the device
   time by group; then training with f32 masters and AdamW: one step at
   the initial weights through the kernels against the plain versions (in
   f32 activations, gated with two controls; in bf16, the loss gated and
   the gradient reported), 20 steps of 8 x 128 tokens with f32
   activations (finite, falling losses, exactly 97 rmsnorm launches a step
   and no fused_sgd_update) and 5 in bf16, with step time, tokens/s and
   peak memory;
9. hybrid phase: jamba-v0.1-52b at full published width cut to one
   8-layer block of its 32 (7 mamba mixers of 128 heads, one attention
   layer, 4 MoE FFNs of 16 experts top-2, 13.3 B parameters): a [2, 1024]
   prefill (24 rmsnorm launches, 7 with the [128, 64] weight, and one
   swa_attention) held against the plain versions, decode against
   prefill at capacity factor 8 with the two faulty-state controls, both
   gated in bf16 and with f32 activations (HYBRID_GATED), and the serve
   of phase 4 (24 rmsnorm launches a decode step);
10. audio phase: whisper-base at full published width and depth (6 + 6
   layers, d_model 512, 8 heads of 64, 1,500 frame embeddings, 97 M
   parameters in bf16, random from a seeded CUDA generator): a [4, 448]
   prefill over frames at scale 0.1 (18 swa_attention launches: 6 encoder
   self-attentions over the frames, 6 causal decoder self-attentions, 6
   cross-attentions; no rmsnorm) held against the plain versions, decode
   against prefill over CONTROL_POSITIONS positions with the encoder's
   output in the cache (6 swa_attention launches a step, the
   cross-attention's one query row against 1,500 frames) with two
   controls that must fail that gate (the KV cache zeroed; the encoder's
   output zeroed), a profile of a prefill and a decode step, and the serve
   of phase 4 on a cache whose encoder output stays at zeros, as the
   reference serves it;
11. train phase: the elastic trainer on ResNet-110 at its full published
   size (random weights from a seeded CUDA generator, CifarLike data of
   CIFAR-10's 50,000 images, 128 images per worker): the paper's Table 2
   pattern on one card, 20 steps at w = 4, stop, restart at w = 8 with
   the eq. 7 LR rescale for 10 steps, then a restart at w = 8 for 40
   more. One fused_sgd_update launch per step, a bit-exact restore,
   finite and falling loss, and a held-out loss and accuracy better than
   chance; then the kernel against the plain version on one set of the
   trained state's gradients, one train step's loss and gradient on the
   card against the same step in f32 on the CPU, an exact-resume check
   (5 + 5 steps against 10) and a profile of the train step;
12. sched phase: the paper's pipeline (tests/test_system.py's story) at
   full size through the port's scheduler stack: a fresh ResNet-110
   trainer takes 30 steps at w = 1, eq. 1 is fitted to its losses, the
   per-worker forward and forward + backward of one 128-image batch are
   timed on the card (Table 1's way, at depth 110), each w in 1, 2, 4, 8
   gets that compute time plus the analytic communication term of eqs.
   2-4 at the paper's 100 Gbit/s InfiniBand (no measurement of the
   card's fabric), eq. 5 is fitted to those step times, the doubling
   heuristic sizes the job on 8 GPUs, and the trainer restarts at that w
   for 10 steps (one fused_sgd_update launch a step, 40 in all). Then
   Table 3 through the port's simulator, at the paper's calibration and
   with every job's step time from the card's profile, at the measured
   stop + restart seconds and at the paper's 10 s; the table and
   reference engines must agree bit for bit;
13. lm_train phase: the dense LM trainer on qwen2.5-3b at full width and
   depth, f32 master parameters in one flat buffer (random, from a seeded
   CUDA generator), bf16 compute, the reference trainer's defaults
   (AdamW, TokenStream, 8 sequences of 128 tokens, base LR 3e-4) on a
   warmup-cosine schedule (warmup 5, 30 steps). First, at the initial
   weights, one step's loss and flat gradient through the kernels against
   the same step through the plain versions called directly (autograd
   through them), with two controls that must fail that gate (labels
   shifted by one position; one layer's mlp/wo gradient zeroed); then 30
   steps (finite losses, the mean of the last 5 below the first, exactly
   73 rmsnorm and 36 swa_attention launches a step and no
   fused_sgd_update), the step time, tokens/s and peak memory, a profile
   of 2 steps, the f32 lm_logits products timed alone, and an exact-resume
   check at the smoke config (5 + 5 steps through the CheckpointStore
   against 10);
14. dp phase: data-parallel ResNet-110 at full size through
   ``launch.explicit_allreduce``: 4 ranks, each its own process with its
   own CUDA context on the one card, 128 images each (global batch 512,
   LR 1.2e-3 by eq. 7), 5 steps under each of psum, ring and
   doubling_halving from one seeded init on the same batches, then 3 ranks
   under ring. The ranks exchange gradients over gloo through pinned host
   memory (transport "gloo-host"): every exchange time here is a host
   loopback time, not an all-reduce number of the card. Gates: ring and
   halving-doubling leave every rank with rank 0's bits; one
   fused_sgd_update launch per rank per step; each rank's update p5 - p0
   agrees with the one-process train step at the global batch, and two
   faulty exchanges built here (the sum not divided by w; the all-gather
   skipped) fail that gate; the first step's exchanged gradients agree
   with dist.all_reduce's;
15. lm_dp phase: the LM job under the paper's exchange, qwen2.5-3b at full
   width cut to 2 layers (776 M f32 parameters), 4 ranks sharing the card
   over gloo as in phase 14, 2 rows of 128 tokens each, momentum SGD at a
   constant LR of 0.05, 2 steps under each of psum, ring and
   doubling_halving: the same gates (each rank measures its update against
   the one-process step's, saved to a file, and psum's ranks their spread
   by two all-reduces: a full-width LM's parameters are not shipped back),
   5 rmsnorm, 2 swa_attention and 1 fused_sgd_update launches per rank and
   step, and the bytes each rank sends per all-reduce (4.66 GB for the
   ring).

Launch counts are set to 0 just before each serve, each counted prefill,
the audio decode, the training runs, the sched phase's two segments and
the LM step and training runs and read just after; each dp and lm_dp rank
does the same around its steps under each algorithm. Any failed check
raises, and the script exits non-zero.
The last two lines are the kernels' JSON line and the device line. It
exits non-zero, printing no result, when there is no CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import resnet110  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.core.elastic import ElasticTrainer  # noqa: E402
from repro_torch.core import scheduler  # noqa: E402
from repro_torch.core.convergence import fit_convergence  # noqa: E402
from repro_torch.core.jobs import make_workload  # noqa: E402
from repro_torch.core.resource_model import (fit_resource_model,  # noqa: E402
                                             profile_to_speeds)
from repro_torch.core.simulator import (TABLE3_STRATEGIES, run_table3,  # noqa: E402
                                        simulate)
from repro_torch.data.synthetic import CifarLike, TokenStream  # noqa: E402
from repro_torch.engine.steps import (init_train_state, make_decode_step,  # noqa: E402
                                      make_prefill, make_train_step,
                                      value_and_flat_grad)
from repro_torch.collectives import dist as cdist  # noqa: E402
from repro_torch.collectives import cost  # noqa: E402
from repro_torch.engine import steps as steps_module  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import fused_update as sgd_kernel  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_kernel  # noqa: E402
from repro_torch.kernels import swa_attention as swa_kernel  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import explicit_allreduce as dp  # noqa: E402
from repro_torch.launch import mesh as mesh_module  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers as mlayers  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models import spec as pspec  # noqa: E402
from repro_torch.models.registry import build_model, decode_window  # noqa: E402
from repro_torch.optim import adamw, sgd, warmup_cosine  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50 * 2**20

DEVICE = "cuda"
ARCH = "qwen2.5-3b"
SERVE = dict(batch=4, prompt_len=128, new_tokens=32)
PREFILL_SHAPE = (2, 1024)
TOL = {"rmsnorm": {torch.float32: 1e-5, torch.bfloat16: 2e-2},
       "swa_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
       "fused_sgd_update": {torch.float32: 1e-5}}
# tests/test_kernels.py sweeps, plus danube's head dim 80, a width that
# is not a multiple of the 16-byte vector, and the edges of the bf16
# kernel's 64-row q tiles and 64-key K/V tiles: many band-skipped tiles
# with a window that is a multiple of no tile, a ragged S at the prefill's
# D, D = 80 with a ragged S and a window, an S within one tile at D = 256.
SWA_SWEEP = [(2, 256, 64, None, True), (2, 256, 64, 128, True),
             (1, 384, 128, 96, True), (3, 128, 128, None, False),
             (1, 130, 32, 64, True), (2, 64, 256, 32, True),
             (2, 200, 80, None, True), (4, 2048, 128, 512, True),
             (2, 1000, 128, None, True), (2, 333, 80, 100, True),
             (1, 64, 256, None, True)]
# Queries and keys of different lengths, queries at an offset
# (bh, sq, sk, d, causal, window, q_offset): whisper-base's encoder
# self-attention (1,500 frames: 23 tiles of 64 and one of 28), its
# decoder's cross-attention at Whisper's 448-token text context and at a
# decode step's one query row, and causal continuations at an offset,
# with a window that crosses key tiles and without one.
SWA_CROSS_SWEEP = [(32, 1500, 1500, 64, False, None, 0),
                   (32, 448, 1500, 64, False, None, 0),
                   (32, 1, 1500, 64, False, None, 0),
                   (4, 100, 1124, 128, True, 300, 1024),
                   (2, 20, 84, 64, True, None, 64)]
RMS_SWEEP = [(4, 128, 512), (1, 7, 64), (300, 1024), (2, 2048), (3, 100)]
# rmsnorm's route edges (csrc/rmsnorm.cu), in rows of 16-byte vectors:
# 32 | 33 (small | wide: bf16 d = 256 | 264, f32 128 | 132), 128 | 129 (a
# row within a warp | across a block's warps: bf16 1024 | 1032, f32
# 512 | 516) and 1024 | 1025 (wide | general: bf16 8192 | 8200, f32
# 4096 | 4100); each width runs in both dtypes
RMS_EDGES = (128, 132, 256, 264, 512, 516, 1024, 1032, 4096, 4100, 8192, 8200)
# unaligned views: (d, element offset into a larger buffer)
RMS_UNALIGNED = ((2048, 1), (64, 3), (1536, 2))
SGD_SWEEP = (7, 65536, 100001)
# The trainer: Table 2's 4 -> 8 restart at the paper's 128 images per GPU,
# then a third segment at w = 8 long enough to learn. The reference's
# ResNet-110 (GroupNorm, no zero-init of the residual branches) starts at
# loss 5.46; from a base LR of 1e-3 up (4e-3 and more at w = 4) it spikes
# (to 19-141) and ends near ln 10, the loss of uniform logits. At 3e-4
# per worker the held-out loss after 70 steps is 1.55 with accuracy 0.49;
# at the six other LRs of chip_train_lr.py's sweep it stays at or above
# 2.15 (NVIDIA H100 80GB HBM3, 700 W).
TRAIN_SEGMENTS = ((4, 20), (8, 10), (8, 40))  # (w, steps)
TRAIN = dict(m_per_worker=128, base_lr_1w=3e-4)
TRAIN_DATASET = 50_000  # CIFAR-10's training set
TRAIN_LOG_EVERY = 5
# Learning below chance, on a batch the trainer never drew (its noise is
# seeded by the step): loss under ln 10 - 0.2 and accuracy at least twice
# chance's 0.1.
HELD_OUT = dict(step=10_000, images=1024)
HELD_LOSS_MAX = math.log(10) - 0.2
HELD_ACCURACY_MIN = 0.2
# One train step on the card against the same step in f32 on the CPU, at
# the trained state. The largest readings of chip_train_lr.py's sweep
# (seven LRs, states at steps 0, 20, 30 and 70; NVIDIA H100 80GB HBM3,
# 700 W): f32 on the card, loss 4e-7, flat gradient 1.6e-3, worst leaf
# 7.4e-3; bf16, loss 2.4e-3, flat gradient 0.15 (0.073 at 3e-4, step 70)
# except at the states that spiked and settled near ln 10 (up to 0.96).
# bf16's worst leaf reaches 0.82 outside those and is reported, not
# gated. A fault in a conv, a norm or a cast moves these by O(1).
STEP_CHECK_IMAGES = 32
STEP_LIMITS = {"gpu_f32": {"loss_rel_err": 1e-5, "flat_rel_err": 1e-2,
                           "worst_leaf_rel_err": 5e-2},
               "gpu_bf16": {"loss_rel_err": 1e-2, "flat_rel_err": 0.25}}
# Decode against prefill at full depth with random weights: the logits
# have many near-ties, so bf16 noise alone flips some argmaxes (0.948
# agreement over [2, 1024] on an H100 at 700 W; kernels against plain
# versions, 0.954). The gate sits below that noise and far above the
# faulty controls (0.016 and 0.008 on the same card), which step the
# decoder over the first CONTROL_POSITIONS prompt tokens.
DECODE_AGREE_MIN = 0.90
CONTROL_POSITIONS = 128
CONTROL_FAULTS = ("pos_lag", "no_cache")
# The LM trainer: qwen2.5-3b at full width and depth with the reference
# trainer's defaults (src/repro/launch/train.py: AdamW, TokenStream, 8
# sequences of 128 tokens per worker, base LR 3e-4) on warmup_cosine with
# a warmup of 5 over 30 steps; the exact-resume check runs 5 + 5 steps at
# the smoke config.
LM = dict(batch=8, seq=128, steps=30, base_lr=3e-4, warmup=5)
LM_RESUME = (5, 5)
# One step at the initial weights through the kernels against the same
# step through the plain versions called directly (autograd through
# them), both in the bf16 compute the trainer runs. Set before the first
# run from this reasoning: the two routes run the same bf16 graph and
# differ only where the kernels round (rmsnorm's f32 statistics summed in
# another order, an occasional bf16 ulp in its output; the attention
# kernel's bf16 products with P split hi + lo against f32 attention, about
# 2^-9 relative) and in the backward formulas against autograd (f32
# rounding). On the CPU, the port against the reference (which differ more:
# the reference also rounds P to bf16) read a flat gradient error of
# 0.009-0.014 and a worst per-layer leaf of 0.013-0.032 at 2 layers
# (tests/test_torch_train_lm.py); 36 layers carry such perturbations
# further, so 0.005-0.03 and 0.01-0.06 are expected here. The limits are
# that test's: loss 1e-2 relative (the bf16 contract), relative L2 of the
# flat gradient 0.05 and of its worst per-layer leaf 0.1. Two controls
# must fail them: labels shifted by one position (flat error near 1) and
# one layer's mlp/wo gradient zeroed (that leaf's error is 1).
LM_STEP_LIMITS = {"loss_rel_err": 1e-2, "flat_rel_err": 0.05,
                  "worst_leaf_rel_err": 0.1}
LM_CONTROLS = ("labels_shifted", "one_layer_zeroed")
# kernel-name substrings of an LM train step's parts, for its profile
LM_KERNEL_GROUPS = {
    "rmsnorm": ("rmsnorm",),
    "swa_attention": ("swa_attention",),
    "gemm": ("gemm", "nvjet", "xmma", "cutlass"),
    "index": ("index", "scatter", "gather"),
    "softmax_logsumexp": ("softmax", "logsumexp"),
    "reduce": ("reduce_kernel",),
    "elementwise": ("elementwise", "vectorized"),
}
# The paper's pipeline (sched phase): tests/test_system.py's story on
# ResNet-110 at full size. SCHED_STEPS at w = 1, then at the allocation of
# the doubling heuristic on SCHED_CAPACITY GPUs; the job needs
# SCHED_EPOCHS in all (the paper's ResNet-110 runs, Table 2). The profile
# is the median of SCHED_REPS timed calls on the host clock with the
# device synced, after two untimed ones.
SCHED_STEPS = (30, 10)
SCHED_EPOCHS = 160.0
SCHED_WS = (1, 2, 4, 8)
SCHED_CAPACITY = 8
SCHED_REPS = 7
RESNET_PARAMS = 1_727_962
# The paper's Table 1 (K40m, its cluster's measurements, not the card's):
# for w workers, forward and backward ms of a 128-image batch, step ms and
# images/s, as benchmarks/table1_profiling.py lists them.
PAPER_TABLE1 = {1: (108.0, 236.5, 402.5, 318.0), 2: (110.2, 274.6, 427.2, 576.2),
                4: (107.1, 290.1, 444.3, 1152.4), 8: (106.0, 307.4, 470.2, 2177.8)}
PAPER_RESTART_SECONDS = 10.0  # the paper's stop + restart (§6)
# run_table3's default traces: contention level -> (mean gap s, jobs)
SCHED_CONTENTION = {"extreme": (250.0, 206), "moderate": (500.0, 114),
                    "none": (1000.0, 44)}
# Data parallel: the train phase's first segment (w = 4, 128 images per
# worker, base LR 3e-4) as 4 processes, then 3 under ring. ResNet-110's
# 1,727,962 parameters are a multiple of neither 3 nor 4, so both pad.
DP = dp.DPRun(world=4, steps=5, m_per_worker=TRAIN["m_per_worker"],
              base_lr_1w=TRAIN["base_lr_1w"], timeout_s=180)
DP_W3 = dataclasses.replace(DP, world=3, algorithms=("ring",))
# Each rank's update p5 - p0 against the one-process step at the global
# batch: relative L2 error below DP_UPDATE_LIMIT. Set before the first run
# from this reasoning: per image the forward and backward are the same
# bf16 computations in both; what differs is where the batch sum is
# rounded (each rank's bf16 weight gradient over 128 images, summed in
# f32, against one bf16 rounding over 512) and cuDNN's choice of
# algorithm at 128 and 512 images, about 2^-9 per element, so 0.003-0.01
# is expected after 5 steps. A faulty exchange is far off: the sum not
# divided by w gives an error of w - 1 = 3; the all-gather skipped leaves
# each rank its own segment of the sum and partial sums elsewhere, 0.47
# even if every rank had the same gradient. The limit sits 10x above the
# expectation and 4.7x below the nearer control.
DP_UPDATE_LIMIT = 0.1
# An f32 limit for sums of the same 4 f32 terms in another order (first
# step's exchanged gradient against dist.all_reduce's, and psum's ranks
# against each other): max |a - b| / max |b|.
DP_F32_LIMIT = 1e-5
DP_FAULTS = ("not_divided", "no_all_gather")
# The MoE and VLM decoder families at full published width (moe_serve and
# vlm phases), each served as the qwen2.5-3b cell is: SERVE, and a prefill
# of PREFILL_SHAPE held against the plain versions under the bf16 contract
# (relative max error < 0.08, argmax agreement > 0.95). Set before the
# first run from this reasoning. Kernels and plain versions differ only in
# rmsnorm's rounding (an occasional bf16 ulp) and attention's (P split
# hi + lo against f32), as on qwen2.5-3b, where the prefill read 0.9517;
# every GEMM sees the same inputs in both runs until those differences
# reach it. The MoE adds routing: its router logits are bf16 values, so a
# perturbed hidden state can move an assignment across the 8th/9th place.
# The reference's expert weights are drawn with a fan-in of E x D (the
# "experts" axis is not the stacked "layers" axis), so at the init an
# expert's output is about 1e-3 of the residual stream and a flipped
# choice moves the logits far less than the attention differences do: the
# same contract is expected to hold, and the phase reports the flipped
# routing choices in the first and last layer beside it.
MOE_ARCH, VLM_ARCH = "qwen3-moe-30b-a3b", "qwen2-vl-2b"
MOE_PARAMS, VLM_PARAMS = 30_532_110_336, 1_777_088_000  # param_count() of each
# Decode against prefill for the MoE at the reference's capacity factor
# for that check (tests/test_decode_consistency.py): at the config's 1.25
# a [2, 1024] prefill has C = 80 slots an expert and drops assignments
# while one-token decode never does. The gate is decode_gate's, over the
# first CONTROL_POSITIONS positions, with both faulty-cache controls.
MOE_DECODE_CF = 8.0
# The VLM's control: the same weights and tokens through the config with
# mrope=False. Text rows keep their relative offsets (RoPE sees only
# differences), but the 256 patch rows lose their grid coordinates and
# every text row sees the patches at other offsets, so a quarter of the
# rows and their attention change; that must fail the contract, or
# M-RoPE is not in effect.
# aten ops of a serving step, for its device time by group (op_group);
# GEMMs are told apart by their operands' shapes
DISPATCH_OPS = ("aten::sort", "aten::argsort", "aten::searchsorted",
                 "aten::gather", "aten::topk")
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
# The SSM and hybrid families (ssm and hybrid phases). mamba2-780m at full
# published width and depth; jamba-v0.1-52b at full published width, cut
# to one 8-layer block of its 32 layers (its 51.5 B bf16 parameters, about
# 103 GB, do not fit one 80 GB card): the block holds every layer kind of
# the model (7 mamba mixers, 1 attention layer, 4 MoE and 4 dense FFNs).
SSM_ARCH, HYBRID_ARCH = "mamba2-780m", "jamba-v0.1-52b"
HYBRID_LAYERS = 8
SSM_PARAMS, HYBRID_PARAMS = 857_219_328, 13_267_598_848  # param_count() of each
# Decode against prefill: an SSM never reads pos, so the pos_lag control
# would pass and prove nothing. The controls zero every cache before each
# step, or only the SSM states (the conv windows and the KV cache kept).
# Which runs the SSM and hybrid gates read. At the reference's init (A_log
# 0, dt_bias 0, and a gated norm that gives every mixer's output an RMS of
# about 1) each Mamba-2 mixer adds a fresh, rounding-sensitive term to the
# residual stream, so rounding differences grow with depth, in the
# reference as in the port. On the CPU (cpu_ssm_sensitivity.py, one
# 256-token prompt through the same weights at full width) the
# reference's own bf16 logits against its f32 logits read rel err 0.079,
# 0.198, 0.264 and 0.381 and argmax 0.930, 0.891, 0.758 and 0.590 at 4, 8,
# 12 and 24 layers; the port's read 0.118, 0.146, 0.238 and 0.373 and
# 0.941, 0.902, 0.773 and 0.594; its f32 logits agree with the reference's
# within 2.1e-4. On an H100 (NVIDIA H100 80GB HBM3, 700 W) a [2,1024]
# mamba2-780m prefill through the kernels against the plain versions read
# rel err 0.30 and argmax 0.71 in bf16, decode against prefill argmax
# 0.35, and the plain route's bf16 train gradient lay 1.33 (flat relative
# L2) from its f32 gradient, so 20 bf16 AdamW steps did not lower the loss.
# So at 48 layers the bf16 readings cannot tell a right kernel from
# rounding: the SSM gates read the same runs with f32 activations (the
# embedding's rows kept in f32 and f32 caches; every rmsnorm call then
# takes the kernel's f32 route, with [D] and [G, D] weights), where the
# contract (0.08 / 0.95; decode_gate) and the LM trainer's step limits
# (loss 1e-2, flat 0.05, worst per-layer leaf 0.1; the f32 step read
# 8.5e-8, 1.5e-3 and 3.0e-3 on the H100) must hold, and the controls must
# fail them; its bf16 runs, the path a user serves and trains, have their
# launches and the bf16 step's loss gated and their agreement reported.
# The hybrid's block of 7 mixers stays inside the bf16 contract on the
# H100 (kernels vs plain 0.036 / 0.973, decode vs prefill 0.918 / 0.073),
# so both its bf16 and its f32 runs are gated.
SSM_GATED, HYBRID_GATED = ("f32",), ("bf16", "f32")
SSM_CONTROL_FAULTS = ("no_cache", "ssm_state_zeroed")
# The SSM trainer: the LM trainer's defaults (8 x 128 tokens, AdamW, base
# LR 3e-4, warmup 5): 20 steps with f32 activations, gated on a falling
# loss, then SSM_BF16_STEPS in bf16, the trainer's own compute, timed. At
# this init the loss moves little in 20 steps (on the H100, a last-5 mean
# 0.006 below the first loss with f32 activations, 0.002 above it in
# bf16), so the f32 steps run with deterministic algorithms, and the loss
# of a held-out batch must fall too (11.355 to 11.237 on the H100).
SSM_TRAIN = dict(batch=8, seq=128, steps=20, base_lr=3e-4, warmup=5)
SSM_BF16_STEPS = 5
SSM_BF16_LOSS_LIMIT = 1e-2  # the bf16 step's loss, kernels vs plain
# The audio family (audio phase): whisper-base at full published width and
# depth (arXiv:2212.04356: 6 + 6 layers, d_model 512, 8 heads of 64, d_ff
# 2048, vocab 51,865, 1,500 frame embeddings from the stubbed front end),
# nothing cut. A prefill of AUDIO_PREFILL tokens (Whisper's 448-token text
# context) over frames at scale 0.1, as tests/test_decode_consistency.py
# draws them, held to the plain versions under the bf16 contract, as the
# decoder-only families are: kernels and plain versions differ only in
# attention's rounding (P split hi + lo against f32 softmax weights), here
# in 18 attentions a pass (6 encoder, 6 decoder, 6 cross) of 64-wide heads
# over 1,500 frames, no rmsnorm. Decode against prefill over
# CONTROL_POSITIONS positions by decode_gate, with the encoder's output in
# the cache, and two controls that must fail it: "no_cache" (the KV cache
# zeroed before every step) and "enc_zeroed" (the encoder's output zeroed:
# the cross-attention reads no audio). The serve of phase 4 runs on a
# cache whose encoder output stays at zeros, as the reference's serve loop
# passes no frames.
AUDIO_ARCH = "whisper-base"
AUDIO_PARAMS = 97_241_088  # param_count()
AUDIO_PREFILL = (4, 448)
AUDIO_FRAMES_SCALE = 0.1
AUDIO_CONTROL_FAULTS = ("no_cache", "enc_zeroed")
# The LM job under the paper's exchange (lm_dp phase): qwen2.5-3b at full
# published width cut from 36 layers to LM_DP_LAYERS (four full-width ranks
# of 36 layers do not share one 80 GB card: one alone peaks at 67.8 GB in
# the lm_train phase), 776,485,888 f32 parameters, as 4 spawned ranks
# sharing the card over gloo, 2 rows of 128 tokens each (global batch 8 x
# 128), momentum SGD at a constant LR of 0.05 (the reference example's),
# 2 steps under each of psum, ring and doubling_halving, each step's
# exchange timed (the untimed first-step check has already set up the
# pinned buffers and gloo's pairs), so 2 warm exchanges an algorithm and
# rank. Per rank and step: 5 rmsnorm (2 a layer and the final norm), 2
# swa_attention and 1 fused_sgd_update launches, the last at
# n = LM_DP_PARAMS, which the kernel phase holds against the plain update
# (the one-process reference launches the same kernel). The
# faulty-exchange controls run 1 step each, with no first-step check.
LM_DP_LAYERS = 2
LM_DP_PARAMS = 776_485_888
LM_DP = dp.DPRun(cfg=dataclasses.replace(get_config(ARCH), n_layers=LM_DP_LAYERS),
                 world=4, steps=1, m_per_worker=2, seq=128, base_lr_1w=0.05 / 4,
                 timeout_s=240)
# One timed step under each exchange (two until the shard phase came: the
# smoke keeps under its time limit). Each rank's update p1 - p0 against
# the one-process step at the global
# batch of 8 x 128 tokens (same init, batches and LR): relative L2 error
# below LM_DP_UPDATE_LIMIT. Set before the first run from this reasoning.
# Per token the forward and backward are the same bf16 computations in
# both; what differs is where the batch sum is rounded (each rank's bf16
# weight gradients over 256 tokens, summed in f32 by the exchange, against
# one bf16 rounding over 1,024 tokens) and cuBLAS's choice of algorithm at
# 256 and 1,024 rows, about 2^-9 relative per rounded element. Carried
# through 2 layers and 2 SGD steps (as it was set) that is 0.003-0.02 (on the CPU the
# port's and the reference's bf16 gradients, which round at more places,
# differ by 0.009-0.014 at 2 layers: tests/test_torch_train_lm.py). A
# faulty exchange is far off: the sum not divided by w gives w - 1 = 3;
# the all-gather skipped leaves each rank its own segment of the sum and
# partial sums elsewhere, about 0.5. The limit is the dp phase's 0.1: 5x
# above the expectation's top and 5x below the nearer control.
LM_DP_UPDATE_LIMIT = 0.1


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync_time() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def time_ms(fn, arg_sets, iters: int = 50) -> float:
    """Time per call between CUDA events around back-to-back calls of
    fn(*args), cycling through arg_sets so that they do not all hit the L2
    cache. Includes whatever the host adds between launches."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn, n: int) -> tuple[dict[str, float], int, dict]:
    """Device time by kernel name (us) and the number of kernels over n
    calls of fn, from torch.profiler's CUDA events, and a listing of the
    device events per call: count, time and streams of each name.

    User annotations (``record_function`` ranges that the profiler mirrors
    on the device timeline, such as ``Optimizer.step#SGD.step``) span the
    kernels launched inside them: they are listed, marked, and not added,
    or each such kernel would count twice."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    listing: dict[str, dict] = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        annotation = bool(getattr(e, "is_user_annotation", False))
        row = listing.setdefault(e.name[:80], {
            "per_call": 0.0, "us_per_call": 0.0, "streams": [],
            "annotation": annotation})
        row["per_call"] += 1 / n
        row["us_per_call"] += us / n
        stream = getattr(e, "device_resource_id", None)
        if stream not in row["streams"]:
            row["streams"].append(stream)
        if not annotation:
            n_kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    return by_name, n_kernels, listing


def device_ms(fn, arg_sets, iters: int = 20) -> tuple[float | None, dict]:
    """Summed device time of the kernels of one fn(*args) call, and the
    listing of its device events (``kernel_times``)."""
    it = iter(range(iters))
    by_name, n_kernels, listing = kernel_times(
        lambda: fn(*arg_sets[next(it) % len(arg_sets)]), iters)
    return (sum(by_name.values()) / iters / 1e3 if n_kernels else None), listing


def copies(make, nbytes: int) -> list:
    """Enough independent input sets to exceed the L2 cache four times."""
    n = max(1, min(16, math.ceil(4 * L2_BYTES / max(nbytes, 1))))
    return [make() for _ in range(n)]


def randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=DEVICE) * scale).to(dtype)


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain PyTorch versions."""
    saved = ops.rmsnorm, ops.swa_attention
    ops.rmsnorm, ops.swa_attention = ref.rmsnorm_ref, ref.swa_attention_ref
    try:
        yield
    finally:
        ops.rmsnorm, ops.swa_attention = saved


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


# ---------------------------------------------------------------- kernels --
def rms_compare(gen, shape, dtype, grouped: bool = False, offset: int = 0) -> float:
    """The kernel against the plain version on x of ``shape``, with w [D],
    or with a gain per group w [G, D] (the last two dims of x). With an
    ``offset``, x is a contiguous view at that element offset into a
    larger buffer: not 16-byte aligned, so the general route, one element
    a load."""
    if offset:
        x = randn(gen, (math.prod(shape) + offset,), dtype)[offset:].view(shape)
        route = rms_kernel.design(shape[-1], dtype, aligned=False)
        check(x.data_ptr() % 16 != 0 and route["route"] == "general"
              and route["load_bytes"] == x.element_size(),
              f"rmsnorm {shape} at offset {offset} {dtype}: design {route}")
    else:
        x = randn(gen, shape, dtype)
    w = randn(gen, shape[-2:] if grouped else (shape[-1],), torch.float32, 0.1)
    n = rms_kernel.rmsnorm.grouped_launches
    got = rms_kernel.rmsnorm(x, w)
    want = ref.rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = TOL["rmsnorm"][dtype]
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"rmsnorm {shape} w {tuple(w.shape)} offset {offset} {dtype}: max abs err {err}")
    check(rms_kernel.rmsnorm.grouped_launches == n + grouped,
          f"rmsnorm {shape}: grouped launch count")
    return err


def swa_compare(gen, bh, s, d, window, causal, dtype, sk=None, q_offset=0) -> float:
    """The kernel against the plain version on q [bh, s, d] and k, v
    [bh, sk, d] (sk = s when None), query row i at position q_offset + i."""
    sk = s if sk is None else sk
    q = randn(gen, (bh, s, d), dtype)
    k, v = (randn(gen, (bh, sk, d), dtype) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = swa_kernel.swa_attention(q, k, v, **kw)
    want = ref.swa_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = TOL["swa_attention"][dtype]
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"swa_attention {(bh, s, sk, d, window, causal, q_offset)} {dtype}: "
          f"max abs err {err}")
    return err


def sgd_compare(gen, n, nesterov, offsets=None) -> float:
    """Kernel against the plain version on p, g, mu of length n; with
    ``offsets``, on views at those element offsets into larger buffers."""
    if offsets is None:
        p, g, mu = (randn(gen, (n,), torch.float32) for _ in range(3))
    else:
        bufs = [randn(gen, (n + 8,), torch.float32) for _ in range(3)]
        p, g, mu = (b[o:o + n] for b, o in zip(bufs, offsets))
    want_p, want_mu = ref.fused_sgd_update_ref(p, g, mu, 0.1, nesterov=nesterov)
    sgd_kernel.fused_sgd_update(p, g, mu, 0.1, nesterov=nesterov)
    torch.cuda.synchronize()
    err = max(float((p - want_p).abs().max()), float((mu - want_mu).abs().max()))
    tol = TOL["fused_sgd_update"][torch.float32]
    check(torch.allclose(p, want_p, rtol=tol, atol=tol)
          and torch.allclose(mu, want_mu, rtol=tol, atol=tol),
          f"fused_sgd_update n={n} nesterov={nesterov} offsets={offsets}: "
          f"max abs err {err}")
    return err


def backward_compare(gen, call, case, dtype, grouped: bool = False) -> float:
    """The gradient of ops.rmsnorm / ops.swa_attention on CUDA tensors that
    require grad (the autograd Function: kernel forward, explicit backward
    formula) against torch.autograd of the plain version, for a random
    cotangent; ``case`` is rmsnorm's shape (``grouped``: with a gain per
    group, w [G, D] over its last two dims) or swa_attention's (bh, s, d,
    window, causal)."""
    if call == "rmsnorm":
        args = [randn(gen, case, dtype).requires_grad_(),
                randn(gen, case[-2:] if grouped else (case[-1],), torch.float32,
                      0.1).requires_grad_()]
        out = ops.rmsnorm(*args)
        plain = ref.rmsnorm_ref(*args)
        fn_name = "_RMSNormBackward"
    else:
        bh, s_, d, window, causal = case
        args = [randn(gen, (bh, s_, d), dtype).requires_grad_() for _ in range(3)]
        out = ops.swa_attention(*args, causal=causal, window=window)
        plain = ref.swa_attention_ref(*args, causal=causal, window=window)
        fn_name = "_SWAAttentionBackward"
    check(type(out.grad_fn).__name__ == fn_name, f"{call}: {out.grad_fn} is not the Function")
    cot = randn(gen, tuple(out.shape), dtype)
    got = torch.autograd.grad(out, args, cot)
    want = torch.autograd.grad(plain, args, cot)
    torch.cuda.synchronize()
    tol = TOL[call][dtype]
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    check(all(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)
              for a, b in zip(got, want)),
          f"{call} backward {case} {dtype}: max abs err {err}")
    return err


def timings(kernel, plain, library, sets) -> dict:
    """Per call: the summed device time of its kernels (``*ms``, from the
    profiler; the CUDA-event time if the profiler saw no kernel), the
    CUDA-event time of back-to-back calls, host gaps included
    (``*host_ms``), and the device events the profiler saw
    (``*device_events``)."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        host = time_ms(fn, sets)
        dev, listing = device_ms(fn, sets)
        out[f"{key}ms"] = host if dev is None else dev
        out[f"{key}host_ms"] = host
        out[f"{key}device_events"] = listing
    return out


def bound(nbytes: int, n_ops: int, dtype) -> dict:
    """Least time on the card: bytes over HBM rate vs operations over peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[dtype]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rms_timing(gen, rows, d, dtype) -> dict:
    elt = torch.tensor([], dtype=dtype).element_size()
    n_ops, nbytes = ops.rmsnorm_cost((rows, d), (d,), elt)
    nbytes = int(nbytes)

    def make():
        x, w = randn(gen, (rows, d), dtype), randn(gen, (d,), torch.float32, 0.1)
        return x, w, (1 + w).to(dtype)

    sets = copies(make, nbytes)
    return {
        "shape": [rows, d], "dtype": str(dtype).removeprefix("torch."),
        **timings(kernel=lambda x, w, g: rms_kernel.rmsnorm(x, w),
                  plain=lambda x, w, g: ref.rmsnorm_ref(x, w),
                  library=lambda x, w, g: F.rms_norm(x, (d,), g, 1e-6),
                  sets=sets),
        **bound(nbytes, n_ops, dtype),  # square, sum, scale, gain, cast
    }


def rms_grouped_timing(gen, shape, dtype) -> dict:
    """The [G, D] route at x ``shape`` [..., G, D]. Its library yardstick
    is two calls, F.rms_norm over the last dim then the product with
    1 + w: F.rms_norm with a [G, D] weight would normalise over G x D, a
    different function."""
    elt = torch.tensor([], dtype=dtype).element_size()
    d = shape[-1]
    n_ops, nbytes = ops.rmsnorm_cost(shape, shape[-2:], elt)
    nbytes = int(nbytes)

    def make():
        x, w = randn(gen, shape, dtype), randn(gen, shape[-2:], torch.float32, 0.1)
        return x, w, (1 + w).to(dtype)

    sets = copies(make, nbytes)
    return {
        "shape": list(shape), "weight": list(shape[-2:]),
        "dtype": str(dtype).removeprefix("torch."),
        "library_call": f"F.rms_norm(x, ({d},)) * (1 + w): two calls",
        **timings(kernel=lambda x, w, g: rms_kernel.rmsnorm(x, w),
                  plain=lambda x, w, g: ref.rmsnorm_ref(x, w),
                  library=lambda x, w, g: F.rms_norm(x, (d,), None, 1e-6) * g,
                  sets=sets),
        **bound(nbytes, n_ops, dtype),  # square, sum, scale, gain, cast
    }


def swa_timing(gen, bh, s, d, dtype, heads: int, sk=None, causal: bool = True) -> dict:
    """Causal self-attention over [bh, s, d], or with ``sk`` and
    ``causal=False`` queries [bh, s, d] against keys [bh, sk, d] (whisper's
    encoder, cross-attention and decode step)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    sk = s if sk is None else sk
    # q and o, k and v; q.k and p.v over the (query, key) pairs this work
    # needs: the causal band or all
    n_ops, nbytes = ops.swa_attention_cost(bh, s, sk, d, elt, causal=causal, window=None)
    nbytes = int(nbytes)
    sets = copies(lambda: (randn(gen, (bh, s, d), dtype),
                           *(randn(gen, (bh, sk, d), dtype) for _ in range(2))), nbytes)
    b = bh // heads

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.view(b, heads, s, d), k.view(b, heads, sk, d),
            v.view(b, heads, sk, d), is_causal=causal)

    out = timings(kernel=lambda q, k, v: swa_kernel.swa_attention(q, k, v, causal=causal),
                  plain=lambda q, k, v: ref.swa_attention_ref(q, k, v, causal=causal),
                  library=library, sets=sets)
    return {
        "shape": [bh, s, d] if sk == s else [bh, s, sk, d], "causal": causal,
        "dtype": str(dtype).removeprefix("torch."), **out,
        # SDPA's backend for this call: the kernels it launched
        "library_kernels": [n for n, e in out["library_device_events"].items()
                            if not e["annotation"]],
        **bound(nbytes, n_ops, dtype),  # q.k and p.v, 2 each
    }


def sgd_timing(gen, n) -> dict:
    n_ops, nbytes = ops.fused_sgd_update_cost(n)  # read p, g, mu; write p, mu
    nbytes = int(nbytes)

    def make():
        p, g, mu = (randn(gen, (n,), torch.float32) for _ in range(3))
        lib_p = p.clone().requires_grad_()
        lib_p.grad = g.clone()
        opt = torch.optim.SGD([lib_p], lr=0.1, momentum=0.9, weight_decay=1e-4,
                              fused=True)
        opt.step()  # makes its momentum buffer outside the timed calls
        return p, g, mu, opt

    sets = copies(make, nbytes)
    return {
        "shape": [n], "dtype": "float32",
        **timings(kernel=lambda p, g, mu, o: sgd_kernel.fused_sgd_update(p, g, mu, 0.1),
                  plain=lambda p, g, mu, o: ref.fused_sgd_update_ref(p, g, mu, 0.1),
                  library=lambda p, g, mu, o: o.step(), sets=sets),
        **bound(nbytes, n_ops, torch.float32),  # 3 multiplies, 3 adds
    }


def audio_swa_timings(gen) -> dict:
    """swa_attention at whisper-base's shapes (AUDIO_PREFILL clips of its
    1,500 frames, 8 heads of 64): the encoder's self-attention, the
    decoder's cross-attention over the frames at the prefill and at a
    decode step; none causal."""
    c = get_config(AUDIO_ARCH)
    b, s = AUDIO_PREFILL
    bh, frames = b * c.n_heads, c.n_frontend_tokens
    return {name: swa_timing(gen, bh, sq, c.d_head, torch.bfloat16, c.n_heads, sk=frames,
                             causal=False)
            for name, sq in (("encoder", frames), ("cross_prefill", s), ("cross_decode", 1))}


def kernel_phase(cfg, n_resnet: int) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    b, s = PREFILL_SHAPE
    bf16, f32 = torch.bfloat16, torch.float32
    # main-path shapes: decode rows (batch 4), prefill rows, prefill attention
    rms_err = max(rms_compare(gen, (SERVE["batch"], cfg.d_model), bf16),
                  rms_compare(gen, (b * s, cfg.d_model), bf16))
    swa_err = swa_compare(gen, b * cfg.n_heads, s, cfg.d_head, None, True, bf16)
    for arch in (MOE_ARCH, VLM_ARCH):  # the MoE and VLM paths' shapes
        c = get_config(arch)
        rms_err = max(rms_err, rms_compare(gen, (SERVE["batch"], c.d_model), bf16),
                      rms_compare(gen, (b * s, c.d_model), bf16))
        swa_err = max(swa_err, swa_compare(gen, b * c.n_heads, s, c.d_head, None,
                                           True, bf16))
    # the gated norm's [G, D] route (a gain per head) at mamba2-780m's and
    # jamba's prefill and decode shapes of y [B, S, H, P]
    gnorm_shapes = {}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        c = get_config(arch)
        gnorm_shapes[arch] = [(b, s, c.n_ssm_heads, c.ssm_headdim),
                              (SERVE["batch"], 1, c.n_ssm_heads, c.ssm_headdim)]
        for shape in gnorm_shapes[arch]:
            rms_compare(gen, shape, f32, grouped=True)
            rms_err = max(rms_err, rms_compare(gen, shape, bf16, grouped=True))
    # every [D] width of the main paths (mamba2 and qwen2-vl 1536, qwen2.5
    # and qwen3-moe 2048, jamba 4096) at decode and prefill rows, in bf16
    # and f32 (the f32-activation runs), and the route each width takes
    widths = sorted({get_config(a).d_model for a in (ARCH, MOE_ARCH, VLM_ARCH, SSM_ARCH,
                                                     HYBRID_ARCH)})
    for d in widths:
        for rows in (SERVE["batch"], b * s):
            rms_compare(gen, (rows, d), f32)
            rms_err = max(rms_err, rms_compare(gen, (rows, d), bf16))
    rms_routes = {f"{d} {str(dt).removeprefix('torch.')}": rms_kernel.design(d, dt)
                  for d in (*widths, gnorm_shapes[SSM_ARCH][0][-1]) for dt in (bf16, f32)}
    for key, route in rms_routes.items():
        print(f"rmsnorm design at d = {key}: {json.dumps(route)}", flush=True)
    swa_compare(gen, b * cfg.n_heads, s, cfg.d_head, None, True, f32)
    for dtype in (f32, bf16):
        for shape in RMS_SWEEP:
            rms_compare(gen, shape, dtype)
        for d in RMS_EDGES:
            rms_compare(gen, (3, d), dtype)
        for d, offset in RMS_UNALIGNED:
            rms_compare(gen, (4, d), dtype, offset=offset)
        for case in SWA_SWEEP:
            swa_compare(gen, *case, dtype)
        for bh, sq, sk, d, causal, window, q_offset in SWA_CROSS_SWEEP:
            swa_compare(gen, bh, sq, d, window, causal, dtype, sk=sk, q_offset=q_offset)
    edge_routes = {f"{d} {str(dt).removeprefix('torch.')}": rms_kernel.design(d, dt)["route"]
                   for d in RMS_EDGES for dt in (bf16, f32)}
    check(set(edge_routes.values()) == set(rms_kernel.ROUTES),
          f"rmsnorm edge widths reach every route: {edge_routes}")
    # main-path lengths (ResNet-110's parameters; the lm_dp model's, whose
    # 3.1 GB buffers pass 2^31 bytes, while the card is still nearly
    # empty), both nesterov settings, the reference's sweep, and views at
    # offsets into larger buffers
    sgd_err = max(sgd_compare(gen, n, nesterov) for n in (n_resnet, LM_DP_PARAMS)
                  for nesterov in (False, True))
    torch.cuda.empty_cache()
    for n in SGD_SWEEP:
        for nesterov in (False, True):
            sgd_compare(gen, n, nesterov)
    for offsets in ((1, 1, 1), (3, 3, 3), (1, 2, 3)):
        sgd_compare(gen, n_resnet, False, offsets)
    # the Functions' backward at the LM train step's shapes (8 x 128 rows;
    # 8 x 16 heads of 128 tokens) and at one windowed sweep case
    rows, bh = LM["batch"] * LM["seq"], LM["batch"] * cfg.n_heads
    ssm = get_config(SSM_ARCH)
    gnorm_train = (SSM_TRAIN["batch"], SSM_TRAIN["seq"], ssm.n_ssm_heads, ssm.ssm_headdim)
    backward = {
        "rmsnorm": {str(dt).removeprefix("torch."): max(
            backward_compare(gen, "rmsnorm", shape, dt)
            for shape in ((rows, cfg.d_model), RMS_SWEEP[2])) for dt in (f32, bf16)},
        # the gated norm's [48, 64] weight at the SSM train step's shape
        "rmsnorm_grouped": {str(dt).removeprefix("torch."): backward_compare(
            gen, "rmsnorm", gnorm_train, dt, grouped=True) for dt in (f32, bf16)},
        "swa_attention": {str(dt).removeprefix("torch."): max(
            backward_compare(gen, "swa_attention", case, dt)
            for case in ((bh, LM["seq"], cfg.d_head, None, True), SWA_SWEEP[2]))
            for dt in (f32, bf16)}}
    torch.cuda.synchronize()
    n_rms = 6 + 8 + 4 * len(widths) + 2 * (len(RMS_SWEEP) + len(RMS_EDGES) + len(RMS_UNALIGNED))
    print(f"kernel phase: the three kernels agree with their plain versions at "
          f"{n_rms} rmsnorm (8 with a [G, D] weight; routes at the edges "
          f"{json.dumps(edge_routes)}), "
          f"{(len(SWA_SWEEP) + len(SWA_CROSS_SWEEP)) * 2 + 4} swa_attention "
          f"({len(SWA_CROSS_SWEEP) * 2} of them with Sq != Sk or an offset) and "
          f"{4 + 2 * len(SGD_SWEEP) + 3} fused_sgd_update cases (4 at n = "
          f"{n_resnet} and {LM_DP_PARAMS}); the rmsnorm "
          f"and swa_attention Functions' gradients agree with autograd of the "
          f"plain versions at 6 and 4 cases "
          f"(max abs err {json.dumps(backward)})", flush=True)
    return {
        "rmsnorm": {"max_abs_err": rms_err,
                    "backward_max_abs_err": backward["rmsnorm"],
                    "backward_grouped_max_abs_err": backward["rmsnorm_grouped"],
                    "design": rms_routes, "edge_routes": edge_routes,
                    "prefill": rms_timing(gen, b * s, cfg.d_model, bf16),
                    "decode": rms_timing(gen, SERVE["batch"], cfg.d_model, bf16),
                    # the other [D] widths of the main paths, at prefill rows
                    "widths": {str(d): rms_timing(gen, b * s, d, bf16)
                               for d in widths if d != cfg.d_model},
                    "gnorm": {arch: {"prefill": rms_grouped_timing(gen, shapes[0], bf16),
                                     "decode": rms_grouped_timing(gen, shapes[1], bf16)}
                              for arch, shapes in gnorm_shapes.items()},
                    # mamba2's gated runs use f32 activations
                    "gnorm_f32": {SSM_ARCH: {"prefill": rms_grouped_timing(
                        gen, gnorm_shapes[SSM_ARCH][0], f32)}}},
        "swa_attention": {"max_abs_err": swa_err,
                          "backward_max_abs_err": backward["swa_attention"],
                          "prefill": swa_timing(gen, b * cfg.n_heads, s,
                                                cfg.d_head, bf16, cfg.n_heads),
                          "prefill_f32": swa_timing(gen, b * cfg.n_heads, s,
                                                    cfg.d_head, f32, cfg.n_heads),
                          # whisper-base's three attention shapes in bf16
                          "audio": audio_swa_timings(gen)},
        "fused_sgd_update": {"max_abs_err": sgd_err,
                             "train": sgd_timing(gen, n_resnet),
                             "lm_dp": sgd_timing(gen, LM_DP_PARAMS)},
    }


# ------------------------------------------------------------- main path --
def serve_phase(cfg, params, label: str = "serve", per_step: int | None = None,
                swa_per_step: int = 0) -> dict:
    """SERVE through launch.serve with the launch counts read around it;
    ``per_step``: the rmsnorm launches a decode step must make (the
    decoder-only transformers' 2 x layers + 1 when None); ``swa_per_step``
    its swa_attention launches (whisper's cross-attention)."""
    # warm-up at a tiny length (cuBLAS handles, allocator), not counted
    serve(cfg, batch=SERVE["batch"], prompt_len=4, new_tokens=2,
          params=params, device=DEVICE, log=False)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tokens, seconds, last = serve(cfg, params=params, device=DEVICE,
                                  return_logits=True, **SERVE)
    counts = ops.launch_counts()
    steps = SERVE["prompt_len"] + SERVE["new_tokens"] - 1
    if per_step is None:
        per_step = 2 * cfg.n_layers + 1
    out = {"batch": SERVE["batch"], "prompt_len": SERVE["prompt_len"],
           "new_tokens": SERVE["new_tokens"], "decode_steps": steps,
           "seconds": seconds,
           "tokens_per_s": SERVE["batch"] * SERVE["new_tokens"] / seconds,
           "decode_steps_per_s": steps / seconds,
           "rmsnorm_launches_per_step": counts["rmsnorm"] / steps,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": counts, "first_row": tokens[0, :8].tolist()}
    print(f"{label} phase: " + json.dumps(out), flush=True)
    check(tokens.shape == (SERVE["batch"], SERVE["new_tokens"]),
          f"serve tokens shape {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "serve tokens in the vocabulary")
    check(tuple(last.shape) == (SERVE["batch"], 1, cfg.vocab_size),
          f"serve last-step logits {tuple(last.shape)}")
    check(bool(torch.isfinite(last).all()), "serve last-step logits finite")
    check(counts["rmsnorm"] == per_step * steps,
          f"rmsnorm launches {counts['rmsnorm']} != {per_step} x {steps} steps")
    check(counts["swa_attention"] == swa_per_step * steps,
          f"swa_attention launches {counts['swa_attention']} != {swa_per_step} x "
          f"{steps} steps")
    return out


# which cache entries each fault of decode_vs_prefill zeroes before every step
ZEROED = {"no_cache": lambda path: path != "enc",
          "ssm_state_zeroed": lambda path: path.endswith("ssm"),
          "enc_zeroed": lambda path: path == "enc"}


def decode_vs_prefill(decode, model, params, tokens, logits, n: int,
                      fault: str | None = None, cache_dtype=torch.bfloat16,
                      enc: torch.Tensor | None = None) -> dict:
    """Step the decoder over the first n prompt tokens and compare each
    step's logits with the prefill's at that position. ``enc``: whisper's
    encoder output, written into the cache's ``enc`` before the first step.

    fault injects a cache fault from outside the model, as a control that
    the gate must catch: "pos_lag" passes pos t-1 at step t (each token
    overwrites the previous token's slot), "no_cache" zeroes the cache but
    ``enc`` before every step (decode sees no history), "ssm_state_zeroed"
    zeroes every SSM state before every step and keeps the conv windows
    and KV caches (the recurrence loses its history beyond the conv's last
    K - 1 inputs), "enc_zeroed" zeroes whisper's ``enc`` (the
    cross-attention reads no audio) and keeps the KV cache.
    """
    b = tokens.shape[0]
    cache = pspec.init_params(None, model.cache_specs(
        InputShape("d", tokens.shape[1], b, "decode"), cache_dtype), DEVICE)
    if enc is not None:
        cache["enc"].copy_(enc)
    argmax, diff, finite = [], [], []
    for t in range(n):
        pos = max(t - 1, 0) if fault == "pos_lag" else t
        for path, c in pspec.flatten(cache).items():
            if fault in ZEROED and ZEROED[fault](path):
                c.zero_()
        step, cache = decode(params, cache, {
            "tokens": tokens[:, t:t + 1],
            "pos": torch.full((b,), pos, dtype=torch.int32, device=DEVICE)})
        argmax.append(step[:, 0].argmax(-1))
        diff.append((step[:, 0] - logits[:, t]).abs().amax(-1))
        finite.append(torch.isfinite(step).all())
    diff = torch.stack(diff, 1)                                # [b, n]
    agree = torch.stack(argmax, 1) == logits[:, :n].argmax(-1)

    def stats(m: int) -> dict:
        """Over the first m positions."""
        scale = float(logits[:, :m].abs().max()) + 1e-6
        return {"positions": m, "rel_err_last": float(diff[:, m - 1].max()) / scale,
                "rel_err_all": float(diff[:, :m].max()) / scale,
                "argmax_agree": float(agree[:, :m].float().mean())}

    head = {"head": stats(CONTROL_POSITIONS)} if n > CONTROL_POSITIONS else {}
    return {**stats(n), **head, "finite": bool(torch.stack(finite).all()),
            "last_shape": list(step.shape)}


def decode_gate(r: dict) -> bool:
    """The decode-vs-prefill gate: relative max error below the bf16
    contract's 0.08 at the last and at every position, and argmax agreement
    at least DECODE_AGREE_MIN."""
    return (r["rel_err_last"] < 0.08 and r["rel_err_all"] < 0.08
            and r["argmax_agree"] >= DECODE_AGREE_MIN)


def prefill_vs_plain(model, params, batch, window: int | None = None) -> dict:
    """A counted prefill through the kernels (time, launches), then the
    same prefill through the plain versions: the bf16 contract's readings."""
    prefill = make_prefill(model, window=window, device=DEVICE)
    prefill(params, {k: v[:, :64] for k, v in batch.items()})  # warm-up
    ops.reset_launch_counts()
    t0 = sync_time()
    logits = prefill(params, batch)
    seconds = sync_time() - t0
    counts = ops.launch_counts()
    grouped = rms_kernel.rmsnorm.grouped_launches
    with plain_versions():
        plain = prefill(params, batch)
    b, s = batch["tokens"].shape
    return {"logits": logits, "plain": plain, "seconds": seconds,
            "tokens_per_s": b * s / seconds, "launches": counts,
            "rmsnorm_grouped_launches": grouped,
            "rel_err_vs_plain": rel_err(logits, plain),
            "argmax_agree_vs_plain": float((logits.argmax(-1) == plain.argmax(-1))
                                           .float().mean())}


def contract(r: dict) -> bool:
    """The bf16 serving contract of tests/test_decode_consistency.py."""
    return r["rel_err_vs_plain"] < 0.08 and r["argmax_agree_vs_plain"] > 0.95


def prefill_phase(cfg, model, params) -> dict:
    b, s = PREFILL_SHAPE
    tokens = torch.as_tensor(TokenStream(cfg.vocab_size, s, seed=5).batch(0, b)["tokens"],
                             device=DEVICE)
    window = decode_window(cfg, s)
    res = prefill_vs_plain(model, params, {"tokens": tokens}, window)
    logits, counts = res.pop("logits"), res["launches"]
    del res["plain"]

    # step-by-step decode over the same prompt, then the faulty controls
    decode = make_decode_step(model, window=window, device=DEVICE)
    sound = decode_vs_prefill(decode, model, params, tokens, logits, s)
    controls = {f: decode_vs_prefill(decode, model, params, tokens, logits,
                                     CONTROL_POSITIONS, fault=f)
                for f in CONTROL_FAULTS}

    out = {"shape": [b, s], **res, "decode_vs_prefill": sound,
           "decode_vs_prefill_faulty_controls": controls}
    print("prefill phase: " + json.dumps(out), flush=True)
    check(counts == {"rmsnorm": 2 * cfg.n_layers + 1,
                     "swa_attention": cfg.n_layers, "fused_sgd_update": 0},
          f"prefill launches {counts}")
    check(logits.shape == (b, s, cfg.vocab_size), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits finite")
    check(sound["last_shape"] == [b, 1, cfg.vocab_size],
          f"decode logits {sound['last_shape']}")
    check(sound["finite"], "decode logits finite at every step")
    check(contract(res), f"kernels vs plain prefill: rel err "
          f"{res['rel_err_vs_plain']}, argmax {res['argmax_agree_vs_plain']}")
    check(decode_gate(sound) and decode_gate(sound["head"]),
          f"decode vs prefill: {sound}")
    # each half of the gate on its own must fail each faulty control
    for fault, r in controls.items():
        check(r["argmax_agree"] < DECODE_AGREE_MIN and r["rel_err_all"] >= 0.08,
              f"decode vs prefill gate passed the faulty control {fault}: {r}")
    return out


def device_profile(fn, n: int, groups: dict[str, tuple[str, ...]] | None = None) -> dict:
    """Wall time per call of fn without the profiler, then device busy time
    and kernel time by name with it; the idle share is 1 - busy / wall.
    ``groups`` sums the device time of kernels whose names hold any of a
    group's substrings (first group that matches; the rest is "other")."""
    fn()
    t0 = sync_time()
    for _ in range(n):
        fn()
    wall_us = 1e6 * (sync_time() - t0)
    by_name, n_kernels, _ = kernel_times(fn, n)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"calls": n, "wall_ms_per_call": wall_us / n / 1e3,
           "device_busy_ms_per_call": busy_us / n / 1e3 if n_kernels else None,
           "device_idle_share": 1 - busy_us / wall_us if n_kernels else None,
           "kernels_per_call": n_kernels / n,
           "top_kernels_ms_per_call": {k[:60]: v / n / 1e3 for k, v in top}}
    if groups:
        sums = dict.fromkeys([*groups, "other"], 0.0)
        for name, us in by_name.items():
            group = next((g for g, keys in groups.items()
                          if any(key in name for key in keys)), "other")
            sums[group] += us
        out["groups_ms_per_call"] = {g: us / n / 1e3 for g, us in sums.items()}
    return out


def profile_phase(cfg, model, params) -> dict:
    """Where a decode step's and a prefill's time goes (not counted)."""
    b = SERVE["batch"]
    decode = make_decode_step(model, device=DEVICE)
    cache = pspec.init_params(None, model.cache_specs(
        InputShape("p", SERVE["prompt_len"], b, "decode")), DEVICE)
    batch = {"tokens": torch.zeros((b, 1), dtype=torch.int32, device=DEVICE),
             "pos": torch.full((b,), SERVE["prompt_len"] // 2, dtype=torch.int32,
                               device=DEVICE)}
    tokens = torch.zeros(PREFILL_SHAPE, dtype=torch.int32, device=DEVICE)
    prefill = make_prefill(model, device=DEVICE)
    out = {"decode_step": device_profile(lambda: decode(params, cache, batch), 8),
           "prefill": device_profile(lambda: prefill(params, {"tokens": tokens}), 2)}
    print("profile phase: " + json.dumps(out), flush=True)
    return out


# ------------------------------------------------------ moe and vlm --
def init_full(cfg, label: str):
    """The model and its random bf16 weights at full width, from a seeded
    CUDA generator, with the draw's time and peak memory."""
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = sync_time()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    seconds = sync_time() - t0
    n = sum(t.numel() for t in pspec.flatten(params).values())
    out = {"config": cfg.name, "n_params": n, "init_seconds": seconds,
           "init_peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "weight_bytes": sum(t.numel() * t.element_size()
                               for t in pspec.flatten(params).values())}
    print(f"{label}: {n:,} parameters drawn in {seconds:.1f} s, peak "
          f"{out['init_peak_memory_bytes'] / 1e9:.1f} GB", flush=True)
    return model, params, out


@contextlib.contextmanager
def recording_routes(into: list):
    """Record each moe_ffn call's expert choices (top-k ids [B, S, K], as
    moe_ffn computes them from its input) in call order."""
    inner = moe_module.moe_ffn

    def recorded(cfg, p, x, sh):
        logits = torch.einsum("bsd,de->bse", x, p["router"].to(x.dtype)).float()
        into.append(moe_module._top_k(torch.softmax(logits, -1), cfg.top_k)[1])
        return inner(cfg, p, x, sh)

    moe_module.moe_ffn = recorded
    try:
        yield
    finally:
        moe_module.moe_ffn = inner


def route_flips(a: torch.Tensor, b: torch.Tensor, n_experts: int) -> dict:
    """Tokens whose top-k sets differ, and choices in one set but not the
    other, between two [B, S, K] expert-id tensors."""
    one = lambda e: F.one_hot(e.reshape(-1, e.shape[-1]), n_experts).sum(1)  # noqa: E731
    shared = torch.minimum(one(a), one(b)).sum(-1)
    k = a.shape[-1]
    return {"tokens": int((shared < k).sum()), "choices": int((k - shared).sum()),
            "of_tokens": int(shared.numel())}


def op_group(cfg, name: str, shapes) -> str:
    """The group of an aten op of a serving step (``shapes``: its
    operands'). A GEMM's second operand tells its origin: [.., V, D] or
    [.., D, V] the logits, [E, D, F] or [E, F, D] the experts, [D, F] or
    [F, D] a dense MLP, [D, E] the router."""
    if name in GEMM_OPS:
        w = list(shapes[1]) if len(shapes) > 1 and shapes[1] else []
        if cfg.vocab_size in w:
            return "lm_logits"
        if cfg.family == "ssm":  # in/out projections touch d_model; the SSD's do not
            return "mixer_projections" if cfg.d_model in w else "ssd_products"
        ffn = w[-2:] in ([cfg.d_model, cfg.d_ff], [cfg.d_ff, cfg.d_model])
        if ffn and cfg.is_moe and len(w) >= 3 and w[-3] == cfg.n_experts:
            return "expert_einsums"
        if ffn and not cfg.is_moe:
            return "mlp"
        if cfg.is_moe and w[-2:] == [cfg.d_model, cfg.n_experts]:
            return "dispatch_combine"  # the router's product
        return "attention"  # projections, decode's q.k and p.v products
    if name in DISPATCH_OPS:
        return "dispatch_combine"
    if name.startswith(("aten::index", "aten::embedding")):
        return "index"
    return "elementwise"


def op_groups(cfg, fn, n: int) -> dict:
    """Device time per call by group: each aten op's own kernels (the
    profiler's self device time, operand shapes recorded), and the
    hand-written kernels, which no aten op launches, by kernel name; the
    device time left over is "unattributed"."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    sums: dict[str, float] = {}
    busy = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        us = e.self_device_time_total
        if getattr(e, "is_user_annotation", False) or us <= 0:
            continue
        if e.device_type == DeviceType.CUDA:
            busy += us
            if "rmsnorm" in e.key or "swa_attention" in e.key:
                sums["kernels"] = sums.get("kernels", 0.0) + us
        else:
            group = op_group(cfg, e.key, e.input_shapes)
            sums[group] = sums.get(group, 0.0) + us
    sums["unattributed"] = busy - sum(sums.values())
    return {g: us / n / 1e3 for g, us in sorted(sums.items())}


def moe_serve_phase(smi: str) -> dict:
    cfg = get_config(MOE_ARCH)
    model, params, out = init_full(cfg, MOE_ARCH)
    check(out["n_params"] == MOE_PARAMS == cfg.param_count(),
          f"{MOE_ARCH} at full width: {out['n_params']} parameters")
    out["serve"] = serve_phase(cfg, params, "moe_serve")
    out["serve_peak_memory_bytes"] = out["serve"]["peak_memory_bytes"]

    # prefill at the config's capacity factor, kernels against plain
    b, s = PREFILL_SHAPE
    tokens = torch.as_tensor(TokenStream(cfg.vocab_size, s, seed=5).batch(0, b)["tokens"],
                             device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    r = prefill_vs_plain(model, params, {"tokens": tokens})
    logits, plain = r.pop("logits"), r.pop("plain")
    prefill = make_prefill(model, device=DEVICE)
    kernel_routes, plain_routes = [], []
    with recording_routes(kernel_routes):
        again = prefill(params, {"tokens": tokens})
    with plain_versions(), recording_routes(plain_routes):
        prefill(params, {"tokens": tokens})
    r["repeat_identical"] = bool(torch.equal(again, logits))
    r["routing_flips_vs_plain"] = {
        "layer_0": route_flips(kernel_routes[0], plain_routes[0], cfg.n_experts),
        "last_layer": route_flips(kernel_routes[-1], plain_routes[-1], cfg.n_experts),
        "all_layers": route_flips(torch.stack(kernel_routes), torch.stack(plain_routes),
                                  cfg.n_experts)}
    r["capacity_factor"] = cfg.capacity_factor
    r["capacity"] = moe_module.group_capacity(s, cfg)
    finite = bool(torch.isfinite(logits).all())
    del logits, plain, again, kernel_routes, plain_routes
    out["prefill"] = r

    # decode against prefill at the reference's capacity factor
    cfg8 = dataclasses.replace(cfg, capacity_factor=MOE_DECODE_CF)
    model8 = build_model(cfg8)
    logits8 = make_prefill(model8, device=DEVICE)(params, {"tokens": tokens})
    decode = make_decode_step(model8, device=DEVICE)
    sound = decode_vs_prefill(decode, model8, params, tokens, logits8, CONTROL_POSITIONS)
    controls = {f: decode_vs_prefill(decode, model8, params, tokens, logits8,
                                     CONTROL_POSITIONS, fault=f)
                for f in CONTROL_FAULTS}
    del logits8
    out["decode_vs_prefill"] = {"capacity_factor": MOE_DECODE_CF, **sound}
    out["decode_vs_prefill_faulty_controls"] = controls
    out["prefill_peak_memory_bytes"] = torch.cuda.max_memory_allocated()

    # moe_ffn at the decode shape and at the prefill shape may not wait
    # on the host
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    p0 = {k: v[0] for k, v in params["layers"]["moe"].items()}
    xs = {"decode": randn(gen, (SERVE["batch"], 1, cfg.d_model), torch.bfloat16),
          "prefill": randn(gen, (b, s, cfg.d_model), torch.bfloat16)}
    torch.cuda.synchronize()
    synced = {}
    for where, x in xs.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe_module.moe_ffn(cfg, p0, x, mlayers.NO_SHARD)
            synced[where] = False
        except RuntimeError as e:
            synced[where] = str(e)[:200]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    out["moe_ffn_waits_on_host"] = synced

    # where the time goes: one prefill and one decode step
    decode = make_decode_step(model, device=DEVICE)
    cache = pspec.init_params(None, model.cache_specs(
        InputShape("p", SERVE["prompt_len"], SERVE["batch"], "decode")), DEVICE)
    step_batch = {"tokens": torch.zeros((SERVE["batch"], 1), dtype=torch.int32,
                                        device=DEVICE),
                  "pos": torch.full((SERVE["batch"],), SERVE["prompt_len"] // 2,
                                    dtype=torch.int32, device=DEVICE)}
    one_decode = lambda: decode(params, cache, step_batch)  # noqa: E731
    one_prefill = lambda: prefill(params, {"tokens": tokens})  # noqa: E731
    out["profile"] = {
        "decode_step": {**device_profile(one_decode, 4),
                        "groups_ms_per_call": op_groups(cfg, one_decode, 2)},
        "prefill": {**device_profile(one_prefill, 2),
                    "groups_ms_per_call": op_groups(cfg, one_prefill, 1)}}
    print(f"moe_serve phase [{smi}]: " + json.dumps(out), flush=True)

    per_step = 2 * cfg.n_layers + 1
    check(r["launches"] == {"rmsnorm": per_step, "swa_attention": cfg.n_layers,
                            "fused_sgd_update": 0}, f"MoE prefill launches {r['launches']}")
    check(finite, "MoE prefill logits finite")
    check(contract(r), f"MoE kernels vs plain prefill: rel err {r['rel_err_vs_plain']}, "
          f"argmax {r['argmax_agree_vs_plain']}")
    check(sound["finite"] and sound["last_shape"] == [b, 1, cfg.vocab_size],
          f"MoE decode logits {sound['last_shape']}")
    check(decode_gate(sound), f"MoE decode vs prefill: {sound}")
    for fault, c in controls.items():
        check(c["argmax_agree"] < DECODE_AGREE_MIN and c["rel_err_all"] >= 0.08,
              f"MoE decode vs prefill gate passed the faulty control {fault}: {c}")
    check(synced == {"decode": False, "prefill": False},
          f"moe_ffn waited on the host: {synced}")
    peak = max(out["init_peak_memory_bytes"], out["serve_peak_memory_bytes"],
               out["prefill_peak_memory_bytes"])
    check(peak < 80e9, f"MoE peak memory {peak}")
    out["launches"] = {k: out["serve"]["launches"][k] + r["launches"][k]
                       for k in r["launches"]}
    return out


def vlm_phase(smi: str) -> dict:
    cfg = get_config(VLM_ARCH)
    model, params, out = init_full(cfg, VLM_ARCH)
    check(out["n_params"] == VLM_PARAMS == cfg.param_count(),
          f"{VLM_ARCH} at full width: {out['n_params']} parameters")
    b, s = PREFILL_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    batch = {"tokens": torch.as_tensor(TokenStream(cfg.vocab_size, s, seed=5)
                                       .batch(0, b)["tokens"], device=DEVICE),
             # at the embedding's scale (its init std is 1 / sqrt(d_model))
             "patch_embeds": randn(gen, (b, cfg.n_frontend_tokens, cfg.d_model),
                                   torch.bfloat16, cfg.d_model ** -0.5)}
    torch.cuda.reset_peak_memory_stats()
    r = prefill_vs_plain(model, params, batch)
    logits, plain = r.pop("logits"), r.pop("plain")
    finite = bool(torch.isfinite(logits).all())
    rope = build_model(dataclasses.replace(cfg, mrope=False))
    ctl = make_prefill(rope, device=DEVICE)(params, batch)
    control = {"rel_err_vs_plain": rel_err(ctl, plain),
               "argmax_agree_vs_plain": float((ctl.argmax(-1) == plain.argmax(-1))
                                              .float().mean())}
    del logits, plain, ctl
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    prefill = make_prefill(model, device=DEVICE)
    r["profile"] = {**device_profile(lambda: prefill(params, batch), 2),
                    "groups_ms_per_call": op_groups(cfg, lambda: prefill(params, batch), 1)}
    out.update(prefill=r, mrope_off_control=control)
    out["serve"] = serve_phase(cfg, params, "vlm_serve")
    print(f"vlm phase [{smi}]: " + json.dumps(out), flush=True)
    check(r["launches"] == {"rmsnorm": 2 * cfg.n_layers + 1,
                            "swa_attention": cfg.n_layers, "fused_sgd_update": 0},
          f"VLM prefill launches {r['launches']}")
    check(finite, "VLM prefill logits finite")
    check(contract(r), f"VLM kernels vs plain prefill: rel err {r['rel_err_vs_plain']}, "
          f"argmax {r['argmax_agree_vs_plain']}")
    check(not contract(control), f"VLM with mrope=False passed the contract: {control}")
    out["launches"] = {k: out["serve"]["launches"][k] + r["launches"][k]
                       for k in r["launches"]}
    return out


# ------------------------------------------------------ ssm and hybrid --
def norm_launches(model) -> tuple[int, int]:
    """rmsnorm launches of one forward or decode step of an SSM or hybrid
    model, and those of them with a gain per head (the gated norms)."""
    cfg = model.cfg
    if cfg.family == "ssm":
        return 2 * cfg.n_layers + 1, cfg.n_layers
    n_mamba = model.n_blocks * (model.block_size - 1)
    return 3 * n_mamba + 2 * model.n_blocks + 1, n_mamba


@contextlib.contextmanager
def f32_activations():
    """The model's activations in f32: embed_tokens keeps the table's f32
    rows (as tests/test_torch_mamba2.py patches both packages)."""
    inner = mlayers.embed_tokens

    def embed_f32(embedding, tokens, scale=None):
        x = embedding[tokens.long()].float()
        return x * scale if scale is not None else x

    mlayers.embed_tokens = embed_f32
    try:
        yield
    finally:
        mlayers.embed_tokens = inner


def train_steps(step, state, data, sched, steps: range, batch: int) -> dict:
    """Train steps of ``batch`` sequences through a make_train_step step,
    with the launch counts read around them: losses, seconds a step, the
    median of the steps after the first, peak memory."""
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, seconds = [], []
    for i in steps:
        t0 = sync_time()
        state, loss = step(state, data.batch(i, batch), sched(i))
        losses.append(float(loss))
        seconds.append(sync_time() - t0)
    tokens = batch * data.seq
    steady = sorted(seconds[1:])
    step_ms = 1e3 * steady[len(steady) // 2]
    return {"steps": len(steps), "losses": losses, "step_seconds": seconds,
            "step_ms_median": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": {**ops.launch_counts(),
                         "rmsnorm_grouped": rms_kernel.rmsnorm.grouped_launches}}


def ssm_train(cfg, smi: str) -> dict:
    """mamba2-780m trained at full width: f32 masters in one flat buffer,
    AdamW. The step check at the initial weights, then SSM_TRAIN["steps"]
    steps with f32 activations and SSM_BF16_STEPS more in bf16."""
    model = build_model(cfg, torch.float32)
    data = TokenStream(cfg.vocab_size, SSM_TRAIN["seq"], seed=0)
    opt = adamw()
    n = SSM_TRAIN["steps"]
    sched = warmup_cosine(SSM_TRAIN["base_lr"], warmup=SSM_TRAIN["warmup"], total=n)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    first = {k: torch.as_tensor(v, device=DEVICE) for k, v in
             data.batch(0, SSM_TRAIN["batch"]).items()}
    with f32_activations():
        step_check = {"f32": lm_step_vs_plain(model, params, first, "gnorm/scale")}
    step_check["bf16"] = lm_step_vs_plain(model, params, first, "gnorm/scale")
    torch.cuda.empty_cache()

    state = {"params": params, "opt": opt.init(params)}
    step = make_train_step(model, opt, device=DEVICE)
    held = {k: torch.as_tensor(v, device=DEVICE) for k, v in
            data.batch(HELD_OUT["step"], SSM_TRAIN["batch"]).items()}
    with f32_activations(), warnings.catch_warnings():
        # deterministic algorithms, so that the gated trajectory is the
        # same in every run on this card; warn_only as in lm_exact_resume
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with torch.no_grad():
                held_before = float(model.loss(params, held))
            f32 = train_steps(step, state, data, sched, range(n), SSM_TRAIN["batch"])
            with torch.no_grad():
                held_after = float(model.loss(state["params"], held))
        finally:
            torch.use_deterministic_algorithms(False)
    f32["held_out_loss"] = {"step": HELD_OUT["step"], "before": held_before,
                            "after": held_after}
    bf16 = train_steps(step, state, data, sched, range(n, n + SSM_BF16_STEPS),
                       SSM_TRAIN["batch"])
    tokens = SSM_TRAIN["batch"] * SSM_TRAIN["seq"]
    print(f"ssm_train: {cfg.name}, {tokens} tokens a step: f32 activations "
          f"{f32['step_ms_median']:.1f} ms a step ({f32['tokens_per_s']:.0f} tokens/s, "
          f"peak {f32['peak_memory_bytes']} bytes); bf16 {bf16['step_ms_median']:.1f} ms "
          f"({bf16['tokens_per_s']:.0f} tokens/s, peak {bf16['peak_memory_bytes']} bytes) "
          f"[{smi}]", flush=True)
    return {"n_params": int(params.flat.numel()), **SSM_TRAIN,
            "step_vs_plain": step_check, "f32_activations": f32, "bf16": bf16}


def ssm_prefill_and_decode(model, params, tokens, gated: tuple[str, ...],
                           decode_model=None) -> dict:
    """The prefill through the kernels against the plain versions and
    decode against prefill over CONTROL_POSITIONS positions: in bf16 (the
    path a user serves) and with f32 activations and caches, launches
    counted in both; the runs named in ``gated`` also decode under the
    SSM_CONTROL_FAULTS. ``decode_model``: the model that decodes and gives
    the prefill it is held to (the hybrid's at capacity factor 8), default
    ``model``."""
    dm = decode_model or model
    decode = make_decode_step(dm, device=DEVICE)
    out = {}
    for name, f32 in (("bf16", False), ("f32", True)):
        with f32_activations() if f32 else contextlib.nullcontext():
            r = prefill_vs_plain(model, params, {"tokens": tokens})
            logits = r.pop("logits")
            del r["plain"]
            r["finite"] = bool(torch.isfinite(logits).all())
            if dm is not model:
                logits = make_prefill(dm, device=DEVICE)(params, {"tokens": tokens})
            cache_dtype = torch.float32 if f32 else torch.bfloat16
            r["decode_vs_prefill"] = decode_vs_prefill(
                decode, dm, params, tokens, logits, CONTROL_POSITIONS, cache_dtype=cache_dtype)
            if name in gated:
                r["decode_vs_prefill_faulty_controls"] = {
                    f: decode_vs_prefill(decode, dm, params, tokens, logits,
                                         CONTROL_POSITIONS, fault=f, cache_dtype=cache_dtype)
                    for f in SSM_CONTROL_FAULTS}
            del logits
        out[name] = r
    return out


def check_ssm_prefill(label: str, runs: dict, gated: tuple[str, ...], per_pass: int,
                      grouped: int, swa: int, vocab: int) -> None:
    """The gates of ssm_prefill_and_decode's readings: launches of both
    counted prefills; the contract, decode_gate and the failing controls
    on the runs named in ``gated``."""
    for name, r in runs.items():
        check(r["launches"] == {"rmsnorm": per_pass, "swa_attention": swa,
                                "fused_sgd_update": 0}
              and r["rmsnorm_grouped_launches"] == grouped,
              f"{label} {name} prefill launches {r['launches']}, "
              f"grouped {r['rmsnorm_grouped_launches']}")
        d = r["decode_vs_prefill"]
        check(r["finite"] and d["finite"] and d["last_shape"][1:] == [1, vocab],
              f"{label} {name} logits finite, decode {d['last_shape']}")
    for name in gated:
        r = runs[name]
        check(contract(r), f"{label} {name} kernels vs plain prefill: rel err "
              f"{r['rel_err_vs_plain']}, argmax {r['argmax_agree_vs_plain']}")
        check(decode_gate(r["decode_vs_prefill"]),
              f"{label} {name} decode vs prefill: {r['decode_vs_prefill']}")
        for fault, c in r["decode_vs_prefill_faulty_controls"].items():
            check(c["argmax_agree"] < DECODE_AGREE_MIN and c["rel_err_all"] >= 0.08,
                  f"{label} {name} decode vs prefill gate passed the faulty control "
                  f"{fault}: {c}")


def ssm_phase(smi: str) -> dict:
    cfg = get_config(SSM_ARCH)
    model, params, out = init_full(cfg, SSM_ARCH)
    check(out["n_params"] == SSM_PARAMS == cfg.param_count(),
          f"{SSM_ARCH} at full width: {out['n_params']} parameters")
    per_pass, grouped = norm_launches(model)
    out["serve"] = serve_phase(cfg, params, "ssm_serve", per_step=per_pass)

    b, s = PREFILL_SHAPE
    tokens = torch.as_tensor(TokenStream(cfg.vocab_size, s, seed=5).batch(0, b)["tokens"],
                             device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    out["prefill"] = ssm_prefill_and_decode(model, params, tokens, SSM_GATED)
    out["prefill_peak_memory_bytes"] = torch.cuda.max_memory_allocated()

    # where the time goes: one prefill and one decode step, in bf16
    cache = pspec.init_params(None, model.cache_specs(
        InputShape("p", SERVE["prompt_len"], SERVE["batch"], "decode")), DEVICE)
    step_batch = {"tokens": torch.zeros((SERVE["batch"], 1), dtype=torch.int32,
                                        device=DEVICE),
                  "pos": torch.full((SERVE["batch"],), SERVE["prompt_len"] // 2,
                                    dtype=torch.int32, device=DEVICE)}
    prefill, decode = make_prefill(model, device=DEVICE), make_decode_step(model, device=DEVICE)
    one_decode = lambda: decode(params, cache, step_batch)  # noqa: E731
    one_prefill = lambda: prefill(params, {"tokens": tokens})  # noqa: E731
    out["profile"] = {
        "decode_step": {**device_profile(one_decode, 4),
                        "groups_ms_per_call": op_groups(cfg, one_decode, 2)},
        "prefill": {**device_profile(one_prefill, 2),
                    "groups_ms_per_call": op_groups(cfg, one_prefill, 1)}}
    del params, cache, model
    torch.cuda.empty_cache()
    out["train"] = ssm_train(cfg, smi)
    print(f"ssm phase [{smi}]: " + json.dumps(out), flush=True)

    check_ssm_prefill("SSM", out["prefill"], SSM_GATED, per_pass, grouped, 0, cfg.vocab_size)
    sc = out["train"]["step_vs_plain"]
    none = {"swa_attention": 0, "fused_sgd_update": 0}
    for name, r in sc.items():
        check(r["launches"] == {"rmsnorm": per_pass, **none, "rmsnorm_grouped": grouped},
              f"SSM {name} step launches {r['launches']}")
    check(lm_step_gate(sc["f32"]["kernels"]),
          f"SSM step in f32, kernels vs plain: {sc['f32']['kernels']}, limits {LM_STEP_LIMITS}")
    for control in LM_CONTROLS:
        check(not lm_step_gate(sc["f32"][control]),
              f"SSM step gate passed the control {control}: {sc['f32'][control]}")
    check(sc["bf16"]["kernels"]["loss_rel_err"] < SSM_BF16_LOSS_LIMIT,
          f"SSM step in bf16, kernels vs plain: loss {sc['bf16']['kernels']}")
    for name in ("f32_activations", "bf16"):
        tr = out["train"][name]
        n = tr["steps"]
        check(tr["launches"] == {"rmsnorm": per_pass * n, **none,
                                 "rmsnorm_grouped": grouped * n},
              f"SSM {name} train launches {tr['launches']}: {per_pass} ({grouped} "
              f"grouped) a step")
        check(all(math.isfinite(l) for l in tr["losses"]),
              f"SSM {name} losses finite: {tr['losses']}")
    losses = out["train"]["f32_activations"]["losses"]
    check(sum(losses[-5:]) / 5 < losses[0],
          f"SSM loss falls: mean of the last 5 {losses[-5:]} vs the first {losses[0]}")
    held = out["train"]["f32_activations"]["held_out_loss"]
    check(held["after"] < held["before"], f"SSM held-out loss falls: {held}")
    counted = [out["serve"], out["prefill"]["bf16"], out["prefill"]["f32"],
               out["train"]["f32_activations"], out["train"]["bf16"]]
    out["launches"] = {k: sum(c["launches"][k] for c in counted)
                       for k in ("rmsnorm", "swa_attention", "fused_sgd_update")}
    return out


def hybrid_phase(smi: str) -> dict:
    cfg = dataclasses.replace(get_config(HYBRID_ARCH), n_layers=HYBRID_LAYERS)
    model, params, out = init_full(cfg, f"{HYBRID_ARCH}, one block of {HYBRID_LAYERS} layers")
    check(out["n_params"] == HYBRID_PARAMS == cfg.param_count(),
          f"{HYBRID_ARCH} at full width, {HYBRID_LAYERS} layers: {out['n_params']} parameters")
    per_pass, grouped = norm_launches(model)
    b, s = PREFILL_SHAPE
    tokens = torch.as_tensor(TokenStream(cfg.vocab_size, s, seed=5).batch(0, b)["tokens"],
                             device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    # prefill at the config's capacity factor; decode against the prefill
    # at the reference's capacity factor for that check
    model8 = build_model(dataclasses.replace(cfg, capacity_factor=MOE_DECODE_CF))
    out["prefill"] = ssm_prefill_and_decode(model, params, tokens, HYBRID_GATED,
                                            decode_model=model8)
    out["prefill"]["capacity_factor"] = cfg.capacity_factor
    out["prefill"]["decode_capacity_factor"] = MOE_DECODE_CF
    out["prefill_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["serve"] = serve_phase(cfg, params, "hybrid_serve", per_step=per_pass)
    print(f"hybrid phase [{smi}]: " + json.dumps(out), flush=True)

    runs = {k: out["prefill"][k] for k in ("bf16", "f32")}
    check_ssm_prefill("hybrid", runs, HYBRID_GATED, per_pass, grouped, model.n_blocks,
                      cfg.vocab_size)
    peak = max(out["init_peak_memory_bytes"], out["prefill_peak_memory_bytes"],
               out["serve"]["peak_memory_bytes"])
    check(peak < 80e9, f"hybrid peak memory {peak}")
    counted = [out["serve"], runs["bf16"], runs["f32"]]
    out["launches"] = {k: sum(c["launches"][k] for c in counted)
                       for k in ("rmsnorm", "swa_attention", "fused_sgd_update")}
    return out


# ------------------------------------------------------------- training --
# ---------------------------------------------------------------- audio --
def audio_phase(smi: str) -> dict:
    cfg = get_config(AUDIO_ARCH)
    model, params, out = init_full(cfg, AUDIO_ARCH)
    check(out["n_params"] == AUDIO_PARAMS == cfg.param_count(),
          f"{AUDIO_ARCH} at full width: {out['n_params']} parameters")
    b, s = AUDIO_PREFILL
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    tokens = torch.as_tensor(TokenStream(cfg.vocab_size, s, seed=5).batch(0, b)["tokens"],
                             device=DEVICE)
    batch = {"tokens": tokens,
             "frames": randn(gen, (b, cfg.n_frontend_tokens, cfg.d_model), torch.bfloat16,
                             AUDIO_FRAMES_SCALE)}
    torch.cuda.reset_peak_memory_stats()
    r = prefill_vs_plain(model, params, batch)
    logits = r.pop("logits")
    del r["plain"]
    finite = bool(torch.isfinite(logits).all())

    # decode against prefill, the encoder's output in the cache; controls
    enc = model.encode(params, batch["frames"])
    decode = make_decode_step(model, device=DEVICE)
    ops.reset_launch_counts()
    sound = decode_vs_prefill(decode, model, params, tokens, logits, CONTROL_POSITIONS, enc=enc)
    decode_launches = ops.launch_counts()
    controls = {f: decode_vs_prefill(decode, model, params, tokens, logits,
                                     CONTROL_POSITIONS, fault=f, enc=enc)
                for f in AUDIO_CONTROL_FAULTS}
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del logits

    # where the time goes: one prefill and one decode step (cross-attention
    # over the 1,500 frames of the encoder's output)
    prefill = make_prefill(model, device=DEVICE)
    cache = pspec.init_params(None, model.cache_specs(
        InputShape("p", SERVE["prompt_len"], b, "decode")), DEVICE)
    cache["enc"].copy_(enc)
    step_batch = {"tokens": tokens[:, :1],
                  "pos": torch.full((b,), SERVE["prompt_len"] // 2, dtype=torch.int32,
                                    device=DEVICE)}
    one_decode = lambda: decode(params, cache, step_batch)  # noqa: E731
    one_prefill = lambda: prefill(params, batch)  # noqa: E731
    r["profile"] = {
        "decode_step": {**device_profile(one_decode, 4),
                        "groups_ms_per_call": op_groups(cfg, one_decode, 2)},
        "prefill": {**device_profile(one_prefill, 2),
                    "groups_ms_per_call": op_groups(cfg, one_prefill, 1)}}
    del cache, enc
    out.update(prefill=r, frames=[b, cfg.n_frontend_tokens, cfg.d_model],
               decode_vs_prefill=sound, decode_vs_prefill_faulty_controls=controls,
               decode_launches_per_step={k: v / CONTROL_POSITIONS
                                         for k, v in decode_launches.items()})
    out["serve"] = serve_phase(cfg, params, "audio_serve", per_step=0,
                               swa_per_step=cfg.n_layers)
    print(f"audio phase [{smi}]: " + json.dumps(out), flush=True)

    per_prefill = {"rmsnorm": 0, "swa_attention": cfg.encoder_layers + 2 * cfg.n_layers,
                   "fused_sgd_update": 0}
    check(r["launches"] == per_prefill, f"audio prefill launches {r['launches']}")
    check(decode_launches == {"rmsnorm": 0, "swa_attention": cfg.n_layers * CONTROL_POSITIONS,
                              "fused_sgd_update": 0},
          f"audio decode launches {decode_launches} over {CONTROL_POSITIONS} steps")
    check(finite, "audio prefill logits finite")
    check(contract(r), f"audio kernels vs plain prefill: rel err {r['rel_err_vs_plain']}, "
          f"argmax {r['argmax_agree_vs_plain']}")
    check(sound["finite"] and sound["last_shape"] == [b, 1, cfg.vocab_size],
          f"audio decode logits {sound['last_shape']}")
    check(decode_gate(sound), f"audio decode vs prefill: {sound}")
    for fault, c in controls.items():
        check(not decode_gate(c), f"audio decode vs prefill gate passed the faulty "
              f"control {fault}: {c}")
    out["launches"] = {k: out["serve"]["launches"][k] + r["launches"][k]
                       + decode_launches[k] for k in r["launches"]}
    return out


class RecordingStore(CheckpointStore):
    """A CheckpointStore that keeps a copy of the last state it saved and
    of the last state it restored, for the bit-exact restore check."""

    saved: dict | None = None
    restored: dict | None = None

    @staticmethod
    def _copy(state) -> dict:
        return {"params": state["params"].flat.clone(),
                "mu": state["opt"]["mu"].flat.clone(),
                "step": int(state["step"]), "epoch": float(state["epoch"])}

    def save(self, step, state, meta=None):
        self.saved = self._copy(state)
        return super().save(step, state, meta)

    def restore(self, template, step=None):
        state, meta, seconds = super().restore(template, step)
        self.restored = self._copy(state)
        return state, meta, seconds


def trainer(model, store, data) -> ElasticTrainer:
    return ElasticTrainer(model, sgd(), data, store, **TRAIN, device=DEVICE)


def segment_stats(r) -> dict:
    images = r.steps * TRAIN["m_per_worker"] * r.w
    return {"w": r.w, "steps": r.steps, "global_batch": TRAIN["m_per_worker"] * r.w,
            "seconds": r.seconds, "step_ms": 1e3 * r.seconds / r.steps,
            "images_per_s": images / r.seconds, "epochs": r.epochs,
            "losses": [loss for _, _, loss in r.losses],
            "save_seconds": r.save_seconds, "restore_seconds": r.restore_seconds}


def exact_resume(model, data, root: Path) -> dict:
    """5 + 5 steps at w = 4 against 10 uninterrupted, with cuDNN's
    deterministic algorithms for this check only."""
    torch.backends.cudnn.deterministic = True
    try:
        w = TRAIN_SEGMENTS[0][0]
        whole = trainer(model, CheckpointStore(str(root / "whole")), data)
        straight = [l for _, _, l in whole.train_segment(
            w, 10, resume=False, log_every=1).losses]
        parts = trainer(model, CheckpointStore(str(root / "parts")), data)
        parts.train_segment(w, 5, resume=False, log_every=1)
        resumed = [l for _, _, l in parts.train_segment(
            w, 5, resume=True, log_every=1).losses]
    finally:
        torch.backends.cudnn.deterministic = False
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight[5:]))
    check(worst <= 1e-5, f"exact resume: {resumed} vs {straight[5:]}")
    return {"uninterrupted": straight[5:], "resumed": resumed, "max_rel_err": worst}


def kernel_on_trained_state(model, store, data) -> float:
    """From one set of gradients at the trained state, the kernel and the
    plain version on copies of parameters and momentum."""
    tr = trainer(model, store, data)
    state, _, _ = store.restore(tr.fresh_state())
    w = TRAIN_SEGMENTS[-1][0]
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in
             data.batch(int(state["step"]), TRAIN["m_per_worker"] * w).items()}
    _, grads = value_and_flat_grad(model, state["params"], batch)
    lr = tr._lr(w, float(state["epoch"]))
    p, mu = state["params"].flat, state["opt"]["mu"].flat
    want_p, want_mu = ref.fused_sgd_update_ref(p, grads, mu, lr)
    got_p, got_mu = p.clone(), mu.clone()
    sgd_kernel.fused_sgd_update(got_p, grads, got_mu, lr)
    torch.cuda.synchronize()
    err = max(float((got_p - want_p).abs().max()), float((got_mu - want_mu).abs().max()))
    tol = TOL["fused_sgd_update"][torch.float32]
    check(torch.allclose(got_p, want_p, rtol=tol, atol=tol)
          and torch.allclose(got_mu, want_mu, rtol=tol, atol=tol),
          f"fused_sgd_update on the trained state: max abs err {err}")
    return err


def grad_errors(got: torch.Tensor, want: torch.Tensor, shapes: dict) -> dict:
    """Relative L2 error of a flat gradient against a reference: over the
    whole buffer and at its worst leaf (``shapes`` from FlatTree.shapes,
    in the buffer's order)."""
    got, want = got.double().cpu(), want.double().cpu()
    worst, worst_leaf, off = 0.0, None, 0
    for path, shape in shapes.items():
        size = math.prod(shape)
        g, r = got[off:off + size], want[off:off + size]
        err = float((g - r).norm() / (r.norm() + 1e-30))
        if err > worst:
            worst, worst_leaf = err, path
        off += size
    return {"flat_rel_err": float((got - want).norm() / want.norm()),
            "worst_leaf_rel_err": worst, "worst_leaf": worst_leaf}


def step_vs_f32(model, store, data, step: int) -> dict:
    """One train step's loss and flat gradient on the card, held against
    the same step computed in f32 on the host's CPU, at the state of the
    checkpoint at ``step`` and on STEP_CHECK_IMAGES of its next batch:
    the f32 model on the card (cuDNN and cuBLAS without TF32) and the bf16
    model that the trainer runs."""
    tr = trainer(model, store, data)
    state, _, _ = store.restore(tr.fresh_state(), step=step)
    params = state["params"]
    batch = data.batch(int(state["step"]), STEP_CHECK_IMAGES)
    f32 = build_model(resnet110.CONFIG, dtype=torch.float32)
    cpu = pspec.views(params.flat.cpu(), params.shapes())
    want_loss, want = value_and_flat_grad(
        f32, cpu, {k: torch.as_tensor(v) for k, v in batch.items()})
    on_card = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch.items()}
    out = {"images": STEP_CHECK_IMAGES, "cpu_f32_loss": float(want_loss)}
    for name, m in (("gpu_f32", f32), ("gpu_bf16", model)):
        loss, grads = value_and_flat_grad(m, params, on_card)
        out[name] = {"loss": float(loss),
                     "loss_rel_err": abs(float(loss) - float(want_loss))
                     / abs(float(want_loss)),
                     **grad_errors(grads, want, params.shapes())}
    return out


# kernel-name substrings of a train step's parts, for its profile
TRAIN_KERNEL_GROUPS = {
    "fused_sgd_update": ("fused_sgd",),
    "conv_forward": ("fprop",),
    "conv_data_grad": ("dgrad",),
    "conv_weight_grad": ("wgrad",),
    "layout_conversion": ("nchwToNhwc", "nhwcToNchw"),
    "group_norm": ("RowwiseMoments", "ComputeFusedParams", "ComputeInternalGradients",
                   "ComputeBackwardFusedParams", "GammaBetaBackward"),
    "elementwise": ("elementwise", "vectorized"),
    "reduce": ("reduce_kernel",),
}


def train_profile(model, data, store) -> dict:
    """Where a train step's time goes at w = 4: wall time per step with the
    host's batch generation, device time by kernel and by part of the step,
    the SGD kernel's share."""
    tr = trainer(model, store, data)
    state, _, _ = store.restore(tr.fresh_state())
    train_state = {"params": state["params"], "opt": state["opt"]}
    step = make_train_step(model, tr.opt, device=DEVICE)
    batch_size = TRAIN["m_per_worker"] * TRAIN_SEGMENTS[0][0]
    it = iter(range(1000))

    def one():
        nonlocal train_state
        train_state, loss = step(train_state, data.batch(next(it), batch_size), 0.01)
        return loss

    t0 = time.perf_counter()
    for i in range(4):
        data.batch(i, batch_size)
    host_batch_ms = 1e3 * (time.perf_counter() - t0) / 4
    out = device_profile(one, 4, TRAIN_KERNEL_GROUPS)
    busy = out["device_busy_ms_per_call"]
    sgd_ms = out["groups_ms_per_call"]["fused_sgd_update"]
    out.update(host_batch_ms=host_batch_ms, sgd_kernel_ms_per_step=sgd_ms,
               sgd_share_of_device_time=sgd_ms / busy if busy else None)
    return out


def held_out(model, store, data) -> dict:
    """Loss and accuracy of the last checkpoint on the HELD_OUT batch."""
    state, _, _ = store.restore(trainer(model, store, data).fresh_state())
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in
             data.batch(HELD_OUT["step"], HELD_OUT["images"]).items()}
    with torch.no_grad():
        return {"step": int(state["step"]), "images": HELD_OUT["images"],
                "loss": float(model.loss(state["params"], batch)),
                "accuracy": float(model.accuracy(state["params"], batch))}


def train_phase() -> dict:
    cfg = resnet110.CONFIG
    model = build_model(cfg)
    data = CifarLike(size=TRAIN_DATASET, seed=0)
    (w1, n1), (w2, n2), (w3, n3) = TRAIN_SEGMENTS
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # warm-up at both batches (cuDNN plans, allocator), not counted
        warm = trainer(model, CheckpointStore(str(root / "warm")), data)
        warm.train_segment(w1, 2, resume=False)
        warm.train_segment(w2, 2)

        store = RecordingStore(str(root / "main"))
        tr = trainer(model, store, data)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        r1 = tr.train_segment(w1, n1, resume=False, log_every=TRAIN_LOG_EVERY)
        after_first = ops.launch_counts()
        saved = store.saved
        r2 = tr.train_segment(w2, n2, resume=True, log_every=TRAIN_LOG_EVERY)
        restored = store.restored
        r3 = tr.train_segment(w3, n3, resume=True, log_every=TRAIN_LOG_EVERY)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()

        with np.load(store._path(n1)) as z:
            on_disk = {k: z[k] for k in z.files}
        mine = torch.cat([torch.as_tensor(v).reshape(-1) for k, v in sorted(
            on_disk.items()) if k.startswith("params/")])
        exact = {"params": torch.equal(saved["params"], restored["params"]),
                 "momentum": torch.equal(saved["mu"], restored["mu"]),
                 "file": torch.equal(saved["params"].cpu(), mine)}
        out = {"config": cfg.name, "n_params": int(saved["params"].numel()),
               "base_lr_1w": TRAIN["base_lr_1w"],
               "segments": [segment_stats(r) for r in (r1, r2, r3)],
               "stop_restart_seconds": r1.save_seconds + r2.restore_seconds,
               "peak_memory_bytes": peak, "launches": counts,
               "restore_bit_exact": exact,
               "restored_step": restored["step"], "restored_epoch": restored["epoch"],
               "held_out": held_out(model, store, data)}
        out["kernel_vs_plain_on_trained_state_max_abs_err"] = kernel_on_trained_state(
            model, store, data)
        out["step_vs_f32"] = step_vs_f32(model, store, data, step=n1 + n2 + n3)
        out["exact_resume"] = exact_resume(model, data, root)
        out["profile"] = train_profile(model, data, store)
    print("train phase: " + json.dumps(out), flush=True)

    losses1, losses2, losses3 = (s["losses"] for s in out["segments"])
    check(after_first == {"rmsnorm": 0, "swa_attention": 0, "fused_sgd_update": n1},
          f"launches after the first segment {after_first}")
    check(counts == {"rmsnorm": 0, "swa_attention": 0,
                     "fused_sgd_update": n1 + n2 + n3},
          f"train launches {counts}: one fused_sgd_update per step")
    check(all(math.isfinite(l) for l in losses1 + losses2 + losses3), "losses finite")
    check(sum(losses2) / len(losses2) < losses1[0],
          f"second segment's mean loss {losses2} below the first loss {losses1[0]}")
    held = out["held_out"]
    check(held["loss"] < HELD_LOSS_MAX and held["accuracy"] >= HELD_ACCURACY_MIN,
          f"learned below chance: held-out {held}, limits loss < {HELD_LOSS_MAX}, "
          f"accuracy >= {HELD_ACCURACY_MIN}")
    for name, limits in STEP_LIMITS.items():
        got = out["step_vs_f32"][name]
        for key, limit in limits.items():
            check(got[key] < limit, f"train step {name} vs f32 on the CPU: "
                  f"{key} {got[key]} >= {limit}")
    check(all(exact.values()), f"restore bit-exact: {exact}")
    check(restored["step"] == n1 and restored["epoch"] == saved["epoch"],
          f"step and epoch carried over: {restored['step']}, {restored['epoch']}")
    check(r2.losses[0][0] == n1 and r2.epochs > r1.epochs, "segment 2 continues segment 1")
    check(r3.losses[0][0] == n1 + n2 and r3.epochs > r2.epochs,
          "segment 3 continues segment 2")
    return out


# ------------------------------------------------------------- sched ----
def sched_profile(model, params, data) -> dict:
    """Table 1's profile on the card: the per-worker forward (the loss
    without autograd) and forward + backward (``value_and_flat_grad``) of
    one batch of m images, each the median of SCHED_REPS calls."""
    m = TRAIN["m_per_worker"]
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in data.batch(0, m).items()}

    def forward():
        with torch.no_grad():
            model.loss(params, batch)

    out = {"images": m, "reps": SCHED_REPS}
    for name, fn in (("fwd", forward),
                     ("fwd_back", lambda: value_and_flat_grad(model, params, batch))):
        for _ in range(2):
            fn()
        times = []
        for _ in range(SCHED_REPS):
            t0 = sync_time()
            fn()
            times.append(1e3 * (sync_time() - t0))
        out[f"{name}_ms"] = float(np.median(times))
        out[f"{name}_ms_all"] = times
    out["T_fwd"] = out["fwd_ms"] / 1e3 / m  # seconds per example
    out["T_back"] = max(out["fwd_back_ms"] - out["fwd_ms"], 1e-6) / 1e3 / m
    return out


def card_table3(T_fwd: float, T_back: float, restart_cost: float) -> dict:
    """Table 3's poisson traces with every job's step time from the card's
    profile (eqs. 2-4 at the paper's InfiniBand for the exchange): avg JCT
    in hours per level and strategy, and each run's jobs completed."""
    cluster = cost.ClusterModel(capacity=64, restart_cost=restart_cost)
    jct, completed, traces = {}, {}, {}
    for level, (gap, n_jobs) in SCHED_CONTENTION.items():
        traces[level] = [dataclasses.replace(j, speed_mode="analytic", T_fwd=T_fwd,
                                             T_back=T_back, T_const=0.0, T_per_worker=0.0)
                         for j in make_workload("poisson", n_jobs, gap, 0)]
        runs = {s: simulate(traces[level], strategy=s, cluster=cluster)
                for s in TABLE3_STRATEGIES}
        jct[level] = {s: r.avg_jct_hours for s, r in runs.items()}
        completed[level] = {s: len(r.completion_times) == n_jobs and not r.rejected
                            for s, r in runs.items()}
    table, ref = (simulate(traces["none"], strategy="precompute", cluster=cluster,
                           engine=engine) for engine in ("table", "reference"))
    return {"restart_cost_s": restart_cost, "avg_jct_hours": jct, "completed": completed,
            "precompute_over_best_fixed": over_best_fixed(jct),
            "engines_bit_identical_none_precompute": {
                j: t.hex() for j, t in table.completion_times.items()} == {
                j: t.hex() for j, t in ref.completion_times.items()}}


def over_best_fixed(jct: dict) -> dict:
    """precompute's avg JCT over the best fixed_w strategy's, per level."""
    return {level: row["precompute"] / min(v for s, v in row.items()
                                           if s.startswith("fixed_"))
            for level, row in jct.items()}


def sched_phase(smi: str) -> dict:
    """The paper's pipeline on the card (tests/test_system.py:26-62 at full
    size): train, fit eq. 1, profile, fit eq. 5, let the doubling
    heuristic size the job, restart it at that size; then Table 3."""
    t_start = time.perf_counter()
    model = build_model(resnet110.CONFIG)
    data = CifarLike(size=TRAIN_DATASET, seed=0)
    m = TRAIN["m_per_worker"]
    n_params = pspec.n_params(model.param_specs())
    n_bytes = 4 * n_params
    steps_1, steps_2 = SCHED_STEPS
    out = {"card": smi, "config": resnet110.CONFIG.name, "n_params": n_params,
           "m_per_worker": m, "base_lr_1w": TRAIN["base_lr_1w"]}
    with tempfile.TemporaryDirectory() as tmp:
        tr = trainer(model, CheckpointStore(tmp), data)
        ops.reset_launch_counts()
        rec = tr.train_segment(1, steps_1, resume=False, log_every=1)

        # (2) eq. 1 on the logged losses
        conv = fit_convergence(np.array([s for s, _, _ in rec.losses], float),
                               np.array([l for _, _, l in rec.losses], float))
        out["eq1"] = {**dataclasses.asdict(conv), "loss_at_100": float(conv.loss_at(100.0))}

        # (3) Table 1's profile, and eq. 5 from its step times
        prof = sched_profile(model, tr.fresh_state()["params"], data)
        step_times, rows = {}, []
        for w in SCHED_WS:
            comm = cost.step_time(1, 0.0, 0.0, w, n_bytes, cost.INFINIBAND_100G)
            step_times[w] = prof["fwd_back_ms"] / 1e3 + comm
            paper = PAPER_TABLE1[w]
            rows.append({"w": w, "compute_ms": prof["fwd_back_ms"],
                         "comm_ms_analytic_ib100g": 1e3 * comm,
                         "step_ms": 1e3 * step_times[w],
                         "images_per_s": m * w / step_times[w],
                         "paper_k40m": {"fwd_ms": paper[0], "back_ms": paper[1],
                                        "step_ms": paper[2], "images_per_s": paper[3]}})
        ws, speeds = profile_to_speeds(step_times, TRAIN_DATASET / m)
        rm = fit_resource_model(ws, speeds, m=m, n=n_bytes)
        fitted = rm.f(ws)
        out["profile"] = prof
        out["table1"] = rows
        out["eq5"] = {"theta": rm.theta.tolist(), "ws": ws.tolist(),
                      "speeds_epochs_per_s": speeds.tolist(),
                      "fitted_epochs_per_s": fitted.tolist(),
                      "rel_residual": ((fitted - speeds) / speeds).tolist()}

        # (4) the doubling heuristic sizes the job; restart at its w
        remaining = SCHED_EPOCHS - rec.epochs
        alloc = scheduler.doubling_heuristic(
            [(0, remaining, lambda w: float(rm.f(np.array([w]))[0]))],
            capacity=SCHED_CAPACITY, max_w=SCHED_CAPACITY)
        rec2 = tr.train_segment(alloc[0], steps_2, resume=True, log_every=1)
        counts = ops.launch_counts()
    out.update(remaining_epochs=remaining, alloc=alloc[0],
               segments=[segment_stats(rec), segment_stats(rec2)], launches=counts,
               save_seconds=rec.save_seconds, restore_seconds=rec2.restore_seconds,
               stop_restart_seconds=rec.save_seconds + rec2.restore_seconds,
               stop_restart_note="save and restore inside one process; no process "
                                 "relaunch is in it (the paper's ~10 s is)")
    out["seconds_card"] = time.perf_counter() - t_start

    # (5) Table 3 through the port's simulator, on the host
    t0 = time.perf_counter()
    calibrated = run_table3()
    out["table3"] = {
        "paper_calibration": {"avg_jct_hours": calibrated,
                              "precompute_over_best_fixed": over_best_fixed(calibrated)},
        "card_profile": [card_table3(prof["T_fwd"], prof["T_back"], rc) for rc in
                         (out["stop_restart_seconds"], PAPER_RESTART_SECONDS)]}
    out["seconds_host_table3"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_start

    for r in rows:
        k = r["paper_k40m"]
        print(f"sched table1 w={r['w']}: compute {r['compute_ms']:.3f} ms (card, per worker, "
              f"{m} images) + comm {r['comm_ms_analytic_ib100g']:.3f} ms (analytic, eqs. "
              f"2-4 at the paper's 100 Gbit/s InfiniBand; not a measurement of the card) "
              f"= {r['step_ms']:.3f} ms, {r['images_per_s']:.1f} images/s; the paper's "
              f"K40m: {k['step_ms']} ms, {k['images_per_s']} images/s [{smi}]", flush=True)
    for label, t3 in [("paper calibration", out["table3"]["paper_calibration"])] + [
            (f"card profile, restart {t['restart_cost_s']:.3f} s", t)
            for t in out["table3"]["card_profile"]]:
        for level, row in t3["avg_jct_hours"].items():
            print(f"sched table3 [{label}] {level:8s} " + " ".join(
                f"{s} {v:.4f}" for s, v in row.items())
                + f" | precompute / best fixed {t3['precompute_over_best_fixed'][level]:.4f}",
                flush=True)
    print(f"sched phase [{smi}]: " + json.dumps(out), flush=True)

    check(n_params == RESNET_PARAMS, f"sched: {n_params} parameters")
    check(math.isfinite(out["eq1"]["loss_at_100"]), f"eq. 1 fit: {out['eq1']}")
    check(bool(np.all(np.diff(fitted) > 0)), f"eq. 5 f(w) increasing: {fitted}")
    check(alloc[0] == SCHED_CAPACITY, f"doubling heuristic allocation {alloc}")
    check(rec2.epochs > rec.epochs, "the restart continues the epochs")
    check(rec2.losses[-1][2] < rec.losses[0][2],
          f"last loss {rec2.losses[-1][2]} below the first {rec.losses[0][2]}")
    check(rec2.losses[0][0] == steps_1, "the restart continues the steps")
    check(counts == {"rmsnorm": 0, "swa_attention": 0,
                     "fused_sgd_update": steps_1 + steps_2},
          f"sched launches {counts}: one fused_sgd_update per step")
    for t in out["table3"]["card_profile"]:
        check(all(all(row.values()) for row in t["completed"].values()),
              f"every job completes: {t['completed']}")
        check(t["engines_bit_identical_none_precompute"],
              "table and reference engines bit-identical under the card's profile")
    return out


# ------------------------------------------------------------ LM train --
def lm_grad_errors(got: torch.Tensor, want: torch.Tensor, shapes: dict) -> dict:
    """Relative L2 error of a flat gradient against another, over the whole
    buffer and at its worst leaf, a stacked leaf (``layers/...``) per
    layer; sums of squares in f64 one leaf at a time (the buffers hold
    3.4 B values each)."""
    num = den = worst = 0.0
    worst_leaf, off = None, 0
    for path, shape in shapes.items():
        size = math.prod(shape)
        g, w = got[off:off + size].view(shape), want[off:off + size].view(shape)
        off += size
        if path.startswith("layers/"):
            pairs = [(f"{path}[{i}]", a, b)
                     for i, (a, b) in enumerate(zip(g.unbind(0), w.unbind(0)))]
        else:
            pairs = [(path, g, w)]
        for name, a, b in pairs:
            d2 = float((a - b).double().square().sum())
            b2 = float(b.double().square().sum())
            num, den = num + d2, den + b2
            err = math.sqrt(d2 / b2) if b2 else (0.0 if d2 == 0 else math.inf)
            if err > worst:
                worst, worst_leaf = err, name
    return {"flat_rel_err": math.sqrt(num / den), "worst_leaf_rel_err": worst,
            "worst_leaf": worst_leaf}


def lm_step_gate(r: dict) -> bool:
    return all(r[key] < limit for key, limit in LM_STEP_LIMITS.items())


def lm_step_vs_plain(model, params, batch: dict, leaf: str = "mlp/wo") -> dict:
    """One step's loss and flat gradient through the kernels against the
    same step through the plain versions called directly, and the two
    controls: labels shifted, and the last layer's ``layers/{leaf}``
    gradient zeroed. Holds three full-size buffers: parameters and two flat
    gradients."""
    shapes = params.shapes()
    with plain_versions():
        want_loss, want = value_and_flat_grad(model, params, batch)
    want_loss = float(want_loss)
    ops.reset_launch_counts()
    loss, grads = value_and_flat_grad(model, params, batch)
    counts = {**ops.launch_counts(), "rmsnorm_grouped": rms_kernel.rmsnorm.grouped_launches}

    def errors(l) -> dict:
        return {"loss": float(l), "loss_rel_err": abs(float(l) - want_loss) / abs(want_loss),
                **lm_grad_errors(grads, want, shapes)}

    out = {"plain_loss": want_loss, "launches": counts, "kernels": errors(loss),
           "zeroed_leaf": f"layers/{leaf}"}
    node = pspec.views(grads, shapes)["layers"]
    for k in leaf.split("/"):
        node = node[k]
    node[-1].zero_()
    out["one_layer_zeroed"] = errors(loss)
    shifted = dict(batch, labels=torch.roll(batch["labels"], 1, dims=1))
    loss, grads = value_and_flat_grad(model, params, shifted, grads)
    out["labels_shifted"] = errors(loss)
    return out


def lm_logits_ms(x_shape, unembed: torch.Tensor, iters: int = 5) -> float:
    """CUDA-event time of the f32 lm_logits product and its two backward
    products (no TF32) at the train step's shape, alone."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    x = randn(gen, x_shape, torch.bfloat16).requires_grad_()
    w = unembed.detach().requires_grad_()
    cot = randn(gen, (*x_shape[:-1], unembed.shape[0]), torch.float32)

    def fwd_bwd():
        torch.autograd.grad(mlayers.lm_logits(x, w), (x, w), cot)

    return time_ms(fwd_bwd, [()], iters)


def lm_backward_formulas_ms(cfg) -> dict:
    """CUDA-event time of the rmsnorm and swa_attention backward formulas
    at the train step's shapes, times their calls a step (73 and 36)."""
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    bf16, rows = torch.bfloat16, LM["batch"] * LM["seq"]
    x, g = (randn(gen, (rows, cfg.d_model), bf16) for _ in range(2))
    w = randn(gen, (cfg.d_model,), torch.float32, 0.1)
    qkvo = [randn(gen, (LM["batch"] * cfg.n_heads, LM["seq"], cfg.d_head), bf16)
            for _ in range(4)]
    return {"rmsnorm": (2 * cfg.n_layers + 1) * time_ms(
                lambda: ops.rmsnorm_backward(x, w, g), [()], 20),
            "swa_attention": cfg.n_layers * time_ms(
                lambda: ops.swa_attention_backward(*qkvo), [()], 20)}


def lm_exact_resume(root: Path) -> dict:
    """At the smoke config: LM_RESUME[0] steps, a checkpoint of {params,
    opt}, a restore into a state drawn from another seed and LM_RESUME[1]
    more steps, against the same steps uninterrupted; deterministic
    algorithms for this check only (index_add's atomics otherwise)."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, torch.float32)
    data = TokenStream(cfg.vocab_size, LM["seq"], seed=0)
    n1, n2 = LM_RESUME
    sched = warmup_cosine(LM["base_lr"], warmup=LM["warmup"], total=n1 + n2)

    def fresh(seed: int) -> dict:
        return init_train_state(model, adamw(), torch.Generator(device=DEVICE).manual_seed(seed),
                                device=DEVICE)

    def run(state, steps) -> list[float]:
        step = make_train_step(model, adamw(), device=DEVICE)
        return [float(step(state, data.batch(i, LM["batch"]), sched(i))[1]) for i in steps]

    with warnings.catch_warnings():
        # warn_only: cuBLAS on one stream is deterministic without
        # CUBLAS_WORKSPACE_CONFIG, which would have to be set before it starts
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            straight = run(fresh(0), range(n1 + n2))
            state = fresh(0)
            run(state, range(n1))
            store = CheckpointStore(str(root / "lm"))
            store.save(n1, state)
            restored, _, _ = store.restore(fresh(1))
            resumed = run(restored, range(n1, n1 + n2))
        finally:
            torch.use_deterministic_algorithms(False)
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight[n1:]))
    check(worst <= 1e-5 and int(restored["opt"]["t"]) == n1 + n2,
          f"LM exact resume: {resumed} vs {straight[n1:]}")
    return {"config": cfg.name, "uninterrupted": straight[n1:], "resumed": resumed,
            "max_rel_err": worst}


def lm_train_phase(smi: str) -> dict:
    cfg = get_config(ARCH)
    model = build_model(cfg, torch.float32)  # f32 masters, bf16 compute
    data = TokenStream(cfg.vocab_size, LM["seq"], seed=0)
    opt = adamw()
    sched = warmup_cosine(LM["base_lr"], warmup=LM["warmup"], total=LM["steps"])
    t0 = sync_time()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    init_seconds = sync_time() - t0
    first = {k: torch.as_tensor(v, device=DEVICE) for k, v in
             data.batch(0, LM["batch"]).items()}
    step_check = lm_step_vs_plain(model, params, first)
    torch.cuda.empty_cache()

    state = {"params": params, "opt": opt.init(params)}
    step = make_train_step(model, opt, device=DEVICE)
    run = train_steps(step, state, data, sched, range(LM["steps"]), LM["batch"])
    losses, counts, peak = run["losses"], run["launches"], run["peak_memory_bytes"]
    tokens, step_ms = LM["batch"] * LM["seq"], run["step_ms_median"]
    more = iter(range(LM["steps"], 1000))
    profile_ = device_profile(
        lambda: step(state, data.batch(next(more), LM["batch"]), sched(LM["steps"] - 1)),
        2, LM_KERNEL_GROUPS)
    logits_ms = lm_logits_ms((LM["batch"], LM["seq"], cfg.d_model),
                             state["params"]["unembed"])
    busy = profile_["device_busy_ms_per_call"]
    formulas_ms = lm_backward_formulas_ms(cfg)
    del step  # its flat gradient buffer: AdamW is timed on a zero one
    zero = torch.zeros_like(params.flat)
    adamw_ms = time_ms(lambda: opt.update(zero, state["opt"], state["params"], 0.0),
                       [()], 3)
    del state, params, zero
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        resume = lm_exact_resume(Path(tmp))

    out = {"config": cfg.name, "n_params": cfg.param_count(), "batch": LM["batch"],
           "seq": LM["seq"], "steps": LM["steps"], "init_seconds": init_seconds,
           "step_vs_plain": step_check, **run, "profile": profile_,
           "lm_logits_fwd_bwd_ms": logits_ms,
           "lm_logits_share_of_device_busy": logits_ms / busy if busy else None,
           "adamw_update_ms": adamw_ms,
           "adamw_share_of_device_busy": adamw_ms / busy if busy else None,
           "backward_formulas_ms_per_step": formulas_ms,
           "backward_formulas_share_of_device_busy":
               sum(formulas_ms.values()) / busy if busy else None,
           "exact_resume": resume, "card": smi}
    print(f"lm_train: {cfg.name}, {LM['steps']} steps of {tokens} tokens, step "
          f"{step_ms:.1f} ms (median of steps 2-{LM['steps']}), {tokens / (step_ms / 1e3):.0f} "
          f"tokens/s, peak memory {peak} bytes, device busy {busy} ms and idle share "
          f"{profile_['device_idle_share']} a step, f32 lm_logits fwd+bwd "
          f"{logits_ms:.2f} ms, AdamW update {adamw_ms:.2f} ms, backward formulas "
          f"{json.dumps(formulas_ms)} ms a step [{smi}]", flush=True)
    print("lm_train phase: " + json.dumps(out), flush=True)

    per_step = {"rmsnorm": 2 * cfg.n_layers + 1, "swa_attention": cfg.n_layers,
                "fused_sgd_update": 0}
    check(step_check["launches"] == {**per_step, "rmsnorm_grouped": 0},
          f"LM step launches {step_check['launches']}")
    check(counts == {**{k: n * LM["steps"] for k, n in per_step.items()}, "rmsnorm_grouped": 0},
          f"LM train launches {counts}: {per_step} a step")
    check(lm_step_gate(step_check["kernels"]),
          f"LM step, kernels vs plain: {step_check['kernels']}, limits {LM_STEP_LIMITS}")
    for control in LM_CONTROLS:
        check(not lm_step_gate(step_check[control]),
              f"LM step gate passed the control {control}: {step_check[control]}")
    check(all(math.isfinite(l) for l in losses), f"LM losses finite: {losses}")
    check(sum(losses[-5:]) / 5 < losses[0],
          f"LM loss falls: mean of the last 5 {losses[-5:]} vs the first {losses[0]}")
    check(peak < torch.cuda.get_device_properties(0).total_memory,
          f"LM peak memory {peak}")
    return out


# ------------------------------------------------------- data parallel --
def _not_divided(x, group=None, algorithm="ring"):
    """Faulty exchange (a): the step's division by w is undone, so the
    update uses the sum of the ranks' gradients."""
    cdist.allreduce_(x, group, algorithm)
    return x.mul_(torch.distributed.get_world_size(group))


def _no_all_gather(x, group=None, algorithm="ring"):
    """Faulty exchange (b): the ring's reduce-scatter without its
    all-gather; each rank keeps its own segment of the sum and partial
    sums elsewhere."""
    w = torch.distributed.get_world_size(group)
    r = torch.distributed.get_rank(group)
    n = x.numel()
    buf = torch.zeros(n + (-n) % w, pin_memory=x.is_cuda)
    buf[:n].copy_(x)
    cdist._ring_reduce_scatter(buf, w, r, group)
    return x.copy_(buf[:n])


def faulty_runs(rank, run, dev) -> dict:
    """A rank's ring run of ``run`` through each faulty exchange in turn (a
    test double: the package has no switch for it)."""
    out, inner = {}, steps_module.allreduce_
    try:
        for fault in DP_FAULTS:
            steps_module.allreduce_ = globals()[f"_{fault}"]
            out[fault] = dp.train(rank, run, dev)["algorithms"]["ring"]
    finally:
        steps_module.allreduce_ = inner
    return out


DP_LABEL = ("times: host clock, gloo over host memory with CUDA<->pinned staging, "
            "all ranks sharing one card; not an all-reduce number of the card")


def dp_rank(rank, run, controls, init_method, out_dir):
    """A data-parallel rank: ``run`` under each algorithm, then, unless
    ``controls`` is None, the faulty exchanges on ``controls``, in one
    process (a spawn and the ranks' start on the card cost seconds); saves
    both and their seconds."""
    dev = dp.join(rank, run, init_method)
    try:
        t0 = time.perf_counter()
        out = {"run": dp.train(rank, run, dev)}
        t1 = time.perf_counter()
        if controls is not None:
            out.update(faulty_runs(rank, controls, dev))
        out["seconds"] = {"run": t1 - t0, "controls": time.perf_counter() - t1}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def dp_run(spec, control_steps: int | None) -> tuple[dict, list[dict]]:
    """``spec`` on its ranks, each holding its update to the one-process
    step's (``dp.one_process_updates``), and, with ``control_steps``, each
    faulty exchange under ring for that many steps in the same ranks.
    Returns ``dp.summary`` with the init digests, the psum ranks' spread
    over the largest element of the update, the controls' update errors
    and the seconds; and the ranks' results."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dp_") as tmp:
        init_digest, updates, scale = dp.one_process_updates(spec, Path(tmp))
        t_one = time.perf_counter() - t0
        run = dataclasses.replace(spec, reference=str(updates[-1]))
        controls = None if control_steps is None else dataclasses.replace(
            spec, algorithms=("ring",), steps=control_steps, check_exchange=False,
            reference=str(updates[control_steps - 1]))
        outs = dp.spawn(dp_rank, spec.world, (run, controls), spec.timeout_s * (
            len(spec.algorithms) + (0 if controls is None else len(DP_FAULTS)) + 2))
    ranks = [o["run"] for o in outs]
    summary = dp.summary(run, ranks)
    summary["init_digest_one_process"] = init_digest
    summary["init_digests"] = [r["init_digest"] for r in ranks]
    if "psum" in spec.algorithms:
        summary["psum_rank_spread_rel"] = summary["algorithms"]["psum"]["rank_spread"] / scale
    if controls is not None:
        summary["controls_update_rel_err"] = {
            fault: [o[fault]["update_rel_err_vs_reference"] for o in outs]
            for fault in DP_FAULTS}
    summary["seconds"] = {"one_process": t_one, "ranks": time.perf_counter() - t0 - t_one,
                          "in_rank0": outs[0]["seconds"]}
    return summary, ranks


def dp_launches(ranks: list[dict]) -> dict[str, int]:
    """Each kernel's launches over the ranks and their algorithms."""
    return {k: sum(r["algorithms"][alg]["launches"][k] for r in ranks
                   for alg in r["algorithms"])
            for k in ("rmsnorm", "swa_attention", "fused_sgd_update")}


def dp_report(name: str, summary: dict, smi: str) -> None:
    for alg, a in summary["algorithms"].items():
        print(f"{name} {alg:16s} step {a['step_ms_median']} ms, exchange in the "
              f"steps {a['exchange_ms_median']} ms (host clock, gloo over host "
              f"memory, staging included; {summary['transport']}), "
              f"{a['bytes_sent_per_rank']} bytes sent per rank and step, ranks "
              f"bit-identical {a['ranks_bit_identical']}, update vs one process "
              f"{a['update_rel_err_vs_reference']}, peak memory per rank "
              f"{a['peak_memory_bytes']} [{smi}]", flush=True)


def dp_gates(where: str, spec, summary: dict, ranks: list[dict],
             per_step: dict[str, int], limit: float) -> None:
    """The data-parallel gates: one init everywhere, staged gloo, psum's
    ranks within DP_F32_LIMIT and the others' bits identical, ``per_step``
    launches a rank and step, finite losses, every rank's update within
    ``limit`` of the one-process update, the first-step exchange within
    DP_F32_LIMIT of dist.all_reduce, and every rank of every faulty
    exchange at or past ``limit``."""
    check(summary["same_init"] and summary["init_digests"][0]
          == summary["init_digest_one_process"],
          f"{where}: one init on every rank and in the parent")
    check(summary["transport"] == "gloo-host", f"{where}: transport {summary['transport']}")
    for alg, a in summary["algorithms"].items():
        at = f"{where} {alg}"
        if alg == "psum":
            check(summary["psum_rank_spread_rel"] <= DP_F32_LIMIT,
                  f"{at}: ranks differ by {summary['psum_rank_spread_rel']}")
        else:
            check(a["ranks_bit_identical"], f"{at}: ranks' parameters differ")
        for r in ranks:
            got = r["algorithms"][alg]["launches"]
            check(got == {k: v * spec.steps for k, v in per_step.items()},
                  f"{at}: rank {r['rank']} launches {got}, {per_step} a step")
            check(all(math.isfinite(x) for x in r["algorithms"][alg]["losses"]),
                  f"{at}: losses finite")
        errs = a["update_rel_err_vs_reference"]
        check(max(errs) < limit, f"{at}: update vs one process {errs} >= {limit}")
        check(a["max_rel_err_vs_psum"] <= DP_F32_LIMIT,
              f"{at}: first-step exchange vs dist.all_reduce "
              f"{a['max_rel_err_vs_psum']} > {DP_F32_LIMIT}")
    for fault, errs in summary.get("controls_update_rel_err", {}).items():
        check(min(errs) >= limit, f"{where}: faulty exchange {fault} passed the "
                                  f"update gate: {errs}")


# ------------------------------------------------------------- shard --
# The dry-run of qwen2.5-3b at full width on a 1 x 1 ("data", "model") mesh,
# with the H100 constants of launch.analysis: its roofline bound for the
# prefill phase's [2, 1024] and the lm_train phase's 8 x 128 AdamW step,
# each held to the device-busy time the profile and lm_train phases
# measured in this run (a bound above the measurement means the count is
# wrong). Then the [2, 1024] prefill through the DTensor route on the card,
# in one spawned rank of a world-1 NCCL group: logits against the
# unsharded prefill of the same weights under the bf16 contract, and
# 2 x layers + 1 rmsnorm and layers swa_attention launches on the local
# shards.
SHARD_MESH = mesh_module.AbstractMesh((1, 1), ("data", "model"))
SHARD_TIMEOUT_S = 300


def shard_rank(rank: int, init_method: str, out_dir: str) -> None:
    """The shard phase's rank: the prefill, unsharded and then through the
    DTensor route, from the same seeded weights; saves the readings."""
    mesh_module.init_data_group(rank, 1, init_method,
                                "nccl" if DEVICE == "cuda" else "gloo", DEVICE, SHARD_TIMEOUT_S)
    try:
        cfg = get_config(ARCH)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        b, s = PREFILL_SHAPE
        batch = {"tokens": torch.as_tensor(
            TokenStream(cfg.vocab_size, s, seed=5).batch(0, b)["tokens"], device=DEVICE)}
        window = decode_window(cfg, s)
        one = make_prefill(model, window=window, device=DEVICE)(params, batch)
        sh = mlayers.Sharder(mesh_module.device_mesh(SHARD_MESH))
        prefill = make_prefill(model, sh, window=window, device=DEVICE)
        sharded_params = steps_module.shard_tree(params, model.param_specs(), sh)
        prefill(sharded_params, {k: v[:, :64] for k, v in batch.items()})  # warm-up
        ops.reset_launch_counts()
        t0 = sync_time()
        logits = prefill(sharded_params, batch)
        seconds = sync_time() - t0
        counts = ops.launch_counts()
        local = logits.to_local()
        out = {"launches": counts, "seconds_prefill": seconds,
               "logits_type": type(logits).__name__,
               "placements": [str(p) for p in logits.placements],
               "shape": list(local.shape), "finite": bool(torch.isfinite(local).all()),
               "max_abs_diff_vs_unsharded": float((local - one).abs().max()),
               "rel_err_vs_plain": rel_err(local, one),
               "argmax_agree_vs_plain": float((local.argmax(-1) == one.argmax(-1))
                                              .float().mean())}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def shard_phase(smi: str, prefill_profile: dict, train_profile: dict) -> dict:
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    b, s = PREFILL_SHAPE
    shapes = {"prefill": (InputShape("chip_prefill", s, b, "prefill"), prefill_profile),
              "lm_train": (InputShape("chip_lm_train", LM["seq"], LM["batch"], "train"),
                           train_profile)}
    bounds = {}
    for name, (shape, prof) in shapes.items():
        t1 = time.perf_counter()
        rec = dryrun.dryrun_on(cfg, shape, SHARD_MESH, skip_costs=True)
        roof = rec["roofline"]
        busy = prof["device_busy_ms_per_call"]
        bound_ms = 1e3 * roof["bound_s"]
        bounds[name] = {
            "shape": [shape.global_batch, shape.seq_len], "kind": shape.kind,
            "flops": roof["flops_per_device"], "bytes": roof["bytes_per_device"],
            "collective_bytes": roof["collective_bytes_per_device"],
            "compute_ms": 1e3 * roof["compute_s"], "memory_ms": 1e3 * roof["memory_s"],
            "collective_ms": 1e3 * roof["collective_s"], "dominant": roof["dominant"],
            "bound_ms": bound_ms, "device_busy_ms": busy,
            "bound_share_of_busy": bound_ms / busy if busy else None,
            "model_flops": rec["model_flops"], "memory": rec["memory"],
            "kernel_calls": rec["kernel_calls"], "dryrun_seconds": time.perf_counter() - t1}
        print(f"shard: {cfg.name} {shape.kind} {bounds[name]['shape']}: roofline bound "
              f"{bound_ms:.3f} ms ({roof['dominant']}; compute "
              f"{bounds[name]['compute_ms']:.3f}, memory {bounds[name]['memory_ms']:.3f} ms, "
              f"H100 SXM5 datasheet constants) vs device busy {busy} ms measured: share "
              f"{bounds[name]['bound_share_of_busy']} [{smi}]", flush=True)
    t1 = time.perf_counter()
    (rank,) = dp.spawn(shard_rank, 1, (), SHARD_TIMEOUT_S)
    rank["seconds_rank"] = time.perf_counter() - t1
    out = {"card": smi, "mesh": "1x1", "bounds": bounds, "prefill": rank,
           "launches": {**rank["launches"]}, "seconds": time.perf_counter() - t0}
    print("shard phase: " + json.dumps(out), flush=True)
    for name, r in bounds.items():
        check(r["device_busy_ms"] is not None and r["bound_ms"] <= r["device_busy_ms"],
              f"shard: the {name} bound {r['bound_ms']} ms exceeds the measured device "
              f"busy time {r['device_busy_ms']} ms")
        check(r["kernel_calls"] == {"rmsnorm": 2 * cfg.n_layers + 1,
                                    "swa_attention": cfg.n_layers},
              f"shard: the {name} dry-run counted kernels {r['kernel_calls']}")
    check(rank["logits_type"] == "DTensor" and rank["finite"]
          and rank["shape"] == [b, s, cfg.vocab_size],
          f"shard: sharded prefill logits {rank['logits_type']} {rank['shape']}")
    check(contract(rank), f"shard: DTensor-route prefill vs unsharded: rel err "
          f"{rank['rel_err_vs_plain']}, argmax {rank['argmax_agree_vs_plain']}")
    check(rank["launches"] == {"rmsnorm": 2 * cfg.n_layers + 1,
                               "swa_attention": cfg.n_layers, "fused_sgd_update": 0},
          f"shard: DTensor-route prefill launches {rank['launches']}")
    return out


def dp_phase(smi: str) -> dict:
    t0 = time.perf_counter()
    out = {"label": DP_LABEL, "card": smi, "runs": {}}
    ranks = {}
    for spec, control_steps in ((DP, DP.steps), (DP_W3, None)):
        key = f"w{spec.world}"
        out["runs"][key], ranks[key] = dp_run(spec, control_steps)
        dp_report(f"dp {key}", out["runs"][key], smi)
    out["launches"] = dp_launches([r for rs in ranks.values() for r in rs])
    out["seconds"] = time.perf_counter() - t0
    print("dp phase: " + json.dumps(out), flush=True)
    for spec in (DP, DP_W3):
        key = f"w{spec.world}"
        dp_gates(f"dp w={spec.world}", spec, out["runs"][key], ranks[key],
                 {"rmsnorm": 0, "swa_attention": 0, "fused_sgd_update": 1},
                 DP_UPDATE_LIMIT)
    return out


def lm_dp_phase(smi: str) -> dict:
    t0 = time.perf_counter()
    spec = LM_DP
    n = spec.cfg.param_count()
    check(n == LM_DP_PARAMS, f"lm_dp: {n} parameters at {LM_DP_LAYERS} layers")
    summary, ranks = dp_run(spec, control_steps=1)
    summary["seconds"]["total"] = time.perf_counter() - t0
    out = {"label": DP_LABEL, "card": smi, "layers": LM_DP_LAYERS,
           "tokens_per_rank_step": spec.m_per_worker * spec.seq, **summary,
           "launches": dp_launches(ranks)}
    dp_report("lm_dp", summary, smi)
    print("lm_dp phase: " + json.dumps(out), flush=True)
    cfg = spec.cfg
    dp_gates("lm_dp", spec, summary, ranks,
             {"rmsnorm": 2 * cfg.n_layers + 1, "swa_attention": cfg.n_layers,
              "fused_sgd_update": 1}, LM_DP_UPDATE_LIMIT)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 lm_logits in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    seconds = build.build_all()
    print(f"build: {seconds:.1f} s for {', '.join(build.SOURCES)}", flush=True)
    for name in build.SOURCES:
        log = build.BUILD_DIR / f"{name}.log"
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    cfg = get_config(ARCH)
    n_resnet = pspec.n_params(build_model(resnet110.CONFIG).param_specs())
    kernels = kernel_phase(cfg, n_resnet)
    torch.cuda.empty_cache()  # the fused_sgd_update checks at the lm_dp length
    print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s", flush=True)

    model = build_model(cfg)
    t0 = sync_time()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    print(f"{ARCH}: {cfg.param_count() / 1e9:.3f} B parameters drawn in "
          f"{sync_time() - t0:.1f} s", flush=True)
    served = serve_phase(cfg, params)
    prefilled = prefill_phase(cfg, model, params)
    profiled = profile_phase(cfg, model, params)
    del model, params  # each later model's peak memory is its own
    torch.cuda.empty_cache()
    print(f"serving phases done at {time.perf_counter() - t_start:.1f} s", flush=True)
    moe = moe_serve_phase(smi)
    torch.cuda.empty_cache()
    print(f"moe_serve phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    vlm = vlm_phase(smi)
    torch.cuda.empty_cache()
    print(f"vlm phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    ssm = ssm_phase(smi)
    torch.cuda.empty_cache()
    print(f"ssm phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    hybrid = hybrid_phase(smi)
    torch.cuda.empty_cache()
    print(f"hybrid phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    audio = audio_phase(smi)
    torch.cuda.empty_cache()
    print(f"audio phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    trained = train_phase()
    print(f"train phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    sched = sched_phase(smi)
    print(f"sched phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    torch.cuda.empty_cache()  # the LM trainer needs most of the card
    lm_trained = lm_train_phase(smi)
    print(f"lm_train phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    torch.cuda.empty_cache()  # the sharded prefill's rank shares the card
    sharded = shard_phase(smi, profiled["prefill"], lm_trained["profile"])
    print(f"shard phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    torch.cuda.empty_cache()  # the dp ranks share the card
    data_parallel = dp_phase(smi)
    print(f"dp phase done at {time.perf_counter() - t_start:.1f} s", flush=True)
    w4 = next(r for r in sched["table1"] if r["w"] == DP.world)
    print(f"sched comm at w = {DP.world}: {w4['comm_ms_analytic_ib100g']:.3f} ms analytic "
          "(eqs. 2-4 at the paper's 100 Gbit/s InfiniBand); the dp phase's exchange, "
          "gloo over host loopback on one card (no fabric): " + ", ".join(
              f"{alg} {a['exchange_ms_median']} ms" for alg, a in
              data_parallel["runs"][f"w{DP.world}"]["algorithms"].items())
          + f" [{smi}]", flush=True)
    lm_dp = lm_dp_phase(smi)
    print(f"lm_dp phase done at {time.perf_counter() - t_start:.1f} s", flush=True)

    tpu = {"rmsnorm": "src/repro/kernels/rmsnorm.py:25",
           "swa_attention": "src/repro/kernels/swa_attention.py:81",
           "fused_sgd_update": "src/repro/kernels/fused_update.py:31"}
    entries = []
    for name in ("rmsnorm", "swa_attention"):
        k = kernels[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": tpu[name], "tpu_counterpart": f"{tpu[name]} {name}",
            "launches": (served["launches"][name] + prefilled["launches"][name]
                         + moe["launches"][name] + vlm["launches"][name]
                         + ssm["launches"][name] + hybrid["launches"][name]
                         + audio["launches"][name] + lm_trained["launches"][name]
                         + sharded["launches"][name] + lm_dp["launches"][name]),
            "launches_shard": sharded["launches"][name],  # the DTensor route's prefill
            "launches_per_decode_step": served["launches"][name] / served["decode_steps"],
            "launches_per_prefill": prefilled["launches"][name],
            "launches_per_moe_decode_step": (moe["serve"]["launches"][name]
                                             / moe["serve"]["decode_steps"]),
            "launches_per_moe_prefill": moe["prefill"]["launches"][name],
            "launches_per_vlm_prefill": vlm["prefill"]["launches"][name],
            "launches_per_vlm_decode_step": (vlm["serve"]["launches"][name]
                                             / vlm["serve"]["decode_steps"]),
            "launches_lm_train": lm_trained["launches"][name],
            "launches_per_lm_train_step": lm_trained["launches"][name] / lm_trained["steps"],
            "launches_per_hybrid_prefill": hybrid["prefill"]["bf16"]["launches"][name],
            "launches_per_audio_prefill": audio["prefill"]["launches"][name],
            "launches_per_audio_decode_step": audio["decode_launches_per_step"][name],
            "launches_lm_dp": lm_dp["launches"][name],  # all ranks, all algorithms
            "launches_per_lm_dp_rank_step": lm_dp["launches"][name] / (
                LM_DP.world * LM_DP.steps * len(LM_DP.algorithms)),
            **({"launches_per_ssm_decode_step": (ssm["serve"]["launches"][name]
                                                 / ssm["serve"]["decode_steps"]),
                "launches_per_ssm_prefill": ssm["prefill"]["bf16"]["launches"][name],
                "launches_ssm_train": {t: ssm["train"][t]["launches"][name]
                                       for t in ("f32_activations", "bf16")},
                "launches_grouped": {
                    "per_ssm_prefill": ssm["prefill"]["bf16"]["rmsnorm_grouped_launches"],
                    "per_hybrid_prefill": hybrid["prefill"]["bf16"]["rmsnorm_grouped_launches"],
                    "ssm_train": {t: ssm["train"][t]["launches"]["rmsnorm_grouped"]
                                  for t in ("f32_activations", "bf16")}},
                "launches_per_hybrid_decode_step": (hybrid["serve"]["launches"][name]
                                                    / hybrid["serve"]["decode_steps"]),
                "backward_grouped_max_abs_err": k["backward_grouped_max_abs_err"],
                "at_gnorm": k["gnorm"], "at_gnorm_f32": k["gnorm_f32"],
                "at_widths": k["widths"], "design": k["design"],
                "edge_routes": k["edge_routes"]} if name == "rmsnorm" else {}),
            "backward_max_abs_err": k["backward_max_abs_err"],
            "max_abs_err": k["max_abs_err"],
            **k["prefill"], "kernel_ms": k["prefill"]["ms"],  # the issue's name
            **({"at_decode": k["decode"]} if "decode" in k else {}),
            # the other dtype's route, and the design of each route timed
            # as the built library reports it
            **({"f32": k["prefill_f32"], "at_audio": k["audio"],
                "design": {str(dt).removeprefix("torch."):
                           swa_kernel.design(dt, cfg.d_head)
                           for dt in swa_kernel.KERNELS}}
               if name == "swa_attention" else {})})
    k = kernels["fused_sgd_update"]
    sgd_steps = sum(n for _, n in TRAIN_SEGMENTS)
    entries.append({
        "name": "fused_sgd_update", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_sgd_update.cu",
        "replaces": tpu["fused_sgd_update"],
        "tpu_counterpart": f"{tpu['fused_sgd_update']} fused_sgd_update",
        "launches": (trained["launches"]["fused_sgd_update"]
                     + sched["launches"]["fused_sgd_update"]
                     + data_parallel["launches"]["fused_sgd_update"]
                     + lm_dp["launches"]["fused_sgd_update"]),
        "launches_train": trained["launches"]["fused_sgd_update"],
        "launches_per_train_step": trained["launches"]["fused_sgd_update"] / sgd_steps,
        "launches_sched": sched["launches"]["fused_sgd_update"],
        "launches_per_sched_step": sched["launches"]["fused_sgd_update"] / sum(SCHED_STEPS),
        # all ranks, all algorithms
        "launches_dp": data_parallel["launches"]["fused_sgd_update"],
        "launches_per_dp_rank_step": data_parallel["launches"]["fused_sgd_update"] / sum(
            spec.world * spec.steps * len(spec.algorithms) for spec in (DP, DP_W3)),
        "launches_lm_dp": lm_dp["launches"]["fused_sgd_update"],
        "launches_per_lm_dp_rank_step": lm_dp["launches"]["fused_sgd_update"] / (
            LM_DP.world * LM_DP.steps * len(LM_DP.algorithms)),
        "max_abs_err": k["max_abs_err"], **k["train"], "kernel_ms": k["train"]["ms"],
        "at_lm_dp": k["lm_dp"]})
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} never launched on the main path")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
