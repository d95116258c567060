"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through their hand-written CUDA kernels and holds
each kernel against its plain PyTorch version on the card:

- the main path, `plan(N).execute(A).solve(b)` at N = 16384 in float32
  (kernels `lu_panel`, `fused_trsm_schur`), on the (strategy, v, backend)
  that the calibrated `auto` picks from the committed table, a v that the
  fused stream takes, N / v launches of each kernel;
- the calibrated `auto` (module item 9): the committed table is this card's,
  its picks at N = 1024, 4096 and 16384 (f32) and 16384 (bf16), each pick at
  N = 16384 against the analytic pick (sequential, v = 32, "cuda") and every
  other candidate v in turns, best of 7 rounds each, at most 1.25x the
  analytic wall (the calibration tool's guard, the JAX package's
  AUTOTUNE_TOLERANCE and round count), each plan's spread printed, with the
  predicted and measured walls and their residual; `profile_hotloop()` of the
  N = 16384 LU and Cholesky plans, each of their four kernels launched; and
  `python -m repro_torch.analysis.calibrate --smoke` into a temporary file;
- the batched path, `plan((256, 512)).execute(A).solve(b)` (kernels
  `lu_panel_batched`, `fused_trsm_schur_batched`);
- the serving tier on top of both: `SolveEngine(512)` and
  `AsyncSolveEngine(512)` answering ragged requests of 64..512;
- the SPD Cholesky paths: `plan(N, strategy="sequential_chol")` at
  N = 16384 (kernels `chol_panel`, `trsm_right_upper`, `schur_update`),
  `plan((256, 512), strategy="sequential_chol")` (their `_batched` forms),
  and both engines with `strategy="sequential_chol"` on ragged SPD requests;
- the distributed 2.5D schedules: `plan(N, strategy="conflux",
  grid=GridConfig(1, 1, 1, 32, N))` in-process at N = 16384 with both hot
  loops (the windowed one through `lu_panel`, `trsm_right_upper` and
  `fused_trsm_schur`, the flat one through `trsm_left_lower` and
  `schur_update` instead of the fused kernel), and eight ranks sharing the
  card through a gloo process group on a 2x2x2 grid: conflux, baseline2d and
  cholesky25d, both hot loops, every rank returning the same factors;
- mixed precision (ROADMAP.md module item 7): `plan(N, dtype="float64",
  compute_dtype="float32").execute(A).solve(b, refine_tol=1e-12)` beside
  the f64 kernels; the same N in f32 working over bf16 and f16 factors
  (the 2-byte entry points of `lu_panel` and `fused_trsm_schur`, each
  fused call in the body that `fused_schur.stream_mode` predicts: the
  `wgmma` stream on the paths' shapes, asserted there too), refined to
  1e-6; `plan((256, 512), compute_dtype=...)` with per-lane tolerances;
  the kernel path against the plain path at N = 128; both engines on a
  bf16 plan with half the requests refined;
- mixed precision on the Cholesky kernels and the 2.5D schedules: the bf16
  and f16 entry points of `chol_panel`, `trsm_right_upper`,
  `trsm_left_lower` and `schur_update` (single and batched) at the paths'
  shapes and their bodies' edges, each `schur_update` call in the body that
  `schur_update.stream_mode` predicts (the `wgmma` stream on the paths'
  shapes, asserted there too) and each `trsm_right_upper` call in the one
  that `trsm.right_mode` predicts (the warp's 16-byte loads, "wide", on the
  paths' shapes: every right solve of a 2-byte path is held to it);
  `plan(N, strategy="sequential_chol",
  compute_dtype=...)` in bf16 and f16 and `plan((256, 512), ...)` with
  per-lane tolerances, refined to 1e-6; the kernel path against the plain
  path at N = 128; both Cholesky engines on a bf16 plan; conflux (windowed
  and flat) and cholesky25d on a 1x1x1 grid at N in bf16 (cholesky25d flat
  in f16), refined; and bf16 conflux and cholesky25d on the eight gloo
  ranks at N = 2048, kernel path against plain path;
- the plan auditor (module item 11): `analysis.audit.run_audit` on the card,
  with every kernel instance's registers, shared memory and spills against
  Hopper's budgets, the twelve solver kernels at the audit's shapes in f32
  and bf16 against their plain versions (`trsm_left_lower_batched`'s only
  caller), the 2-byte accumulators, the cache keys and the in-core plans'
  collectives; and, in the eight-rank run, each rank's traced collective
  bytes against the port's executed model beside the schedule's volume and
  the X-partitioning lower bound;
- engines on the distributed strategies (module item 8): `SolveEngine` on
  conflux (N), cholesky25d (N, SPD) and baseline2d (4096) on 1x1x1 grids,
  each `solve` launching what one `plan(...).execute(A)` launches and
  answering its x bit for bit, then ragged requests through
  `flush_systems` and `AsyncSolveEngine` on the batched kernels alone;
  and, on the eight gloo ranks at N = 2048, engines on the default config,
  conflux, cholesky25d and baseline2d and an async one on conflux, every
  answer bit-identical across the ranks;
- the LM serving path at full width and depth, bf16, random weights from a
  seeded `torch.Generator` on the card: `ServeEngine` on qwen3-8b (36
  layers, kernel `flash_attention` once per layer of each prefill) and on
  falcon-mamba-7b (64 layers, kernel `mamba_scan` likewise), 2048-token
  prompts and 32 greedy tokens; and the first four groups of each with
  `backend="cuda"` against `backend="ref"`;
- the MoE archs at full width, depth cut to the card: qwen3-moe-235b-a22b
  (8 of 94 layers) and jamba-v0.1-52b (8 of 32: one period, whose prefill
  runs `flash_attention` once and `mamba_scan` seven times) served as
  above; and each in f32 (qwen3-moe at 4 layers, jamba at 8) on the kernel
  path against the plain path, logits within 2e-4 of max|logits|;
- training (module item 13's training part): `make_train_step` on
  qwen3-8b (4 layers, 2.016 B parameters, B = 2) and falcon-mamba-7b
  (4 layers, B = 1) at full width in bf16, AdamW, remat, S = 2048, six
  steps each, every loss and gradient norm finite, each mixer's kernel
  launched twice per layer a step (the forward and the remat recompute);
  two layers of each in f32, loss and every gradient on the kernel path
  against the plain path; crash and resume through `run_training` on
  reduced qwen3-8b and jamba-v0.1-52b, bit-identical to the run without
  the crash; `python -m repro_torch.launch.train` and `launch.serve
  --ckpt-dir` in subprocesses;
- training across ranks (item 13's rest): qwen3-8b at full width, 2
  layers, f32, S = 2048, global batch 2, three steps on one rank in this
  process, then the same steps data-parallel on two gloo ranks sharing the
  card (one card allows NCCL only at world size 1), every step's loss and
  gradient norm against the one-rank run and each gradient leaf of step 1
  against the rank's own one-device gradient; `compressed_psum` on the two
  ranks against its plain formula; the same steps on two gloo ranks with
  the training state sharded over "data" (fsdp, the JAX rules of the (2, 1)
  mesh), then tensor-parallel on the (1, 2) mesh (tp, kv: qwen3-8b and
  falcon-mamba-7b, 2 layers), then expert-parallel on (1, 2) (ep: one
  full-width qwen3-moe-235b-a22b layer, 64 experts a rank): losses and
  norms against the one-rank runs; step 2, the first at a non-zero
  learning rate, held through its update (the gradient the update
  receives and the moments after step 1 against one device's, the
  parameters after it against the port's AdamW of the ranks' own inputs;
  step 1's parameters bit-equal to the draw); the leaves whole along both
  axes bit-alike across the ranks; each rank's state bytes and each
  step's wire bytes against the dry run's count;
  `torchrun --nproc-per-node=1 -m repro_torch.launch.train` (an NCCL group
  of one);
- bf16 score buffers: `flash_attention(score_dtype=bf16)` (both bodies)
  against `ref.flash_attention(score_dtype=bf16)`, and qwen3-8b (4 layers)
  served and trained with `attn_score_dtype="bfloat16"` against f32 scores;
- llama4-maverick at full width, one group (a dense and a MoE layer),
  bf16, served as above;
- the dry-run tools (`repro_torch.launch.dryrun` on the meta device) for
  the qwen3-8b training configuration above: the predicted state bytes at
  most that phase's measured peak, no byte put on the card, the counted
  FLOPs over its step time; the sharded configurations on the (2, 1) and
  (1, 2) meshes (the predictions the sharded steps are held to); and the
  dry-run CLI for qwen3-8b and qwen3-moe-235b-a22b x train_4k on the 16x16
  mesh, sharded 16 ways along each axis (the experts too), with no card
  visible, in processes of their own beside the training phases: each
  rank must fit one card.

Before the paths, `lu_panel` and `lu_panel_batched` are held bit for bit at
the edges of their CUDA bodies, in f64 and on panels with NaN and infinite
entries, each call is checked to make one device record, and the conflux
tournament's [32, 32] panel is timed; `fused_trsm_schur` and its batched
form are held against their plain version at the edges of their CUDA body
(v = 1, 16, 31, 32, 33, 128; M = 1 and ragged; C = 1, 96, 300; items split
across blocks; an odd row stride, a window of a wider matrix, f64;
unit=False; zero rows of L10 and NaN / inf in L10 and A), batched lanes bit
for bit against the single call, with the mode (TMA stream or plain loads)
each case took.  Before the Cholesky paths,
`trsm_right_upper` and `schur_update` and their batched forms are held
against their plain versions at the edges of their bodies (v, R, K, ragged
shapes, strides that bulk copies cannot take, windows of a wider matrix,
f64, NaN and inf), batched lanes bit for bit against the single call.

Phases print JSON lines; any failure raises, so the exit code is not 0.  The
second-to-last line lists the kernels with their launches, errors and times
(`ms` of one call between CUDA events, `device_ms` from torch.profiler,
or from CUDA events where no profiler window came out whole, as the
`device_ms_windows` line counts, `host_ms` the difference, each beside its bound and its library call's);
the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

It needs a CUDA card and the repository's `src/` beside it, and builds the
kernels from `src/repro_torch/kernels/csrc/` at first use.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.analysis.roofline import H100_SXM  # noqa: E402

N = 16384
# Published H100 SXM rates (NVIDIA data sheet, at the full 700 W limit), from
# the port's roofline model, the one source of them.
HBM_BYTES_PER_S = H100_SXM.hbm_bw
FP32_FLOPS = H100_SXM.f32_flops
BF16_FLOPS = H100_SXM.peak_flops  # dense, tensor cores
# fused_trsm_schur against its plain version: the two sum the v-term
# contraction in different orders, each term rounding by up to eps_f32 =
# 6e-8 of its size, so v = 32 terms drift by ~2e-6 of the result's scale.
# Five times that is the bound.
FUSED_REL_TOL = 1e-5
# Kernel path against plain path over a whole factorization at N = 1024:
# each path's factors drift from the exact ones by up to about
# N * eps_f32 * max|F| (the plain path on the CPU against a float64
# factorization of a standard normal matrix: 1.2e-4 of max|F| at N = 1024),
# and the two paths round differently.  Twice the sum of the two drifts is
# the bound.
LU_F_TOL_FACTOR = 4.0
HPL_RESIDUAL_MAX = 16.0
# The batched path and the serving tier (module items 5 and 8).
BATCH, BATCH_N = 256, 512
PLAIN_BATCH, PLAIN_BATCH_N = 64, 256
SERVE_N, SERVE_REQUESTS, SERVE_MIN_N = 512, 384, 64
ASYNC_TENANTS, ASYNC_PER_TENANT, ASYNC_MAX_BATCH, ASYNC_DELAY_MS = 4, 64, 64, 2.0
# The Cholesky paths (module items 5, 6 and 8): the same shapes as the LU's,
# fewer serving requests.
CHOL = "sequential_chol"
CHOL_V = 32
CHOL_SERVE_REQUESTS, CHOL_ASYNC_PER_TENANT = 256, 32
# trsm_right_upper and schur_update against their plain versions: as for the
# fused kernel, a v-term sum in another order, so FUSED_REL_TOL of the
# result's scale.  chol_panel is held bit for bit.  The Cholesky factor of the
# kernel path against the plain path at N = 1024: each drifts from the exact
# factor by up to about N * eps_f32 * max|L|, so CHOL_L_TOL_FACTOR * N * eps *
# max|L| bounds their difference, as LU_F_TOL_FACTOR does for F.
CHOL_L_TOL_FACTOR = 4.0
# The calibrated `auto` (module item 9): its pick's execute against the
# analytic pick's and every other width's, in turns, best of the calibration
# tool's GUARD_ROUNDS (7, the JAX validation's) on a guarded row and of
# AUTO_ROUNDS on the reported f64 row; the limit is the tool's guard
# (`calibrate.AUTOTUNE_TOLERANCE`, the JAX package's).
AUTO_ROUNDS = 3
HOTLOOP_REPEATS = 3
# The LM serving path: qwen3-8b and falcon-mamba-7b at full width and depth
# in bf16, 2048-token prompts, 32 new tokens; the first four groups at
# S = 1024 for the kernel path against the plain path.
LM_SERVE = (("qwen3-8b", 4), ("falcon-mamba-7b", 2))
LM_PROMPT, LM_NEW = 2048, 32
LM_PLAIN_GROUPS, LM_PLAIN_S, LM_PLAIN_B, LM_PLAIN_NEW = 4, 1024, 2, 8
# The MoE archs (module item 13), full published widths in bf16, depth cut
# to fit one 80 GB card: (arch, batch, layers, phase suffix).  qwen3-moe's
# layer holds about 2.49 B parameters (its experts 2.42 B): 8 of its 94
# layers and the untied embed and head make about 42 GB.  jamba's 8 layers
# are one whole period of its pattern (1 attention, 7 mamba, 4 MoE layers;
# about 12.9 B parameters, 26 GB).  llama4 runs on the CPU tests only.
LM_SERVE_MOE = (("qwen3-moe-235b-a22b", 4, 8, "qwen3_moe"), ("jamba-v0.1-52b", 2, 8, "jamba"))
# Their kernel path against the plain path runs in f32, one model at a time
# (qwen3-moe at 4 layers, about 45 GB; jamba at one group, about 53 GB):
# in bf16 the paths' attention differs by 1.4-1.8% of the largest logit
# (the dense archs' bf16 lm_plain_check), enough to flip a top-8-of-128
# routing choice, whose neighbouring router probabilities lie about 0.06
# apart, and a flip changes a token's output discontinuously.  In f32 the two paths sum the
# same terms in other orders, so the CPU tests' f32 tolerance, 2e-4 of
# max|logits|, is the bound: (arch, layers).
LM_PLAIN_MOE = (("qwen3-moe-235b-a22b", 4), ("jamba-v0.1-52b", 8))
LM_MOE_LOGIT_REL_TOL = 2e-4
# flash_attention against its plain version (dense softmax): in f32 the two
# sum the same terms in other orders, so 2e-4 (rtol and atol), the CPU
# tests' f32 tolerance.  In bf16 2e-2, the tolerance of
# tests/test_kernels.py::_tol: the plain version rounds the scores to bf16
# where the kernel keeps them in f32 (0.4% of a score), and both round the
# output to bf16 once more.
FLASH_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# mamba_scan's y against the plain recurrence: each y_t sums N = 16 products
# in another order (each rounding by up to eps_f32 = 6e-8 of the largest),
# so 1e-5 of max|y| bounds it with a tenfold margin.  The final state rounds
# the same two operations per step as the plain version: held bit for bit.
MAMBA_Y_REL_TOL = 1e-5
# The four-group full-width models, kernel path against plain path, bf16:
# the paths round the attention scores (bf16 in the plain blocked path, f32
# in the kernel) and the attention outputs at other places, 0.4% per
# rounding, and each group carries such differences into the residual
# stream, where later products and norms spread them; over four groups they
# stay within a few percent of the largest logit.  5% of max|logits| is the
# bound.  The scan path rounds nothing differently before its bf16 output.
LM_LOGIT_REL_TOL = 5e-2
# The training phases (module item 13's training part): (arch, layers, batch,
# phase suffix) at full width in bf16, AdamW with f32 moments, remat, S =
# 2048 `copy` tokens, six steps (not `run_training`: its saves would write
# the whole state, about 24 GB for qwen3's four layers).  qwen3-8b's four
# layers hold 2.016 B parameters (embed and head 1.24 B), falcon-mamba-7b's
# about 0.95 B.
LM_TRAIN = (("qwen3-8b", 4, 2, "qwen3"), ("falcon-mamba-7b", 4, 1, "falcon_mamba"))
LM_TRAIN_S, LM_TRAIN_STEPS = 2048, 6
# qwen3-8b's loss rises over lm_train_qwen3's six steps at OptConfig's lr
# (3e-4).  The same steps again from the same seed and batches, in f32 at
# that lr and in bf16 at a tenth of it, say whether the rise follows the
# learning rate or the bf16 parameters: (dtype, lr).
LM_TRAIN_LOSS_STUDY = ((torch.float32, 3e-4), (torch.bfloat16, 3e-5))
# The kernel path's loss and gradients against the plain path's, two layers
# of each at full width in f32, B = 1, S = 1024.  Both differentiate the same
# formulation (blocked attention, the chunked scan) at inputs that differ
# only by the forwards' f32 rounding (the kernels sum in other orders), so
# the loss (about ln V = 12) agrees to a few f32 ulps: 1e-5 relative.  Each
# gradient leaf within 1e-3 of its max |g|.
LM_TRAIN_PLAIN_LAYERS, LM_TRAIN_PLAIN_S = 2, 1024
LM_TRAIN_LOSS_REL_TOL, LM_TRAIN_GRAD_REL_TOL = 1e-5, 1e-3
# Crash and resume on the card: reduced configs (f32, hd = 16), B = 4,
# S = 16, 12 steps, checkpoints every 4, a failure before step 6.
LM_RESUME = ("qwen3-8b", "jamba-v0.1-52b")
LM_RESUME_B, LM_RESUME_S, LM_RESUME_STEPS, LM_RESUME_FAIL_AT = 4, 16, 12, 6
# Training across ranks (item 13's rest): qwen3-8b at full width, LM_DP's
# layers, f32, S = 2048, a global batch of 2, LM_DP_STEPS steps on one rank
# and then on LM_DP_RANKS gloo ranks on cuda:0, each rank one row.  Two
# layers hold 1.63 B parameters: 6.5 GB each of weights, gradients, m and v,
# and a gradient's clipped copy, about 33 GB a rank at its peak.  Both runs
# compute the same function and sum the same terms in other orders (f32:
# cuBLAS may tile a batch of 1 and of 2 differently; the all-reduce adds the
# ranks' sums), so each step's loss and gradient norm within 2e-4 relative
# (the CPU tests' step tolerance), each gradient leaf of step 1 within 1e-4
# of its max |g| (f32 sums of ~4096-term products: 1e-6 expected).
LM_DP = ("qwen3-8b", 2, 2)  # (arch, layers, global batch)
LM_DP_S, LM_DP_STEPS, LM_DP_RANKS = 2048, 3, 2
LM_DP_STEP_RTOL, LM_DP_GRAD_REL = 2e-4, 1e-4
LM_DP_TIMEOUT_S = 420  # both ranks together, from spawn to exit
# The same model, batches and steps on LM_DP_RANKS gloo ranks with the state
# sharded over "data" (`init_train_state(rules=make_rules(mesh))`: fsdp ->
# "data" on the (2, 1) mesh).  Each step's loss and gradient norm within
# LM_DP_STEP_RTOL of the one-rank run's (lm_train_dp's); step 2 held through
# its update (F8, below); each rank's state bytes (parameters and moments,
# counted from its tensors) equal the dry run's prediction for the (2, 1)
# mesh exactly, as do its wire bytes a step.
COMPRESS_N, COMPRESS_BITS = 1 << 24, (8, 4)  # compressed_psum's tensor, its bit widths
# F8 (ROADMAP §3): step 1 runs at lr 0 (warmup_steps = 2) and leaves every
# parameter as drawn, so each phase that trains across ranks holds step 2, the
# first at a non-zero lr, through the update itself, leaf by leaf of the JAX
# tree, with the CPU tests' bounds (tests/multidev/torch_training_common.py):
# - the gradient the update receives at step 2 (after the clip), gathered
#   whole, within F8_GRAD_REL of the leaf's max |g| + F8_GRAD_ABS of the
#   one-device run's, read the same way;
# - the AdamW moments after step 1, gathered whole, within the same bound of
#   the one-device run's, v at twice the relative bound (a moment block that
#   does not lie under its parameter's block fails here, and the update
#   check cannot see it);
# - the parameters after step 2, gathered whole, within F8_UPDATE_ABS
#   (absolute: an element moves by about lr) of the port's AdamW applied on
#   one device to the ranks' gathered parameters, moments and clipped
#   gradient before it.
# Step 1's gathered parameters are bit-equal to the drawn ones (sha256 of
# each leaf against the one-device run's after its step 1):
# `step1_layout_params_exact`.  Step 2's gathered parameters against the
# one-device run's step 2 are reported, not held: a norm scale drawn as zeros
# is about lr after it, so an f32 summation order moves an element by a
# large share of the leaf's max.  The gradients are read through a stand-in
# for `train_step.adamw_update` patched in before a step is built
# (`_UpdateSpy`).  Whole leaves travel to rank 0's host (gloo send / recv of
# each distinct block), where the copies the checks need live; the AdamW
# runs on the card in flat chunks of F8_CHUNK elements.
F8_GRAD_REL, F8_GRAD_ABS, F8_UPDATE_ABS = 2e-4, 1e-7, 1e-6
F8_CHUNK = 1 << 26
# Tensor parallelism (tp, kv -> "model", Megatron) on LM_DP_RANKS gloo ranks
# on cuda:0, the (1, 2) ("data", "model") mesh: (arch, layers, global batch,
# steps, phase suffix, held to lm_train_dp's one-rank run), full width, f32,
# S = LM_DP_S.  qwen3-8b's 32 heads and 8 KV heads both split 2 ways (a
# rank's flash launch: [2, 2048, 16, 128] against 4 KV heads); falcon-mamba's
# d_inner splits 2 ways (a rank's scan: [1, 2048, 4096, 16]).  qwen3 is
# lm_train_dp's configuration and is held to its one-rank run; falcon-mamba
# to rank 0's own one-device run before the ranks'.  Each step's loss and
# gradient norm within LM_DP_STEP_RTOL; step 2 held through its update (F8);
# the leaves and moments whole along both axes bit-alike across the ranks
# after each step; qwen3's state bytes and wire bytes a step as dryrun_tp
# counts them, exactly.
LM_TP = (("qwen3-8b", 2, 2, 3, "qwen3", True), ("falcon-mamba-7b", 2, 1, 2, "falcon_mamba", False))
LM_TP_MESH = (1, 2)
# Expert parallelism (ep -> "model") on LM_DP_RANKS gloo ranks on cuda:0, the
# (1, 2) mesh: qwen3-moe-235b-a22b at full width, its first layer (one
# (attn, moe) group), f32, global batch 1, S = LM_DP_S, 3 steps, held to rank
# 0's own one-device run before the ranks'.  A rank holds 64 of the 128
# experts; its flash launch is [1, 2048, 32, 128] against 2 KV heads; its
# expert products [64, 160, 4096] @ [64, 4096, 3072] and [64, 160, 1536] @
# [64, 1536, 4096] (G = 16 dispatch groups, cap = 10).  The same checks as
# LM_TP's, the state and wire bytes against dryrun_ep.  The one-device run
# holds the whole model's f32 state and gradients (3.73 G parameters) on the
# card and frees it before the ranks start.
LM_EP = ("qwen3-moe-235b-a22b", 1, 1, 3, "qwen3_moe")  # arch, layers, batch, steps, suffix
# lm_train_fsdp's and lm_train_tp's configurations run on one pair of ranks
# (`lm_train_sharded`), which start and warm up once; lm_train_ep's on a pair
# of its own, since a process keeps the pinned host blocks it frees and the
# EP references take most of the host's memory.
LM_SHARDED_TIMEOUT_S = 900  # both ranks together, from spawn to exit
# Serving on a sharded state (`prefill`, `decode_step`, `ServeEngine` on the
# rank's blocks) on the pair of ranks of lm_train_fsdp and lm_train_tp, after
# them (the pair's first all-reduce, ~11 s, is paid once): (phase suffix,
# arch, layers, ("data", "model") mesh, global batch, new tokens), full width,
# f32, seeded LM_DP_S-token prompts.  qwen3-8b on (1, 2) (16 heads a rank;
# of the attention caches every KV head on its half of the sequence, JAX's
# cache_specs block) and on (2, 1) (one row a rank, every weight gathered along
# "data" at each call: ~6.5 GB through the host a call, so 2 new tokens),
# falcon-mamba-7b on (1, 2) (4096 channels a rank) and qwen3-moe-235b-a22b's
# first layer on (1, 2) (64 of 128 experts and 32 heads a rank).  Rank 0
# first serves the same drawn parameters on one device (greedy); the ranks'
# decode steps are fed its tokens (teacher-forced), so that a near-tie
# cannot end the comparison, and each rank's own greedy picks are kept.
# Held: the prefill's and every step's logits within LM_SERVE_SHARDED_REL of
# max|logit| of the one-device run's (the LM phases' f32 tolerance); every
# rank's picks and logits bits alike; each rank's parameter and cache bytes
# and the wire bytes of the prefill and of each decode step, by axis and
# kind, equal to dryrun_serve's count exactly, its cache bytes JAX's
# per-device share and its block of the sequence dryrun_serve's shifted by
# its place along "model"; flash_attention once per
# attention layer and mamba_scan once per mamba layer of the prefill, 0 in
# the decode steps.
LM_SERVE_SHARDED = (("tp_qwen3", "qwen3-8b", 2, (1, 2), 2, 8),
                    ("fsdp_qwen3", "qwen3-8b", 2, (2, 1), 2, 2),
                    ("tp_falcon_mamba", "falcon-mamba-7b", 2, (1, 2), 2, 8),
                    ("ep_qwen3_moe", "qwen3-moe-235b-a22b", 1, (1, 2), 1, 8))
LM_SERVE_SHARDED_REL = 2e-4
# bf16 score buffers: flash_attention(score_dtype=bf16) against
# ref.flash_attention(score_dtype=bf16) at qwen3-8b's prefill shape, the
# bf16-score model's (B = 2), and in f32 (the f32 body) at the DP shape and
# lm_train_resume's reduced one.  Three bounds, each case:
# - within FLASH_TOL of bf16 (the scores' dtype's: the kernel rounds s - m
#   against its running max, the plain version against the row's max, each
#   within a bf16 ulp, 0.4%, of a score, for f32 inputs too);
# - the flag is seen: the bf16-score kernel's max and mean error against that
#   reference at most SCORE_FRAC of the f32-score kernel's against the same
#   reference, in the same run.  A kernel that ignored the flag would score
#   1 on both; the kernel read 0.22-0.29 at the 2048-token shapes (the
#   rounding points agree, the maxima they round against need not) and 0
#   at the reduced one;
# - f32 inputs: within SCORE_F32_BODY_TOL (atol and rtol), twice the f32
#   body's 2.0e-3 at the DP shape (the reduced shape read 0.0), below the
#   f32-score kernel's 5.3e-3 and 1.8e-2 there.
# qwen3-8b's first LM_SCORE_LAYERS layers served and trained LM_SCORE_STEPS
# steps with bf16 scores against f32 scores (same weights): prefill logits
# within LM_LOGIT_REL_TOL of max|logits| of the f32-score run's and of the
# plain path's (backend "ref", blocked attention in bf16 scores), the same
# kernel launches.
LM_SCORE_CASES = ((4, LM_PROMPT, 32, 8, 128, torch.bfloat16), (2, LM_PROMPT, 32, 8, 128,
                  torch.bfloat16), (1, LM_PROMPT, 32, 8, 128, torch.float32),
                  (LM_RESUME_B, LM_RESUME_S, 4, 2, 16, torch.float32))
SCORE_FRAC, SCORE_F32_BODY_TOL = 0.5, 4e-3
LM_SCORE_LAYERS, LM_SCORE_B, LM_SCORE_STEPS = 4, 2, 2
# llama4-maverick at full width in bf16, one group (a dense and a MoE layer,
# ~37 GB; its 128 experts alone 32.2 GB, all read by every decode step):
# (arch, batch, layers, phase suffix).
LM_SERVE_LLAMA4 = ("llama4-maverick-400b-a17b", 1, 2, "llama4")


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line of a phase's readings, with the host seconds since the
    script started (`at_s`: where the run's time goes)."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - _START}),
          flush=True)


def time_ms(fn, reps: int = 7) -> float:
    """Median device time of one call, from CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


DEVICE_CALLS = 20  # calls under the profiler for `device_ms`


MARK_KERNEL = "spin_kernel"  # what torch.cuda._sleep launches
PROFILE_HEAD, PROFILE_TAIL = 512, 8  # sleep kernels before and after a window's calls
# Profiler windows: how many were profiled, how many were profiled again
# (their head or tail not whole, or no record of the calls), the most one
# window lost of its head, the most windows one measurement needed, and the
# `device_ms` calls timed with CUDA events because no window came out whole.
WINDOWS = {"calls": 0, "profiled": 0, "rejected": 0, "head_lost_max": 0,
           "most_in_one_call": 0, "event_timed": 0}


def profiled(run, activities=None, tries: int = 5):
    """The device records (kernels, copies, fills) of one call of `run`
    under torch.profiler, in the order they started, with `run`'s host
    seconds and a flag: whether a window came out whole.

    The profiler on the card drops the first records of a window, more of
    them the longer the card has been busy (so late in a long run all of a
    short window's records), and now and then its last records or all of
    them.  So a head of PROFILE_HEAD short sleep
    kernels comes before `run` and a tail of PROFILE_TAIL after it, both left
    out of the records, and a window counts as whole only where some of the
    head and all of the tail were kept, which leaves every record of `run`
    in it.  A window that is not whole is profiled again, with twice the
    head where it lost all of it, up to `tries` windows; then the last
    window's records are returned with the flag false."""
    from torch.profiler import ProfilerActivity, profile

    activities = activities or [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    head = PROFILE_HEAD
    for window in range(1, tries + 1):
        WINDOWS["profiled"] += 1
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(head):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            for _ in range(PROFILE_TAIL):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
        body = [i for i, ev in enumerate(evs) if MARK_KERNEL not in ev.name]
        records = [evs[i] for i in body]
        head_kept = body[0] if body else 0
        tail_kept = len(evs) - 1 - body[-1] if body else 0
        WINDOWS["head_lost_max"] = max(WINDOWS["head_lost_max"], head - head_kept)
        WINDOWS["most_in_one_call"] = max(WINDOWS["most_in_one_call"], window)
        if body and head_kept > 0 and tail_kept == PROFILE_TAIL:
            return records, seconds, True
        WINDOWS["rejected"] += 1
        if head_kept == 0:
            head *= 2
    return records, seconds, False


def device_ms(fn, calls: int = DEVICE_CALLS) -> float:
    """Device time of one call: the device's records (kernels, copies,
    fills) of `calls` calls in a whole window of `profiled`, summed by name
    as the median duration of a record times the records one call makes
    (one slow record would move a mean).  With `time_ms` (one call between
    CUDA events, so the host's time to reach the launch as well),
    `ms - device_ms` is the host's share of a call.  Where no window came
    out whole, the call is timed with CUDA events instead (`time_ms`) and
    counted in WINDOWS["event_timed"]."""
    from collections import defaultdict
    from statistics import median

    fn()
    WINDOWS["calls"] += 1
    records, _, whole = profiled(lambda: [fn() for _ in range(calls)])
    if not whole:
        WINDOWS["event_timed"] += 1
        return time_ms(fn)
    us = defaultdict(list)
    for ev in records:
        us[ev.name].append(ev.time_range.elapsed_us())
    return sum(median(t) * max(1, round(len(t) / calls)) for t in us.values()) / 1e3


def device_fields(kernel, library=None) -> dict:
    """A kernels-line row's `device_ms`, and its library call's
    `library_device_ms` (None where no single call computes the function)."""
    return {"device_ms": device_ms(kernel),
            "library_device_ms": None if library is None else device_ms(library)}


def hpl_residuals(A, x, b) -> torch.Tensor:
    """HPL's scaled residual ||Ax - b||_inf / (eps (||A||_inf ||x||_inf + ||b||_inf) N)
    of each system: A [..., N, N], x and b [..., N]."""
    A64, x64, b64 = A.double(), x.double(), b.double()
    r = ((A64 @ x64[..., None])[..., 0] - b64).abs().amax(-1)
    norm_a = A64.abs().sum(dim=-1).amax(-1)
    eps = torch.finfo(A.dtype).eps
    scale = eps * (norm_a * x64.abs().amax(-1) + b64.abs().amax(-1)) * A.shape[-1]
    return r / scale


def hpl_residual(A, x, b) -> float:
    """The largest HPL scaled residual over the systems of A."""
    return float(hpl_residuals(A, x, b).max())


# Name prefixes of the port's kernels in csrc/, as the profiler names them.
PORT_KERNELS = ("lu_panel_", "fused_trsm_schur_", "chol_panel_", "trsm_", "schur_update_",
                "flash_fwd_", "mamba_scan_")


KERNEL_CLASSES = (  # (class, lower-case name fragments), first match wins
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "sm90_", "sm80_")),
    ("sort", ("sort", "radix", "scan_by_key")),
    ("gather_scatter_index", ("gather", "scatter", "index", "take")),
    ("reduce", ("reduce",)),
    ("copy_fill", ("copy", "memcpy", "memset", "fill", "cat_")),
)


def kernel_class(name: str) -> str:
    """A device record's class for the profiles' breakdown: "port" for the
    port's kernels, a library class by its name, else "elementwise"."""
    if name.startswith(PORT_KERNELS):
        return "port"
    low = name.lower()
    return next((c for c, parts in KERNEL_CLASSES if any(p in low for p in parts)),
                "elementwise")


def profile_once(fn, tries: int = 3) -> dict:
    """Wall time, device busy time, idle share, top kernels and every kernel
    of the port of one call under torch.profiler (a window of `profiled`;
    `window_whole` false where none came out whole in `tries`)."""
    records, seconds, whole = profiled(fn, tries=tries)
    wall_ms = 1e3 * seconds
    by_kernel: dict[str, list] = {}
    for ev in records:
        name = ev.name.removeprefix("void ").replace("(anonymous namespace)::", "")
        name = name.split("(")[0][:60]
        entry = by_kernel.setdefault(name, [0.0, 0])
        entry[0] += ev.time_range.elapsed_us() / 1e3
        entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    classes: dict[str, list] = {}
    for k, (ms, n) in by_kernel.items():
        entry = classes.setdefault(kernel_class(k), [0.0, 0])
        entry[0] += ms
        entry[1] += n
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "window_whole": whole,
            "top": [{"kernel": k, "ms": ms, "count": n} for k, (ms, n) in top],
            "classes": {c: {"ms": ms, "count": n} for c, (ms, n) in
                        sorted(classes.items(), key=lambda kv: -kv[1][0])},
            "port_kernels": [{"kernel": k, "ms": ms, "count": n}
                             for k, (ms, n) in by_kernel.items() if k.startswith(PORT_KERNELS)]}


def bound(nbytes: float, nops: float, flops: float = FP32_FLOPS) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the rate for their type (f32 unless given), whichever is
    larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / flops
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def panel_ops(R: int, v: int, n_active: int) -> int:
    """Operations of one masked panel LUP with n_active rows of weight 1: per
    round the R candidate products, then a division and v-k-1 products and
    differences on each row still active."""
    return sum(R + max(n_active - k - 1, 0) * (1 + 2 * (v - k - 1)) for k in range(v))


def _wrappers() -> dict:
    from repro_torch.kernels import (chol_panel, flash_attention, fused_schur, lu_panel,
                                     mamba_scan, schur_update, trsm)

    return {"lu_panel": lu_panel.lu_panel, "fused_trsm_schur": fused_schur.fused_trsm_schur,
            "lu_panel_batched": lu_panel.lu_panel_batched,
            "fused_trsm_schur_batched": fused_schur.fused_trsm_schur_batched,
            "chol_panel": chol_panel.chol_panel,
            "trsm_right_upper": trsm.trsm_right_upper,
            "schur_update": schur_update.schur_update,
            "chol_panel_batched": chol_panel.chol_panel_batched,
            "trsm_right_upper_batched": trsm.trsm_right_upper_batched,
            "schur_update_batched": schur_update.schur_update_batched,
            "trsm_left_lower": trsm.trsm_left_lower,
            "trsm_left_lower_batched": trsm.trsm_left_lower_batched,
            "flash_attention": flash_attention.flash_attention,
            "mamba_scan": mamba_scan.mamba_scan}


def v32(**fields):
    """The config of the phases that hold the kernel path against the plain
    path or count launches at v = 32: sequential at v = 32, pinned, since
    the calibrated `auto` picks v and the backend."""
    from repro_torch.api import SolverConfig

    return SolverConfig(strategy="sequential", v=32, **fields)


def expected_launches(**counts) -> dict:
    """Every kernel's count for a path: the given ones, 0 for the others."""
    return {name: counts.get(name, 0) for name in _wrappers()}


def reset_launches() -> None:
    """Set every kernel's launch count to 0 (just before a path is driven)."""
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


@contextlib.contextmanager
def right_modes():
    """While active, count the body (`.mode`) that each CUDA call of
    trsm_right_upper[_batched] takes, by mode, through `ops`, which the
    "cuda" backend calls.  The wrappers and their launch counts are
    untouched."""
    from collections import Counter

    from repro_torch.kernels import ops

    seen = Counter()
    saved = {name: getattr(ops, name) for name in ("trsm_right_upper", "trsm_right_upper_batched")}

    def recording(fn):
        def call(B, U):
            X = fn(B, U)
            if B.device.type == "cuda":
                seen[fn.mode] += 1
            return X
        return call

    for name, fn in saved.items():
        setattr(ops, name, recording(fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def device_record_names(fn, calls: int = DEVICE_CALLS, tries: int = 8) -> dict:
    """The device records (kernels, copies, fills) of `calls` calls in a
    whole window of `profiled`, counted by name ({} where no window of
    `tries` came out whole)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity

    fn()
    records, _, whole = profiled(lambda: [fn() for _ in range(calls)],
                                 [ProfilerActivity.CUDA], tries)
    return dict(Counter(ev.name for ev in records)) if whole else {}


def special_panel(case: str, panel: torch.Tensor, weights: torch.Tensor):
    """A copy of (panel [..., R, v], weights [..., R]) with NaN or infinite
    entries, or a tie between the first and the last row, in every lane.  The
    plain version lets a NaN candidate |F[i, k]| * w[i] win at the lowest
    index (inf * 0 = NaN for a row of weight 0) and spreads a non-finite
    pivot row to every row, weight 0 or not."""
    P, W = panel.clone(), weights.clone()
    R, v = P.shape[-2:]
    if case == "nan_two_rows":
        P[..., [7 % R, R // 2], 0] = float("nan")
    elif case == "inf_weight0_row":
        W[..., 10 % R] = 0
        P[..., 10 % R, 0] = float("inf")
    elif case == "nan_column":
        P[..., :, 0] = float("nan")
    elif case == "inf_later_column":
        W[..., 3 % R] = 0
        P[..., 3 % R, min(2, v - 1)] = float("-inf")
        P[..., 5 % R, v - 1] = float("inf")
    elif case == "tie_first_last":
        W[...] = 1
        P[..., :, 0] *= 0.1
        P[..., 0, 0] = -1e3
        P[..., R - 1, 0] = 1e3
    return P, W


LU_PANEL_SPECIAL = ("nan_two_rows", "inf_weight0_row", "nan_column", "inf_later_column",
                    "tie_first_last")
# lu_panel's bodies and the shapes that reach each: the one-block register
# body (R <= 256 rows in f32 with a row a thread, <= 1024 with two; 128 and
# 512 in f64), the grid register body (1, 2 or 4 rows a thread, up to
# 132 * 1024 rows in f32), the generic bodies (v > 32, or more rows).
LU_PANEL_EDGES = ((1, 32, torch.float32), (31, 32, torch.float32), (32, 32, torch.float32),
                  (1000, 32, torch.float32), (1025, 32, torch.float32),
                  (40000, 32, torch.float32), (100000, 32, torch.float32),
                  (200000, 32, torch.float32), (16384, 32, torch.float64),
                  (600, 32, torch.float64), (16384, 1, torch.float32),
                  (16384, 7, torch.float32), (4096, 33, torch.float32),
                  (2048, 128, torch.float32))


def lu_panel_check(got, want, panel, weights) -> dict:
    """F bit for bit (NaN at the same places), order and ok equal; on a
    finite panel also the rows of weight 0 unchanged."""
    F, order, ok = got
    check = {"order_equal": torch.equal(order, want[1]), "ok_equal": torch.equal(ok, want[2]),
             "F_bit_identical": same_bits(F, want[0])}
    if bool(torch.isfinite(panel).all()):
        masked = weights == 0
        check["masked_rows_untouched"] = same_bits(F[masked], panel[masked])
    return check


def lu_panel_edges(dev, gen, panel, weights) -> dict:
    """lu_panel at the edges of its bodies and on NaN / inf panels, bit for
    bit against the plain version; the conflux tournament's [32, 32] panel
    timed; the records of a call at the main path's inputs (one kernel, no
    copy or fill); torch.linalg.lu_factor_ex on the main path's panel as a
    yardstick.  Returns fields for the kernels line's lu_panel row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lu_panel import lu_panel

    failed = []
    for R, v, dt in LU_PANEL_EDGES:
        X = torch.randn(R, 3 * v, generator=gen, device=dev, dtype=dt)
        P = X[:, v:2 * v]
        W = (torch.rand(R, generator=gen, device=dev) > 0.1).to(dt)
        check = lu_panel_check(lu_panel(P, W), ref.lu_panel(P, W), P, W)
        emit("kernel_lu_panel_edge", shape=[R, v], dtype=str(dt), **check)
        if not all(check.values()):
            failed.append(([R, v], str(dt), check))
        del X, P, W
    for R, v in ((N, 32), (32, 32), (512, 32), (64, 8), (4096, 33)):
        X = torch.randn(R, 3 * v, generator=gen, device=dev)
        W0 = (torch.rand(R, generator=gen, device=dev) > 0.1).float()
        for case in LU_PANEL_SPECIAL:
            P, W = special_panel(case, X[:, v:2 * v], W0)
            got = lu_panel(P, W)
            check = lu_panel_check(got, ref.lu_panel(P, W), P, W)
            emit("kernel_lu_panel_special", case=case, shape=[R, v],
                 order_head=got[1][:4].tolist(), **check)
            if not all(check.values()):
                failed.append(([R, v], case, check))
    if failed:
        raise AssertionError(f"lu_panel disagrees with its plain version: {failed}")

    # The tournament's panel: the v winners, all of weight 1.
    P32 = torch.randn(32, 32, generator=gen, device=dev)
    W32 = torch.ones(32, device=dev)
    tournament = {"shape": [32, 32], "ms": time_ms(lambda: lu_panel(P32, W32)),
                  "device_ms": device_ms(lambda: lu_panel(P32, W32)),
                  "plain_ms": time_ms(lambda: ref.lu_panel(P32, W32), reps=3),
                  **bound(4 * (2 * 32 * 32 + 32) + 5 * 32, panel_ops(32, 32, 32))}
    emit("kernel_lu_panel_tournament", **tournament)

    # One launch per call: every device record of calls at the main path's
    # inputs (a column slice of an [N, N] matrix, its f32 weights) and at the
    # tournament's is a lu_panel kernel.
    records = {"path": device_record_names(lambda: lu_panel(panel, weights)),
               "tournament": device_record_names(lambda: lu_panel(P32, W32))}
    emit("lu_panel_records_per_call", calls=DEVICE_CALLS, records=records)
    for name, counts in records.items():
        if not counts or any("lu_panel" not in k for k in counts) or \
                sum(counts.values()) > DEVICE_CALLS:
            raise AssertionError(f"lu_panel at the {name} shape made other device records "
                                 f"than one kernel a call: {counts}")

    # A yardstick, not the same function: LU with partial pivoting and row
    # swaps of the main path's panel with every weight 1.
    A = panel.contiguous()
    try:
        torch.linalg.lu_factor_ex(A)
        yardstick = {"call": "torch.linalg.lu_factor_ex(panel), all weights 1: row swaps, "
                             "not the masked LUP", "shape": list(A.shape),
                     "ms": time_ms(lambda: torch.linalg.lu_factor_ex(A)),
                     "device_ms": device_ms(lambda: torch.linalg.lu_factor_ex(A))}
    except RuntimeError as e:
        yardstick = {"call": "torch.linalg.lu_factor_ex(panel)", "refused": str(e)[:200]}
    emit("yardstick_lu_factor_ex", **yardstick)
    return {"tournament": tournament, "records_per_call": records, "yardstick": yardstick}


def fused_inputs(lead: tuple, M: int, C: int, v: int, unit: bool, dt, kind, gen, dev):
    """Operands of fused_trsm_schur[_batched] for one case of its edges.

    `kind`: "odd_lda", A with an odd row stride (the kernel's plain loads);
    "window", A a window of a wider matrix as the conflux step passes it (row
    stride > C, base 32 rows and 64 columns in); "special", R01 zero before
    C // 3 and L10's top quarter of rows zero, as the LU paths pass them,
    with NaN and inf in A, an infinite entry in an active row of L10 and NaN
    in a zero row (a row of weight 0 whose panel entry was infinite)."""
    if kind == "odd_lda":
        A = torch.randn(*lead, M, C + 1, generator=gen, device=dev, dtype=dt)[..., :C]
    elif kind == "window":
        A = torch.randn(*lead, M + 32, C + 64, generator=gen, device=dev,
                        dtype=dt)[..., 32:, 64:]
    else:
        A = torch.randn(*lead, M, C, generator=gen, device=dev, dtype=dt)
    L00 = (0.3 * torch.tril(torch.randn(*lead, v, v, generator=gen, device=dev, dtype=dt), -1)
           + (1.0 if unit else 2.0) * torch.eye(v, device=dev, dtype=dt))
    R01 = torch.randn(*lead, v, C, generator=gen, device=dev, dtype=dt)
    L10 = torch.randn(*lead, M, v, generator=gen, device=dev, dtype=dt)
    if kind == "special":
        R01[..., :C // 3] = 0.0
        L10[..., :M // 4, :] = 0.0
        L10[..., 1, v - 1] = float("nan")
        L10[..., M // 2, v // 2] = float("inf")
        A[..., 5, 7] = float("nan")
        A[..., 9, 100] = float("-inf")
    return A, L00, R01, L10


def fused_check(out_k, U_k, out_p, U_p) -> tuple[float, float, dict]:
    """(max error over the entries finite in the plain version, their
    scale, checks): within FUSED_REL_TOL of the scale, NaN and inf at the
    plain version's places."""
    finite = torch.isfinite(out_p)
    err = max(float((out_k - out_p)[finite].abs().max()), float((U_k - U_p).abs().max()))
    scale = max(float(out_p[finite].abs().max()), float(U_p.abs().max()))
    return err, scale, {"within_tol": err <= FUSED_REL_TOL * scale,
                        "nan_as_plain": torch.equal(out_k.isnan(), out_p.isnan()),
                        "inf_as_plain": torch.equal(out_k.isinf(), out_p.isinf())}


def batched_kernel_rows(dev, gen) -> list[dict]:
    """Each batched kernel against its plain version, and lanes against the
    single-system kernel, at the batched path's shapes and beyond."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lu_panel import lu_panel, lu_panel_batched

    rows = []
    # lu_panel_batched: the path's shape; the over-budget branch (panel kept
    # in device memory); f64; the edges of the one-block register body (two
    # rows a thread, R < 32, R = 1) and the generic one (v = 128); then the
    # path's shape with a special panel in each of five lanes.  Strided
    # panels, as the path passes them.
    shapes = [(BATCH, BATCH_N, 32, torch.float32, None), (4, 8192, 32, torch.float32, None),
              (64, BATCH_N, 32, torch.float64, None), (8, 1024, 32, torch.float32, None),
              (8, 31, 32, torch.float32, None), (5, 1, 32, torch.float32, None),
              (3, 100, 128, torch.float32, None), (BATCH, BATCH_N, 32, torch.float32, "special")]
    for B, R, v, dt, special in shapes:
        X = torch.randn(B, R, 3 * v, generator=gen, device=dev, dtype=dt)
        panel = X[:, :, v:2 * v]
        weights = (torch.rand(B, R, generator=gen, device=dev) > 0.1).to(dt)
        lanes = (0, B - 1)
        if special:
            panel, weights = panel.clone(), weights.clone()
            lanes = tuple(range(len(LU_PANEL_SPECIAL)))
            for b, case in enumerate(LU_PANEL_SPECIAL):
                panel[b], weights[b] = special_panel(case, panel[b], weights[b])
        F_k, order_k, ok_k = lu_panel_batched(panel, weights)
        F_p, order_p, ok_p = ref.lu_panel_batched(panel, weights)
        torch.cuda.synchronize()
        masked = weights == 0
        check = lu_panel_check((F_k, order_k, ok_k), (F_p, order_p, ok_p), panel, weights)
        for b in lanes:
            F1, o1, k1 = lu_panel(panel[b], weights[b])
            check[f"lane{b}_equals_single"] = (same_bits(F1, F_k[b])
                                               and torch.equal(o1, order_k[b])
                                               and torch.equal(k1, ok_k[b]))
        finite = torch.isfinite(F_p) & torch.isfinite(F_k)
        err = float((F_k - F_p)[finite].abs().max()) if bool(finite.any()) else 0.0
        ms = time_ms(lambda: lu_panel_batched(panel, weights))
        emit("kernel_lu_panel_batched", shape=[B, R, v], dtype=str(dt), special=special,
             weight0_rows=int(masked.sum()), max_abs_err=err, ms=ms, **check)
        if not all(check.values()):
            raise AssertionError(f"lu_panel_batched [{B}, {R}, {v}] {dt} {special}: {check}")
        if (B, R, dt, special) != (BATCH, BATCH_N, torch.float32, None):
            continue
        n_active = (weights > 0).sum(1).tolist()
        rows.append({
            "name": "lu_panel_batched", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lu_panel.cu",
            "replaces": "src/repro/kernels/lu_panel.py:98",
            "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(lambda: ref.lu_panel_batched(panel, weights), reps=3),
            **bound(4 * B * (2 * R * v + R) + 5 * B * v,
                    sum(panel_ops(R, v, n) for n in n_active)),
            "library_ms": None,
            **device_fields(lambda: lu_panel_batched(panel, weights)),
            "library": "none: no single PyTorch call computes a masked LUP with row weights",
        })

    # fused_trsm_schur_batched: the path's shape, then the kernel's edges
    # (`fused_inputs`): v = 1, 31, 33 and 128, ragged M with C = 96, M = 1
    # with C = 300, C = 1, items split across blocks (4 systems of 128 row
    # tiles each over the SMs), f64, a batch of one, NaN / inf with zero rows,
    # unit=False, an odd row stride, a window.
    from repro_torch.kernels import fused_schur as fs_mod

    modes = {}
    f32, f64 = torch.float32, torch.float64
    for B, M, C, v, unit, dt, kind in (
            (BATCH, BATCH_N, BATCH_N, 32, True, f32, None), (8, 2048, 1536, 16, False, f32, None),
            (8, 300, 500, 1, True, f32, None), (8, 300, 500, 31, True, f32, None),
            (8, 300, 500, 33, True, f32, None), (4, 300, 500, 128, False, f32, None),
            (8, 777, 96, 32, True, f32, None), (8, 1, 300, 32, True, f32, None),
            (8, 777, 1, 32, True, f32, None), (4, 4096, 256, 32, True, f32, None),
            (4, 1000, 700, 32, True, f64, None), (1, BATCH_N, BATCH_N, 32, True, f32, None),
            (4, 777, 1000, 32, True, f32, "special"), (4, 777, 1000, 32, False, f32, "special"),
            (8, 1000, 1000, 32, True, f32, "odd_lda"), (4, 1000, 1000, 32, True, f32, "window")):
        A, L00, R01, L10 = fused_inputs((B,), M, C, v, unit, dt, kind, gen, dev)
        out_k, U_k = ops.fused_trsm_schur_batched(A, L00, R01, L10, unit=unit)
        mode = fs_mod.fused_trsm_schur_batched.mode
        out_p, U_p = ref.fused_trsm_schur_batched(A, L00, R01, L10, unit=unit)
        torch.cuda.synchronize()
        err, scale, check = fused_check(out_k, U_k, out_p, U_p)
        for b in sorted({0, B - 1}):
            o1, u1 = ops.fused_trsm_schur(A[b], L00[b], R01[b], L10[b], unit=unit)
            check[f"lane{b}_equals_single"] = same_bits(o1, out_k[b]) and same_bits(u1, U_k[b])
        case = f"{[B, M, C, v]} {dt} unit={unit} {kind}"
        modes[case] = mode
        emit("kernel_fused_trsm_schur_batched", shape=[B, M, C, v], dtype=str(dt), unit=unit,
             kind=kind, lda=A.stride(-2), mode=mode, max_abs_err=err, rel_err=err / scale,
             tol_rel=FUSED_REL_TOL, **check)
        if not all(check.values()):
            raise AssertionError(f"fused_trsm_schur_batched {case}: error {err} "
                                 f"(scale {scale}), {check}")
        if (B, M, C, v, dt, kind) != (BATCH, BATCH_N, BATCH_N, 32, f32, None):
            continue

        def library():
            U = torch.linalg.solve_triangular(L00, R01, upper=False, unitriangular=True)
            return torch.baddbmm(A, L10, U, alpha=-1.0)

        rows.append({
            "name": "fused_trsm_schur_batched", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_schur.cu",
            "replaces": "src/repro/kernels/fused_schur.py:117",
            "max_abs_err": err,
            "ms": time_ms(lambda: ops.fused_trsm_schur_batched(A, L00, R01, L10)),
            "plain_ms": time_ms(lambda: ref.fused_trsm_schur_batched(A, L00, R01, L10)),
            **bound(4 * B * (2 * M * C + v * v + 2 * v * C + M * v),
                    B * (2 * M * C * v + v * v * C)),
            "library_ms": time_ms(library),
            **device_fields(lambda: ops.fused_trsm_schur_batched(A, L00, R01, L10), library),
            "library": "batched torch.linalg.solve_triangular + torch.baddbmm (two calls)",
        })
    emit("fused_trsm_schur_batched_modes", **modes)
    return rows


def calibrated_auto(dev, kind: str) -> list[dict]:
    """`strategy="auto"` on the committed table (which must be the card's):
    the picks of `plan(N, SolverConfig())` at N = 1024, 4096 and 16384 in
    f32 and at 16384 in bf16, and `calibrate.auto_against_widths` of each
    pick's execute against the analytic pick (sequential, v = 32, "cuda")
    and every other candidate v, in turns: at 16384 in f32 and bf16 and at
    4096 in f32 (fault F7), the calibration tool's guard, best of
    `calibrate.GUARD_ROUNDS` each, where auto over the analytic pick's wall
    or over the fastest width's (`calibrate.guard_ok`) > 1 +
    AUTOTUNE_TOLERANCE fails; reported only at 8192 in f64, best of
    AUTO_ROUNDS (at 16384 its executes took more of the run's time limit
    than any other row).  Each row gives its rounds, every wall and each
    plan's spread (worst wall over best), and the alpha scales under which
    the table keeps its pick there (`calibrate.pick_alpha_range`).  Returns
    the picks."""
    from repro_torch.analysis import calibrate, costmodel
    from repro_torch.api import SolverConfig, plan

    table = costmodel.load_calibration(costmodel._DEFAULT_TABLE)
    if table is None or table.device_kind != kind:
        raise AssertionError(f"the committed calibration table is for "
                             f"{table and table.device_kind!r}, not {kind!r}")
    active = costmodel.active_calibration()
    if active is None or active.version != table.version:
        raise AssertionError(f"auto scores with {active and active.version!r}, not the "
                             f"committed table {table.version!r}")
    picks = []
    for n, compute in ((1024, None), (4096, None), (N, None), (N, "bfloat16")):
        p = plan(n, SolverConfig(compute_dtype=compute))
        pick = {"N": n, "compute_dtype": compute or "float32", "strategy": p.config.strategy,
                "v": p.config.v, "backend": p.config.backend, "hotloop": p.config.hotloop,
                "calibration": p.config.calibration,
                "predicted_wall_us": (p.autotune or {}).get("predicted_wall_us"),
                "n_candidates": (p.autotune or {}).get("n_candidates")}
        emit("calibrated_pick", **pick)
        if p.config.calibration != table.version or p.config.backend != "cuda":
            raise AssertionError(f"plan({n}) did not resolve through the table onto the "
                                 f"kernels: {pick}")
        picks.append(pick)
    limit = 1 + calibrate.AUTOTUNE_TOLERANCE
    guarded = set(calibrate.GUARD)
    for n, dtype in ((N, "float32"), (N, "bfloat16"), (N // 4, "float32"), (N // 2, "float64")):
        widths = tuple(costmodel._sequential_v_candidates(n, None))
        rounds = calibrate.GUARD_ROUNDS if (n, dtype) in guarded else AUTO_ROUNDS
        row = calibrate.auto_against_widths(n, dtype, widths, rounds=rounds, device=dev)
        row.update(guarded=(n, dtype) in guarded, limit=limit if (n, dtype) in guarded else None,
                   rounds=rounds,
                   alpha_scale_range=calibrate.pick_alpha_range(table, n, dtype, dev))
        emit("calibrated_auto", **row)
        if (row["calibration"] != table.version or row["measured_wall_us"] is None
                or any(len(w) != rounds for w in row["walls_s"].values())
                or (row["guarded"] and not calibrate.guard_ok(row))):
            raise AssertionError(f"calibrated auto at N = {n}, {dtype}: auto / analytic "
                                 f"= {row['auto_over_analytic']:.4f}, auto / fastest "
                                 f"({row['fastest']}) = {row['auto_over_fastest']:.4f} "
                                 f"(limit {limit} where guarded), or not through the "
                                 f"table: {row}")
    torch.cuda.empty_cache()
    return picks


def profile_hotloop_phase() -> None:
    """`profile_hotloop()` of the N = 16384 LU plan (the main path's, f32) and
    of the `sequential_chol` plan: the six primitive times and spreads, and
    each wrapper's launches during the profile (its four kernels, each once
    to warm up and once per repeat; 0 of every other)."""
    from repro_torch.api import SolverConfig, plan

    for name, p, kernels in (
            ("lu", plan(N), ("lu_panel", "trsm_left_lower", "schur_update",
                             "fused_trsm_schur")),
            ("cholesky", plan(N, SolverConfig(strategy=CHOL)),
             ("chol_panel", "trsm_right_upper", "schur_update", "fused_trsm_schur"))):
        reset_launches()
        prof = p.profile_hotloop(repeats=HOTLOOP_REPEATS)
        launches = read_launches()
        emit("profile_hotloop", plan=name, v=p.config.v, backend=p.config.backend,
             shapes=prof["shapes"],
             us={k[:-3]: prof[k] for k in prof if k.endswith("_us")},
             spread={k[:-7]: prof[k] for k in prof if k.endswith("_spread")},
             launches=launches)
        want = expected_launches(**{k: HOTLOOP_REPEATS + 1 for k in kernels})
        if launches != want:
            raise AssertionError(f"profile_hotloop of the {name} plan: launches {launches}, "
                                 f"expected {want}")
    torch.cuda.empty_cache()


def calibrate_smoke(kind: str) -> None:
    """`python -m repro_torch.analysis.calibrate --smoke` (one combo,
    ("cuda", "float32"), a short sweep) into a temporary file: the table
    loads back, is keyed by this card and covers its combo."""
    import tempfile

    from repro_torch.analysis import calibrate, costmodel

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "calibration_smoke.json")
        t0 = time.perf_counter()
        calibrate.main(["--smoke", "--out", out])
        seconds = time.perf_counter() - t0
        table = costmodel.load_calibration(out)
    ok = (table is not None and table.device_kind == kind
          and table.covers("cuda", "float32")
          and {costmodel.split_key(k)[0] for k in table.fits("cuda", "float32")}
          == set(costmodel.PRIMITIVES))
    emit("calibrate_smoke", version=table and table.version, seconds=seconds,
         device_kind=table and table.device_kind,
         alpha_scale=table and table.meta.get("alpha_scale"),
         fits=table and {p: f.to_json() for p, f in table.fits("cuda", "float32").items()},
         ok=ok)
    if not ok:
        raise AssertionError(f"calibrate --smoke wrote no usable table for {kind!r}")


AUDIT_KERNEL_DTYPES = ("float32", "bfloat16")  # check_kernels' 24 cases


def audit_phase(dev) -> dict:
    """The plan auditor on the card (module item 11):
    `audit.run_audit(rules={"comm", "kernels", "cache-key"})` on cuda:0, the
    distributed combos left to `grid_8ranks`.  Prints a `kernel_resources`
    line for every kernel instance of every `csrc/*.cu` (registers, static
    and dynamic shared memory, spills, block), a `kernel_check` line for each
    of `check_kernels`' 24 cases (the twelve solver kernels in f32 and bf16,
    each against its plain version), and the `kernel_accum`, cache-key and
    in-core comm findings.  Any error finding fails the phase, and so does a
    solver kernel launched no time (`trsm_left_lower_batched` has no other
    caller).  Returns {dtype: {kernel: launches}} of `check_kernels`."""
    from repro_torch.analysis import audit

    reset_launches()
    t0 = time.perf_counter()
    report = audit.run_audit(rules={"comm", "kernels", "cache-key"}, device=dev, world=0)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    per_dtype: dict = {}
    for f in report.findings:
        d = f.data
        if f.rule == "kernel-resources":
            emit("kernel_resources", kernel=d.get("kernel"), source=d.get("source"),
                 dtype=d.get("dtype"), registers=d.get("registers"),
                 static_smem=d.get("static_smem"), dynamic_smem=d.get("dynamic_smem"),
                 spill_bytes=d.get("spill_bytes"), block=d.get("block"),
                 max_threads=d.get("max_threads"), severity=f.severity)
        elif f.rule == "kernel-check":
            name, dtype = f.location.rstrip("]").split("[")
            per_dtype.setdefault(dtype, {})[name] = d.get("launched", 0)
            emit("kernel_check", kernel=name, dtype=dtype, max_abs_err=d.get("max_abs_err"),
                 scale=d.get("scale"), tol_rel=d.get("tol"), body=d.get("body"),
                 predicted_body=d.get("predicted_body"), severity=f.severity)
        elif f.rule in ("kernel-accum", "kernel-divisibility", "cache-key", "comm-conformance",
                        "audit"):
            emit("audit_finding", rule=f.rule, severity=f.severity, location=f.location,
                 detail=f.detail)
    counts = report.to_json()["counts"]
    resources = [f for f in report.findings if f.rule == "kernel-resources"]
    checks = sum(len(v) for v in per_dtype.values())
    solver = [name for name, *_ in audit._kernel_cases()]
    unlaunched = [k for k in solver if launches[k] == 0]
    emit("audit", seconds=seconds, counts=counts, kernel_instances=len(resources),
         spilling_instances=sum(1 for f in resources if f.severity == "warning"),
         kernel_checks=checks, launches=launches)
    if report.errors or checks != 12 * len(AUDIT_KERNEL_DTYPES) or unlaunched or len(
            resources) < 14:
        raise AssertionError(f"audit: {[(f.rule, f.location, f.detail) for f in report.errors]}, "
                             f"{checks} kernel checks, unlaunched {unlaunched}, "
                             f"{len(resources)} kernel instances")
    torch.cuda.empty_cache()
    return per_dtype


def batched_path(dev, gen) -> dict:
    """plan((256, 512)).execute(A).solve(b) through the entry points, the
    loop of single plans it replaces, its profile and the library yardstick.
    Returns the launches of the counted run."""
    from repro_torch.api import SolverConfig, plan
    from repro_torch.kernels import fused_schur as fs_mod

    A = torch.randn(BATCH, BATCH_N, BATCH_N, generator=gen, device=dev)
    b = torch.randn(BATCH, BATCH_N, generator=gen, device=dev)
    p = plan((BATCH, BATCH_N))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fact = p.execute(A)
    torch.cuda.synchronize()
    execute_s = time.perf_counter() - t0
    launches = read_launches()
    fused_mode = fs_mod.fused_trsm_schur_batched.mode
    t0 = time.perf_counter()
    x = fact.solve(b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    resid = hpl_residuals(A, x, b)
    single = plan(BATCH_N, SolverConfig(strategy="sequential", v=p.config.v))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(BATCH):
        single.execute(A[i])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    steps = BATCH_N // p.config.v
    emit("batched_path", B=BATCH, N=BATCH_N, v=p.config.v, strategy=fact.strategy,
         backend=fact.backend, launches=launches, execute_s=execute_s, solve_s=solve_s,
         hpl_residual_max=float(resid.max()), x_finite=bool(torch.isfinite(x).all()),
         x_shape=list(x.shape), loop_of_single_plans_s=loop_s,
         loop_over_batched=loop_s / execute_s, last_fused_mode=fused_mode)
    if fact.backend != "cuda":
        raise AssertionError(f"batched path ran backend {fact.backend!r}, not 'cuda'")
    if fused_mode != "tma":
        raise AssertionError(f"the batched path's fused call took {fused_mode!r}")
    if launches != expected_launches(lu_panel_batched=steps, fused_trsm_schur_batched=steps):
        raise AssertionError(f"expected {steps} launches of each batched kernel, got {launches}")
    if not (torch.isfinite(x).all() and bool((resid < HPL_RESIDUAL_MAX).all())):
        raise AssertionError(f"batched HPL scaled residual {float(resid.max())} "
                             f">= {HPL_RESIDUAL_MAX}")
    # The plain path on the same stack: how many systems pick the same
    # pivots (reported, not held: the update rounds differently).
    rows_plain = plan((BATCH, BATCH_N), v32(backend="ref")).execute(A).rows
    emit("plain_batched_path_full", B=BATCH, N=BATCH_N,
         rows_equal_systems=int((rows_plain == fact.rows).all(1).sum()))
    del fact, x, rows_plain
    emit("profile_batched_execute", **profile_once(lambda: p.execute(A)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    LU, piv = torch.linalg.lu_factor(A)
    torch.cuda.synchronize()
    lib_factor_s = time.perf_counter() - t0
    x_lib = torch.linalg.lu_solve(LU, piv, b[..., None])[..., 0]
    emit("yardstick_torch_lu_batched", factor_s=lib_factor_s,
         hpl_residual_max=hpl_residual(A, x_lib, b),
         note="torch.linalg.lu_factor + lu_solve on the stack; the port never calls them")
    return launches


def plain_batched_path(dev, gen) -> None:
    """The batched kernel path against the plain path (backend "ref")."""
    from repro_torch.api import SolverConfig, plan

    B, n = PLAIN_BATCH, PLAIN_BATCH_N
    A = torch.randn(B, n, n, generator=gen, device=dev)
    f_k = plan((B, n), v32()).execute(A)
    f_p = plan((B, n), v32(backend="ref")).execute(A)
    lanes_equal = (f_k.rows == f_p.rows).all(1)
    err = (f_k.F - f_p.F).abs().amax((1, 2))
    tol = LU_F_TOL_FACTOR * n * torch.finfo(torch.float32).eps * f_p.F.abs().amax((1, 2))
    emit("plain_batched_path", B=B, N=n, rows_equal_systems=int(lanes_equal.sum()),
         F_max_abs_err=float(err.max()), F_err_over_tol_max=float((err / tol).max()))
    if not (bool(lanes_equal.all()) and bool((err <= tol).all())):
        raise AssertionError(f"kernel and plain batched paths differ: "
                             f"{int((~lanes_equal).sum())} systems with other pivots, "
                             f"F error / tol up to {float((err / tol).max())}")


def _requests(rng, count: int):
    """Ragged requests: n uniform in SERVE_MIN_N..SERVE_N, standard normal
    A and b, from a seeded numpy generator."""
    import numpy as np

    out = []
    for n in rng.integers(SERVE_MIN_N, SERVE_N + 1, size=count):
        out.append((rng.standard_normal((n, n)).astype(np.float32),
                    rng.standard_normal(n).astype(np.float32)))
    return out


def _check_answers(requests, answers, phase: str) -> float:
    resid = [hpl_residual(torch.from_numpy(A), x.cpu(), torch.from_numpy(b))
             for (A, b), x in zip(requests, answers)]
    if not all(r < HPL_RESIDUAL_MAX for r in resid):
        raise AssertionError(f"{phase}: HPL scaled residual {max(resid)} >= {HPL_RESIDUAL_MAX}")
    return max(resid)


def serving_sync(phase: str = "serving_sync", strategy: str = "auto",
                 make=_requests, count: int = SERVE_REQUESTS,
                 kernels=("lu_panel_batched", "fused_trsm_schur_batched")) -> None:
    """SolveEngine(512): `count` ragged requests, submit_system then one
    flush; every kernel of `kernels` must have been launched."""
    import numpy as np
    from repro_torch.api import SolverConfig
    from repro_torch.serving import SolveEngine

    requests = make(np.random.default_rng(1), count)
    eng = SolveEngine(SERVE_N, SolverConfig(strategy=strategy))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = [eng.submit_system(A, b) for A, b in requests]
    slots = sorted({p.slotN for p in eng._pending_systems})
    buckets = {s: sum(p.slotN == s for p in eng._pending_systems) for s in slots}
    xs = eng.flush_systems()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    answers = [xs[t] for t in tickets]
    st = eng.stats()
    emit(phase, N=SERVE_N, strategy=st["strategy"], requests=len(requests),
         buckets={str(s): {"systems": k, "batch_slot": eng._slot(k)} for s, k in buckets.items()},
         batched_factorizations=st["batched_factorizations"],
         batch_pad_waste=st["batch_pad_waste"], wall_s=wall_s,
         requests_per_s=len(requests) / wall_s, flush_s=st["batch_s_total"],
         launches=launches, hpl_residual_max=_check_answers(requests, answers, phase))
    if any(launches[k] == 0 for k in kernels):
        raise AssertionError(f"{phase} launched no batched kernel: {launches}")


def serving_async(phase: str = "serving_async", strategy: str = "auto", make=_requests,
                  per_tenant_count: int = ASYNC_PER_TENANT, kernels=()) -> None:
    """AsyncSolveEngine(512): 4 tenant threads submitting `per_tenant_count`
    requests each; every kernel of `kernels` must have been launched."""
    import threading

    import numpy as np
    from repro_torch.api import SolverConfig
    from repro_torch.serving import AsyncSolveEngine

    per_tenant = [make(np.random.default_rng(10 + t), per_tenant_count)
                  for t in range(ASYNC_TENANTS)]
    futures: list[list] = [[] for _ in range(ASYNC_TENANTS)]
    eng = AsyncSolveEngine(SERVE_N, SolverConfig(strategy=strategy), max_batch=ASYNC_MAX_BATCH,
                           max_delay_ms=ASYNC_DELAY_MS)
    reset_launches()

    def tenant(t: int) -> None:
        for A, b in per_tenant[t]:
            futures[t].append(eng.submit(A, b, tenant=f"tenant{t}"))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=tenant, args=(t,)) for t in range(ASYNC_TENANTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    answers = [[f.result(timeout=300) for f in futs] for futs in futures]
    wall_s = time.perf_counter() - t0
    eng.close()
    launches = read_launches()
    st = eng.stats()["async"]
    resid = max(_check_answers(reqs, ans, phase) for reqs, ans in zip(per_tenant, answers))
    total = ASYNC_TENANTS * per_tenant_count
    emit(phase, N=SERVE_N, strategy=strategy, tenants=ASYNC_TENANTS, requests=total,
         max_batch=ASYNC_MAX_BATCH, max_delay_ms=ASYNC_DELAY_MS, wall_s=wall_s,
         requests_per_s=total / wall_s, latency_ms=st["latency_ms"], flushes=st["flushes"],
         batch_fill=st["batch_fill"], served=st["served"], failed=st["failed"],
         shed=st["shed"], spilled=st["spilled"], launches=launches, hpl_residual_max=resid)
    if st["served"] + st["spilled"] != total or st["failed"]:
        raise AssertionError(f"{phase} served {st['served']} + spilled {st['spilled']} "
                             f"of {total}, failed {st['failed']}")
    if any(launches[k] == 0 for k in kernels):
        raise AssertionError(f"{phase} launched no batched kernel: {launches}")


def spd(shape, gen, dev, dtype=torch.float32) -> torch.Tensor:
    """G G^T / n + I for a standard normal G of shape [..., n, n], made on the
    card: SPD with eigenvalues in about [1, 5]."""
    n = shape[-1]
    G = torch.randn(*shape, generator=gen, device=dev, dtype=dtype)
    A = G @ G.mT
    del G
    A /= n
    A.diagonal(dim1=-2, dim2=-1).add_(1.0)
    return A


def chol_ops(v: int) -> int:
    """Operations of one v x v Cholesky: per round a root, v-k-1 divisions
    and the (v-k-1)(v-k)/2 multiply-subtracts of the trailing lower triangle."""
    return sum(1 + (v - k - 1) + (v - k - 1) * (v - k) for k in range(v))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN at the same places and bit-for-bit equal everywhere else."""
    nan = a.isnan()
    if not torch.equal(nan, b.isnan()):
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(ints)[~nan], b.contiguous().view(ints)[~nan])


def chol_kernel_rows(dev, gen) -> list[dict]:
    """The Cholesky kernels against their plain versions, and batched lanes
    against the single call, at the Cholesky paths' shapes and beyond.
    Returns the six rows of the kernels line (launches filled in later)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import trsm as trsm_mod

    rows = []
    # chol_panel[_batched]: the batched path's stack (lane 0 is the single
    # path's block), f64, v = 128 in f64 (the largest shared-memory block),
    # and the edges of the two bodies: v = 1 and 31 (the register body) and
    # v = 33 (the shared-memory one).  Strided blocks, as the paths pass a
    # diagonal block of A.
    for B, v, dt in ((BATCH, CHOL_V, torch.float32), (64, CHOL_V, torch.float64),
                     (4, 128, torch.float64), (64, 1, torch.float32), (64, 31, torch.float32),
                     (64, 33, torch.float32)):
        buf = torch.zeros(B, v, 2 * v, device=dev, dtype=dt)
        buf[:, :, v:] = spd((B, v, v), gen, dev, dt)
        blocks = buf[:, :, v:]
        L_k = ops.chol_panel_batched(blocks)
        L_p = ref.chol_panel_batched(blocks)
        bad = blocks.clone()
        p = min(5, v - 1)
        bad[:, p, p] = -1.0  # not SPD: the pivot of round p is negative
        bad_k = ops.chol_panel_batched(bad)
        bad_p = ref.chol_panel_batched(bad)
        # Not SPD through a non-finite entry: an inf below the diagonal makes
        # an l infinite in round (v - 1) // 2 (no entry below it at v = 1).
        inf = blocks.clone()
        if v > 1:
            inf[:, v - 1, (v - 1) // 2] = float("inf")
        inf_k = ops.chol_panel_batched(inf)
        inf_p = ref.chol_panel_batched(inf)
        torch.cuda.synchronize()
        eps = torch.finfo(dt).eps
        recon = float((L_k @ L_k.mT - blocks).abs().max()) / float(blocks.abs().max())
        check = {"bit_identical": same_bits(L_k, L_p),
                 "reconstruct_ok": recon <= 4 * v * eps,
                 "not_spd_nonfinite": (not bool(torch.isfinite(bad_k).all())
                                       and not bool(torch.isfinite(bad_p).all())),
                 "not_spd_bit_identical": same_bits(bad_k, bad_p),
                 "inf_entry_bit_identical": same_bits(inf_k, inf_p)}
        if v > 1:
            check["inf_entry_nonfinite"] = (not bool(torch.isfinite(inf_k).all())
                                            and not bool(torch.isfinite(inf_p).all()))
        for b in (0, B - 1):
            check[f"lane{b}_equals_single"] = same_bits(ops.chol_panel(blocks[b]), L_k[b])
        check["not_spd_single_equals_lane0"] = same_bits(ops.chol_panel(bad[0]), bad_k[0])
        check["inf_entry_single_equals_lane0"] = same_bits(ops.chol_panel(inf[0]), inf_k[0])
        err = float((L_k - L_p).abs().max())
        emit("kernel_chol_panel_batched", shape=[B, v, v], dtype=str(dt), max_abs_err=err,
             reconstruct_rel_err=recon, **check)
        if not all(check.values()):
            raise AssertionError(f"chol_panel [{B}, {v}, {v}] {dt} disagrees: {check}")
        if (B, v, dt) != (BATCH, CHOL_V, torch.float32):
            continue
        one = blocks[0]
        one_err = float((ops.chol_panel(one) - ref.chol_panel(one)).abs().max())
        rows.append({
            "name": "chol_panel", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chol_panel.cu",
            "replaces": "src/repro/kernels/chol_panel.py:50",
            "max_abs_err": one_err, "ms": time_ms(lambda: ops.chol_panel(one)),
            "plain_ms": time_ms(lambda: ref.chol_panel(one), reps=3),
            **bound(4 * 2 * v * v, chol_ops(v)),
            "library_ms": time_ms(lambda: torch.linalg.cholesky_ex(one)),
            **device_fields(lambda: ops.chol_panel(one), lambda: torch.linalg.cholesky_ex(one)),
            "library": "torch.linalg.cholesky_ex on the [v, v] block",
        })
        rows.append({
            "name": "chol_panel_batched", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chol_panel.cu",
            "replaces": "src/repro/kernels/chol_panel.py:66",
            "max_abs_err": err, "ms": time_ms(lambda: ops.chol_panel_batched(blocks)),
            "plain_ms": time_ms(lambda: ref.chol_panel_batched(blocks), reps=3),
            **bound(4 * 2 * B * v * v, B * chol_ops(v)),
            "library_ms": time_ms(lambda: torch.linalg.cholesky_ex(blocks)),
            **device_fields(lambda: ops.chol_panel_batched(blocks),
                            lambda: torch.linalg.cholesky_ex(blocks)),
            "library": "torch.linalg.cholesky_ex on the [B, v, v] stack",
        })

    # trsm_right_upper[_batched]: U = L00^T, a transposed view of a lower
    # factor, as the Cholesky path passes it, or a plain upper matrix, as the
    # LU conflux path passes U00; B with its top quarter of rows zero, as the
    # paths pass it.  The single and batched paths' shapes, a ragged one
    # (v = 24), v = 128 in f64 (the shared-memory body), the register body's
    # edges v = 1, 31 and 32 in f64, v = 33 (the shared-memory body), R = 1,
    # R = 100,000, B with a NaN row and an inf row ("nan_inf": those rows
    # non-finite where the plain version's are, the rest within tolerance),
    # and a zero on U's diagonal ("zero_diag": every row non-finite, the zero
    # rows NaN, as (0 - 0) / 0 is).
    for Bb, R, v, dt, ukind, special in (
            (None, N, CHOL_V, torch.float32, "mT", None),
            (BATCH, BATCH_N, CHOL_V, torch.float32, "mT", None),
            (8, 2000, 24, torch.float32, "mT", None), (4, 1000, 128, torch.float64, "mT", None),
            (8, 1000, 1, torch.float32, "mT", None), (8, 1000, 31, torch.float32, "upper", None),
            (8, 1000, 32, torch.float64, "mT", None), (8, 1000, 33, torch.float32, "mT", None),
            (None, 1, CHOL_V, torch.float32, "mT", None),
            (None, 100_000, CHOL_V, torch.float32, "upper", None),
            (4, 777, CHOL_V, torch.float32, "upper", "nan_inf"),
            (None, 777, CHOL_V, torch.float32, "mT", "nan_inf"),
            (4, 777, CHOL_V, torch.float32, "upper", "zero_diag")):
        nb = 1 if Bb is None else Bb
        if ukind == "mT":
            U = ref.chol_panel_batched(spd((nb, v, v), gen, dev, dt)).mT
        else:
            U = torch.triu(torch.randn(nb, v, v, generator=gen, device=dev, dtype=dt))
            U.diagonal(dim1=-2, dim2=-1).add_(4.0)
        Bm = torch.randn(nb, R, v, generator=gen, device=dev, dtype=dt)
        Bm[:, :R // 4] = 0.0
        if special == "nan_inf":
            Bm[:, R // 2, v // 3] = float("nan")
            Bm[:, R // 2 + 1, 0] = float("inf")
        if special == "zero_diag":
            U[:, 5, 5] = 0.0
        if Bb is None:
            U, Bm = U[0], Bm[0]
            X_k = ops.trsm_right_upper(Bm, U)
            mode = trsm_mod.trsm_right_upper.mode
            X_p = ref.trsm_right_upper(Bm, U)
        else:
            X_k = ops.trsm_right_upper_batched(Bm, U)
            mode = trsm_mod.trsm_right_upper_batched.mode
            X_p = ref.trsm_right_upper_batched(Bm, U)
        torch.cuda.synchronize()
        finite_rows = torch.isfinite(X_p).all(-1)
        check = {"nonfinite_rows_as_plain": torch.equal(torch.isfinite(X_k).all(-1), finite_rows),
                 "mode_as_predicted": mode == trsm_mod.right_mode(Bm, U)}
        if special == "zero_diag":
            err = rel = None
            check["zero_rows_nan"] = bool(X_k[..., :R // 4, :].isnan().any(-1).all())
        else:
            err = float((X_k - X_p)[finite_rows].abs().max())
            scale = float(X_p[finite_rows].abs().max())
            rel = err / scale
            check["within_tol"] = err <= FUSED_REL_TOL * scale
            check["zero_rows_zero"] = bool((X_k[..., :R // 4, :] == 0).all())
        if Bb is not None:
            for b in (0, Bb - 1):
                check[f"lane{b}_equals_single"] = same_bits(ops.trsm_right_upper(Bm[b], U[b]),
                                                            X_k[b])
        emit("kernel_trsm_right_upper" + ("" if Bb is None else "_batched"),
             shape=[nb, R, v], dtype=str(dt), U=ukind, special=special, mode=mode,
             max_abs_err=err, rel_err=rel, tol_rel=FUSED_REL_TOL, **check)
        if not all(check.values()):
            raise AssertionError(f"trsm_right_upper [{nb}, {R}, {v}] {dt}: {check}")
        if dt != torch.float32 or special or (R, v) not in ((N, CHOL_V), (BATCH_N, CHOL_V)):
            continue
        single = Bb is None
        kernel = ops.trsm_right_upper if single else ops.trsm_right_upper_batched
        plain = ref.trsm_right_upper if single else ref.trsm_right_upper_batched
        rows.append({
            "name": "trsm_right_upper" + ("" if single else "_batched"), "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/trsm.cu",
            "replaces": "src/repro/kernels/trsm.py:" + ("78" if single else "96"),
            "max_abs_err": err, "ms": time_ms(lambda: kernel(Bm, U)),
            "plain_ms": time_ms(lambda: plain(Bm, U)),
            **bound(4 * nb * (2 * R * v + v * v), nb * R * v * v),
            "library_ms": time_ms(
                lambda: torch.linalg.solve_triangular(U, Bm, upper=True, left=False)),
            **device_fields(lambda: kernel(Bm, U), lambda: torch.linalg.solve_triangular(
                U, Bm, upper=True, left=False)),
            "library": "torch.linalg.solve_triangular(U, B, upper=True, left=False)",
        })

    # schur_update[_batched]: the single path's [N, N] with K = 32, the
    # batched path's (256, 512, 512, 32), a batch of one, K = 1, 16, 33, 40
    # and 64, ragged M and N on both the bulk-copy branch (N % 4 == 0) and the
    # plain-load one, f64, an odd row stride of A (the plain-load branch), a
    # window of a wider matrix as the conflux step passes it (row stride > N,
    # base 32 rows and 64 columns in), and NaN and inf in A and L ("special":
    # non-finite where the plain version is, the rest within tolerance).
    for Bb, M, C, K, dt, kind in ((None, N, N, CHOL_V, torch.float32, None),
                                  (None, 2000, 1000, 40, torch.float32, None),
                                  (BATCH, BATCH_N, BATCH_N, CHOL_V, torch.float32, None),
                                  (8, 2048, 1536, 16, torch.float32, None),
                                  (4, 1000, 700, 40, torch.float64, None),
                                  (1, BATCH_N, BATCH_N, CHOL_V, torch.float32, None),
                                  (8, 300, 500, 1, torch.float32, None),
                                  (8, 300, 500, 33, torch.float32, None),
                                  (8, 300, 500, 64, torch.float32, None),
                                  (8, 777, 1000, CHOL_V, torch.float32, None),
                                  (8, 777, 1001, CHOL_V, torch.float32, None),
                                  (None, 1000, 1000, CHOL_V, torch.float32, "odd_lda"),
                                  (None, 4064, 4064, CHOL_V, torch.float32, "window"),
                                  (4, 777, 1000, CHOL_V, torch.float32, "special")):
        lead = () if Bb is None else (Bb,)
        if kind == "odd_lda":
            A = torch.randn(*lead, M, C + 1, generator=gen, device=dev, dtype=dt)[..., :C]
        elif kind == "window":
            A = torch.randn(*lead, M + 32, C + 64, generator=gen, device=dev,
                            dtype=dt)[..., 32:, 64:]
        else:
            A = torch.randn(*lead, M, C, generator=gen, device=dev, dtype=dt)
        Lm = torch.randn(*lead, M, K, generator=gen, device=dev, dtype=dt)
        Um = torch.randn(*lead, K, C, generator=gen, device=dev, dtype=dt)
        if kind == "special":
            A[..., 5, 7] = float("nan")
            A[..., 9, 100] = float("inf")
            Lm[..., 11, 0] = float("nan")
            Lm[..., 13, K - 1] = float("-inf")
        kernel = ops.schur_update if Bb is None else ops.schur_update_batched
        plain = ref.schur_update if Bb is None else ref.schur_update_batched
        out_k = kernel(A, Lm, Um)
        out_p = plain(A, Lm, Um)
        torch.cuda.synchronize()
        finite = torch.isfinite(out_p)
        err = float((out_k - out_p)[finite].abs().max())
        scale = float(out_p[finite].abs().max())
        check = {"within_tol": err <= FUSED_REL_TOL * scale,
                 "nan_as_plain": torch.equal(out_k.isnan(), out_p.isnan()),
                 "inf_as_plain": torch.equal(out_k.isinf(), out_p.isinf())}
        if Bb is not None:
            for b in sorted({0, Bb - 1}):
                check[f"lane{b}_equals_single"] = same_bits(
                    ops.schur_update(A[b], Lm[b], Um[b]), out_k[b])
        emit("kernel_schur_update" + ("" if Bb is None else "_batched"),
             shape=[*lead, M, C, K], dtype=str(dt), kind=kind, lda=A.stride(-2),
             max_abs_err=err, rel_err=err / scale, tol_rel=FUSED_REL_TOL, **check)
        if not all(check.values()):
            raise AssertionError(f"schur_update {[*lead, M, C, K]} {dt} {kind}: {check}")
        del out_k, out_p
        if (dt != torch.float32 or kind is not None or Bb == 1
                or (M, C, K) not in ((N, N, CHOL_V), (BATCH_N, BATCH_N, CHOL_V))):
            continue
        nb = 1 if Bb is None else Bb
        library = torch.addmm if Bb is None else torch.baddbmm
        rows.append({
            "name": "schur_update" + ("" if Bb is None else "_batched"), "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/schur_update.cu",
            "replaces": "src/repro/kernels/schur_update.py:" + ("52" if Bb is None else "75"),
            "max_abs_err": err, "ms": time_ms(lambda: kernel(A, Lm, Um)),
            "plain_ms": time_ms(lambda: plain(A, Lm, Um)),
            **bound(4 * nb * (2 * M * C + M * K + K * C), 2 * nb * M * C * K),
            "library_ms": time_ms(lambda: library(A, Lm, Um, alpha=-1.0)),
            **device_fields(lambda: kernel(A, Lm, Um), lambda: library(A, Lm, Um, alpha=-1.0)),
            "library": ("torch.addmm" if Bb is None else "torch.baddbmm") + "(A, L, U, alpha=-1)",
        })
        del A, Lm, Um
    torch.cuda.empty_cache()
    return rows


def chol_main_path(dev, gen) -> dict:
    """plan(16384, strategy="sequential_chol").execute(A).solve(b) through the
    entry points, its profile, the library yardstick and the plain path at
    N = 1024.  Returns the launches of the counted run."""
    from repro_torch.api import SolverConfig, plan

    A = spd((N, N), gen, dev)
    b = torch.randn(N, generator=gen, device=dev)
    p = plan(N, SolverConfig(strategy=CHOL))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fact = p.execute(A)
    torch.cuda.synchronize()
    execute_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    x = fact.solve(b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    resid = hpl_residual(A, x, b)
    steps = N // p.config.v
    emit("chol_main_path", N=N, v=p.config.v, strategy=fact.strategy, backend=fact.backend,
         kind=fact.kind, launches=launches, execute_s=execute_s, solve_s=solve_s,
         hpl_residual=resid, x_finite=bool(torch.isfinite(x).all()), x_shape=list(x.shape))
    if fact.backend != "cuda" or fact.kind != "cholesky":
        raise AssertionError(f"Cholesky path ran backend {fact.backend!r}, kind {fact.kind!r}")
    if launches != expected_launches(chol_panel=steps, trsm_right_upper=steps,
                                     schur_update=steps):
        raise AssertionError(f"expected {steps} launches of each Cholesky kernel, got {launches}")
    if not (torch.isfinite(x).all() and resid < HPL_RESIDUAL_MAX):
        raise AssertionError(f"Cholesky HPL scaled residual {resid} >= {HPL_RESIDUAL_MAX}")
    del fact, x

    emit("profile_chol_execute", **profile_once(lambda: p.execute(A)))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_lib, info = torch.linalg.cholesky_ex(A)
    torch.cuda.synchronize()
    lib_factor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_lib = torch.cholesky_solve(b[:, None], L_lib)[:, 0]
    torch.cuda.synchronize()
    emit("yardstick_torch_cholesky", factor_s=lib_factor_s, solve_s=time.perf_counter() - t0,
         info=int(info), hpl_residual=hpl_residual(A, x_lib, b),
         note="torch.linalg.cholesky_ex + cholesky_solve; the port never calls them")
    del L_lib, x_lib, A, b

    n = 1024
    A_small = spd((n, n), gen, dev)
    L_k = plan(n, SolverConfig(strategy=CHOL)).execute(A_small).F
    L_p = plan(n, SolverConfig(strategy=CHOL, backend="ref")).execute(A_small).F
    err = float((L_k - L_p).abs().max())
    tol = CHOL_L_TOL_FACTOR * n * torch.finfo(torch.float32).eps * float(L_p.abs().max())
    emit("plain_chol_path_1024", L_max_abs_err=err, tol=tol, L_max_abs=float(L_p.abs().max()))
    if not err <= tol:
        raise AssertionError(f"kernel and plain Cholesky paths differ at N={n}: {err} > {tol}")
    torch.cuda.empty_cache()
    return launches


def chol_batched_path(dev, gen) -> dict:
    """plan((256, 512), strategy="sequential_chol") through the entry points,
    the loop of single plans it replaces, its profile and the library
    yardstick.  Returns the launches of the counted run."""
    from repro_torch.api import SolverConfig, plan

    A = spd((BATCH, BATCH_N, BATCH_N), gen, dev)
    b = torch.randn(BATCH, BATCH_N, generator=gen, device=dev)
    p = plan((BATCH, BATCH_N), SolverConfig(strategy=CHOL))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fact = p.execute(A)
    torch.cuda.synchronize()
    execute_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    x = fact.solve(b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    resid = hpl_residuals(A, x, b)
    single = plan(BATCH_N, SolverConfig(strategy=CHOL))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(BATCH):
        single.execute(A[i])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    steps = BATCH_N // p.config.v
    emit("chol_batched_path", B=BATCH, N=BATCH_N, v=p.config.v, strategy=fact.strategy,
         backend=fact.backend, kind=fact.kind, launches=launches, execute_s=execute_s,
         solve_s=solve_s, hpl_residual_max=float(resid.max()),
         x_finite=bool(torch.isfinite(x).all()), x_shape=list(x.shape),
         loop_of_single_plans_s=loop_s, loop_over_batched=loop_s / execute_s)
    if fact.backend != "cuda" or fact.kind != "cholesky":
        raise AssertionError(f"batched Cholesky ran backend {fact.backend!r}, kind {fact.kind!r}")
    if launches != expected_launches(chol_panel_batched=steps, trsm_right_upper_batched=steps,
                                     schur_update_batched=steps):
        raise AssertionError(f"expected {steps} launches of each batched Cholesky kernel, "
                             f"got {launches}")
    if not (torch.isfinite(x).all() and bool((resid < HPL_RESIDUAL_MAX).all())):
        raise AssertionError(f"batched Cholesky HPL scaled residual {float(resid.max())} "
                             f">= {HPL_RESIDUAL_MAX}")
    del fact, x
    emit("profile_chol_batched_execute", **profile_once(lambda: p.execute(A)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_lib, info = torch.linalg.cholesky_ex(A)
    torch.cuda.synchronize()
    lib_factor_s = time.perf_counter() - t0
    x_lib = torch.cholesky_solve(b[..., None], L_lib)[..., 0]
    emit("yardstick_torch_cholesky_batched", factor_s=lib_factor_s,
         info_max=int(info.max()), hpl_residual_max=hpl_residual(A, x_lib, b),
         note="torch.linalg.cholesky_ex + cholesky_solve on the stack; the port never calls them")
    return launches


def _spd_requests(rng, count: int):
    """Ragged SPD requests: n uniform in SERVE_MIN_N..SERVE_N, A = G^T G / n + I
    for a standard normal G, and a standard normal b, from a seeded numpy
    generator."""
    import numpy as np

    out = []
    for n in rng.integers(SERVE_MIN_N, SERVE_N + 1, size=count):
        G = rng.standard_normal((n, n)).astype(np.float32)
        A = G.T @ G / np.float32(n) + np.eye(n, dtype=np.float32)
        out.append((A, rng.standard_normal(n).astype(np.float32)))
    return out


CHOL_BATCHED_KERNELS = ("chol_panel_batched", "trsm_right_upper_batched", "schur_update_batched")

# The distributed schedules (module item 10).  One card holds one rank at
# the full N (a 1x1x1 grid, as the JAX package's own hot-loop tests use);
# eight ranks share it through gloo to exercise every collective, at sizes
# that keep the run short (correctness runs, not speed).  The first conflux
# case took 9.4 s at N = 8192 and runs at 4096, to keep the script near its
# earlier run time; baseline2d at N = 2048 is the longest case (22 s), since
# partial pivoting makes one collective per column.
CONFLUX_V = 32
GRID_WORLD = 8
GRID_CASES = (  # (name, strategy, N, hotloop, backend, compute dtype)
    ("conflux_windowed", "conflux", 4096, "windowed", "cuda", None),
    ("conflux_flat", "conflux", 2048, "flat", "cuda", None),
    ("baseline2d", "baseline2d", 2048, "windowed", "cuda", None),
    ("cholesky25d_windowed", "cholesky25d", 2048, "windowed", "cuda", None),
    ("cholesky25d_flat", "cholesky25d", 2048, "flat", "cuda", None),
    ("conflux_windowed_1024", "conflux", 1024, "windowed", "cuda", None),
    ("conflux_windowed_1024_plain", "conflux", 1024, "windowed", "ref", None),
    ("conflux_flat_1024", "conflux", 1024, "flat", "cuda", None),
    ("conflux_flat_1024_plain", "conflux", 1024, "flat", "ref", None),
    # bf16 factors under f32, refined to MIXED_LOW_TOL, on both backends
    # (each "_plain" case is compared with the kernel case before it); the
    # LU on `well_conditioned`, whose pivot ids (up to 2047) bf16 cannot
    # carry exactly (F5).
    ("conflux_flat_bf16", "conflux", 2048, "flat", "cuda", "bfloat16"),
    ("conflux_flat_bf16_plain", "conflux", 2048, "flat", "ref", "bfloat16"),
    ("cholesky25d_flat_bf16", "cholesky25d", 2048, "flat", "cuda", "bfloat16"),
    ("cholesky25d_flat_bf16_plain", "cholesky25d", 2048, "flat", "ref", "bfloat16"),
)
GRID_TIMEOUT_S = 420  # all ranks together, from spawn to exit
# Engines on the 8-rank group (module item 8) at N = 2048: the default
# config (resolved as `plan()` resolves it here: the calibrated `auto`), and
# conflux 2x2x2, cholesky25d 2x2x2 and baseline2d on explicit grids;
# (name, strategy or None for SolverConfig()).
GRID_ENGINE_N = 2048
GRID_ENGINE_CASES = (("engine_default", None), ("engine_conflux", "conflux"),
                     ("engine_cholesky25d", "cholesky25d"), ("engine_baseline2d", "baseline2d"))
GRID_ENGINE_RHS, GRID_ASYNC_RHS = 4, 8
# The async engine's batches are each rank's own (`AsyncSolveEngine`'s
# docstring), and a stacked triangular solve of k RHS need not give a column
# the bits it gets among k' others: the ranks' async answers are compared bit
# for bit over one batch of all GRID_ASYNC_RHS requests on every rank, closed
# by the size trigger (max_batch) and never by a deadline, which eight ranks
# sharing the host's cores can pass between two submits.
GRID_ASYNC_DELAY_MS = 60_000.0


def trsm_left_lower_rows(dev, gen) -> list[dict]:
    """trsm_left_lower[_batched] against their plain version, and batched
    lanes against the single call.  Returns the two rows of the kernels line
    (launches filled in later)."""
    from repro_torch.kernels import ops, ref

    def lower(lead, v, unit, dt):
        L = 0.3 * torch.tril(torch.randn(*lead, v, v, generator=gen, device=dev, dtype=dt), -1)
        return L + (1.0 if unit else 2.0) * torch.eye(v, device=dev, dtype=dt)

    rows = []
    # The P = 1 flat path's shape (unit, f32), an f64 non-unit one, a ragged
    # one (C % 64 != 0, v = 24) read through a strided view of B, v = 128 in
    # f64 (the largest shared-memory tile), and the edges of the two bodies
    # with ragged C: v = 1 (the register body) and v = 33 (the shared-memory
    # one).
    for v, C, unit, dt, strided in ((CONFLUX_V, N, True, torch.float32, False),
                                    (CONFLUX_V, 4096, False, torch.float64, False),
                                    (24, 777, True, torch.float32, True),
                                    (128, 1000, False, torch.float64, False),
                                    (1, 63, True, torch.float32, False),
                                    (33, 65, False, torch.float32, True)):
        L = lower((), v, unit, dt)
        buf = torch.randn(v, 2 * C if strided else C, generator=gen, device=dev, dtype=dt)
        Bm = buf[:, C:] if strided else buf
        X_k = ops.trsm_left_lower(L, Bm, unit=unit)
        X_p = ref.trsm_left_lower(L, Bm, unit=unit)
        torch.cuda.synchronize()
        err = float((X_k - X_p).abs().max())
        scale = float(X_p.abs().max())
        emit("kernel_trsm_left_lower", shape=[v, C], dtype=str(dt), unit=unit, strided=strided,
             max_abs_err=err, rel_err=err / scale, tol_rel=FUSED_REL_TOL)
        if not err <= FUSED_REL_TOL * scale:
            raise AssertionError(f"trsm_left_lower [{v}, {C}] {dt} off by {err} (scale {scale})")
        if (v, C) != (CONFLUX_V, N):
            continue
        rows.append({
            "name": "trsm_left_lower", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/trsm.cu",
            "replaces": "src/repro/kernels/trsm.py:115",
            "max_abs_err": err, "ms": time_ms(lambda: ops.trsm_left_lower(L, Bm)),
            "plain_ms": time_ms(lambda: ref.trsm_left_lower(L, Bm)),
            **bound(4 * (v * v + 2 * v * C), v * (v - 1) * C),
            "library_ms": time_ms(lambda: torch.linalg.solve_triangular(
                L, Bm, upper=False, unitriangular=True)),
            **device_fields(lambda: ops.trsm_left_lower(L, Bm),
                            lambda: torch.linalg.solve_triangular(
                                L, Bm, upper=False, unitriangular=True)),
            "library": "torch.linalg.solve_triangular(L, B, upper=False, unitriangular=True)",
        })

    Bb, v, C = 256, CONFLUX_V, 512
    for unit in (True, False):
        L = lower((Bb,), v, unit, torch.float32)
        Bm = torch.randn(Bb, v, C, generator=gen, device=dev)
        X_k = ops.trsm_left_lower_batched(L, Bm, unit=unit)
        X_p = ref.trsm_left_lower_batched(L, Bm, unit=unit)
        torch.cuda.synchronize()
        err = float((X_k - X_p).abs().max())
        scale = float(X_p.abs().max())
        lanes_equal = sum(torch.equal(ops.trsm_left_lower(L[b], Bm[b], unit=unit), X_k[b])
                          for b in range(Bb))
        emit("kernel_trsm_left_lower_batched", shape=[Bb, v, C], unit=unit, max_abs_err=err,
             rel_err=err / scale, tol_rel=FUSED_REL_TOL, lanes_equal_single=lanes_equal)
        if not (err <= FUSED_REL_TOL * scale and lanes_equal == Bb):
            raise AssertionError(f"trsm_left_lower_batched: error {err} (scale {scale}), "
                                 f"{lanes_equal} of {Bb} lanes equal the single call")
    rows.append({
        "name": "trsm_left_lower_batched", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trsm.cu",
        "replaces": "src/repro/kernels/trsm.py:133",
        "max_abs_err": err, "ms": time_ms(lambda: ops.trsm_left_lower_batched(L, Bm, unit=False)),
        "plain_ms": time_ms(lambda: ref.trsm_left_lower_batched(L, Bm, unit=False)),
        **bound(4 * Bb * (v * v + 2 * v * C), Bb * (v * (v - 1) + v) * C),
        "library_ms": time_ms(lambda: torch.linalg.solve_triangular(L, Bm, upper=False)),
        **device_fields(lambda: ops.trsm_left_lower_batched(L, Bm, unit=False),
                        lambda: torch.linalg.solve_triangular(L, Bm, upper=False)),
        "library": "batched torch.linalg.solve_triangular(L, B, upper=False)",
    })
    return rows


def conflux_p1_path(dev, gen, sequential_execute_s: float) -> dict:
    """plan(N, strategy="conflux", grid=GridConfig(1, 1, 1, 32, N)) through
    the entry points, in-process, with both hot loops.  Returns the flat
    run's launches (the path of trsm_left_lower)."""
    from repro_torch.api import GridConfig, SolverConfig, plan
    from repro_torch.kernels import fused_schur as fs_mod

    A = torch.randn(N, N, generator=gen, device=dev)
    b = torch.randn(N, generator=gen, device=dev)
    steps = N // CONFLUX_V
    grid = GridConfig(1, 1, 1, CONFLUX_V, N)
    # At Px = 1 the tournament factors each panel twice: the local panel,
    # then its v winners (`_local_lu::tournament`).
    want = {"windowed": expected_launches(lu_panel=2 * steps, trsm_right_upper=steps,
                                          fused_trsm_schur=steps),
            "flat": expected_launches(lu_panel=2 * steps, trsm_right_upper=steps,
                                      trsm_left_lower=steps, schur_update=steps)}
    launches = {}
    rows = {}
    for hotloop in ("windowed", "flat"):
        p = plan(N, SolverConfig(strategy="conflux", grid=grid, hotloop=hotloop))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fact = p.execute(A)
        torch.cuda.synchronize()
        execute_s = time.perf_counter() - t0
        launches[hotloop] = read_launches()
        t0 = time.perf_counter()
        x = fact.solve(b)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        resid = hpl_residual(A, x, b)
        rows[hotloop] = fact.rows
        # The windowed loop's last fused call, on its narrowest window of
        # the carried matrix (row stride > C), took the TMA stream.
        fused_mode = fs_mod.fused_trsm_schur.mode if hotloop == "windowed" else None
        emit("conflux_p1_path", N=N, hotloop=hotloop, grid=str(fact.grid),
             strategy=fact.strategy, backend=fact.backend, launches=launches[hotloop],
             execute_s=execute_s, solve_s=solve_s, hpl_residual=resid,
             comm_total=fact.comm["total"], x_finite=bool(torch.isfinite(x).all()),
             sequential_execute_s=sequential_execute_s, last_fused_mode=fused_mode)
        if fact.backend != "cuda" or fact.strategy != "conflux":
            raise AssertionError(f"conflux path ran {fact.strategy!r} on {fact.backend!r}")
        if hotloop == "windowed" and fused_mode != "tma":
            raise AssertionError(f"the windowed conflux step's fused call took {fused_mode!r}")
        if launches[hotloop] != want[hotloop]:
            raise AssertionError(f"conflux {hotloop}: expected launches {want[hotloop]}, "
                                 f"got {launches[hotloop]}")
        if not (torch.isfinite(x).all() and resid < HPL_RESIDUAL_MAX):
            raise AssertionError(f"conflux {hotloop} HPL scaled residual {resid}")
        del fact, x
        emit("profile_conflux_p1_execute", hotloop=hotloop, **profile_once(lambda: p.execute(A)))
        del p
        torch.cuda.empty_cache()
    diff = (rows["windowed"] != rows["flat"]).nonzero()
    emit("conflux_p1_windowed_vs_flat", N=N,
         first_pivot_difference=int(diff[0]) if len(diff) else None)
    del A, b
    torch.cuda.empty_cache()
    return launches["flat"]


def min_pivot_gap(A: torch.Tensor) -> float:
    """The smallest relative gap between the two largest candidates of a
    column under partial pivoting, in f64.  Where it is near f32's rounding,
    two f32 paths that round differently may both rightly pick either row."""
    F = A.double().clone()
    gaps = []
    for k in range(F.shape[0] - 1):
        vals, idx = F[k:, k].abs().topk(2)
        gaps.append((vals[0] - vals[1]) / vals[0])
        rows = torch.stack((torch.tensor(k, device=F.device), idx[0] + k))
        F[rows] = F[rows.flip(0)]
        F[k + 1:, k] /= F[k, k]
        F[k + 1:, k + 1:] -= F[k + 1:, k, None] * F[k, None, k + 1:]
    return float(torch.stack(gaps).min())


def conflux_p1_plain_1024(dev) -> None:
    """The 1x1x1 conflux kernel path against the plain path (backend "ref")
    at N = 1024, both hot loops; windowed and flat must pick the same pivots.
    The matrix has a generator of its own, so that it does not change when
    an earlier phase draws more or fewer numbers; its `min_pivot_gap` is
    reported beside the check."""
    from repro_torch.api import GridConfig, SolverConfig, plan

    n = 1024
    A = torch.randn(n, n, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    gap = min_pivot_gap(A)
    grid = GridConfig(1, 1, 1, CONFLUX_V, n)
    facts = {(hl, bk): plan(n, SolverConfig(strategy="conflux", grid=grid, hotloop=hl,
                                            backend=bk)).execute(A)
             for hl in ("windowed", "flat") for bk in ("cuda", "ref")}
    eps = torch.finfo(torch.float32).eps
    check = {}
    for hl in ("windowed", "flat"):
        k, p_ = facts[hl, "cuda"], facts[hl, "ref"]
        err = float((k.F - p_.F).abs().max())
        tol = LU_F_TOL_FACTOR * n * eps * float(p_.F.abs().max())
        check[f"{hl}_rows_equal_plain"] = torch.equal(k.rows, p_.rows)
        check[f"{hl}_F_within_tol"] = err <= tol
        emit("conflux_p1_plain_1024", hotloop=hl, F_max_abs_err=err, tol=tol,
             rows_equal=check[f"{hl}_rows_equal_plain"], min_pivot_gap=gap)
    w, f = facts["windowed", "cuda"], facts["flat", "cuda"]
    check["windowed_rows_equal_flat"] = torch.equal(w.rows, f.rows)
    emit("conflux_p1_windowed_vs_flat_1024", rows_equal=check["windowed_rows_equal_flat"],
         F_bit_identical=torch.equal(w.F, f.F), F_max_abs_diff=float((w.F - f.F).abs().max()),
         plain_F_bit_identical=torch.equal(facts["windowed", "ref"].F, facts["flat", "ref"].F))
    if not all(check.values()):
        raise AssertionError(f"conflux at N={n}: {check}")


# Engines on the distributed strategies (module item 8), one process: a
# 1x1x1 grid at the full N for conflux (windowed) and cholesky25d (SPD A),
# and at 4096 for baseline2d, whose partial pivoting makes a step per
# column.  Ragged requests at n in SERVE_MIN_N..SERVE_N ride each engine's
# batched sequential sibling (64 systems at N would need 68 GB).
P1_ENGINE_CASES = (("conflux", N), ("cholesky25d", N), ("baseline2d", 4096))
# The launches of one 1x1x1 windowed execute of n / v steps, by strategy:
# conflux factors each panel twice (the tournament, then the pivoted panel),
# cholesky25d factors its diagonal block once, and baseline2d pivots its
# panel column by column in plain PyTorch, so it launches no `lu_panel`.
P1_ENGINE_LAUNCHES = {
    "conflux": lambda steps: dict(lu_panel=2 * steps, trsm_right_upper=steps,
                                  fused_trsm_schur=steps),
    "cholesky25d": lambda steps: dict(chol_panel=steps, trsm_right_upper=steps,
                                      fused_trsm_schur=steps),
    "baseline2d": lambda steps: dict(trsm_right_upper=steps, fused_trsm_schur=steps),
}
P1_ENGINE_RHS, P1_RAGGED = 4, 64
LU_BATCHED_KERNELS = ("lu_panel_batched", "fused_trsm_schur_batched")


def _only_batched(launches: dict, kernels) -> bool:
    """Every kernel of `kernels` launched, and no other."""
    return (all(launches[k] > 0 for k in kernels)
            and not any(c for k, c in launches.items() if k not in kernels))


def serving_distributed_p1(dev) -> dict:
    """`SolveEngine` and `AsyncSolveEngine` on the distributed strategies,
    each on a 1x1x1 grid in this process, through the entry points.

    Per engine: `solve(A, b)`, `resolve(2 b)` and P1_ENGINE_RHS RHS through
    `submit` / `flush`.  The solve's launches must equal those of one
    `plan(n, same config).execute(A)` and the closed form of
    P1_ENGINE_LAUNCHES (for conflux `conflux_p1_path`'s: 2 n / v `lu_panel`
    at Px = 1), its x must equal that
    plan's `solve(b)` bit for bit, every answer's HPL residual must be
    under 16, and `stats()` must name the strategy and grid with 1
    factorization and 2 solves (6 after the flush).  Then P1_RAGGED ragged
    requests through `submit_system` / `flush_systems`, and an
    `AsyncSolveEngine` on the same config (`engine.factor(A)`, then the RHS
    through `submit_rhs` and the requests again as whole systems): only
    the batched kernels of the engine's kind may launch there.  Returns the
    solves' launches by strategy.  Draws from a generator of its own."""
    import numpy as np
    from repro_torch.api import GridConfig, SolverConfig, plan
    from repro_torch.serving import AsyncSolveEngine, SolveEngine

    gen = torch.Generator(device=dev).manual_seed(28)
    out = {}
    for i, (strategy, n) in enumerate(P1_ENGINE_CASES):
        chol = strategy == "cholesky25d"
        cfg = SolverConfig(strategy=strategy, grid=GridConfig(1, 1, 1, CONFLUX_V, n))
        A = spd((n, n), gen, dev) if chol else torch.randn(n, n, generator=gen, device=dev)
        b = torch.randn(n, generator=gen, device=dev)
        rhs = torch.randn(P1_ENGINE_RHS, n, generator=gen, device=dev)
        p = plan(n, cfg)
        reset_launches()
        fact = p.execute(A)
        torch.cuda.synchronize()
        plan_launches = read_launches()
        x_plan = fact.solve(b)
        del fact
        eng = SolveEngine(n, cfg)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = eng.solve(A, b)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = read_launches()
        x2 = eng.resolve(2 * b)
        st = eng.stats()
        tickets = [eng.submit(r) for r in rhs]
        flushed = eng.flush()
        st_flush = eng.stats()
        resid = {"solve": hpl_residual(A, x, b), "resolve": hpl_residual(A, x2, 2 * b),
                 "flush": max(hpl_residual(A, flushed[t], r) for t, r in zip(tickets, rhs))}
        steps = n // CONFLUX_V
        want = expected_launches(**P1_ENGINE_LAUNCHES[strategy](steps))
        problems = []
        if not (launches == plan_launches == want):
            problems.append(f"launches {launches}, plan's {plan_launches}, want {want}")
        if not same_bits(x, x_plan):
            problems.append("x differs from plan(...).execute(A).solve(b)")
        if not max(resid.values()) < HPL_RESIDUAL_MAX:
            problems.append(f"HPL residuals {resid}")
        if (st["strategy"], st["grid"], st["factorizations"], st["solves"]) != (
                strategy, str(GridConfig(1, 1, 1, CONFLUX_V, n)), 1, 2):
            problems.append(f"stats after solve + resolve {st}")
        if (st_flush["solves"], st_flush["batched_rhs"]) != (2 + P1_ENGINE_RHS, P1_ENGINE_RHS):
            problems.append(f"stats after the flush {st_flush}")
        emit("serving_distributed_p1", strategy=strategy, N=n, grid=st["grid"],
             solve_s=solve_s, factor_s=st["factor_s_total"], launches={k: c for k, c in
                                                                         launches.items() if c},
             x_bit_identical_plan=same_bits(x, x_plan), hpl_residual=resid,
             stats={k: st_flush[k] for k in ("strategy", "grid", "factorizations", "solves",
                                             "batched_solves", "batched_rhs")})
        del x, x2, x_plan, flushed

        # Ragged whole systems on the batched sibling, sync then async.
        kernels = CHOL_BATCHED_KERNELS if chol else LU_BATCHED_KERNELS
        requests = (_spd_requests if chol else _requests)(np.random.default_rng(40 + i),
                                                          P1_RAGGED)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tickets = [eng.submit_system(Ar, br) for Ar, br in requests]
        answers = eng.flush_systems()
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        sync_launches = read_launches()
        sync_resid = _check_answers(requests, [answers[t] for t in tickets],
                                    f"serving_distributed_p1 {strategy}")
        a = AsyncSolveEngine(n, cfg, max_batch=ASYNC_MAX_BATCH, max_delay_ms=ASYNC_DELAY_MS)
        a.engine.factor(A)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rhs_futs = [a.submit_rhs(r) for r in rhs]
        sys_futs = [a.submit(Ar, br) for Ar, br in requests]
        rhs_x = [f.result(timeout=300) for f in rhs_futs]
        sys_x = [f.result(timeout=300) for f in sys_futs]
        torch.cuda.synchronize()
        async_s = time.perf_counter() - t0
        a.close()
        async_launches = read_launches()
        ast = a.stats()["async"]
        async_resid = max(_check_answers(requests, sys_x, f"serving_distributed_p1 async "
                                                          f"{strategy}"),
                          max(hpl_residual(A, xr, r) for xr, r in zip(rhs_x, rhs)))
        emit("serving_distributed_p1_ragged", strategy=strategy, N=n, requests=P1_RAGGED,
             sync_s=sync_s, sync_launches={k: c for k, c in sync_launches.items() if c},
             sync_hpl_residual_max=sync_resid, async_s=async_s,
             async_launches={k: c for k, c in async_launches.items() if c},
             async_hpl_residual_max=async_resid, async_served=ast["served"],
             async_flushes=ast["flushes"], async_failed=ast["failed"])
        if not _only_batched(sync_launches, kernels):
            problems.append(f"flush_systems launched {sync_launches}, want only {kernels}")
        if not _only_batched(async_launches, kernels):
            problems.append(f"the async engine launched {async_launches}, want only {kernels}")
        if ast["served"] != P1_RAGGED + P1_ENGINE_RHS or ast["failed"] or not (
                async_resid < HPL_RESIDUAL_MAX):
            problems.append(f"async served {ast['served']}, failed {ast['failed']}, HPL "
                            f"{async_resid}")
        if problems:
            raise AssertionError(f"serving_distributed_p1 {strategy}: " + "; ".join(problems))
        out[strategy] = launches
        del eng, a, A, b, rhs, rhs_x, sys_x, answers
        torch.cuda.empty_cache()
    return out


def _grid_rank(rank: int, out_dir: str, device: str) -> None:
    """One of GRID_WORLD ranks, all on one device: runs GRID_CASES through the
    entry points and writes what it saw to out_dir/rank<r>.json.  The ranks
    share one mesh per grid shape, passed to `plan(..., mesh=...)`."""
    import hashlib

    import torch.distributed as dist
    from repro_torch.analysis import audit, trace
    from repro_torch.api import GridConfig, SolverConfig, plan
    from repro_torch.core.lu.baseline2d import scalapack2d_grid
    from repro_torch.core.lu.conflux import make_lu_mesh

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host: loopback
    torch.set_num_threads(1)  # the ranks share the host's cores
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    # NCCL refuses two ranks on one device ("Duplicate GPU detected"); gloo
    # takes CUDA tensors for all_reduce and broadcast, staging through the
    # host, and the schedules use no other collective.
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
                            world_size=GRID_WORLD)
    out, meshes, kept = {}, {}, {}
    try:
        for name, strategy, n, hotloop, backend, compute in GRID_CASES:
            gen = torch.Generator(device=dev).manual_seed(n)  # alike on every rank
            A, b = _grid_inputs(strategy, n, compute, gen, dev)
            grid = (scalapack2d_grid(n, GRID_WORLD, v=CONFLUX_V) if strategy == "baseline2d"
                    else GridConfig(2, 2, 2, CONFLUX_V, n))
            shape = (grid.Px, grid.Py, grid.c)
            if shape not in meshes:
                meshes[shape] = make_lu_mesh(grid)
            p = plan(n, SolverConfig(strategy=strategy, grid=grid, hotloop=hotloop,
                                     backend=backend, compute_dtype=compute),
                     device=dev, mesh=meshes[shape])
            dist.barrier()
            update = _wrappers()["schur_update"]
            update.mode = None
            reset_launches()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with trace.recording() as rec:  # the execute's own trace
                fact = p.execute(A)
                if cuda:
                    torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {k: c for k, c in read_launches().items() if c}
            text = rec.text()
            (Path(out_dir) / f"trace_{name}_rank{rank}.txt").write_text(text)
            _, comm = audit.check_comm_conformance(p, text=text)
            refined = fact.solve(b, refine_tol=MIXED_LOW_TOL) if compute else None
            x = fact.solve(b) if refined is None else refined.x
            bits = fact.F.cpu()
            bits = bits.view(torch.int16) if bits.element_size() == 2 else bits
            out[name] = {
                "wall_s": wall_s, "hpl_residual": hpl_residual(A, x, b),
                "F": hashlib.sha256(bits.numpy().tobytes()).hexdigest(),
                "rows": hashlib.sha256(fact.rows.cpu().numpy().tobytes()).hexdigest(),
                "rows_list": fact.rows.tolist() if n == 1024 else None,
                "launches": launches, "comm_total": fact.comm["total"],
                "comm": {**{k: comm[k] for k in ("extracted_bytes", "predicted_bytes", "rel_err",
                                                 "schedule_bytes", "lower_bound_bytes",
                                                 "traced_by_site", "active", "collectives")},
                         "model_by_site": {k: x for k, x in comm["model"].items()
                                           if k != "total" and x}},
                "last_schur_update_mode": update.mode,
                "grid": str(fact.grid), "kind": fact.kind, "factor_dtype": str(fact.F.dtype),
                "converged": None if refined is None else bool(refined.converged),
                "refinement_iters": None if refined is None else refined.refinement_iters,
            }
            if compute and backend == "cuda":
                kept[name] = fact
            elif compute:  # the plain path against the kernel path before it
                k = kept.pop(name.removesuffix("_plain"))
                diff = (k.rows != fact.rows).nonzero()
                err = float((k.F.float() - fact.F.float()).abs().max())
                out[name]["vs_kernel_path"] = {
                    "first_pivot_difference": int(diff[0]) if len(diff) else None,
                    "F_max_abs_err": err, "tol": mixed_path_tol(fact.F),
                }
            del p, fact, x, A
        out["engines"] = _grid_engines(dev)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _grid_inputs(strategy: str, n: int, compute, gen, dev):
    """(A, b) of a GRID_CASES case, drawn alike on every rank: SPD for
    cholesky25d, `well_conditioned` for a 2-byte compute dtype, else
    standard normal."""
    if strategy == "cholesky25d":
        A = spd((n, n), gen, dev)
    elif compute:
        A = well_conditioned((n, n), gen, dev)
    else:
        A = torch.randn(n, n, generator=gen, device=dev)
    return A, torch.randn(n, generator=gen, device=dev)


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _grid_engines(dev) -> dict:
    """One rank's engine cases (GRID_ENGINE_CASES) on the 8-rank group:
    `solve` + `resolve(2 b)` + a GRID_ENGINE_RHS-RHS `flush` each, and an
    `AsyncSolveEngine` on the explicit conflux grid (`engine.factor(A)` on
    every rank, then GRID_ASYNC_RHS `submit_rhs` futures).  Each case's x
    is held against `plan(N, config).execute(A).solve(b)` on the same A
    and b, run here.  Returns digests,
    HPL residuals and the resolved strategy and grid per case."""
    import torch.distributed as dist
    from repro_torch.api import GridConfig, SolverConfig, plan
    from repro_torch.core.lu.baseline2d import scalapack2d_grid
    from repro_torch.serving import AsyncSolveEngine, SolveEngine

    n = GRID_ENGINE_N
    out = {}
    for name, strategy in GRID_ENGINE_CASES:
        gen = torch.Generator(device=dev).manual_seed(n)
        A, b = _grid_inputs(strategy or "conflux", n, None, gen, dev)
        rhs = torch.randn(GRID_ASYNC_RHS, n, generator=gen, device=dev)
        if strategy is None:
            cfg = SolverConfig()
        else:
            grid = (scalapack2d_grid(n, GRID_WORLD, v=CONFLUX_V) if strategy == "baseline2d"
                    else GridConfig(2, 2, 2, CONFLUX_V, n))
            cfg = SolverConfig(strategy=strategy, grid=grid)
        eng = SolveEngine(n, cfg, device=dev)
        dist.barrier()
        reset_launches()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        x = eng.solve(A, b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        solve_s = time.perf_counter() - t0
        launches = {k: c for k, c in read_launches().items() if c}
        x2 = eng.resolve(2 * b)
        tickets = [eng.submit(r) for r in rhs[:GRID_ENGINE_RHS]]
        flushed = eng.flush()
        flushed = torch.stack([flushed[t] for t in tickets])
        x_ref = plan(n, cfg, device=dev).execute(A).solve(b)
        st = eng.stats()
        case = {"strategy": st["strategy"], "grid": st["grid"], "solve_s": solve_s,
                "launches": launches,
                "x_equals_plan": same_bits(x, x_ref),
                "digests": {"x": _digest(x), "resolve": _digest(x2), "flush": _digest(flushed)},
                "hpl_residual": max([hpl_residual(A, x, b), hpl_residual(A, x2, 2 * b)]
                                    + [hpl_residual(A, xf, r) for xf, r in zip(flushed, rhs)])}
        if strategy == "conflux":
            a = AsyncSolveEngine(n, cfg, device=dev, max_batch=GRID_ASYNC_RHS,
                                 max_delay_ms=GRID_ASYNC_DELAY_MS)
            a.engine.factor(A)
            futs = [a.submit_rhs(r) for r in rhs]
            xs = torch.stack([f.result(timeout=120) for f in futs])
            a.close()
            case["digests"]["async_rhs"] = _digest(xs)
            case["hpl_residual"] = max([case["hpl_residual"]]
                                       + [hpl_residual(A, xf, r) for xf, r in zip(xs, rhs)])
            case["async_served"] = a.stats()["async"]["served"]
            case["async_flushes"] = a.stats()["async"]["flushes"]
        out[name] = case
        del eng, A, b, x, x2, flushed, x_ref
    return out


def grid_8ranks(device: str = "cuda:0") -> dict:
    """GRID_WORLD ranks share cuda:0 through gloo and run GRID_CASES; every
    rank must return the same F and rows with HPL < 16, and the kernel path
    must pick the plain path's pivots at N = 1024 and in bf16, where its F
    must also lie within `mixed_path_tol` of the plain path's and its last
    schur_update (the flat hot loop's) must take the wgmma stream.  Each
    rank's execute is traced (`analysis.trace.recording`): its collective
    bytes must equal the port's executed model (`audit.executed_comm_bytes`)
    exactly, site by site, and every group's ranks must issue the same
    collectives (`audit.check_mesh_uniformity`); the lines give them beside
    the schedule's volume and the X-partitioning bound.  A rank that fails
    or outlives GRID_TIMEOUT_S fails the phase.

    Then each rank serves GRID_ENGINE_CASES (module item 8): every answer
    of an engine (`solve`, `resolve`, the flushed RHS, the async futures)
    must be bit-identical across the ranks with HPL < 16, its `solve` x
    bit-identical to that rank's `plan(...).execute(A).solve(b)`, and the
    default config must resolve alike on every rank.  Returns rank 0's
    launches of each engine's `solve`."""
    import multiprocessing as mp
    import tempfile

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_grid_rank, args=(r, out_dir, device))
                 for r in range(GRID_WORLD)]
        t0 = time.perf_counter()
        deadline = time.monotonic() + GRID_TIMEOUT_S
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if hung or failed:
            raise AssertionError(f"grid_8ranks: ranks {failed} failed (of which {hung} "
                                 f"outlived {GRID_TIMEOUT_S} s)")
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(GRID_WORLD)]
        traces = {name: [(Path(out_dir) / f"trace_{name}_rank{r}.txt").read_text()
                         for r in range(GRID_WORLD)] for name, *_ in GRID_CASES}
    problems = []
    from repro_torch.analysis import audit

    for name, strategy, n, hotloop, backend, compute in GRID_CASES:
        comm = [r[name]["comm"] for r in ranks]
        mesh = audit.check_mesh_uniformity(traces[name], name)
        mesh_errors = [f.detail for f in mesh if f.severity == "error"]
        exact = all(c["rel_err"] == 0.0 and c["traced_by_site"] == c["model_by_site"]
                    for c in comm)
        emit("grid_8ranks_comm", case=name, N=n,
             traced_bytes=[c["extracted_bytes"] for c in comm],
             model_bytes=[c["predicted_bytes"] for c in comm],
             traced_by_site_rank0=comm[0]["traced_by_site"],
             collectives=[c["collectives"] for c in comm],
             schedule_bytes=comm[0]["schedule_bytes"],
             lower_bound_bytes=comm[0]["lower_bound_bytes"],
             active=[c["active"] for c in comm], traced_equals_model=exact,
             mesh_uniformity_errors=mesh_errors)
        if not exact or mesh_errors:
            problems.append(f"{name}: traced bytes {[c['extracted_bytes'] for c in comm]} vs "
                            f"model {[c['predicted_bytes'] for c in comm]}, mesh {mesh_errors}")
    for name, strategy, n, hotloop, backend, compute in GRID_CASES:
        per = [r[name] for r in ranks]
        same = len({(x["F"], x["rows"]) for x in per}) == 1
        hpl = max(x["hpl_residual"] for x in per)
        emit("grid_8ranks", case=name, strategy=strategy, N=n, hotloop=hotloop,
             backend=backend, compute_dtype=compute, factor_dtype=per[0]["factor_dtype"],
             grid=per[0]["grid"], wall_s=max(x["wall_s"] for x in per),
             hpl_residual_max=hpl, ranks_bit_identical=same,
             converged=per[0]["converged"], refinement_iters=per[0]["refinement_iters"],
             vs_kernel_path=per[0].get("vs_kernel_path"),
             comm_total=per[0]["comm_total"], launches_per_rank=[x["launches"] for x in per],
             last_schur_update_modes=[x["last_schur_update_mode"] for x in per])
        if not (same and hpl < HPL_RESIDUAL_MAX):
            problems.append(f"{name}: ranks identical {same}, HPL {hpl}")
        if compute and not all(x["converged"] for x in per):
            problems.append(f"{name}: refinement to {MIXED_LOW_TOL} did not converge")
        if compute and backend == "cuda" and any(
                x["last_schur_update_mode"] != MIXED_UPDATE_MODE["schur_update"] for x in per):
            problems.append(f"{name}: last schur_update modes "
                            f"{[x['last_schur_update_mode'] for x in per]}")
        vs = per[0].get("vs_kernel_path")
        if vs and vs["first_pivot_difference"] is not None:
            problems.append(f"{name}: pivot {vs['first_pivot_difference']} differs from the "
                            f"kernel path's")
        if vs and not vs["F_max_abs_err"] <= vs["tol"]:
            problems.append(f"{name}: the kernel path's F is {vs['F_max_abs_err']} from the "
                            f"plain path's, over {vs['tol']}")
        if backend == "cuda" and hotloop == "flat":
            steps = n // CONFLUX_V
            if any(x["launches"].get("trsm_left_lower") != steps for x in per):
                problems.append(f"{name}: trsm_left_lower launches per rank "
                                f"{[x['launches'].get('trsm_left_lower') for x in per]} != {steps}")
    for name, strategy in GRID_ENGINE_CASES:
        per = [r["engines"][name] for r in ranks]
        same = len({json.dumps(x["digests"], sort_keys=True) for x in per}) == 1
        resolved = {(x["strategy"], x["grid"]) for x in per}
        hpl = max(x["hpl_residual"] for x in per)
        emit("grid_8ranks_engine", case=name, N=GRID_ENGINE_N,
             config="SolverConfig()" if strategy is None else strategy,
             strategy=per[0]["strategy"], grid=per[0]["grid"], ranks_agree=len(resolved) == 1,
             answers_bit_identical_across_ranks=same,
             answers_differing=[k for k in per[0]["digests"]
                                if len({x["digests"][k] for x in per}) > 1],
             x_bit_identical_plan=[x["x_equals_plan"] for x in per],
             hpl_residual_max=hpl,
             solve_s=max(x["solve_s"] for x in per), launches_rank0=per[0]["launches"],
             async_flushes=[x.get("async_flushes") for x in per] if strategy == "conflux"
             else None,
             async_served=[x.get("async_served") for x in per] if strategy == "conflux"
             else None)
        if not (same and len(resolved) == 1 and all(x["x_equals_plan"] for x in per)
                and hpl < HPL_RESIDUAL_MAX):
            problems.append(f"{name}: answers identical {same}, resolved {resolved}, x equal "
                            f"to the plan's {[x['x_equals_plan'] for x in per]}, HPL {hpl}")
        if strategy is not None and per[0]["strategy"] != strategy:
            problems.append(f"{name}: the engine runs {per[0]['strategy']!r}")
        if not all(x["launches"] for x in per):  # the factorization ran the kernels
            problems.append(f"{name}: launches per rank {[x['launches'] for x in per]}")
        if strategy == "conflux" and any(x["async_served"] != GRID_ASYNC_RHS for x in per):
            problems.append(f"{name}: async served {[x['async_served'] for x in per]}")
    for hotloop in ("windowed", "flat"):
        k = ranks[0][f"conflux_{hotloop}_1024"]["rows_list"]
        p_ = ranks[0][f"conflux_{hotloop}_1024_plain"]["rows_list"]
        emit("grid_8ranks_plain_1024", hotloop=hotloop, rows_equal=k == p_)
        if k != p_:
            problems.append(f"conflux {hotloop} at N=1024: pivots differ from the plain path")
    emit("grid_8ranks_total", ranks=GRID_WORLD, seconds=spawn_s)
    if problems:
        raise AssertionError("grid_8ranks: " + "; ".join(problems))
    return {f"grid_8ranks[{name}]": ranks[0]["engines"][name]["launches"]
            for name, _ in GRID_ENGINE_CASES}


# --------------------------------------------------------------------------
# The LM serving path (module item 13): flash_attention and mamba_scan.
# --------------------------------------------------------------------------

def attention_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs that the mask keeps, over one head."""
    if not causal:
        return S * S
    if window is None:
        return S * (S + 1) // 2
    return sum(min(q + 1, window) for q in range(S))


def flash_build_report() -> list[dict]:
    """ptxas's registers and spills for each instantiation of
    `csrc/flash_attention.cu`, from this process's build, with the dynamic
    shared memory each bf16 instantiation asks for at launch."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    smem = _build.function("flash_attention", "flash_attention_bf16_smem", (ctypes.c_int,))
    report = []
    lines = _build.build_log.get("flash_attention", "").splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '.*flash_fwd_(bf16|f32)_kernelILi(\d+)ELb([01])E",
                      line)
        if not m:
            continue
        text = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
        dtype, width = m.group(1), int(m.group(2))
        scores = ", bf16 scores" if m.group(3) == "1" else ""
        entry = {"kernel": f"{dtype}<{width}{scores}>",
                 "registers": int(regs.group(1)) if regs else None,
                 "spill_stores": int(spill.group(1)) if spill else None,
                 "spill_loads": int(spill.group(2)) if spill else None}
        if dtype == "bf16":  # the template argument is hd padded to 64
            entry["dynamic_smem_bytes"] = smem(width)
        report.append(entry)
    return report


def lm_kernel_rows(dev, gen) -> list[dict]:
    """flash_attention and mamba_scan against their plain versions on the
    card, at the LM path's shapes and beyond.  Returns the two rows of the
    kernels line (launches filled in later)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    emit("flash_ptxas", instantiations=flash_build_report())
    rows = []
    # (B, S, H, KV, hd, dtype, causal, window, softcap): qwen3-8b's prefill
    # (the row), f32, gemma2-9b's local layer (hd = 256, window, softcap), a
    # ragged S, bidirectional, and the attention shapes of four more configs
    # in configs/ at S = 2048: hubert-xlarge (hd = 80, bidirectional),
    # phi3-mini (hd = 96), starcoder2-15b (48 / 4 heads: gq = 12) and
    # llama4-maverick (40 / 8: gq = 5; neither divides a 128-row tile), and
    # qwen3-moe-235b-a22b's prefill as lm_serve_qwen3_moe gives it (64 / 4:
    # gq = 16, B = 4); then the training phases' shapes: lm_train_qwen3's
    # (B = 2, bf16), lm_train_plain_check's is the f32 case, and
    # lm_train_resume's reduced qwen3 and jamba (f32, hd = 16, S = 16); then
    # lm_train_dp's f32 shapes: the one-rank run's (B = 2) and a rank's (B = 1).
    cases = ((4, LM_PROMPT, 32, 8, 128, torch.bfloat16, True, None, None),
             (1, 1024, 32, 8, 128, torch.float32, True, None, None),
             (1, LM_PROMPT, 16, 8, 256, torch.bfloat16, True, 512, 50.0),
             (2, 1000, 8, 2, 64, torch.bfloat16, False, None, None),
             (1, LM_PROMPT, 16, 16, 80, torch.bfloat16, False, None, None),
             (1, LM_PROMPT, 32, 32, 96, torch.bfloat16, True, None, None),
             (1, LM_PROMPT, 48, 4, 128, torch.bfloat16, True, None, None),
             (1, LM_PROMPT, 40, 8, 128, torch.bfloat16, True, None, None),
             (4, LM_PROMPT, 64, 4, 128, torch.bfloat16, True, None, None),
             (LM_TRAIN[0][2], LM_TRAIN_S, 32, 8, 128, torch.bfloat16, True, None, None),
             (LM_RESUME_B, LM_RESUME_S, 4, 2, 16, torch.float32, True, None, None),
             (LM_DP[2], LM_DP_S, 32, 8, 128, torch.float32, True, None, None),
             (LM_DP[2] // LM_DP_RANKS, LM_DP_S, 32, 8, 128, torch.float32, True, None, None))
    for B, S, H, KV, hd, dt, causal, window, softcap in cases:
        q = torch.randn(B, S, H, hd, generator=gen, device=dev, dtype=dt)
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev, dtype=dt)
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev, dtype=dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out_k = ops.flash_attention(q, k, v, **kw)
        out_p = ref.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        diff = (out_k.float() - out_p.float()).abs()
        err = float(diff.max())
        tol = FLASH_TOL[dt]
        within = bool((diff <= tol + tol * out_p.float().abs()).all())
        finite = bool(torch.isfinite(out_k).all())
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        elem = q.element_size()
        nbytes = elem * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        nops = 4 * B * H * hd * attention_pairs(S, causal, window)
        b = bound(nbytes, nops, BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS)
        emit("kernel_flash_attention", shape=[B, S, H, KV, hd], dtype=str(dt), causal=causal,
             window=window, softcap=softcap, max_abs_err=err, tol=tol, within_tol=within,
             finite=finite, ms=ms, **b)
        if not (within and finite):
            raise AssertionError(f"flash_attention {[B, S, H, KV, hd]} {dt} {kw}: error {err} "
                                 f"beyond {tol} (rtol and atol), finite {finite}")
        if len(rows) == 0:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            rows.append({
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:64",
                "max_abs_err": err, "ms": ms,
                "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v, **kw), reps=3),
                **b,
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)),
                **device_fields(lambda: ops.flash_attention(q, k, v, **kw),
                                lambda: F.scaled_dot_product_attention(
                                    qt, kt, vt, is_causal=True, enable_gqa=True)),
                "library": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
                           "on [B, H, S, hd] views",
            })
        del q, k, v, out_k, out_p, diff

    # mamba_scan at falcon-mamba-7b's prefill shape (the row), then the
    # training phases' shapes: lm_train_falcon_mamba's (B = 1, S = 2048),
    # lm_train_plain_check's (S = 1024) and lm_train_resume's reduced jamba.
    for B, S, di, N in ((2, LM_PROMPT, 8192, 16), (LM_TRAIN[1][2], LM_TRAIN_S, 8192, 16),
                        (1, LM_TRAIN_PLAIN_S, 8192, 16), (LM_RESUME_B, LM_RESUME_S, 128, 4)):
        a = torch.rand(B, S, di, N, generator=gen, device=dev).mul_(0.399).add_(0.6)
        bb = torch.randn(B, S, di, N, generator=gen, device=dev)
        C = torch.randn(B, S, N, generator=gen, device=dev)
        y_k, h_k = ops.mamba_scan(a, bb, C, return_state=True)
        y_p, h_p = ref.mamba_scan(a, bb, C, return_state=True)
        torch.cuda.synchronize()
        err = float((y_k - y_p).abs().max())
        scale = float(y_p.abs().max())
        check = {"y_within_tol": err <= MAMBA_Y_REL_TOL * scale,
                 "state_bit_identical": torch.equal(h_k, h_p),
                 "finite": bool(torch.isfinite(y_k).all() and torch.isfinite(h_k).all())}
        ms = time_ms(lambda: ops.mamba_scan(a, bb, C, return_state=True))
        b = bound(4 * (2 * B * S * di * N + B * S * N + B * S * di + B * di * N),
                  4 * B * S * di * N)
        emit("kernel_mamba_scan", shape=[B, S, di, N], max_abs_err=err, y_scale=scale,
             tol_rel=MAMBA_Y_REL_TOL, state_max_abs_err=float((h_k - h_p).abs().max()), ms=ms,
             **b, **check)
        if not all(check.values()):
            raise AssertionError(f"mamba_scan {[B, S, di, N]} disagrees with its plain version: "
                                 f"{check}, y error {err} (scale {scale})")
        if B == 2:  # the row's case, timed again below
            row_case = (a, bb, C, err, ms, b)
        del a, bb, C, y_k, y_p, h_k, h_p
    a, bb, C, err, ms, b = row_case
    rows.append({
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:46",
        "max_abs_err": err, "ms": ms,
        "plain_ms": time_ms(lambda: ref.mamba_scan(a, bb, C, return_state=True), reps=3),
        **b,
        "library_ms": None,
        **device_fields(lambda: ops.mamba_scan(a, bb, C, return_state=True)),
        "library": "none: no single PyTorch call computes a selective scan",
    })
    del a, bb, C, row_case
    torch.cuda.empty_cache()
    return rows


def _mixer_layers(cfg, kind: str) -> int:
    return cfg.n_groups * sum(1 for s in cfg.pattern if s.mixer.startswith(kind))


def lm_serve(arch: str, batch: int, layers: int | None = None, short: str | None = None) -> dict:
    """`ServeEngine.generate` on the full-width model through the entry
    points: B seeded 2048-token prompts, 32 greedy tokens; all published
    layers, or the first `layers`.  The counted run must launch each
    mixer's kernel once per layer of the prefill and nothing in the decode
    steps, within the card's memory.  Returns the launches of the counted
    run."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import SamplerConfig, ServeEngine

    phase = "lm_serve_" + (short or arch.split("-")[0].replace("falcon", "falcon_mamba"))
    cfg = get_config(arch)
    published_layers = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    max_len = LM_PROMPT + LM_NEW
    engine = ServeEngine(model, max_len=max_len, batch_size=batch,
                         sampler=SamplerConfig(max_new_tokens=LM_NEW))
    prompt_gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (batch, LM_PROMPT), generator=prompt_gen)
    # Warm-up: cuBLAS handles and the first launch of each kernel, on a short prompt.
    model.prefill({"tokens": prompts[:, :64].to(model.device)}, max_len=128)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outs = engine.generate(prompts.tolist())
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    stats = engine.stats
    n_attn, n_mamba = _mixer_layers(cfg, "attn"), _mixer_layers(cfg, "mamba")
    expected = expected_launches(flash_attention=n_attn, mamba_scan=n_mamba)
    tokens_ok = (len(outs) == batch and all(len(o) == LM_NEW for o in outs)
                 and all(0 <= t < cfg.vocab for o in outs for t in o))
    emit(phase, arch=arch, layers=cfg.n_layers, published_layers=published_layers,
         d_model=cfg.d_model, params=n_params,
         param_gib=sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30,
         dtype=str(model.dtype), backend=model.backend, build_s=build_s, batch=batch,
         prompt_len=LM_PROMPT, new_tokens=LM_NEW, prefill_s=stats["prefill_s"],
         decode_s=stats["decode_s"], decode_steps=stats["decode_steps"],
         decode_tokens_per_s=batch * stats["decode_steps"] / stats["decode_s"],
         ms_per_decode_step=1e3 * stats["decode_s"] / stats["decode_steps"],
         peak_gib=peak_gib, launches={k: c for k, c in launches.items() if c},
         launches_per_prefill={"flash_attention": n_attn, "mamba_scan": n_mamba},
         launches_per_decode_step=0, tokens_ok=tokens_ok, first_tokens=[o[:8] for o in outs])
    if launches != expected:
        raise AssertionError(f"{arch}: expected one prefill's launches {expected} and none in "
                             f"{stats['decode_steps']} decode steps, got {launches}")
    if not tokens_ok:
        raise AssertionError(f"{arch}: generate returned {[len(o) for o in outs]} tokens")
    if not peak_gib < torch.cuda.get_device_properties(0).total_memory / 2**30:
        raise AssertionError(f"{arch}: peak memory {peak_gib} GiB")

    # Where the time goes: one more prefill and one decode step after it,
    # each under the profiler; the decode step must launch no kernel.
    toks = prompts.to(model.device)
    name = phase.removeprefix("lm_serve_")
    result = []
    emit(f"profile_{name}_prefill",
         **profile_once(lambda: result.append(model.prefill({"tokens": toks}, max_len=max_len))))
    logits, caches = result.pop()
    if not (logits.shape == (batch, cfg.vocab) and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{arch}: prefill logits {tuple(logits.shape)} not finite")
    nxt = logits.argmax(-1)
    reset_launches()
    emit(f"profile_{name}_decode_step",
         **profile_once(lambda: result.append(model.decode_step(caches, nxt, LM_PROMPT))))
    step_launches = {k: c for k, c in read_launches().items() if c}
    if step_launches or not bool(torch.isfinite(result[0][0]).all()):
        raise AssertionError(f"{arch}: a decode step launched {step_launches}, or its logits "
                             f"are not finite")
    del engine, model, result, logits, caches, toks
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def lm_plain_check(arch: str, layers: int | None = None, dtype=None,
                   tol: float = LM_LOGIT_REL_TOL) -> None:
    """The first LM_PLAIN_GROUPS groups (or `layers` layers) of the
    full-width model in its parameter dtype (or `dtype`), kernel path
    against plain path (backend "ref") on the card, same weights: prefill
    logits within `tol` of max|logits|; the first greedy token at which the
    two paths part is reported, not held."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers or LM_PLAIN_GROUPS * len(cfg.pattern))
    prompt_gen = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (LM_PLAIN_B, LM_PLAIN_S), generator=prompt_gen)
    results = {}
    for backend in ("cuda", "ref"):
        model = build_model(cfg, backend=backend, seed=3, dtype=dtype)
        model_dtype = str(model.dtype)
        t = toks.to(model.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill({"tokens": t}, max_len=LM_PLAIN_S + LM_PLAIN_NEW)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        first = logits.float()
        seq = []
        nxt = logits.argmax(-1)
        for i in range(LM_PLAIN_NEW):
            seq.append(nxt.tolist())
            logits, caches = model.decode_step(caches, nxt, LM_PLAIN_S + i)
            nxt = logits.argmax(-1)
        results[backend] = (first, seq, prefill_s)
        del model, caches, logits
        gc.collect()
        torch.cuda.empty_cache()
    (lk, sk, tk), (lp, sp, tp) = results["cuda"], results["ref"]
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    diverge = next((i for i, (a, b) in enumerate(zip(sk, sp)) if a != b), None)
    emit("lm_plain_check", arch=arch, groups=cfg.n_groups, layers=cfg.n_layers,
         dtype=model_dtype, batch=LM_PLAIN_B, S=LM_PLAIN_S,
         logits_max_abs_err=err, logits_max_abs=scale, tol_rel=tol,
         prefill_s_kernels=tk, prefill_s_plain=tp, first_greedy_divergence=diverge,
         greedy_steps=LM_PLAIN_NEW)
    if not err <= tol * scale:
        raise AssertionError(f"{arch}: kernel and plain paths' logits differ by {err} "
                             f"(max |logits| {scale}, tolerance {tol} of it)")


def _train_batch(cfg, B: int, S: int, step: int) -> dict:
    from repro_torch.data import DataConfig, synthetic_batch

    return synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B), step, cfg)


def lm_train(arch: str, layers: int, batch: int, short: str) -> dict:
    """`make_train_step` on the full-width model, its first `layers` layers,
    bf16 parameters, AdamW with f32 moments, remat, B x LM_TRAIN_S `copy`
    tokens: LM_TRAIN_STEPS synchronized steps, each launching each mixer's
    kernel twice per layer (the forward and the remat recompute), finite
    losses and gradient norms.  Then one more step under the profiler.
    Returns the launches of the counted steps and the readings that the
    dryrun phase holds its prediction to (the median step's seconds, the
    peak bytes)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, init_train_state, make_train_step

    phase = f"lm_train_{short}"
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    opt_cfg = OptConfig(warmup_steps=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    state = init_train_state(model, torch.Generator(device=model.device).manual_seed(0), opt_cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    step_fn = make_train_step(model, opt_cfg)
    batches = [_train_batch(cfg, batch, LM_TRAIN_S, s) for s in range(LM_TRAIN_STEPS + 1)]
    torch.cuda.reset_peak_memory_stats()
    step_s, losses, norms = [], [], []
    reset_launches()
    for s in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[s])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    launches = read_launches()
    peak_bytes = torch.cuda.max_memory_allocated()
    peak_gib = peak_bytes / 2**30
    n_attn, n_mamba = _mixer_layers(cfg, "attn"), _mixer_layers(cfg, "mamba")
    per_step = {"flash_attention": 2 * n_attn, "mamba_scan": 2 * n_mamba}
    expected = expected_launches(**{k: LM_TRAIN_STEPS * c for k, c in per_step.items()})
    timed = sorted(step_s[1:])  # steps 2..6: the first builds cuBLAS plans and caches
    median_s = timed[len(timed) // 2]
    finite = all(math.isfinite(x) for x in losses + norms)
    emit(phase, arch=arch, layers=cfg.n_layers, published_layers=get_config(arch).n_layers,
         d_model=cfg.d_model, params=n_params, dtype=str(model.dtype),
         optimizer="adamw", moment_dtype=opt_cfg.moment_dtype, remat=True, batch=batch,
         seq=LM_TRAIN_S, steps=LM_TRAIN_STEPS, build_s=build_s, step_s=step_s,
         step_s_median_2_6=median_s, tokens_per_s=batch * LM_TRAIN_S / median_s,
         peak_gib=peak_gib, losses=losses, grad_norms=norms, finite=finite,
         launches={k: c for k, c in launches.items() if c}, launches_per_step=per_step)
    if launches != expected:
        raise AssertionError(f"{arch}: expected {LM_TRAIN_STEPS} steps' launches {expected}, "
                             f"got {launches}")
    if not finite:
        raise AssertionError(f"{arch}: losses {losses}, gradient norms {norms}")
    emit(f"profile_{short}_train_step",
         **profile_once(lambda: step_fn(state, batches[-1])))
    del state, model, step_fn, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"step_s_median_2_6": median_s, "peak_bytes": peak_bytes}


# The dry-run CLI's cells (`python -m repro_torch.launch.dryrun`, no card
# visible, each in its own process started at LM_TRAIN's first phase and
# read after lm_train_ep, within DRYRUN_CLI_TIMEOUT_S of its start): the
# 16x16 production mesh, train_4k, bf16; (arch, line suffix, ep parts held).
DRYRUN_CLI = (("qwen3-8b", "", None), ("qwen3-moe-235b-a22b", "_moe", 16))
DRYRUN_CLI_TIMEOUT_S = 600


def lm_dryrun(arch: str, layers: int, batch: int, train: dict) -> tuple[dict, dict, dict, dict]:
    """The dry-run tools (`repro_torch.launch.specs`, `launch.dryrun`) on the
    meta device for lm_train's configuration of `arch` (its first `layers`
    layers, bf16, AdamW with f32 moments, B = `batch`, LM_TRAIN_S, remat,
    one rank): the predicted state bytes (parameters, moments, gradients) at
    most lm_train's measured peak (`train`: its readings), and not a byte
    put on the card (`memory_allocated` and the peak unchanged).  Prints the
    counted FLOPs, the predicted bytes and the achieved rate (counted FLOPs
    over lm_train's median step) against H100_SXM's bf16 peak (reported,
    not held).  Also counts lm_train_fsdp's configuration (LM_DP in f32) on
    the (2, 1) mesh, lm_train_tp's qwen3 configuration on the (1, 2) mesh
    (`dryrun_tp`) and lm_train_ep's configuration on the (1, 2) mesh
    (`dryrun_ep`), whose ranks' state and wire bytes it returns for those
    phases to hold; and LM_SERVE_SHARDED's prefill and decode cells
    (`dryrun_serve`, one line a configuration), whose rank's parameter and
    cache bytes, JAX's per-device cache share (`dryrun.cache_share_bytes`)
    and wire bytes a prefill and a decode step it returns, by suffix, for
    lm_serve_sharded."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel import make_rules
    from repro_torch.parallel import Mesh

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    shape = ShapeSpec("lm_train", LM_TRAIN_S, batch, "train")
    with mock.patch.dict(SHAPES, {shape.name: shape}):
        rec, _ = dryrun.lower_cell(
            arch, shape.name, Mesh((1, 1), ("data", "model")), accum=1, remat=True,
            cfg_override=lambda c: dataclasses.replace(c, n_layers=layers))

    def sharded(name, cell_arch, cell_layers, cell_batch, mesh):  # f32, S = LM_DP_S
        cell = ShapeSpec(name, LM_DP_S, cell_batch, "train")
        with mock.patch.dict(SHAPES, {cell.name: cell}):
            return dryrun.lower_cell(
                cell_arch, cell.name, Mesh(mesh, ("data", "model")), accum=1, remat=True,
                cfg_override=lambda c: dataclasses.replace(
                    c, n_layers=cell_layers, param_dtype="float32"))[0]

    # lm_train_fsdp's configuration (f32) on its (2, 1) mesh: the sharded rank
    dp_arch, dp_layers, dp_batch = LM_DP
    fsdp_rec = sharded("lm_train_fsdp", dp_arch, dp_layers, dp_batch, (LM_DP_RANKS, 1))
    # lm_train_tp's qwen3 configuration and lm_train_ep's on the (1, 2) mesh
    tp_arch, tp_layers, tp_batch = LM_TP[0][:3]
    tp_rec = sharded("lm_train_tp", tp_arch, tp_layers, tp_batch, LM_TP_MESH)
    ep_arch, ep_layers, ep_batch = LM_EP[:3]
    ep_rec = sharded("lm_train_ep", ep_arch, ep_layers, ep_batch, LM_TP_MESH)
    # LM_SERVE_SHARDED's configurations: the prefill cell at the prompt's
    # length, the decode cell at max_len (its caches the engine's); and JAX's
    # per-device share of those caches (sanitized cache_specs on the mesh)
    serve, serve_recs = {}, {}
    for short, s_arch, s_layers, s_shape, s_batch, new in LM_SERVE_SHARDED:
        s_cfg = dataclasses.replace(get_config(s_arch), n_layers=s_layers, param_dtype="float32")
        s_mesh = Mesh(s_shape, ("data", "model"))
        for kind, S in (("prefill", LM_DP_S), ("decode", LM_DP_S + new)):
            cell = ShapeSpec(f"lm_serve_{kind}", S, s_batch, kind)
            with mock.patch.dict(SHAPES, {cell.name: cell}):
                serve_recs[short, kind] = dryrun.lower_cell(
                    s_arch, cell.name, s_mesh,
                    cfg_override=lambda c, n=s_layers: dataclasses.replace(
                        c, n_layers=n, param_dtype="float32"))[0]
                if kind == "decode":
                    share = dryrun.cache_share_bytes(
                        Transformer(s_cfg, device="meta", dtype=torch.float32, backend="ref"),
                        cell.name, make_rules(s_mesh, model_cfg=s_cfg), s_mesh)
        pre, dec = serve_recs[short, "prefill"], serve_recs[short, "decode"]
        if not (pre["ok"] and dec["ok"]):
            raise AssertionError(f"dryrun_serve {short}: {pre.get('error')} {dec.get('error')}")
        serve[short] = {"param_bytes": dec["memory"]["port_rank_parts"]["params"],
                        "cache_bytes": dec["memory"]["port_rank_parts"]["caches"],
                        "jax_cache_share": share,
                        "cache_layout": dec["memory"]["state_layout"]["caches"],
                        "wire_prefill": pre["hlo"]["collective_by_axis"],
                        "wire_decode_step": dec["hlo"]["collective_by_axis"]}
    torch.cuda.synchronize()
    after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    parts = rec["memory"]["port_rank_parts"]
    predicted = parts["params"] + parts["opt"] + parts["grads"]
    flops = rec["hlo"]["dot_flops"]
    rate = flops / train["step_s_median_2_6"]
    emit("dryrun", arch=arch, layers=layers, batch=batch, seq=LM_TRAIN_S,
         device=rec["device"], counts_of=rec["counts_of"], n_params=rec["n_params"],
         counted_flops=flops, counted_bytes=rec["hlo"]["bytes_accessed"],
         model_flops=rec["roofline"]["model_flops"], count_s=rec["count_s"],
         predicted_state_bytes=predicted, predicted_parts=parts,
         measured_peak_bytes=train["peak_bytes"], step_s=train["step_s_median_2_6"],
         achieved_flops_per_s=rate, peak_flops_per_s=BF16_FLOPS,
         achieved_share=rate / BF16_FLOPS, card_bytes_before=before, card_bytes_after=after,
         card_peak_during=peak)
    fsdp_parts = fsdp_rec["memory"]["port_rank_parts"]
    fsdp_predicted = {"state_bytes": fsdp_parts["params"] + fsdp_parts["opt"],
                      "replicated_state_bytes": 12 * fsdp_rec["n_params"],  # f32 p, m, v
                      "wire_bytes": fsdp_rec["hlo"]["collective_wire_bytes"]}
    emit("dryrun_fsdp", arch=dp_arch, layers=dp_layers, dtype="float32", batch=dp_batch,
         seq=LM_DP_S, mesh=fsdp_rec["mesh"], count_s=fsdp_rec["count_s"],
         state_layout=fsdp_rec["memory"]["state_layout"], port_rank_parts=fsdp_parts,
         port_rank_bytes=fsdp_rec["memory"]["port_rank_bytes"], **fsdp_predicted,
         collective_by_kind=fsdp_rec["hlo"]["collective_by_kind"],
         n_collective_sites=fsdp_rec["hlo"]["n_collective_sites"],
         counted_flops=fsdp_rec["hlo"]["dot_flops"])
    out = [fsdp_predicted]
    for line, (cell_arch, cell_layers, cell_batch), cell in (
            ("dryrun_tp", (tp_arch, tp_layers, tp_batch), tp_rec),
            ("dryrun_ep", (ep_arch, ep_layers, ep_batch), ep_rec)):
        cell_parts = cell["memory"]["port_rank_parts"]
        cell_predicted = {"state_bytes": cell_parts["params"] + cell_parts["opt"],
                          "wire_bytes": cell["hlo"]["collective_wire_bytes"],
                          "wire_by_axis": cell["hlo"]["collective_by_axis"]}
        emit(line, arch=cell_arch, layers=cell_layers, dtype="float32", batch=cell_batch,
             seq=LM_DP_S, mesh=cell["mesh"], count_s=cell["count_s"],
             state_layout=cell["memory"]["state_layout"], port_rank_parts=cell_parts,
             port_rank_bytes=cell["memory"]["port_rank_bytes"], **cell_predicted,
             collective_by_kind=cell["hlo"]["collective_by_kind"],
             n_collective_sites=cell["hlo"]["n_collective_sites"],
             counted_flops=cell["hlo"]["dot_flops"], rank=cell["rank"])
        out.append(cell_predicted)
    for short, s_arch, s_layers, s_shape, s_batch, new in LM_SERVE_SHARDED:
        pre, dec = serve_recs[short, "prefill"], serve_recs[short, "decode"]
        emit("dryrun_serve", config=short, arch=s_arch, layers=s_layers, dtype="float32",
             batch=s_batch, prompt_len=LM_DP_S, max_len=LM_DP_S + new, mesh=dec["mesh"],
             count_s=[pre["count_s"], dec["count_s"]], rank=dec["rank"],
             state_layout=dec["memory"]["state_layout"],
             port_rank_parts={"prefill": pre["memory"]["port_rank_parts"],
                              "decode": dec["memory"]["port_rank_parts"]},
             counted_flops={"prefill": pre["hlo"]["dot_flops"], "decode": dec["hlo"]["dot_flops"]},
             n_collective_sites={"prefill": pre["hlo"]["n_collective_sites"],
                                 "decode": dec["hlo"]["n_collective_sites"]}, **serve[short])
    out.append(serve)
    if not predicted <= train["peak_bytes"]:
        raise AssertionError(f"dryrun: predicted state bytes {predicted} over lm_train's "
                             f"measured peak {train['peak_bytes']}")
    if after != before or peak != before:
        raise AssertionError(f"dryrun: the card's allocated bytes went {before} -> {after} "
                             f"(peak {peak}); a dry run puts nothing on the card")
    if ep_rec["memory"]["state_layout"]["ep_parts"] != LM_TP_MESH[1]:
        raise AssertionError(f"dryrun_ep: the experts are not split along \"model\": "
                             f"{ep_rec['memory']['state_layout']}")
    return tuple(out)


def start_dryrun_clis() -> list:
    """DRYRUN_CLI's cells, each `python -m repro_torch.launch.dryrun` in a
    process of its own with no card visible, writing into a temporary
    directory: [(arch, suffix, ep parts, process, directory, start)].  A
    process still running when this one exits is killed then."""
    import atexit
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = []
    for arch, suffix, ep_parts in DRYRUN_CLI:
        root = tempfile.TemporaryDirectory()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               "train_4k", "--mesh", "single", "--out",
               os.path.join(root.name, "dryrun_torch.json"), "--no-resume"]
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        atexit.register(proc.kill)  # a no-op once it has been waited for
        out.append((arch, suffix, ep_parts, proc, root, time.perf_counter()))
    return out


def dryrun_cli(started: list) -> None:
    """`start_dryrun_clis`' cells, each within DRYRUN_CLI_TIMEOUT_S of its
    start: the 16x16 rank, sharded 16 ways over "data" and 16 over
    "model" (the experts too, where `ep_parts` says so), fits one card, its
    wire bytes listed by axis and kind (the model axis' all-gathers apart
    from its all-reduces); prints `dryrun_cli<suffix>`."""
    for arch, suffix, ep_parts, proc, root, t0 in started:
        try:
            stdout, stderr = proc.communicate(
                timeout=max(DRYRUN_CLI_TIMEOUT_S - (time.perf_counter() - t0), 1.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        path = Path(root.name) / "dryrun_torch.json"
        recs = json.loads(path.read_text()) if proc.returncode == 0 and path.exists() else []
        root.cleanup()
        cell = recs[0] if len(recs) == 1 else {}
        memory, hlo = cell.get("memory", {}), cell.get("hlo", {})
        emit(f"dryrun_cli{suffix}", cmd=" ".join(proc.args[1:7]) + " ...",
             returncode=proc.returncode, seconds_since_start=seconds, ok=cell.get("ok"),
             count_s=cell.get("count_s"), fits_one_card=memory.get("fits_one_card"),
             port_rank_bytes=memory.get("port_rank_bytes"),
             port_rank_parts=memory.get("port_rank_parts"),
             state_layout=memory.get("state_layout"),
             collective_wire_bytes=hlo.get("collective_wire_bytes"),
             collective_by_kind=hlo.get("collective_by_kind"),
             collective_by_axis=hlo.get("collective_by_axis"),
             n_collective_sites=hlo.get("n_collective_sites"), dot_flops=hlo.get("dot_flops"),
             rank=cell.get("rank"), bottleneck=cell.get("roofline", {}).get("bottleneck"))
        if proc.returncode != 0 or not cell.get("ok"):
            raise AssertionError(f"dryrun CLI {arch}: rc {proc.returncode}: {stdout[-2000:]} "
                                 f"{stderr[-2000:]}")
        by_axis, layout = hlo["collective_by_axis"], memory["state_layout"]
        if not (memory["fits_one_card"] and layout["data_parts"] == 16
                and layout["model_parts"] == 16 and layout["ep_parts"] == ep_parts
                and (ep_parts is None or layout["ep"] == "model")
                and sum(by_axis.get("model", {}).values()) > 0
                and hlo["collective_wire_bytes"] == sum(hlo["collective_by_kind"].values())
                == sum(sum(v.values()) for v in by_axis.values())):
            raise AssertionError(f"dryrun CLI {arch}: the sharded 16x16 rank: {memory} {hlo}")


def lm_train_loss_study(arch: str, layers: int, batch: int) -> None:
    """lm_train's steps for each (dtype, lr) of LM_TRAIN_LOSS_STUDY: the same
    seed and batches, the losses and gradient norms of each step (finite),
    beside lm_train's own at bf16 and OptConfig's lr."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    batches = [_train_batch(cfg, batch, LM_TRAIN_S, s) for s in range(LM_TRAIN_STEPS)]
    for dt, lr in LM_TRAIN_LOSS_STUDY:
        opt_cfg = OptConfig(lr=lr, warmup_steps=2)
        model = build_model(cfg, dtype=dt, seed=0)
        state = init_train_state(model, torch.Generator(device=model.device).manual_seed(0),
                                 opt_cfg)
        step_fn = make_train_step(model, opt_cfg)
        losses, norms = [], []
        t0 = time.perf_counter()
        for b in batches:
            state, metrics = step_fn(state, b)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
        finite = all(math.isfinite(x) for x in losses + norms)
        emit("lm_train_loss_study", arch=arch, layers=layers, batch=batch, seq=LM_TRAIN_S,
             dtype=str(dt), lr=lr, warmup_steps=opt_cfg.warmup_steps, losses=losses,
             grad_norms=norms, seconds=time.perf_counter() - t0, finite=finite)
        if not finite:
            raise AssertionError(f"{arch} {dt} lr {lr}: losses {losses}, norms {norms}")
        del state, model, step_fn, metrics
        gc.collect()
        torch.cuda.empty_cache()


def lm_train_plain_check(arch: str) -> None:
    """The first LM_TRAIN_PLAIN_LAYERS layers of the full-width model in f32,
    B = 1, S = LM_TRAIN_PLAIN_S: `loss_fn` and the gradient of every
    parameter with backend "cuda" (the kernels' forward) against "ref"
    (blocked attention and the chunked scan), same parameters and batch.
    Loss within LM_TRAIN_LOSS_REL_TOL, each gradient within
    LM_TRAIN_GRAD_REL_TOL of its leaf's max |g|."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), n_layers=LM_TRAIN_PLAIN_LAYERS)
    batch = _train_batch(cfg, 1, LM_TRAIN_PLAIN_S, 0)
    results = {}
    for backend in ("cuda", "ref"):
        model = build_model(cfg, backend=backend, seed=3, dtype=torch.float32)
        model.train().requires_grad_(True)
        params = dict(model.named_parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss_fn({k: v.to(model.device) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        torch.cuda.synchronize()
        results[backend] = (loss.item(), dict(zip(params, grads)), time.perf_counter() - t0)
        del model, params, loss, grads
        gc.collect()
        torch.cuda.empty_cache()
    (lk, gk, tk), (lp, gp, tp) = results["cuda"], results["ref"]
    loss_rel = abs(lk - lp) / abs(lp)
    worst_name, worst = None, 0.0
    for name, g in gp.items():
        if g is None:
            if gk[name] is not None:
                raise AssertionError(f"{arch}: {name} has a gradient on one path only")
            continue
        rel = float((gk[name] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
        if rel >= worst:
            worst_name, worst = name, rel
    emit("lm_train_plain_check", arch=arch, layers=cfg.n_layers, dtype="torch.float32", batch=1,
         S=LM_TRAIN_PLAIN_S, loss_kernels=lk, loss_plain=lp, loss_rel_err=loss_rel,
         loss_tol_rel=LM_TRAIN_LOSS_REL_TOL, grad_leaves=len(gp), grad_worst_rel_err=worst,
         grad_worst_leaf=worst_name, grad_tol_rel=LM_TRAIN_GRAD_REL_TOL,
         loss_and_grad_s_kernels=tk, loss_and_grad_s_plain=tp)
    if not (loss_rel <= LM_TRAIN_LOSS_REL_TOL and worst <= LM_TRAIN_GRAD_REL_TOL):
        raise AssertionError(f"{arch}: kernel and plain training paths differ: loss by {loss_rel} "
                             f"(relative), gradient {worst_name} by {worst} of its max")
    del results, gk, gp
    gc.collect()
    torch.cuda.empty_cache()


def _resume_runs(arch: str, root: str, deterministic: bool = True) -> tuple[dict, dict]:
    """`run_training` of reduced(arch) for LM_RESUME_STEPS steps, once
    through and once with a failure injected before step LM_RESUME_FAIL_AT;
    `deterministic` is `RunConfig.deterministic` (on by default, as a user's
    run has it)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.runtime import RunConfig, run_training
    from repro_torch.training import OptConfig

    cfg = reduced(get_config(arch))
    out = {}
    for run, fail_at in (("clean", None), ("crash", LM_RESUME_FAIL_AT)):
        fired = []

        def injector(step, fail_at=fail_at, fired=fired):
            if step == fail_at and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure")

        model = build_model(cfg)
        out[run] = run_training(
            model, DataConfig(vocab=cfg.vocab, seq_len=LM_RESUME_S, global_batch=LM_RESUME_B),
            OptConfig(lr=1e-3, warmup_steps=1),
            RunConfig(total_steps=LM_RESUME_STEPS, ckpt_every=4, log_every=100, metrics=[],
                      deterministic=deterministic),
            Checkpointer(os.path.join(root, f"{arch}-{run}-{deterministic}")),
            fail_injector=injector)
    return out["clean"], out["crash"]


def _resume_row(arch: str, clean: dict, crash: dict) -> dict:
    """How far the crashed run ended from the uninterrupted one."""
    cl = {r["step"]: r["loss"] for r in clean["metrics"]}
    cr = {r["step"]: r["loss"] for r in crash["metrics"]}  # a replayed step: its last run
    pairs = list(zip(clean["final_state"].params.parameters(),
                     crash["final_state"].params.parameters()))
    losses = [cl[s] for s in sorted(cl)]
    return {"arch": arch, "steps": LM_RESUME_STEPS, "fail_at": LM_RESUME_FAIL_AT,
            "restarts": [clean["restarts"], crash["restarts"]],
            "params_bit_identical": all(torch.equal(a, b) for a, b in pairs),
            "params_max_abs_diff": max(float((a - b).detach().abs().max()) for a, b in pairs),
            "losses_bit_identical": cl == cr,
            "losses_max_abs_diff": max(abs(cl[s] - cr[s]) for s in cl),
            "losses": losses, "loss_falls": losses[-1] < losses[0]}


def lm_train_resume() -> dict:
    """Crash and resume through `run_training` on the card, reduced qwen3-8b
    and jamba-v0.1-52b (attention, Mamba and MoE): the run with a failure
    injected restarts once and ends with the uninterrupted run's parameters
    and per-step losses, bit for bit; the copy task's loss falls.  The loop
    runs under deterministic algorithms, as a user's run does (the gathers'
    backward, a scatter-add, takes its sorted form there); the warnings it
    gives for ops without one are reported.  Then the same pair of runs
    with `RunConfig.deterministic` off, whose distance is reported and not
    held (it is what the deterministic mode buys).  Then `launch.train` and
    `launch.serve --ckpt-dir` in subprocesses, at the runs' B and S, so that
    every kernel shape they give is a `kernel_flash_attention` case.
    Returns the launches of the deterministic runs."""
    import tempfile
    import warnings

    reset_launches()
    with tempfile.TemporaryDirectory() as root:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for arch in LM_RESUME:
                row = _resume_row(arch, *_resume_runs(arch, root))
                emit("lm_train_resume", **row)
                if not (row["restarts"] == [0, 1] and row["params_bit_identical"]
                        and row["losses_bit_identical"] and row["loss_falls"]):
                    raise AssertionError(f"{arch}: crash and resume: {row}")
        launches = read_launches()
        emit("lm_train_resume_deterministic_warnings",
             messages=sorted({str(w.message)[:200] for w in caught}))
        for arch in LM_RESUME:
            row = _resume_row(arch, *_resume_runs(arch, root, deterministic=False))
            emit("lm_train_resume_nondeterministic", **row)
            if row["restarts"] != [0, 1]:
                raise AssertionError(f"{arch}: crash and resume without determinism: {row}")
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        ckpt = os.path.join(root, "launch")
        reduced_args = ["--arch", "qwen3-8b", "--reduced", "--ckpt-dir", ckpt,
                        "--batch", str(LM_RESUME_B)]
        cmds = {"train": [sys.executable, "-m", "repro_torch.launch.train", *reduced_args,
                          "--seq", str(LM_RESUME_S), "--steps", "8"],
                "serve": [sys.executable, "-m", "repro_torch.launch.serve", *reduced_args,
                          "--prompt-len", str(LM_RESUME_S)]}
        for name, cmd in cmds.items():
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
            if name == "train":  # "done: steps=8 loss=<finite> restarts=0 ..."
                done = re.search(r"^done: steps=8 loss=(\S+) restarts=0 ", proc.stdout, re.M)
                ok = done is not None and math.isfinite(float(done.group(1)))
            else:
                ok = "restored step 8" in proc.stdout
            ok = ok and proc.returncode == 0
            want = "a finite done: line" if name == "train" else "restored step 8"
            emit(f"lm_launch_{name}", cmd=" ".join(cmd[1:]), returncode=proc.returncode,
                 seconds=time.perf_counter() - t0, stdout_tail=proc.stdout[-600:], ok=ok)
            if not ok:
                raise AssertionError(f"launch.{name}: rc {proc.returncode}, no {want!r}: "
                                     f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    return launches


def _param_checksum(model) -> list[float]:
    """(sum, sum of squares) of every parameter in f64: equal bits give equal
    sums, so ranks that hold the same parameters report the same pair."""
    s = torch.zeros(2, dtype=torch.float64, device=model.device)
    for p in model.parameters():
        x = p.detach().double()
        s[0] += x.sum()
        s[1] += (x * x).sum()
    return s.tolist()


def _dp_rank(rank: int, out_dir: str, device: str = "cuda:0") -> None:
    """One of LM_DP_RANKS ranks on cuda:0 in a gloo group: lm_train_dp's
    model and steps, data-parallel; rank 0 holds step 1's summed gradient
    against its own one-device gradient of the global batch.  Then
    `compressed_psum` at each of COMPRESS_BITS.  Writes what it saw to
    out_dir/rank<r>.json."""
    import dataclasses
    import gc

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.parallel.compression import compressed_psum
    from repro_torch.training import OptConfig, init_train_state, make_train_step
    from repro_torch.training import train_step as ts

    with _gloo_rank(rank, out_dir, device) as dev:
        group = dist.group.WORLD
        out = {"rank": rank}
        arch, layers, batch = LM_DP
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        opt_cfg = OptConfig(warmup_steps=2)
        model = build_model(cfg, device=dev, dtype=torch.float32, seed=0)
        state = init_train_state(model, torch.Generator(device=model.device).manual_seed(0),
                                 opt_cfg)
        batches = [_train_batch(cfg, batch, LM_DP_S, s) for s in range(LM_DP_STEPS)]
        # Rank 0's one-device gradient of step 1 (the global batch), held
        # against the step's own summed gradient as the all-reduce leaves it.
        step1 = {"grads": ts.accumulate_grads(model, batches[0])[1] if rank == 0 else None}
        names = [n for n, _ in model.named_parameters()]
        reduce_s = []
        orig = ts._all_reduce_sum

        def timed(tensors, group, ranks=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig(tensors, group, ranks)
            torch.cuda.synchronize()
            reduce_s.append(time.perf_counter() - t0)
            want = step1.pop("grads", None)
            if want is not None:  # tensors: the loss, then the gradients in parameter order
                rel = {n: float((g - want[n]).abs().max()) / max(float(want[n].abs().max()),
                                                                 1e-30)
                       for n, g in zip(names, tensors[1:])}
                worst = max(rel, key=rel.get)
                out["grad_rel_err_per_leaf"] = rel
                out["grad_leaves"] = len(rel)
                out["grad_worst_leaf"], out["grad_worst_rel_err"] = worst, rel[worst]

        ts._all_reduce_sum = timed
        step_fn = make_train_step(model, opt_cfg, group=group)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out.update(losses=[], grad_norms=[], step_s=[], all_reduce_s=[])
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            out["all_reduce_s"].append(sum(reduce_s))
            reduce_s.clear()
            out["losses"].append(metrics["loss"].item())
            out["grad_norms"].append(metrics["grad_norm"].item())
        ts._all_reduce_sum = orig
        out["launches"] = {k: c for k, c in read_launches().items() if c}
        out["all_reduces_per_step"] = len(ts.buckets(
            [1] + [p.numel() for p in model.parameters()], ts.BUCKET_BYTES))
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["param_checksum"] = _param_checksum(model)
        del state, model, step_fn, metrics
        gc.collect()
        torch.cuda.empty_cache()

        # compressed_psum: each rank's tensor from its own seed; rank 0 makes
        # every rank's and applies the plain formula.
        def draw(r):
            return torch.randn(COMPRESS_N, generator=torch.Generator(device=dev).manual_seed(
                100 + r), device=dev)

        x = draw(rank)
        out["compressed_psum"] = []
        for bits in COMPRESS_BITS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = compressed_psum(x, group, bits)
            torch.cuda.synchronize()
            row = {"bits": bits, "n": COMPRESS_N, "seconds": time.perf_counter() - t0,
                   "finite": bool(torch.isfinite(got).all())}
            if rank == 0:
                xs = [draw(r) for r in range(LM_DP_RANKS)]
                qmax = 2 ** (bits - 1) - 1
                scale = torch.clamp(torch.stack([t.abs().max() for t in xs]).max(),
                                    min=1e-12) * (1.0 / qmax)  # as XLA divides by qmax
                q = sum(torch.clamp(torch.round(t / scale), -qmax, qmax).to(torch.int32)
                        for t in xs)
                want = q.float() * scale
                row["equal_to_plain"] = torch.equal(got, want)
                row["max_abs_err"] = float((got - want).abs().max())
                row["exact_sum_rel_err"] = float((got - sum(xs)).abs().max() /
                                                 sum(xs).abs().max())
                del xs, q, want
            out["compressed_psum"].append(row)
            del got
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def lm_train_dp(device: str = "cuda:0") -> tuple[dict, dict]:
    """LM_DP's steps on one rank in this process, then on LM_DP_RANKS gloo
    ranks on cuda:0 (`_dp_rank`): each step's loss and gradient norm within
    LM_DP_STEP_RTOL of the one-rank run's, every rank's alike and its
    parameters' checksum alike; step 1's gradient leaves within
    LM_DP_GRAD_REL of their max against the one-device gradient;
    `compressed_psum` equal to its plain formula.  Each run launches
    flash_attention twice per layer a step.  Prints the peak memory per rank
    and the all-reduce's share of a step.  Returns the one-rank run's
    launches and readings (losses, gradient norms, step seconds, peak)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import OptConfig, init_train_state, make_train_step

    arch, layers, batch = LM_DP
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    opt_cfg = OptConfig(warmup_steps=2)
    model = build_model(cfg, device=device, dtype=torch.float32, seed=0)
    state = init_train_state(model, torch.Generator(device=model.device).manual_seed(0), opt_cfg)
    n_params = sum(p.numel() for p in model.parameters())
    step_fn = make_train_step(model, opt_cfg)
    batches = [_train_batch(cfg, batch, LM_DP_S, s) for s in range(LM_DP_STEPS)]
    one = {"losses": [], "grad_norms": [], "step_s": []}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        torch.cuda.synchronize()
        one["step_s"].append(time.perf_counter() - t0)
        one["losses"].append(metrics["loss"].item())
        one["grad_norms"].append(metrics["grad_norm"].item())
    launches = read_launches()
    one["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    one["param_checksum"] = _param_checksum(model)
    del state, model, step_fn, metrics
    gc.collect()
    torch.cuda.empty_cache()

    ranks, spawn_s = _spawn_ranks(_dp_rank, device, LM_DP_TIMEOUT_S, "lm_train_dp")
    r0 = ranks[0]
    per_step = {"flash_attention": 2 * _mixer_layers(cfg, "attn")}
    want = {k: LM_DP_STEPS * c for k, c in per_step.items()}

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    loss_rel, norm_rel = rel(r0["losses"], one["losses"]), rel(r0["grad_norms"], one["grad_norms"])
    timed = [(s, a) for s, a in zip(r0["step_s"], r0["all_reduce_s"])][1:]
    check = {
        "losses_within_tol": max(loss_rel) <= LM_DP_STEP_RTOL,
        "grad_norms_within_tol": max(norm_rel) <= LM_DP_STEP_RTOL,
        "grad_leaves_within_tol": r0["grad_worst_rel_err"] <= LM_DP_GRAD_REL,
        "ranks_alike": all(r["losses"] == r0["losses"] and r["grad_norms"] == r0["grad_norms"]
                           and r["param_checksum"] == r0["param_checksum"] for r in ranks),
        "finite": all(math.isfinite(x) for x in r0["losses"] + r0["grad_norms"]),
        "launches": (launches == expected_launches(**want)
                     and all(r["launches"] == want for r in ranks)),
    }
    emit("lm_train_dp", arch=arch, layers=layers, params=n_params, dtype="torch.float32",
         global_batch=batch, seq=LM_DP_S, steps=LM_DP_STEPS, ranks=LM_DP_RANKS,
         backend="gloo on cuda:0", one_rank=one,
         dp_losses=r0["losses"], dp_grad_norms=r0["grad_norms"], loss_rel_err=loss_rel,
         grad_norm_rel_err=norm_rel, step_tol_rel=LM_DP_STEP_RTOL,
         grad_rel_err_per_leaf=r0["grad_rel_err_per_leaf"],
         grad_leaves=r0["grad_leaves"], grad_worst_leaf=r0["grad_worst_leaf"],
         grad_worst_rel_err=r0["grad_worst_rel_err"], grad_tol_rel=LM_DP_GRAD_REL,
         dp_step_s=[r["step_s"] for r in ranks],
         all_reduce_s=[r["all_reduce_s"] for r in ranks],
         all_reduce_share_steps_2_on=[a / s for s, a in timed],
         all_reduces_per_step=r0["all_reduces_per_step"],
         peak_gib_per_rank=[r["peak_gib"] for r in ranks],
         launches_one_rank={k: c for k, c in launches.items() if c},
         launches_per_rank=[r["launches"] for r in ranks], launches_per_step=per_step,
         spawn_s=spawn_s, **check)
    if not all(check.values()):
        raise AssertionError(f"lm_train_dp: {check}")
    for i, row in enumerate(r0["compressed_psum"]):
        row["finite"] = all(r["compressed_psum"][i]["finite"] for r in ranks)
        emit("compressed_psum", ranks=LM_DP_RANKS, **row)
        if not (row["equal_to_plain"] and row["finite"]):
            raise AssertionError(f"compressed_psum bits={row['bits']}: {row}")
    return launches, one


@contextlib.contextmanager
def _gloo_rank(rank: int, out_dir: str, device: str):
    """This process as rank `rank` of LM_DP_RANKS in a gloo group on
    `device` (f32 products without TF32); yields the device.  NCCL refuses
    two ranks on one device; gloo stages CUDA tensors through the host."""
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host: loopback
    torch.set_num_threads(2)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank,
                            world_size=LM_DP_RANKS)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def _f8_blocks(cfg, mesh) -> dict:
    """{parameter name: [(rank, its Shard)]} of the ranks on `mesh` whose
    blocks of the parameter differ (under make_rules(mesh, model_cfg=cfg));
    a leaf whole along an axis has one block along it, the first rank's."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.parallel import make_rules
    from repro_torch.parallel.sharding import leaf_shard

    model = Transformer(cfg, device="meta", dtype=torch.float32, backend="ref")
    rules, specs, M = make_rules(mesh, model_cfg=cfg), model.param_specs(), mesh.shape["model"]
    out = {}
    for n, p in model.named_parameters():
        shards = [leaf_shard(n, tuple(p.shape), specs, mesh, rules, r) for r in range(mesh.size)]
        out[n] = [(r, sh) for r, sh in enumerate(shards)
                  if (sh.dim is not None or r // M == 0) and (sh.mdim is not None or r % M == 0)]
    return out


_FP_WORDS = 1 << 22  # a fingerprint's chunk, in 4-byte words


def _fingerprint(t: torch.Tensor) -> list[int]:
    """An exact fingerprint of the bits of f32 tensor `t`, on its device: the
    flat words of each chunk of _FP_WORDS times fixed odd pseudo-random int64
    weights, summed with wrap-around, one sum a chunk.  Equal bits give
    equal sums; a word that differs changes its chunk's sum (the weight is
    odd), and several cancel with a chance of about 2^-63."""
    gen = torch.Generator(device=t.device).manual_seed(8)
    w = torch.randint(-(1 << 62), 1 << 62, (_FP_WORDS,), generator=gen, device=t.device,
                      dtype=torch.int64) | 1
    words = t.detach().contiguous().view(-1).view(torch.int32)
    return torch.stack([(c.to(torch.int64) * w[:c.numel()]).sum()
                        for c in words.split(_FP_WORDS)]).tolist()


def _pinned_empty(shape, dtype) -> torch.Tensor:
    """An uninitialized tensor in page-locked host memory."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A copy of card tensor `t` in page-locked host memory."""
    out = _pinned_empty(t.shape, t.dtype)
    out.copy_(t)
    return out


def _worst(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max |want|) of a card tensor and a host tensor of
    its shape, on the card in flat chunks of F8_CHUNK (NaN where either
    holds one)."""
    g, w = got.detach().reshape(-1), want.reshape(-1)
    errs, scales = [], []
    for i in range(0, g.numel(), F8_CHUNK):
        wc = w[i:i + F8_CHUNK].to(got.device)
        errs.append((g[i:i + F8_CHUNK] - wc).abs().max())
        scales.append(wc.abs().max())
    err, scale = torch.stack(errs).max(), torch.stack(scales).max()
    return err.item(), scale.item()


class _UpdateSpy:
    """A stand-in for `repro_torch.training.train_step.adamw_update`, patched
    in while a step is built (`build`): while `hook` is set it is called
    with the update's arguments (the gradient as the update receives it,
    after the clip), then the real function runs."""

    def __init__(self):
        from repro_torch.training import train_step

        self.real, self.hook = train_step.adamw_update, None

    def __call__(self, params, grads, opt_state, step, cfg):
        if self.hook is not None:
            self.hook(params, grads, opt_state, step, cfg)
        return self.real(params, grads, opt_state, step, cfg)

    def build(self, model, opt_cfg, **kw):
        from unittest import mock

        from repro_torch.training import make_train_step, train_step

        with mock.patch.object(train_step, "adamw_update", self):
            return make_train_step(model, opt_cfg, **kw)


def _one_device_reference(cfg, dev, opt_cfg, batches, mesh, keep_p2: bool) -> dict:
    """Rank 0's one-device run of `batches` (global batches) from the draw
    the ranks make: each step's loss and gradient norm ("losses",
    "grad_norms") and F8's references, each cut into the blocks of the
    ranks on `mesh` (`_f8_blocks`; (name or JAX leaf key, rank) -> block):
    the fingerprints of the parameters after step 1 ("p1", on the card),
    the moments after step 1 ("m1", "v1") and the gradient the update
    receives at step 2 ("g2"), on the host; with `keep_p2`, the parameters
    after step 2 on the card ("p2", for the reported distance).  Frees the
    card of the run."""
    import gc

    from repro_torch.models import build_model
    from repro_torch.models.transformer import param_leaves
    from repro_torch.training import init_train_state

    blocks = _f8_blocks(cfg, mesh)
    model = build_model(cfg, device=dev, dtype=torch.float32, seed=0)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0), opt_cfg)
    spy = _UpdateSpy()
    step_fn = spy.build(model, opt_cfg)
    ref = {"losses": [], "grad_norms": [], "reference_s": 0.0}

    def keep_grads(params, grads, *_):
        t0 = time.perf_counter()
        ref["g2"] = {(n, r): _pinned(sh.cut(grads[n])) for n in grads for r, sh in blocks[n]}
        ref["reference_s"] += time.perf_counter() - t0

    for s, b in enumerate(batches):
        spy.hook = keep_grads if s == 1 else None
        state, metrics = step_fn(state, b)
        spy.hook = None
        ref["losses"].append(metrics["loss"].item())
        ref["grad_norms"].append(metrics["grad_norm"].item())
        if s == 0:
            t0 = time.perf_counter()
            named = dict(model.named_parameters())
            ref["p1"] = {(n, r): _fingerprint(sh.cut(p)) for n, p in named.items()
                         for r, sh in blocks[n]}
            ref["m1"], ref["v1"] = {}, {}
            for key, ns in param_leaves(named).items():
                lead = int(ns[0].startswith("groups."))  # a stacked moment: the groups first
                for part in ("m", "v"):
                    ref[f"{part}1"].update({(key, r): _pinned(sh.cut(state.opt[part][key], lead))
                                            for r, sh in blocks[ns[0]]})
            ref["reference_s"] += time.perf_counter() - t0
        if s == 1 and keep_p2:
            ref["p2"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    ref["host_bytes"] = sum(t.numel() * t.element_size() for part in ("m1", "v1", "g2")
                            for t in ref[part].values())
    del state, model, step_fn, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return ref


class _UpdateCheck:
    """F8's checks on the ranks' side (the block at F8_GRAD_REL), read on
    rank 0 against `_one_device_reference`'s references.  The ranks share
    one card, so the other ranks hand rank 0 their blocks through CUDA IPC
    (`queue`, a torch.multiprocessing queue): their parameters and moments
    once (the steps update them in place), their gradient at step 2.  Rank
    0 so holds each leaf whole, as its ranks' blocks at their places on the
    mesh, and reads it piece by piece on the card; the references it holds
    on the host are cut the same way.  `moments` runs after step 1, `hook`
    on the step's `_UpdateSpy` at step 2, `params` after step 2;
    `replicated_alike` after each step."""

    def __init__(self, model, state, ref, mesh, group, queue, opt_cfg, real):
        import torch.distributed as dist

        from repro_torch.models.transformer import param_leaves

        self.model, self.state, self.ref, self.group, self.queue = model, state, ref, group, queue
        self.opt_cfg, self.real = opt_cfg, real
        self.rank, self.dist = dist.get_rank(group), dist
        self.blocks = _f8_blocks(model.cfg, mesh)
        self.leaves = param_leaves(dict(model.named_parameters()))
        whole = {n for n, ((_, sh),) in ((n, bl) for n, bl in self.blocks.items() if len(bl) == 1)
                 if sh.block == sh.shape}
        moments = {k for k, ns in self.leaves.items() if ns[0] in whole}
        self.whole = {"p": whole, "m": moments, "v": moments}  # whole along both axes
        self.expected: dict = {}
        self.seconds, self.peak_host = 0.0, 0
        self.out = {"step1_moments_worst": {}, "step2_grad_worst": None,
                    "step2_update_worst_abs": None, "step2_params_vs_one_device": None}
        self.theirs = self._exchange({"p": dict(model.named_parameters()), **state.opt})

    def _exchange(self, tensors: dict) -> dict:
        """{rank: `tensors` of that rank} on rank 0 (its own, and the other
        ranks' through CUDA IPC); {} on the other ranks."""
        mine = {k: {n: t.detach() for n, t in v.items()} for k, v in tensors.items()}
        if self.rank != 0:
            torch.cuda.synchronize()
            self.queue.put((self.rank, mine))
            return {}
        got = {0: mine}
        for _ in range(LM_DP_RANKS - 1):
            r, theirs = self.queue.get(timeout=LM_DP_TIMEOUT_S)
            got[r] = theirs
        return got

    def _barrier(self) -> None:
        torch.cuda.synchronize()
        self.dist.barrier(group=self.group)

    def _host_bytes(self) -> int:
        live = [t for part in ("m1", "v1", "g2") for t in self.ref.get(part, {}).values()]
        return sum(t.numel() * t.element_size() for t in [*live, *self.expected.values()])

    def replicated_alike(self) -> bool | None:
        """Whether every rank holds the bits of rank 0 in each parameter and
        moment whole along both axes (None on the other ranks)."""
        self._barrier()
        alike = None
        if self.rank == 0:
            mine = self.theirs[0]
            alike = all(torch.equal(mine[part][k], t[part][k])
                        for t in self.theirs.values() for part in t for k in self.whole[part])
        self._barrier()
        return alike

    def moments(self) -> None:
        """After step 1: each rank's moment blocks against the one-device
        run's moments after step 1, cut the same way (m within
        F8_GRAD_REL, v within twice it, of the leaf's max, plus
        F8_GRAD_ABS)."""
        t0 = time.perf_counter()
        self._barrier()
        if self.rank == 0:
            self.peak_host = max(self.peak_host, self._host_bytes())
            for part, rel in (("m", F8_GRAD_REL), ("v", 2 * F8_GRAD_REL)):
                worst = None
                for key, ns in self.leaves.items():
                    err = scale = 0.0
                    for r, _ in self.blocks[ns[0]]:
                        e, s = _worst(self.theirs[r][part][key], self.ref[f"{part}1"].pop((key, r)))
                        err, scale = max(err, e), max(scale, s)
                    ratio = err / (rel * scale + F8_GRAD_ABS)
                    if worst is None or not ratio <= worst["ratio_to_bound"]:
                        worst = {"leaf": key, "abs_err": err, "leaf_max": scale,
                                 "ratio_to_bound": ratio}
                self.out["step1_moments_worst"][part] = worst
        self._barrier()
        self.seconds += time.perf_counter() - t0

    def hook(self, params, grads, opt_state, step, cfg) -> None:
        """At step 2, before the update: the gradient each rank's update
        receives against the one-device run's, the parameters' fingerprints
        against the drawn ones', and the port's AdamW of the ranks' blocks at
        step 2 (step index 1, the phase's OptConfig: not what the update is
        handed) into `expected` on the host."""
        t0 = time.perf_counter()
        gs = self._exchange({"g": grads})
        if self.rank == 0:
            exact, worst = True, None
            dev, idx = next(iter(params.values())).device, torch.ones((), dtype=torch.int32)
            for key, ns in self.leaves.items():
                stacked = ns[0].startswith("groups.")
                err = scale = 0.0
                for i, n in enumerate(ns):
                    for r, _ in self.blocks[n]:
                        p, g = self.theirs[r]["p"][n], gs[r]["g"][n]
                        exact &= _fingerprint(p) == self.ref["p1"][(n, r)]
                        e, s = _worst(g, self.ref["g2"].pop((n, r)))
                        err, scale = max(err, e), max(scale, s)
                        m, v = (self.theirs[r][part][key] for part in ("m", "v"))
                        self.expected[(n, r)] = self._adamw(n, key, p, m[i] if stacked else m,
                                                            v[i] if stacked else v, g,
                                                            idx.to(dev), stacked)
                ratio = err / (F8_GRAD_REL * scale + F8_GRAD_ABS)
                if worst is None or not ratio <= worst["ratio_to_bound"]:
                    worst = {"leaf": key, "abs_err": err, "leaf_max": scale,
                             "ratio_to_bound": ratio, "rel_err": err / scale if scale else err}
            self.out["step1_layout_params_exact"] = exact
            self.out["step2_grad_worst"] = worst
            self.peak_host = max(self.peak_host, self._host_bytes())
        del gs
        self._barrier()
        self.seconds += time.perf_counter() - t0

    def _adamw(self, name, key, p, m, v, g, step, stacked) -> torch.Tensor:
        """The port's AdamW (the function the step was built with) of block
        p with moments m, v and gradient g, on the card in flat chunks of
        F8_CHUNK (elementwise: one call's arithmetic); the updated p on the
        host."""
        out = _pinned_empty(p.shape, p.dtype)
        flat = [x.reshape(-1) for x in (p, m, v, g)]
        for i in range(0, flat[0].numel(), F8_CHUNK):
            pc, mc, vc = (x[i:i + F8_CHUNK].clone() for x in flat[:3])
            gc = flat[3][i:i + F8_CHUNK]
            if stacked:
                mc, vc = mc[None], vc[None]
            self.real({name: pc}, {name: gc}, {"m": {key: mc}, "v": {key: vc}}, step,
                      self.opt_cfg)
            out.view(-1)[i:i + F8_CHUNK].copy_(pc)
        return out

    def params(self) -> None:
        """After step 2: each rank's parameter blocks against `expected`
        (held: within F8_UPDATE_ABS) and, with the one-device run's "p2",
        against its parameters after step 2 (reported)."""
        t0 = time.perf_counter()
        self._barrier()
        if self.rank == 0:
            worst, far = None, None
            p2 = self.ref.get("p2")
            for n, bl in self.blocks.items():
                err = 0.0
                for r, sh in bl:
                    got = self.theirs[r]["p"][n]
                    err = max(err, _worst(got, self.expected.pop((n, r)))[0])
                    if p2 is not None:
                        want = sh.cut(p2[n])
                        rel = ((got - want).abs().max() / want.abs().max()).item()
                        if far is None or not rel <= far["rel"]:
                            far = {"leaf": n, "rel": rel}
                if worst is None or not err <= worst["abs_err"]:
                    worst = {"leaf": n, "abs_err": err}
            self.out["step2_update_worst_abs"] = worst
            self.out["step2_params_vs_one_device"] = far
            self.ref.pop("p2", None)
        self._barrier()
        self.seconds += time.perf_counter() - t0

    def result(self) -> dict:
        self.theirs = {}
        return {**self.out, "seconds": self.seconds,
                "host_bytes": {"one_device_references": self.ref.get("host_bytes"),
                               "ranks_peak": self.peak_host},
                "one_device_reference_s": self.ref.get("reference_s")}


def f8_checks(f8: dict) -> dict:
    """The held readings of `_UpdateCheck.result()` (rank 0's)."""
    return {
        "step1_layout_params_exact": f8["step1_layout_params_exact"] is True,
        "step1_moments_within_tol": all(w["ratio_to_bound"] <= 1.0
                                        for w in f8["step1_moments_worst"].values()),
        "step2_grads_within_tol": f8["step2_grad_worst"]["ratio_to_bound"] <= 1.0,
        "step2_update_within_tol": f8["step2_update_worst_abs"]["abs_err"] <= F8_UPDATE_ABS,
    }


def _sharded_run(rank: int, group, queue, dev, cfg, opt_cfg, batches, mesh, ref,
                 profile: bool) -> dict:
    """`batches` on this rank's state, laid out by the JAX rules of `mesh`
    (the draw of `_one_device_reference`), the collectives timed
    (`fsdp.WIRE.sync`), rank 0's last step under the profiler if `profile`,
    with F8's checks (`_UpdateCheck`; `ref` on rank 0, None elsewhere).
    Returns what the rank saw (`clock`: its wall clock at the run's start,
    once the state is built, once the steps are done and at its end); step
    2's `step_s` leaves out the check's seconds."""
    import gc

    from repro_torch.models import build_model
    from repro_torch.parallel import fsdp, make_rules, tensor
    from repro_torch.training import init_train_state

    clock = {"run_start": time.time()}
    model = build_model(cfg, device=dev, dtype=torch.float32, seed=0)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0), opt_cfg,
                             rules=make_rules(mesh, model_cfg=cfg), group=group, mesh=mesh)
    clock["state_built"] = time.time()
    sharding = model.fsdp
    out = {"clock": clock,
           "state_bytes": (sum(p.numel() * p.element_size() for p in model.parameters())
                           + sum(t.numel() * t.element_size()
                                 for part in state.opt.values() for t in part.values())),
           "split_leaves": sum(sharding.split(n) for n in sharding.layout),
           "model_split_leaves": sum(sharding.model_split(n) for n in sharding.layout),
           "summed_over_model": len(tensor.summed_over_model(sharding.layout))}
    out["whole_leaves"] = sum(not (sharding.split(n) or sharding.model_split(n))
                              for n in sharding.layout)
    gc.collect()
    torch.cuda.empty_cache()
    spy = _UpdateSpy()
    step_fn = spy.build(model, opt_cfg, group=group)
    check = _UpdateCheck(model, state, ref if ref is not None else {}, mesh, group, queue,
                         opt_cfg, spy.real)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out.update(losses=[], grad_norms=[], step_s=[], wire=[], seconds=[], calls=[],
               replicated_alike=[])
    fsdp.WIRE.sync = True
    try:
        for s, b in enumerate(batches):
            fsdp.WIRE.reset()
            spy.hook = check.hook if s == 1 else None
            spent = check.seconds
            if profile and rank == 0 and s == len(batches) - 1:  # the idle share
                got = []
                out["profile"] = profile_once(lambda: got.append(step_fn(state, b)), tries=1)
                (state, metrics), = got
                wall = out["profile"]["wall_ms"] / 1e3
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step_fn(state, b)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            spy.hook = None
            out["step_s"].append(wall - (check.seconds - spent))
            out["losses"].append(metrics["loss"].item())
            out["grad_norms"].append(metrics["grad_norm"].item())
            out["wire"].append(fsdp.WIRE.by_axis())
            out["seconds"].append(fsdp.WIRE.by_axis("seconds"))
            out["calls"].append(fsdp.WIRE.by_axis("calls"))
            out["largest_gather"] = fsdp.WIRE.largest_gather
            out["replicated_alike"].append(check.replicated_alike())
            if s == 0:
                check.moments()
            if s == 1:
                check.params()
    finally:
        fsdp.WIRE.sync = False
        spy.hook = None
    clock["steps_done"] = time.time()
    out["f8"] = check.result() if rank == 0 else {}
    out["launches"] = {k: c for k, c in read_launches().items() if c}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del state, model, step_fn, metrics, check
    gc.collect()
    torch.cuda.empty_cache()
    clock["end"] = time.time()
    return out


def _recording_engine(model, max_len: int, batch: int, new: int, forced=None):
    """A greedy `ServeEngine` whose sampling keeps each step's f32 logits
    [B, V] (`logits`), its own greedy picks (`picks`) and the launch counts
    so far (`launches`) and, given `forced` (the one-device run's picks, a
    list a step), hands the next step those instead of its own: the decode
    steps are teacher-forced."""
    from repro_torch.serving import SamplerConfig, ServeEngine

    class Recording(ServeEngine):
        def _sample(self, logits, gen):
            pick = super()._sample(logits, gen)
            self.logits.append(logits)
            self.picks.append(pick.tolist())
            self.launches.append(read_launches())
            if forced is None:
                return pick
            return torch.tensor(forced[len(self.picks) - 1], device=pick.device)

    engine = Recording(model, max_len=max_len, batch_size=batch,
                       sampler=SamplerConfig(max_new_tokens=new), device=model.device)
    engine.logits, engine.picks, engine.launches = [], [], []
    return engine


def _serve_run(rank: int, group, dev, arch: str, layers: int, shape: tuple, batch: int,
               new: int) -> dict:
    """One LM_SERVE_SHARDED configuration on this rank: rank 0 serves the
    drawn parameters on one device first (greedy) and hands its picks to
    every rank; then each rank draws the same parameters, keeps its blocks
    on `shape` (`shard_model`) and serves the global prompts teacher-forced
    on those picks (`_recording_engine`), the collectives timed
    (`fsdp.WIRE.sync`), rank 0's run under the profiler (the idle share).
    Returns what the rank saw; rank 0's also holds each step's logits
    error against its one-device run."""
    import dataclasses
    import gc
    import hashlib

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.parallel import Mesh, fsdp, make_rules

    clock = {"run_start": time.time()}
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    prompts = torch.randint(0, cfg.vocab, (batch, LM_DP_S),
                            generator=torch.Generator().manual_seed(7)).tolist()
    max_len = LM_DP_S + new
    ref, one = None, {}
    if rank == 0:
        model = build_model(cfg, device=dev, dtype=torch.float32, seed=0)
        ref = _recording_engine(model, max_len, batch, new)
        ref.generate(prompts)
        steps = max(ref.stats["decode_steps"], 1)
        one = {"prefill_s": ref.stats["prefill_s"],
               "ms_per_decode_step": 1e3 * ref.stats["decode_s"] / steps, "picks": ref.picks}
        del model
        gc.collect()
        torch.cuda.empty_cache()
    forced = [ref.picks if ref is not None else None]
    dist.broadcast_object_list(forced, src=0, group=group)
    clock["reference_done"] = time.time()
    model = build_model(cfg, device=dev, dtype=torch.float32, seed=0)
    mesh = Mesh(shape, ("data", "model"))
    fsdp.shard_model(model, make_rules(mesh, model_cfg=cfg), group=group, mesh=mesh)
    gc.collect()
    torch.cuda.empty_cache()
    seen = {}
    prefill = model.prefill

    def counted_prefill(*args, **kw):
        logits, caches = prefill(*args, **kw)
        seen["cache_bytes"] = sum(t.numel() * t.element_size()
                                  for c in caches.values() for t in c.values())
        seq = caches.sequence
        seen["sequence"] = None if seq is None else [seq.start, seq.stop]
        return logits, caches

    model.prefill = counted_prefill
    engine = _recording_engine(model, max_len, batch, new, forced[0])
    dist.barrier(group=group)
    clock["sharded_built"] = time.time()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fsdp.WIRE.sync = True
    out = {"clock": clock}
    try:
        if rank == 0:
            out["profile"] = profile_once(lambda: engine.generate(prompts), tries=1)
        else:
            engine.generate(prompts)
    finally:
        fsdp.WIRE.sync = False
    clock["served"] = time.time()
    stats = engine.stats
    out.update(
        param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
        cache_bytes=seen["cache_bytes"], sequence=seen["sequence"], rows=len(engine._rows(batch)),
        prefill_s=stats["prefill_s"], decode_steps=stats["decode_steps"],
        ms_per_decode_step=1e3 * stats["decode_s"] / max(stats["decode_steps"], 1),
        collective_s=stats["collective_s"], wire_prefill=stats["wire_prefill"],
        wire_decode_steps=stats["wire_decode_steps"], wire_logits=stats["wire_logits"],
        picks=engine.picks,
        digests=[hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest() for t in engine.logits],
        launches_prefill={k: c for k, c in engine.launches[0].items() if c},
        launches_decode={k: engine.launches[-1][k] - c for k, c in engine.launches[0].items()
                         if engine.launches[-1][k] - c},
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        finite=all(bool(torch.isfinite(t).all()) for t in engine.logits))
    if ref is not None:
        out["logit_rel_err"] = [float((g - w).abs().max() / w.abs().max())
                                for g, w in zip(engine.logits, ref.logits)]
        out["one_device"] = one
    del engine, model, ref
    gc.collect()
    torch.cuda.empty_cache()
    clock["end"] = time.time()
    return out


def _timeline(clock: dict, start: float) -> dict:
    """A rank's `clock` marks as seconds since `start` (the parent's wall
    clock at the spawn)."""
    return {k: v - start for k, v in clock.items()}


def _sharded_configs() -> dict:
    """{key: (arch, layers, global batch, steps, mesh shape, steps of rank 0's
    one-device reference, whether it keeps its step-2 parameters, whether
    rank 0's last step runs under the profiler)} of the sharded phases:
    lm_train_fsdp's (lm_train_dp's configuration on (2, 1)), LM_TP's (the
    one-device reference takes the first two steps where the one-rank run's
    losses come from lm_train_dp, else every step) and lm_train_ep's."""
    out = {"fsdp": (*LM_DP, LM_DP_STEPS, (LM_DP_RANKS, 1), 2, True, True)}
    out.update({f"tp_{short}": (arch, layers, batch, steps, LM_TP_MESH,
                                2 if from_dp else steps, True, short == LM_TP[0][4])
                for arch, layers, batch, steps, short, from_dp in LM_TP})
    arch, layers, batch, steps, short = LM_EP
    out[f"ep_{short}"] = (arch, layers, batch, steps, LM_TP_MESH, steps, False, True)
    return out


def _sharded_rank(rank: int, out_dir: str, device: str = "cuda:0", queue=None,
                  keys: tuple = ()) -> None:
    """One of LM_DP_RANKS ranks on cuda:0 in a gloo group: each of the
    `_sharded_configs()` named by `keys`, in turn, on its mesh
    (`_sharded_run`), rank 0's one-device reference first
    (`_one_device_reference`), and each LM_SERVE_SHARDED configuration named
    "serve_<suffix>" (`_serve_run`).  Writes what it saw to
    out_dir/rank<r>.json, by configuration."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.parallel import Mesh
    from repro_torch.training import OptConfig

    with _gloo_rank(rank, out_dir, device) as dev:
        out = {"rank": rank}
        configs = _sharded_configs()
        serving = {f"serve_{c[0]}": c[1:] for c in LM_SERVE_SHARDED}
        for key in keys:
            if key in serving:
                started = time.time()
                out[key] = _serve_run(rank, dist.group.WORLD, dev, *serving[key])
                out[key]["clock"].update(config_start=started)
                continue
            arch, layers, batch, steps, shape, ref_steps, keep_p2, profile = configs[key]
            started = time.time()
            cfg = dataclasses.replace(get_config(arch), n_layers=layers)
            opt_cfg = OptConfig(warmup_steps=2)
            batches = [_train_batch(cfg, batch, LM_DP_S, s) for s in range(steps)]
            mesh = Mesh(shape, ("data", "model"))
            ref = (_one_device_reference(cfg, dev, opt_cfg, batches[:ref_steps], mesh, keep_p2)
                   if rank == 0 else None)
            dist.barrier(group=dist.group.WORLD)
            run = _sharded_run(rank, dist.group.WORLD, queue, dev, cfg, opt_cfg, batches, mesh,
                               ref, profile)
            if ref is not None:
                run["one_device"] = {"losses": ref["losses"], "grad_norms": ref["grad_norms"]}
            run["clock"].update(config_start=started)
            out[key] = run
            del ref
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def _spawn_ranks(target, device: str, timeout_s: float, phase: str,
                 share: bool = False, args: tuple = ()) -> tuple[list, float]:
    """LM_DP_RANKS processes of `target(rank, out_dir, device)` (then a
    torch.multiprocessing queue the ranks share, with `share`, then `args`),
    spawned at once and killed at `timeout_s`: (each rank's
    out_dir/rank<r>.json, the seconds from spawn to the last exit).  Fails
    if a rank fails or hangs."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.get_context("spawn")
        extra = ((ctx.Queue(),) if share else ()) + tuple(args)
        procs = [ctx.Process(target=target, args=(r, out_dir, device, *extra))
                 for r in range(LM_DP_RANKS)]
        t0 = time.perf_counter()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if hung or failed:
            raise AssertionError(f"{phase}: ranks {failed} failed (of which {hung} "
                                 f"outlived {timeout_s} s)")
        spawn_s = time.perf_counter() - t0
        return ([json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(LM_DP_RANKS)], spawn_s)


def _rel(a, b) -> list[float]:
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def _ranks_alike(runs: list) -> bool:
    """Every rank's losses and norms are rank 0's, and rank 0 saw every
    rank's leaves whole along both axes bit-equal to its own after each step."""
    r0 = runs[0]
    return (all(r["losses"] == r0["losses"] and r["grad_norms"] == r0["grad_norms"]
                for r in runs) and all(x is True for x in r0["replicated_alike"]))


def _f8_fields(f8: dict) -> dict:
    return {"f8": f8, "f8_tols": {"grad_rel": F8_GRAD_REL, "grad_abs": F8_GRAD_ABS,
                                  "moment_v_rel": 2 * F8_GRAD_REL, "update_abs": F8_UPDATE_ABS}}


def lm_train_sharded(keys: tuple, device: str = "cuda:0") -> tuple[dict, float, float]:
    """The `_sharded_configs()` named by `keys` on one pair of gloo ranks on
    `device` (`_sharded_rank`), whose results lm_train_fsdp, lm_train_tp and
    lm_train_ep read: ({key: each rank's run}, seconds from spawn to exit,
    the wall clock at the spawn)."""
    start = time.time()
    ranks, spawn_s = _spawn_ranks(_sharded_rank, device, LM_SHARDED_TIMEOUT_S,
                                  f"lm_train_sharded{list(keys)}", share=True, args=(keys,))
    return {key: [r[key] for r in ranks] for key in ranks[0] if key != "rank"}, spawn_s, start


def lm_train_fsdp(one: dict, predicted: dict, runs: dict, spawn_s: float, start: float) -> dict:
    """lm_train_dp's model, batches and steps on LM_DP_RANKS gloo ranks on
    cuda:0 with the training state sharded over "data" (`runs`, `spawn_s`
    and `start`: `lm_train_sharded`'s, key "fsdp"): each
    step's loss and gradient norm within LM_DP_STEP_RTOL of lm_train_dp's
    one-rank run (`one`), every rank's alike; step 2 held through its
    update (F8); the leaves whole along "data" bit-alike across the ranks;
    each rank's state bytes and each step's wire bytes equal the dry run's
    (2, 1) prediction (`predicted`, from lm_dryrun) exactly; flash_attention
    twice per layer a step on each rank.  Prints the state bytes and peak
    per rank, the gather, reduce-scatter and all-reduce shares of a step
    and the wire bytes, then `profile_lm_train_fsdp_step`: rank 0's last
    step, run under the profiler (the device's idle share; its `step_s` is
    the window's wall).  Returns rank 0's launches."""
    ranks = runs["fsdp"]
    r0 = ranks[0]
    arch, layers, batch = LM_DP
    per_step = {"flash_attention": 2 * layers}
    want = {k: LM_DP_STEPS * c for k, c in per_step.items()}
    loss_rel, norm_rel = _rel(r0["losses"], one["losses"]), _rel(r0["grad_norms"],
                                                                 one["grad_norms"])
    shares = [{k: sum(v[k] for v in secs.values()) / step_s for k in ("all-gather",
                                                                      "reduce-scatter",
                                                                      "all-reduce")}
              for secs, step_s in zip(r0["seconds"], r0["step_s"])][1:]
    check = {
        "losses_within_tol": max(loss_rel) <= LM_DP_STEP_RTOL,
        "grad_norms_within_tol": max(norm_rel) <= LM_DP_STEP_RTOL,
        **f8_checks(r0["f8"]),
        "ranks_alike": _ranks_alike(ranks),
        "state_bytes_as_predicted": all(r["state_bytes"] == predicted["state_bytes"]
                                        for r in ranks),
        "wire_bytes_as_predicted": all(
            sum(sum(k.values()) for k in w.values()) == predicted["wire_bytes"]
            for r in ranks for w in r["wire"]),
        "finite": all(math.isfinite(x) for x in r0["losses"] + r0["grad_norms"]),
        "launches": all(r["launches"] == want for r in ranks),
    }
    emit("lm_train_fsdp", arch=arch, layers=layers, dtype="torch.float32", global_batch=batch,
         seq=LM_DP_S, steps=LM_DP_STEPS, ranks=LM_DP_RANKS, backend="gloo on cuda:0",
         mesh=[LM_DP_RANKS, 1], rules="make_rules(mesh, model_cfg=cfg): fsdp -> data",
         split_leaves=r0["split_leaves"], whole_leaves=r0["whole_leaves"],
         state_bytes_per_rank=[r["state_bytes"] for r in ranks],
         predicted_state_bytes=predicted["state_bytes"],
         replicated_state_bytes=predicted["replicated_state_bytes"],
         peak_gib_per_rank=[r["peak_gib"] for r in ranks],
         one_rank_losses=one["losses"], fsdp_losses=r0["losses"], loss_rel_err=loss_rel,
         one_rank_grad_norms=one["grad_norms"], fsdp_grad_norms=r0["grad_norms"],
         grad_norm_rel_err=norm_rel, step_tol_rel=LM_DP_STEP_RTOL, **_f8_fields(r0["f8"]),
         step_s=[r["step_s"] for r in ranks], collective_s_by_axis=r0["seconds"],
         collective_share_steps_2_on=shares, wire_bytes_by_axis=r0["wire"],
         predicted_wire_bytes=predicted["wire_bytes"], calls_by_axis=r0["calls"],
         largest_gather_bytes=r0["largest_gather"],
         launches_per_rank=[r["launches"] for r in ranks], launches_per_step=per_step,
         spawn_s=spawn_s, timeline_s=_timeline(r0["clock"], start), **check)
    if not all(check.values()):
        raise AssertionError(f"lm_train_fsdp: {check}")
    emit("profile_lm_train_fsdp_step", rank=0, **r0["profile"])
    return r0["launches"]


def lm_train_tp(one: dict, predicted: dict, runs: dict, spawn_s: float, start: float) -> dict:
    """LM_TP's configurations on LM_DP_RANKS gloo ranks on cuda:0,
    tensor-parallel on the (1, 2) ("data", "model") mesh (`runs`, `spawn_s`
    and `start`: `lm_train_sharded`'s, keys "tp_<suffix>"): each
    step's loss and gradient norm within LM_DP_STEP_RTOL of the one-rank
    run's (qwen3: lm_train_dp's, `one`; falcon-mamba: rank 0's own), every
    rank's alike; step 2 held through its update (F8); the leaves whole
    along "model" bit-alike across the ranks; qwen3's state bytes on each
    rank and its wire bytes a step, by axis and kind, equal dryrun_tp's
    count (`predicted`) exactly; flash_attention (qwen3) and mamba_scan
    (falcon-mamba) twice per layer a step on each rank.  Prints each rank's
    state bytes and peak, the model axis' wire bytes and its all-reduces'
    share of a step, then `profile_lm_train_tp_step`: rank 0's last qwen3
    step under the profiler (the device's idle share).  Returns rank 0's
    launches."""
    launches = {}
    for arch, layers, batch, steps, short, from_dp in LM_TP:
        ranks = runs[f"tp_{short}"]
        r0 = ranks[0]
        ref = one if from_dp else r0["one_device"]
        kernel = "flash_attention" if short == "qwen3" else "mamba_scan"
        want = {kernel: 2 * layers * steps}
        loss_rel, norm_rel = _rel(r0["losses"], ref["losses"]), _rel(r0["grad_norms"],
                                                                     ref["grad_norms"])
        model_share = [sum(sec.get("model", {}).values()) / step_s
                       for sec, step_s in zip(r0["seconds"], r0["step_s"])][1:]
        check = {
            "losses_within_tol": max(loss_rel) <= LM_DP_STEP_RTOL,
            "grad_norms_within_tol": max(norm_rel) <= LM_DP_STEP_RTOL,
            **f8_checks(r0["f8"]),
            "ranks_alike": _ranks_alike(ranks),
            "finite": all(math.isfinite(x) for x in r0["losses"] + r0["grad_norms"]),
            "launches": all(r["launches"] == want for r in ranks),
        }
        if from_dp:
            check["state_bytes_as_predicted"] = all(r["state_bytes"] == predicted["state_bytes"]
                                                    for r in ranks)
            check["wire_bytes_as_predicted"] = all(w == predicted["wire_by_axis"]
                                                   for r in ranks for w in r["wire"])
        emit(f"lm_train_tp_{short}", arch=arch, layers=layers, dtype="torch.float32",
             global_batch=batch, seq=LM_DP_S, steps=steps, ranks=LM_DP_RANKS,
             backend="gloo on cuda:0", mesh=list(LM_TP_MESH),
             rules="make_rules(mesh, model_cfg=cfg): fsdp -> data, tp and kv -> model",
             model_split_leaves=r0["model_split_leaves"], whole_leaves=r0["whole_leaves"],
             summed_over_model=r0["summed_over_model"],
             state_bytes_per_rank=[r["state_bytes"] for r in ranks],
             predicted_state_bytes=predicted["state_bytes"] if from_dp else None,
             peak_gib_per_rank=[r["peak_gib"] for r in ranks],
             one_rank_of="lm_train_dp" if from_dp else "rank 0's one-device run",
             one_rank_losses=ref["losses"], tp_losses=r0["losses"], loss_rel_err=loss_rel,
             one_rank_grad_norms=ref["grad_norms"], tp_grad_norms=r0["grad_norms"],
             grad_norm_rel_err=norm_rel, step_tol_rel=LM_DP_STEP_RTOL, **_f8_fields(r0["f8"]),
             step_s=[r["step_s"] for r in ranks], collective_s_by_axis=r0["seconds"],
             model_axis_share_steps_2_on=model_share, wire_bytes_by_axis=r0["wire"],
             model_wire_bytes_per_step=[sum(w.get("model", {}).values()) for w in r0["wire"]],
             predicted_wire_by_axis=predicted["wire_by_axis"] if from_dp else None,
             calls_by_axis=r0["calls"], launches_per_rank=[r["launches"] for r in ranks],
             launches_want=want, spawn_s=spawn_s, timeline_s=_timeline(r0["clock"], start),
             **check)
        if not all(check.values()):
            raise AssertionError(f"lm_train_tp_{short}: {check}")
        launches.update(r0["launches"])
    emit("profile_lm_train_tp_step", rank=0, arch=LM_TP[0][0],
         **runs[f"tp_{LM_TP[0][4]}"][0]["profile"])
    return launches


def lm_train_ep(predicted: dict, runs: dict, spawn_s: float, start: float) -> dict:
    """LM_EP on LM_DP_RANKS gloo ranks on cuda:0, expert-parallel on the
    (1, 2) mesh (`runs`, `spawn_s` and `start`: `lm_train_sharded`'s, key
    "ep_<suffix>"): each step's loss and gradient norm within
    LM_DP_STEP_RTOL of rank 0's one-device run, every rank's alike; step 2
    held through its update (F8); the leaves whole along "model" (the
    router, the norms) bit-alike across the ranks; each rank's state bytes
    and its wire bytes a step, by axis and kind, equal dryrun_ep's count
    (`predicted`) exactly; flash_attention twice per layer a step on each
    rank.  Prints each rank's state bytes and peak, the model axis' wire by
    kind and the all-gathers' share of a step, then
    `profile_lm_train_ep_step`: rank 0's last step under the profiler (the
    device's idle share).  Returns rank 0's launches."""
    arch, layers, batch, steps, short = LM_EP
    ranks = runs[f"ep_{short}"]
    r0 = ranks[0]
    ref = r0["one_device"]
    want = {"flash_attention": 2 * layers * steps}
    loss_rel, norm_rel = _rel(r0["losses"], ref["losses"]), _rel(r0["grad_norms"],
                                                                 ref["grad_norms"])
    model_secs = [sec.get("model", {}) for sec in r0["seconds"]]
    check = {
        "losses_within_tol": max(loss_rel) <= LM_DP_STEP_RTOL,
        "grad_norms_within_tol": max(norm_rel) <= LM_DP_STEP_RTOL,
        **f8_checks(r0["f8"]),
        "ranks_alike": _ranks_alike(ranks),
        "state_bytes_as_predicted": all(r["state_bytes"] == predicted["state_bytes"]
                                        for r in ranks),
        "wire_bytes_as_predicted": all(w == predicted["wire_by_axis"]
                                       for r in ranks for w in r["wire"]),
        "finite": all(math.isfinite(x) for x in r0["losses"] + r0["grad_norms"]),
        "launches": all(r["launches"] == want for r in ranks),
    }
    emit(f"lm_train_ep_{short}", arch=arch, layers=layers, dtype="torch.float32",
         global_batch=batch, seq=LM_DP_S, steps=steps, ranks=LM_DP_RANKS,
         backend="gloo on cuda:0", mesh=list(LM_TP_MESH),
         rules="make_rules(mesh, model_cfg=cfg): fsdp -> data, tp, kv and ep -> model",
         model_split_leaves=r0["model_split_leaves"], whole_leaves=r0["whole_leaves"],
         summed_over_model=r0["summed_over_model"],
         state_bytes_per_rank=[r["state_bytes"] for r in ranks],
         predicted_state_bytes=predicted["state_bytes"],
         peak_gib_per_rank=[r["peak_gib"] for r in ranks],
         one_rank_of="rank 0's one-device run", one_rank_losses=ref["losses"],
         ep_losses=r0["losses"], loss_rel_err=loss_rel, one_rank_grad_norms=ref["grad_norms"],
         ep_grad_norms=r0["grad_norms"], grad_norm_rel_err=norm_rel,
         step_tol_rel=LM_DP_STEP_RTOL, **_f8_fields(r0["f8"]),
         step_s=[r["step_s"] for r in ranks], collective_s_by_axis=r0["seconds"],
         model_axis_share_steps_2_on=[sum(s.values()) / t for s, t in
                                      zip(model_secs, r0["step_s"])][1:],
         all_gather_share_steps_2_on=[s.get("all-gather", 0.0) / t for s, t in
                                      zip(model_secs, r0["step_s"])][1:],
         wire_bytes_by_axis=r0["wire"], predicted_wire_by_axis=predicted["wire_by_axis"],
         calls_by_axis=r0["calls"], launches_per_rank=[r["launches"] for r in ranks],
         launches_want=want, spawn_s=spawn_s, timeline_s=_timeline(r0["clock"], start),
         **check)
    if not all(check.values()):
        raise AssertionError(f"lm_train_ep_{short}: {check}")
    emit("profile_lm_train_ep_step", rank=0, arch=arch, **r0["profile"])
    return r0["launches"]


def lm_serve_sharded(predicted: dict, runs: dict, spawn_s: float, start: float) -> dict:
    """LM_SERVE_SHARDED's configurations on LM_DP_RANKS gloo ranks on cuda:0
    (`runs`, `spawn_s` and `start`: `lm_train_sharded`'s, keys
    "serve_<suffix>"), each held (LM_SERVE_SHARDED's comment) against rank
    0's one-device run and against dryrun_serve's count (`predicted`, by
    suffix, from lm_dryrun).  Prints one line a configuration: prefill
    seconds and ms a decode step (rank 0's under the profiler, beside its
    one-device run's), each axis' collective seconds and share of the
    call, the idle share, the peak GiB per rank and the first step whose
    greedy pick differs from the one-device run's.  Returns {phase: rank
    0's launches}."""
    import dataclasses

    from repro_torch.configs import get_config

    launches = {}
    for short, arch, layers, shape, batch, new in LM_SERVE_SHARDED:
        ranks = runs[f"serve_{short}"]
        r0 = ranks[0]
        want = predicted[short]
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        kernels = {"flash_attention": _mixer_layers(cfg, "attn"),
                   "mamba_scan": _mixer_layers(cfg, "mamba")}
        kernels = {k: c for k, c in kernels.items() if c}
        # each rank's block of the caches' sequence: rank 0's of the dry run
        # shifted by its place along "model", or the whole sequence (None)
        layout = want["cache_layout"]
        n = layout["positions"][1] - layout["positions"][0]
        seq_want = [[r % shape[1] * n, (r % shape[1] + 1) * n]
                    if layout["sequence"] == "model" else None for r in range(len(ranks))]
        ref_picks = r0["one_device"]["picks"]
        diverged = [next((i for i, (a, b) in enumerate(zip(r["picks"], ref_picks)) if a != b),
                         None) for r in ranks]
        wall = r0["profile"]["wall_ms"] / 1e3
        check = {
            "logits_within_tol": max(r0["logit_rel_err"]) <= LM_SERVE_SHARDED_REL,
            "ranks_alike": all(r["picks"] == r0["picks"] and r["digests"] == r0["digests"]
                               for r in ranks),
            "param_bytes_as_predicted": all(r["param_bytes"] == want["param_bytes"]
                                            for r in ranks),
            "cache_bytes_as_predicted": all(r["cache_bytes"] == want["cache_bytes"]
                                            for r in ranks),
            "cache_bytes_equal_jax_share": all(r["cache_bytes"] == want["jax_cache_share"]
                                               for r in ranks),
            "sequence_as_predicted": [r["sequence"] for r in ranks] == seq_want,
            "wire_prefill_as_predicted": all(r["wire_prefill"] == want["wire_prefill"]
                                             for r in ranks),
            "wire_decode_step_as_predicted": all(
                w == want["wire_decode_step"] for r in ranks for w in r["wire_decode_steps"]),
            "decode_steps": all(r["decode_steps"] == new - 1 for r in ranks),
            "finite": all(r["finite"] for r in ranks),
            "launches": all(r["launches_prefill"] == kernels and not r["launches_decode"]
                            for r in ranks),
        }
        emit(f"lm_serve_{short}", arch=arch, layers=layers, dtype="torch.float32",
             global_batch=batch, prompt_len=LM_DP_S, new_tokens=new, ranks=LM_DP_RANKS,
             backend="gloo on cuda:0", mesh=list(shape), rows_per_rank=[r["rows"] for r in ranks],
             rules="make_rules(mesh, model_cfg=cfg): fsdp -> data, tp, kv and ep -> model",
             prefill_s=[r["prefill_s"] for r in ranks],
             ms_per_decode_step=[r["ms_per_decode_step"] for r in ranks],
             under_profiler="rank 0", one_device=r0["one_device"] | {"picks": None},
             collective_s_by_axis=[r["collective_s"] for r in ranks],
             collective_share_rank0={a: t / wall for a, t in r0["collective_s"].items()},
             device_idle_share=r0["profile"]["device_idle_share"],
             window_whole=r0["profile"]["window_whole"],
             peak_gib_per_rank=[r["peak_gib"] for r in ranks],
             logit_rel_err=r0["logit_rel_err"], tol_rel=LM_SERVE_SHARDED_REL,
             first_greedy_divergence=diverged,
             param_bytes_per_rank=[r["param_bytes"] for r in ranks],
             cache_bytes_per_rank=[r["cache_bytes"] for r in ranks],
             jax_cache_share=want["jax_cache_share"],
             sequence_per_rank=[r["sequence"] for r in ranks],
             predicted=want, wire_prefill=r0["wire_prefill"],
             wire_decode_step=r0["wire_decode_steps"][0], wire_logits=r0["wire_logits"],
             launches_prefill=r0["launches_prefill"], launches_decode=r0["launches_decode"],
             launches_want=kernels, spawn_s=spawn_s,
             timeline_s=_timeline(r0["clock"], start), **check)
        if not all(check.values()):
            raise AssertionError(f"lm_serve_{short}: {check}")
        emit(f"profile_lm_serve_{short}", rank=0, **r0["profile"])
        launches[f"lm_serve_{short}"] = r0["launches_prefill"]
    return launches


def start_torchrun() -> tuple:
    """`torchrun --standalone --nproc-per-node=1 -m repro_torch.launch.train`
    (an NCCL group of one rank, the only one a single card allows) at
    lm_train_resume's reduced shape, started in a process of its own that
    `lm_launch_train_torchrun` reads: (process, its command, its temporary
    directory, the start).  It runs beside grid_8ranks, whose wall is no
    metric; a process still running when this one exits is killed then."""
    import atexit
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    root = tempfile.TemporaryDirectory()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node=1", "-m", "repro_torch.launch.train", "--arch", "qwen3-8b",
           "--reduced", "--batch", str(LM_RESUME_B), "--seq", str(LM_RESUME_S), "--steps",
           "8", "--ckpt-dir", os.path.join(root.name, "ckpt")]
    # its output goes to files: a pipe nobody reads until later could fill
    with open(os.path.join(root.name, "out"), "w") as out, \
            open(os.path.join(root.name, "err"), "w") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True, env=env)
    atexit.register(proc.kill)  # a no-op once it has been waited for
    return proc, cmd, root, time.perf_counter()


def lm_launch_train_torchrun(started: tuple) -> None:
    """`start_torchrun`'s launch, within 300 s of its start: a finite `done:
    steps=8` line from its one NCCL rank."""
    proc, cmd, root, t0 = started
    try:
        proc.wait(timeout=max(300 - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    stdout, stderr = (Path(root.name, name).read_text() for name in ("out", "err"))
    root.cleanup()
    done = re.search(r"^done: steps=8 loss=(\S+) restarts=0 ", stdout, re.M)
    group = re.search(r"data-parallel: rank 0 of 1 \(nccl\)", stdout + stderr)
    ok = (proc.returncode == 0 and done is not None and math.isfinite(float(done.group(1)))
          and group is not None)
    emit("lm_launch_train_torchrun", cmd="torchrun " + " ".join(cmd[3:]),
         returncode=proc.returncode, seconds_since_start=time.perf_counter() - t0,
         stdout_tail=stdout[-600:], group=(group.group(0) if group else None), ok=ok)
    if not ok:
        raise AssertionError(f"torchrun launch.train: rc {proc.returncode}, no finite done: "
                             f"line: {stdout[-2000:]} {stderr[-2000:]}")


def lm_score_bf16_kernels(dev, gen) -> dict:
    """bf16 score buffers in the kernel: score_dtype=bf16 (the bf16 body at
    the LM shapes, the f32 body in f32) against
    ref.flash_attention(score_dtype=bf16), held to the LM_SCORE_CASES bounds
    beside the f32-score kernel's distance from the same reference, timed
    beside the f32-score body and (at the prefill shape) SDPA.  Returns the
    prefill shape's timings."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    bf16 = torch.bfloat16
    row = {}
    for B, S, H, KV, hd, dt in LM_SCORE_CASES:
        q = torch.randn(B, S, H, hd, generator=gen, device=dev, dtype=dt)
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev, dtype=dt)
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev, dtype=dt)
        out_k = ops.flash_attention(q, k, v, score_dtype=bf16).float()
        out_p = ref.flash_attention(q, k, v, score_dtype=bf16).float()
        out_f = ops.flash_attention(q, k, v).float()
        torch.cuda.synchronize()
        diff, diff_f = (out_k - out_p).abs(), (out_f - out_p).abs()
        err = {"max": float(diff.max()), "mean": float(diff.mean())}
        err_f = {"max": float(diff_f.max()), "mean": float(diff_f.mean())}
        tol = FLASH_TOL[bf16]  # the scores' dtype's, for f32 inputs too
        check = {
            "within_tol": bool((diff <= tol + tol * out_p.abs()).all()),
            "finite": bool(torch.isfinite(out_k).all()),
            "max_below_f32_scores": err["max"] <= SCORE_FRAC * err_f["max"],
            "mean_below_f32_scores": err["mean"] <= SCORE_FRAC * err_f["mean"]}
        if dt == torch.float32:
            check["within_f32_body_tol"] = bool(
                (diff <= SCORE_F32_BODY_TOL + SCORE_F32_BODY_TOL * out_p.abs()).all())
        elem = q.element_size()
        b = bound(elem * (2 * B * S * H * hd + 2 * B * S * KV * hd),
                  4 * B * H * hd * attention_pairs(S, True, None),
                  BF16_FLOPS if dt == bf16 else FP32_FLOPS)
        fields = dict(
            ms=time_ms(lambda: ops.flash_attention(q, k, v, score_dtype=bf16)),
            ms_f32_scores=time_ms(lambda: ops.flash_attention(q, k, v)),
            device_ms=device_ms(lambda: ops.flash_attention(q, k, v, score_dtype=bf16)),
            device_ms_f32_scores=device_ms(lambda: ops.flash_attention(q, k, v)), **b)
        if (B, S, dt) == (4, LM_PROMPT, bf16):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,  # noqa
                                                          enable_gqa=True)
            fields.update(library_ms=time_ms(sdpa), library_device_ms=device_ms(sdpa),
                          plain_ms=time_ms(lambda: ref.flash_attention(
                              q, k, v, score_dtype=bf16), reps=3))
            row = fields
        emit("kernel_flash_attention_bf16_scores", shape=[B, S, H, KV, hd], dtype=str(dt),
             body="bf16 wgmma" if dt == bf16 else "f32 SIMT", causal=True,
             max_abs_err=err["max"], mean_abs_err=err["mean"], tol=tol,
             f32_body_tol=SCORE_F32_BODY_TOL if dt == torch.float32 else None,
             f32_scores_max_abs_err=err_f["max"], f32_scores_mean_abs_err=err_f["mean"],
             frac=SCORE_FRAC, **check, **fields)
        if not all(check.values()):
            raise AssertionError(f"flash_attention bf16 scores {[B, S, H, KV, hd]} {dt}: "
                                 f"{check}, error {err} against the f32-score kernel's {err_f}")
        del q, k, v, out_k, out_p, out_f, diff, diff_f
    torch.cuda.empty_cache()
    return row


def lm_score_bf16() -> dict:
    """qwen3-8b's first LM_SCORE_LAYERS layers with attn_score_dtype bf16 and
    f32, same weights: the bf16-score prefill logits within LM_LOGIT_REL_TOL
    of the f32-score run's and of the plain path's with bf16 scores, and the
    same ServeEngine and LM_SCORE_STEPS train steps' launches.  Returns the
    bf16-score run's launches."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import SamplerConfig, ServeEngine
    from repro_torch.training import OptConfig, init_train_state, make_train_step

    base = get_config("qwen3-8b")
    prompts = torch.randint(0, base.vocab, (LM_SCORE_B, LM_PROMPT),
                            generator=torch.Generator().manual_seed(4))
    runs = {}
    for sd in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, n_layers=LM_SCORE_LAYERS, attn_score_dtype=sd)
        model = build_model(cfg, seed=0)
        toks = prompts.to(model.device)
        logits, _ = model.prefill({"tokens": toks}, max_len=LM_PROMPT + 8)
        engine = ServeEngine(model, max_len=LM_PROMPT + 8, batch_size=LM_SCORE_B,
                             sampler=SamplerConfig(max_new_tokens=8))
        reset_launches()
        outs = engine.generate(prompts.tolist())
        serve = {k: c for k, c in read_launches().items() if c}
        opt_cfg = OptConfig(warmup_steps=2)
        state = init_train_state(model, torch.Generator(device=model.device).manual_seed(0),
                                 opt_cfg)
        step_fn = make_train_step(model, opt_cfg)
        reset_launches()
        losses = []
        for s in range(LM_SCORE_STEPS):
            state, metrics = step_fn(state, _train_batch(cfg, LM_SCORE_B, LM_PROMPT, s))
            losses.append(metrics["loss"].item())
        train = read_launches()
        runs[sd] = {"logits": logits.float(), "serve": serve, "train": train, "losses": losses,
                    "tokens": outs}
        del model, engine, state, step_fn, metrics, logits, toks
        gc.collect()
        torch.cuda.empty_cache()
    # The plain path with bf16 scores, prefill only.
    cfg = dataclasses.replace(base, n_layers=LM_SCORE_LAYERS, attn_score_dtype="bfloat16")
    model = build_model(cfg, seed=0, backend="ref")
    plain, _ = model.prefill({"tokens": prompts.to(model.device)}, max_len=LM_PROMPT + 8)
    plain = plain.float()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    f32, low = runs["float32"], runs["bfloat16"]
    err = float((low["logits"] - f32["logits"]).abs().max())
    scale = float(f32["logits"].abs().max())
    err_plain = float((low["logits"] - plain).abs().max())
    err_plain_f32 = float((f32["logits"] - plain).abs().max())
    scale_plain = float(plain.abs().max())
    per_step = 2 * LM_SCORE_LAYERS
    check = {"logits_within_tol": err <= LM_LOGIT_REL_TOL * scale,
             "logits_within_tol_of_plain": err_plain <= LM_LOGIT_REL_TOL * scale_plain,
             "same_serve_launches": low["serve"] == f32["serve"] == {
                 "flash_attention": LM_SCORE_LAYERS},
             "same_train_launches": low["train"] == f32["train"] == expected_launches(
                 flash_attention=LM_SCORE_STEPS * per_step),
             "finite": all(math.isfinite(x) for x in low["losses"] + f32["losses"])}
    emit("lm_score_bf16", arch="qwen3-8b", layers=LM_SCORE_LAYERS, batch=LM_SCORE_B,
         S=LM_PROMPT, dtype="torch.bfloat16", logits_max_abs_err=err, logits_max_abs=scale,
         plain_logits_max_abs_err=err_plain, plain_logits_max_abs=scale_plain,
         f32_scores_plain_logits_max_abs_err=err_plain_f32,
         tol_rel=LM_LOGIT_REL_TOL, serve_launches=low["serve"],
         train_launches={k: c for k, c in low["train"].items() if c},
         losses_bf16_scores=low["losses"], losses_f32_scores=f32["losses"],
         first_tokens_bf16_scores=[o[:8] for o in low["tokens"]],
         first_tokens_f32_scores=[o[:8] for o in f32["tokens"]], **check)
    if not all(check.values()):
        raise AssertionError(f"lm_score_bf16: {check}, logits error {err} (scale {scale}), "
                             f"{err_plain} from the plain path (scale {scale_plain})")
    launches = {k: low["serve"].get(k, 0) + low["train"].get(k, 0) for k in low["train"]}
    del runs, f32, low, plain
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# Mixed precision (module item 7).  The LU kernels' bf16 and f16 entry
# points load 2-byte values, compute in f32 and round once where they store.
# lu_panel[_batched] is held bit for bit against its plain version (which
# upcasts, runs the same f32 rounds and rounds back).  fused_trsm_schur
# rounds an f32 result that may differ from the plain version's f32 result
# by FUSED_REL_TOL of the scale (see above); rounding two such values to a
# 2-byte type can part them by one more ulp of that type at the value, so
# each entry is held within that ulp plus FUSED_REL_TOL of the scale.
MIXED_DTYPES = (torch.bfloat16, torch.float16)
MIXED_SHORT = {torch.bfloat16: "bf16", torch.float16: "f16"}
# Refinement targets: f64 working over f32 factors to 1e-12; f32 working
# over bf16 or f16 factors to 1e-6 on a well-conditioned matrix.
MIXED_F64_TOL, MIXED_LOW_TOL = 1e-12, 1e-6
MIXED_BATCH_TOLS = (1e-3, 1e-5, 1e-6)  # per-lane tolerances, in turns
# The kernel and plain paths of a 2-byte factorization with equal pivots
# part by the odd rounding that a sum in another order tips, carried by later
# steps: at most half an ulp at max|F| in every reading on the H100 (N = 128
# Cholesky, eight-rank N = 2048 conflux and cholesky25d, bf16 and f16).
MIXED_PATH_ULPS = 2
# The body that each 2-byte update kernel takes on the paths' shapes: the
# wgmma streams of fused_trsm_schur and schur_update (every operand of a
# path's update is one TMA takes, at v = 32: `fused_schur.stream_mode`,
# `schur_update.stream_mode`).
MIXED_UPDATE_MODE = {"fused_trsm_schur": "wgmma", "fused_trsm_schur_batched": "wgmma",
                     "schur_update": "wgmma", "schur_update_batched": "wgmma"}
# The body that every 2-byte trsm_right_upper[_batched] call of a path takes:
# the register body with the warp's 16-byte loads (each path's B is a new
# contiguous [R, 32] panel: `trsm.right_mode`).
MIXED_RIGHT_MODE = "wide"


def right_modes_ok(seen, launches: dict) -> bool:
    """Whether every right-solve call that `right_modes` counted in a 2-byte
    path took MIXED_RIGHT_MODE, one count for each launch."""
    calls = launches["trsm_right_upper"] + launches["trsm_right_upper_batched"]
    return set(seen) <= {MIXED_RIGHT_MODE} and sum(seen.values()) == calls


def storage_ulp(x: torch.Tensor, dt) -> torch.Tensor:
    """One ulp of the 2-byte dtype `dt` at |x| (x of any float dtype), in
    f32; the subnormal spacing at and below the smallest normal."""
    fi = torch.finfo(dt)
    mant = {torch.bfloat16: 7, torch.float16: 10}[dt]
    _, e = torch.frexp(x.float().abs())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 1 - mant)
    return ulp.clamp_min(fi.tiny * fi.eps)


def mixed_path_tol(F: torch.Tensor) -> float:
    """How far a 2-byte path's factors F may lie from another path's with
    the same pivots: MIXED_PATH_ULPS ulps of F's dtype at max|F|."""
    return MIXED_PATH_ULPS * float(storage_ulp(F.abs().max(), F.dtype))


def mixed_kernel_check(out_k, out_p, dt, scale=None) -> tuple[float, float, dict]:
    """(max error over the entries finite in the plain version, the largest
    error over its allowance, checks) for a 2-byte kernel's result: each
    entry within one ulp of `dt` at the larger of the two values plus
    FUSED_REL_TOL of the scale (the result's largest finite magnitude unless
    given), NaN and inf at the plain version's places."""
    fin = torch.isfinite(out_p)
    err, ratio = 0.0, 0.0
    if bool(fin.any()):
        kf, pf = out_k.float()[fin], out_p.float()[fin]
        scale = float(pf.abs().max()) if scale is None else scale
        diff = (kf - pf).abs()
        allowed = storage_ulp(torch.maximum(kf.abs(), pf.abs()), dt) + FUSED_REL_TOL * scale
        err, ratio = float(diff.max()), float((diff / allowed).max())
    return err, ratio, {"within_tol": ratio <= 1.0,
                        "nan_as_plain": torch.equal(out_k.isnan(), out_p.isnan()),
                        "inf_as_plain": torch.equal(out_k.isinf(), out_p.isinf())}


def mixed_fused_check(out_k, U_k, out_p, U_p, dt) -> tuple[float, float, dict]:
    """`mixed_kernel_check` of a 2-byte fused call's two results, on the
    scale of both (their finite entries), and U01's NaN at the plain
    version's places."""
    scale = max((float(t[torch.isfinite(t)].float().abs().max())
                 if bool(torch.isfinite(t).any()) else 0.0) for t in (out_p, U_p))
    err, ratio, check = mixed_kernel_check(out_k, out_p, dt, scale)
    err_u, ratio_u, _ = mixed_kernel_check(U_k, U_p, dt, scale)
    check["within_tol"] = max(ratio, ratio_u) <= 1.0
    check["u_nan_as_plain"] = torch.equal(U_k.isnan(), U_p.isnan())
    return max(err, err_u), max(ratio, ratio_u), check


def kernel_rows_mixed(dev, gen) -> list[dict]:
    """The bf16 and f16 entry points of lu_panel[_batched] and
    fused_trsm_schur[_batched] against their plain versions, at the paths'
    shapes and the bodies' edges; batched lanes against the single call;
    every fused call must take the body that `fused_schur.stream_mode`
    predicts.  Returns the kernels line's eight rows (launches filled in
    later)."""
    from repro_torch.kernels import fused_schur as fs_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lu_panel import lu_panel, lu_panel_batched

    rows = []
    f32 = torch.float32
    extra = torch.Generator(device=dev).manual_seed(24)
    for dt in MIXED_DTYPES:
        sh = MIXED_SHORT[dt]
        # lu_panel: the main path's shape (a strided column slice of an
        # [N, N] matrix), the bodies' edges, five NaN / inf / tie panels.
        A = torch.randn(N, N, generator=gen, device=dev).to(dt)
        panel = A[:, 64:96]
        weights = (torch.rand(N, generator=gen, device=dev) > 0.1).to(dt)
        failed = []
        cases = [(N, 32, None)] + [(R, v, None) for R, v, _ in LU_PANEL_EDGES
                                   if _ is f32 and (R, v) != (N, 32)]
        cases += [(R, v, case) for R, v in ((N, 32), (512, 32), (4096, 33))
                  for case in LU_PANEL_SPECIAL]
        for R, v, case in cases:
            if (R, v, case) == (N, 32, None):
                P, W = panel, weights
            else:
                X = torch.randn(R, 3 * v, generator=gen, device=dev).to(dt)
                P = X[:, v:2 * v]
                W = (torch.rand(R, generator=gen, device=dev) > 0.1).to(dt)
                if case:
                    P, W = special_panel(case, P, W)
            check = lu_panel_check(lu_panel(P, W), ref.lu_panel(P, W), P, W)
            emit("kernel_lu_panel_mixed", dtype=sh, shape=[R, v], case=case, **check)
            if not all(check.values()):
                failed.append(([R, v], case, check))
        if failed:
            raise AssertionError(f"lu_panel {sh} disagrees with its plain version: {failed}")
        F_k, _, _ = lu_panel(panel, weights)
        F_p, _, _ = ref.lu_panel(panel, weights)
        n_w1 = int((weights > 0).sum())
        rows.append({
            "name": f"lu_panel[{sh}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lu_panel.cu",
            "replaces": "src/repro/kernels/lu_panel.py:71",
            "max_abs_err": float((F_k.float() - F_p.float()).abs().max()),
            "ms": time_ms(lambda: lu_panel(panel, weights)),
            "plain_ms": time_ms(lambda: ref.lu_panel(panel, weights), reps=3),
            **bound(2 * 2 * N * 32 + 4 * N + 5 * 32, panel_ops(N, 32, n_w1)),
            "library_ms": None,
            **device_fields(lambda: lu_panel(panel, weights)),
            "library": "none: no single PyTorch call computes a masked LUP with row weights",
        })
        del F_k, F_p

        # lu_panel_batched: the batched path's shape, the generic body in
        # shared memory (v = 128) and in the work buffer (R = 8192), the
        # one-block body's edges, special panels in five lanes.
        for B, R, v, special in ((BATCH, BATCH_N, 32, None), (4, 8192, 32, None),
                                 (8, 1024, 32, None), (8, 31, 32, None), (5, 1, 32, None),
                                 (3, 100, 128, None), (BATCH, BATCH_N, 32, "special")):
            X = torch.randn(B, R, 3 * v, generator=gen, device=dev).to(dt)
            P = X[:, :, v:2 * v]
            W = (torch.rand(B, R, generator=gen, device=dev) > 0.1).to(dt)
            lanes = (0, B - 1)
            if special:
                P, W = P.clone(), W.clone()
                lanes = tuple(range(len(LU_PANEL_SPECIAL)))
                for b, case in enumerate(LU_PANEL_SPECIAL):
                    P[b], W[b] = special_panel(case, P[b], W[b])
            got = lu_panel_batched(P, W)
            check = lu_panel_check(got, ref.lu_panel_batched(P, W), P, W)
            for b in lanes:
                F1, o1, k1 = lu_panel(P[b], W[b])
                check[f"lane{b}_equals_single"] = (same_bits(F1, got[0][b])
                                                   and torch.equal(o1, got[1][b])
                                                   and torch.equal(k1, got[2][b]))
            emit("kernel_lu_panel_batched_mixed", dtype=sh, shape=[B, R, v], special=special,
                 **check)
            if not all(check.values()):
                raise AssertionError(f"lu_panel_batched {sh} [{B}, {R}, {v}] {special}: {check}")
            if (B, R, v, special) != (BATCH, BATCH_N, 32, None):
                continue
            F_p = ref.lu_panel_batched(P, W)[0]
            n_active = (W > 0).sum(1).tolist()
            rows.append({
                "name": f"lu_panel_batched[{sh}]", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/lu_panel.cu",
                "replaces": "src/repro/kernels/lu_panel.py:98",
                "max_abs_err": float((got[0].float() - F_p.float()).abs().max()),
                "ms": time_ms(lambda: lu_panel_batched(P, W)),
                "plain_ms": time_ms(lambda: ref.lu_panel_batched(P, W), reps=3),
                **bound(B * (2 * 2 * R * v + 4 * R) + 5 * B * v,
                        sum(panel_ops(R, v, n) for n in n_active)),
                "library_ms": None,
                **device_fields(lambda: lu_panel_batched(P, W)),
                "library": "none: no single PyTorch call computes a masked LUP with row weights",
            })

        # fused_trsm_schur: the main path's shape on A itself, then the
        # edges (`fused_inputs`): the stream at v = 8, 16 and 32, ragged M,
        # windows; the plain loads at v = 1, 31, 33, 128, rows of 1000 bytes
        # and an odd row stride; zero rows with NaN / inf, an infinite L10
        # value against a row of U whose parts past hi are 0
        # ("inf_l10_col0"), non-finite U ("nonfinite_u"), and f16 results
        # that overflow to inf on store.  Each call's mode must be
        # `stream_mode`'s prediction.  The cases after the first fourteen
        # draw from a generator of their own (`extra`), so that every later
        # phase draws the same data from `gen` as before they were added.
        modes = {}
        cases = [(N, N, 32, True, "A"), (2048, 1536, 16, False, None),
                 (300, 500, 1, True, None), (300, 500, 31, True, None),
                 (300, 500, 33, True, None), (300, 500, 128, False, None),
                 (777, 96, 32, True, None), (1, 300, 32, True, None), (777, 1, 32, True, None),
                 (1000, 1000, 32, True, "odd_lda"), (1000, 1000, 32, True, "window"),
                 (777, 1000, 32, True, "special"), (777, 1000, 32, False, "special"),
                 (512, 512, 32, True, "overflow"),
                 (1024, 1024, 8, True, None), (1024, 1024, 16, False, None),
                 (777, 1024, 32, True, None), (1000, 1000, 8, True, "window"),
                 (777, 1000, 32, True, "inf_l10_col0"), (777, 1000, 32, False, "nonfinite_u"),
                 (777, 1000, 16, True, "nonfinite_u")]
        for n_case, (M, C, v, unit, form) in enumerate(cases):
            g = gen if n_case < 14 else extra
            if form == "A":
                Am = A
                L00 = (0.3 * torch.tril(torch.randn(v, v, generator=gen, device=dev), -1)
                       + torch.eye(v, device=dev)).to(dt)
                R01 = torch.randn(v, C, generator=gen, device=dev).to(dt)
                L10 = torch.randn(M, v, generator=gen, device=dev).to(dt)
            else:
                kind = form if form in ("odd_lda", "window", "special") else None
                Am, L00, R01, L10 = (t.to(dt) for t in
                                     fused_inputs((), M, C, v, unit, f32, kind, g, dev))
                if kind == "odd_lda":  # keep the odd row stride after the cast
                    Am = torch.empty(M, C + 1, device=dev, dtype=dt)[:, :C].copy_(Am)
                elif kind == "window":
                    Am = torch.empty(M + 32, C + 64, device=dev, dtype=dt)[32:, 64:].copy_(Am)
                if form == "overflow":
                    # One product a result, exact in f32: L10 zero but for
                    # column 0 in {+-1, +-256}, U01's row 0 = R01's row 0 in
                    # {+-100, +-300}, so |A - L10 U01| is near 100, 300,
                    # 25600 or 76800, and f16 (max 65504) rounds the last to
                    # inf on store, far from the boundary.
                    pick = torch.tensor([1.0, -1.0, 256.0, -256.0], device=dev)
                    L10 = torch.zeros(M, v, device=dev, dtype=dt)
                    L10[:, 0] = pick[torch.randint(4, (M,), generator=g, device=dev)].to(dt)
                    R01 = pick[torch.randint(4, (v, C), generator=g, device=dev)] * 100
                    R01 = torch.where(R01.abs() > 200, R01.sign() * 300, R01).to(dt)
                elif form == "inf_l10_col0":
                    # U's row 0 is R01's row 0 (unit), exact in 2 bytes, so
                    # its mid and lo parts are 0: inf * 0 in the split sum
                    # where the whole product is infinite
                    L10[3, 0] = float("inf")
                    L10[5, 0] = float("-inf")
                elif form == "nonfinite_u":
                    R01[2, 7] = float("inf")
                    R01[4, 300] = float("nan")
                    R01[0, 11] = float("-inf")
            out_k, U_k = ops.fused_trsm_schur(Am, L00, R01, L10, unit=unit)
            mode = fs_mod.fused_trsm_schur.mode
            out_p, U_p = ref.fused_trsm_schur(Am, L00, R01, L10, unit=unit)
            torch.cuda.synchronize()
            err, ratio, check = mixed_fused_check(out_k, U_k, out_p, U_p, dt)
            check["mode_as_predicted"] = mode == fs_mod.stream_mode(Am, L00, R01, L10)
            case = f"{[M, C, v]} unit={unit} {form}"
            modes[case] = mode
            emit("kernel_fused_trsm_schur_mixed", dtype=sh, shape=[M, C, v], unit=unit,
                 kind=form, lda=Am.stride(0), mode=mode, max_abs_err=err,
                 err_over_allowance=ratio, inf_count=int(out_k.isinf().sum()), **check)
            if not all(check.values()):
                raise AssertionError(f"fused_trsm_schur {sh} {case}: error {err} "
                                     f"({ratio} of its allowance), {check}")
            if form == "overflow" and dt == torch.float16 and not bool(out_p.isinf().any()):
                raise AssertionError("the f16 overflow case made no inf")
            del out_k, U_k, out_p, U_p
            if form != "A":
                continue

            def yardstick():  # bf16 / f16 GEMM on the tensor cores, U01 rounded first
                return torch.addmm(Am, L10, R01, alpha=-1.0)

            # f32 U01 would be another function: the yardstick's third
            # operand is R01 in the storage dtype, as the JAX "ref" backend
            # rounds U01 first.

            rows.append({
                "name": f"fused_trsm_schur[{sh}]", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/fused_schur.cu",
                "replaces": "src/repro/kernels/fused_schur.py:83",
                "max_abs_err": err, "mode": mode,
                "ms": time_ms(lambda: ops.fused_trsm_schur(Am, L00, R01, L10)),
                "plain_ms": time_ms(lambda: ref.fused_trsm_schur(Am, L00, R01, L10)),
                **bound(2 * (2 * M * C + v * v + 2 * v * C + M * v), 2 * M * C * v + v * v * C),
                "library_ms": None,
                **device_fields(lambda: ops.fused_trsm_schur(Am, L00, R01, L10)),
                "library": "none: no PyTorch call solves and updates 2-byte operands in f32 "
                           "(cuBLAS trsm has no bf16 or f16)",
                "yardstick_addmm_2byte_ms": time_ms(yardstick),
                "yardstick_addmm_2byte_device_ms": device_ms(yardstick),
            })
        emit("fused_trsm_schur_mixed_modes", dtype=sh, **modes)
        del A, panel

        # fused_trsm_schur_batched: the batched path's shape, edges, lanes
        # against the single call.
        for B, M, C, v, unit, kind in ((BATCH, BATCH_N, BATCH_N, 32, True, None),
                                       (8, 300, 500, 33, True, None),
                                       (4, 777, 1000, 32, False, "special"),
                                       (4, 1000, 1000, 32, True, "window"),
                                       (1, BATCH_N, BATCH_N, 32, True, None),
                                       (8, 777, 1024, 16, True, None)):
            g = extra if (B, M, v) == (8, 777, 16) else gen
            A3, L00, R01, L10 = (t.to(dt) for t in
                                 fused_inputs((B,), M, C, v, unit, f32, kind, g, dev))
            if kind == "window":
                A3 = torch.empty(B, M + 32, C + 64, device=dev, dtype=dt)[:, 32:, 64:].copy_(A3)
            out_k, U_k = ops.fused_trsm_schur_batched(A3, L00, R01, L10, unit=unit)
            mode = fs_mod.fused_trsm_schur_batched.mode
            out_p, U_p = ref.fused_trsm_schur_batched(A3, L00, R01, L10, unit=unit)
            torch.cuda.synchronize()
            err, ratio, check = mixed_fused_check(out_k, U_k, out_p, U_p, dt)
            check["mode_as_predicted"] = mode == fs_mod.stream_mode(A3, L00, R01, L10)
            for b in sorted({0, B - 1}):
                o1, u1 = ops.fused_trsm_schur(A3[b], L00[b], R01[b], L10[b], unit=unit)
                check[f"lane{b}_equals_single"] = same_bits(o1, out_k[b]) and same_bits(u1, U_k[b])
            emit("kernel_fused_trsm_schur_batched_mixed", dtype=sh, shape=[B, M, C, v],
                 unit=unit, kind=kind, mode=mode, max_abs_err=err, err_over_allowance=ratio,
                 **check)
            if not all(check.values()):
                raise AssertionError(f"fused_trsm_schur_batched {sh} {[B, M, C, v]} {kind}: "
                                     f"error {err} ({ratio} of its allowance), {check}")
            if (B, M, kind) != (BATCH, BATCH_N, None):
                continue

            def yardstick_b():  # as `yardstick` above, batched
                return torch.baddbmm(A3, L10, R01, alpha=-1.0)

            rows.append({
                "name": f"fused_trsm_schur_batched[{sh}]", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/fused_schur.cu",
                "replaces": "src/repro/kernels/fused_schur.py:117",
                "max_abs_err": err, "mode": mode,
                "ms": time_ms(lambda: ops.fused_trsm_schur_batched(A3, L00, R01, L10)),
                "plain_ms": time_ms(lambda: ref.fused_trsm_schur_batched(A3, L00, R01, L10)),
                **bound(2 * B * (2 * M * C + v * v + 2 * v * C + M * v),
                        B * (2 * M * C * v + v * v * C)),
                "library_ms": None,
                **device_fields(lambda: ops.fused_trsm_schur_batched(A3, L00, R01, L10)),
                "library": "none: as fused_trsm_schur[2-byte]",
                "yardstick_baddbmm_2byte_ms": time_ms(yardstick_b),
                "yardstick_baddbmm_2byte_device_ms": device_ms(yardstick_b),
            })
        torch.cuda.empty_cache()
    return rows



def well_conditioned(shape, gen, dev) -> torch.Tensor:
    """G / sqrt(n) + 2 I for a standard normal G [..., n, n], made on the
    card: G / sqrt(n) has its spectrum in the unit disk (the circular law)
    and its singular values in [0, 2], so the singular values of the sum lie
    in about [1, 3] and cond(A) is about 3, far below the 256 = 1 / eps(bf16)
    past which bf16 factors cannot drive refinement.  Not symmetric, so the
    LU pivots."""
    n = shape[-1]
    A = torch.randn(*shape, generator=gen, device=dev) / n ** 0.5
    A.diagonal(dim1=-2, dim2=-1).add_(2.0)
    return A


def cond_estimate(A: torch.Tensor, iters: int = 30) -> float:
    """cond_2(A) of one [n, n] system estimated on the card: sigma_max by
    power iteration on A^T A, sigma_min by inverse iteration through
    torch.linalg.lu_factor of A in f64 (a yardstick only: the port never
    calls it)."""
    A64 = A.double()
    x = torch.ones(A.shape[-1], device=A.device, dtype=torch.float64)
    for _ in range(iters):
        x = A64.mT @ (A64 @ x)
        smax2 = x.norm()
        x = x / smax2
    LU, piv = torch.linalg.lu_factor(A64)
    y = torch.ones_like(x)
    for _ in range(iters):
        z = torch.linalg.lu_solve(LU, piv, y[:, None], adjoint=True)[:, 0]
        y = torch.linalg.lu_solve(LU, piv, z[:, None])[:, 0]
        smin2_inv = y.norm()
        y = y / smin2_inv
    return float((smax2 * smin2_inv) ** 0.5)


def mixed_f64_main_path(dev, gen) -> dict:
    """plan(N, dtype="float64", compute_dtype="float32").execute(A).solve(b,
    refine_tol=1e-12) beside plan(N, dtype="float64").execute(A).solve(b) on
    the f64 kernels, on one standard normal A.  Returns the launches of the
    counted (mixed) run."""
    from repro_torch.api import SolverConfig, plan

    A = torch.randn(N, N, generator=gen, device=dev, dtype=torch.float64)
    b = torch.randn(N, generator=gen, device=dev, dtype=torch.float64)
    p = plan(N, v32(dtype="float64", compute_dtype="float32"))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fact = p.execute(A)
    torch.cuda.synchronize()
    execute_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    rs = fact.solve(b, refine_tol=MIXED_F64_TOL)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    resid = hpl_residual(A, rs.x, b)
    steps = N // p.config.v
    f32_factors = fact.F.dtype == torch.float32 and fact.A_ref.dtype == torch.float64
    del fact
    p64 = plan(N, v32(dtype="float64"))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f64 = p64.execute(A)
    torch.cuda.synchronize()
    execute64_s = time.perf_counter() - t0
    launches64 = read_launches()
    t0 = time.perf_counter()
    x64 = f64.solve(b)
    torch.cuda.synchronize()
    solve64_s = time.perf_counter() - t0
    resid64 = hpl_residual(A, x64, b)
    rel = float((rs.x - x64).norm() / x64.norm())
    emit("mixed_f64_main_path", N=N, v=p.config.v, backend=p.config.backend,
         launches=launches, execute_s=execute_s, refine_s=refine_s,
         refinement_iters=rs.refinement_iters, final_residual=rs.final_residual,
         converged=rs.converged, hpl_residual_f64=resid, f64_launches=launches64,
         f64_execute_s=execute64_s, f64_solve_s=solve64_s, f64_hpl_residual=resid64,
         x_refined_vs_f64_rel=rel, f32_factors=f32_factors)
    if launches != expected_launches(lu_panel=steps, fused_trsm_schur=steps) or \
            launches64 != launches:
        raise AssertionError(f"expected {steps} launches of each LU kernel: {launches}, "
                             f"f64 {launches64}")
    if not (f32_factors and rs.converged and resid < HPL_RESIDUAL_MAX
            and resid64 < HPL_RESIDUAL_MAX and torch.isfinite(rs.x).all()):
        raise AssertionError(f"f64 over f32: converged {rs.converged}, HPL {resid} "
                             f"(f64 plan {resid64}), f32 factors {f32_factors}")
    torch.cuda.empty_cache()
    return launches


def _refined_run(p, A, b, phase: str, want: dict, dt, update: str,
                 converge: bool = True, **fields) -> dict:
    """Execute plan p on A (launches counted from 0), solve b plain and
    refined to MIXED_LOW_TOL; emits the phase and fails unless the launches
    are `want`, the factors are in dt, the last call of the `update` kernel
    took the mode that its body takes on the paths' shapes
    (`MIXED_UPDATE_MODE`) and the refined answer is finite; where `converge`,
    also unless refinement converged and the refined answer's HPL residual
    (f32) is below 16; and, in 2-byte compute, unless every right-solve call
    took MIXED_RIGHT_MODE.  Returns the launches."""
    upd = _wrappers()[update]
    upd.mode = None
    reset_launches()
    torch.cuda.synchronize()
    with right_modes() as seen:
        t0 = time.perf_counter()
        fact = p.execute(A)
        torch.cuda.synchronize()
        execute_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    x_plain = fact.solve(b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rs = fact.solve(b, refine_tol=MIXED_LOW_TOL)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    conv = torch.as_tensor(rs.converged)
    row = {"execute_s": execute_s, "solve_s": solve_s, "refine_s": refine_s,
           "launches": launches, "factor_dtype": str(fact.F.dtype), "kind": fact.kind,
           "last_update_mode": upd.mode, "right_modes": dict(seen),
           "refinement_iters": torch.as_tensor(rs.refinement_iters).tolist(),
           "final_residual_max": float(torch.as_tensor(rs.final_residual).max()),
           "converged": bool(conv.all()), "x_finite": bool(torch.isfinite(rs.x).all()),
           "hpl_residual_refined_f32": hpl_residual(A, rs.x, b),
           "hpl_residual_plain_f32": hpl_residual(A, x_plain, b), **fields}
    emit(phase, **row)
    if launches != want:
        raise AssertionError(f"{phase}: expected launches {want}, got {launches}")
    if not (fact.F.dtype == dt and row["last_update_mode"] == MIXED_UPDATE_MODE[update]
            and row["x_finite"] and (dt.itemsize != 2 or right_modes_ok(seen, launches))):
        raise AssertionError(f"{phase}: {row}")
    if converge and not (row["converged"]
                         and row["hpl_residual_refined_f32"] < HPL_RESIDUAL_MAX):
        raise AssertionError(f"{phase}: refinement did not reach {MIXED_LOW_TOL}: {row}")
    return launches


def mixed_low_main_path(dev, gen, dt) -> dict:
    """plan(N, compute_dtype=bf16 | f16).execute(A) through the entry points
    (f32 working): exactly N / v launches of each LU kernel, all in the
    compute dtype, and the wgmma stream in every fused call; refinement to
    1e-6 reported on a standard normal A and held on `well_conditioned`.
    Returns the launches of the counted run on the standard normal A."""
    from repro_torch.api import SolverConfig, plan

    sh = MIXED_SHORT[dt]
    p = plan(N, v32(compute_dtype=str(dt).removeprefix("torch.")))
    steps = N // p.config.v
    want = expected_launches(lu_panel=steps, fused_trsm_schur=steps)
    out = {}
    for kind in ("gauss", "well_conditioned"):
        A = (torch.randn(N, N, generator=gen, device=dev) if kind == "gauss"
             else well_conditioned((N, N), gen, dev))
        b = torch.randn(N, generator=gen, device=dev)
        cond = cond_estimate(A) if kind == "well_conditioned" else None
        out[kind] = _refined_run(p, A, b, f"mixed_{sh}_main_path", want, dt,
                                 "fused_trsm_schur", converge=kind == "well_conditioned",
                                 N=N, v=p.config.v, matrix=kind, cond_estimate=cond)
        if kind == "gauss":
            emit(f"profile_{sh}_execute", **profile_once(lambda: p.execute(A)))
        del A
    torch.cuda.empty_cache()
    return out["gauss"]


def mixed_batched_path(dev, gen, dt, strategy: str = "auto",
                       kernels=("lu_panel_batched", "fused_trsm_schur_batched"),
                       phase: str = "mixed_batched_path", profile: bool = True) -> dict:
    """plan((256, 512), strategy, compute_dtype=bf16 | f16) with per-lane
    refine_tol, on `well_conditioned` systems (LU) or `spd` ones (Cholesky):
    16 launches of each of `kernels` (the last the update, which must take
    its `MIXED_UPDATE_MODE`), every lane refined to its own tolerance.
    Returns the launches of the counted run."""
    from repro_torch.api import SolverConfig, plan

    sh = MIXED_SHORT[dt]
    make = spd if strategy == CHOL else well_conditioned
    A = make((BATCH, BATCH_N, BATCH_N), gen, dev)
    b = torch.randn(BATCH, BATCH_N, generator=gen, device=dev)
    tols = torch.tensor([MIXED_BATCH_TOLS[i % len(MIXED_BATCH_TOLS)] for i in range(BATCH)],
                        device=dev)
    p = plan((BATCH, BATCH_N), SolverConfig(strategy=strategy,
                                            compute_dtype=str(dt).removeprefix("torch.")))
    update = _wrappers()[kernels[-1]]
    update.mode = None
    reset_launches()
    torch.cuda.synchronize()
    with right_modes() as seen:
        t0 = time.perf_counter()
        fact = p.execute(A)
        torch.cuda.synchronize()
        execute_s = time.perf_counter() - t0
    launches = read_launches()
    mode = update.mode
    t0 = time.perf_counter()
    rs = fact.solve(b, refine_tol=tols)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t0
    steps = BATCH_N // p.config.v
    iters = {f"tol={t:g}": sorted(set(rs.refinement_iters[tols == torch.tensor(t, device=dev)]
                                       .tolist()))
             for t in MIXED_BATCH_TOLS}
    resid = hpl_residuals(A, rs.x, b)
    emit(f"{phase}_{sh}", B=BATCH, N=BATCH_N, v=p.config.v, launches=launches,
         execute_s=execute_s, refine_s=refine_s, last_update_mode=mode,
         right_modes=dict(seen), iterations_by_tol=iters, converged_lanes=int(rs.converged.sum()),
         final_residual_max=float(rs.final_residual.max()),
         hpl_residual_refined_max=float(resid.max()), factor_dtype=str(fact.F.dtype))
    if launches != expected_launches(**{k: steps for k in kernels}):
        raise AssertionError(f"{phase} {sh}: expected {steps} launches each of {kernels}, "
                             f"got {launches}")
    if not (bool(rs.converged.all()) and fact.F.dtype == dt
            and mode == MIXED_UPDATE_MODE[kernels[-1]]
            and bool((resid < HPL_RESIDUAL_MAX).all()) and right_modes_ok(seen, launches)):
        raise AssertionError(f"{phase} {sh}: {int(rs.converged.sum())} of {BATCH} converged, "
                             f"HPL {float(resid.max())}, mode {mode}, right solves {dict(seen)}")
    if profile:
        emit(f"profile_batched_{sh}_execute", **profile_once(lambda: p.execute(A)))
    return launches


class _RecordingBackend:
    """A registered backend's primitives, keeping each step's panel input."""

    def __init__(self, inner):
        self.inner, self.panels = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def panel_lup(self, panel, weights, v):
        self.panels.append((panel.clone(), weights.clone()))
        return self.inner.panel_lup(panel, weights, v)

    def panel_lup_batched(self, panel, weights, v):
        self.panels.append((panel.clone(), weights.clone()))
        return self.inner.panel_lup_batched(panel, weights, v)


def _round_candidates(panel: torch.Tensor, weights: torch.Tensor, r: int) -> torch.Tensor:
    """|F[i, r]| * w[i] of every row at round r of the plain panel LUP: the
    rounds of `masked_lup` in f32 on the widened panel, stopped at r."""
    F, w = panel.float().clone(), weights.float().clone()
    cols = torch.arange(F.shape[1], device=F.device)
    for k in range(r):
        p = int(torch.argmax(F[:, k].abs() * w))
        w[p] = 0
        piv = F[p, k]
        safe = torch.where(piv.abs() > 0, piv, torch.ones_like(piv))
        active = w > 0
        mult = torch.where(active, F[:, k] / safe, F[:, k])
        F[:, k] = mult
        F = F - torch.where(active, mult, 0.0)[:, None] * (F[p, :] * (cols > k).float())[None, :]
    return F[:, r].abs() * w


def mixed_plain_128(dev, gen) -> None:
    """The bf16 and f16 kernel paths against the plain paths (backend "ref")
    at N = 128, single and batched (64 systems): pivots identical.  Where a
    system's pivots differ, the first differing pivot is reported with the
    gap between the two candidates the paths chose, in ulps of the compute
    dtype, in the kernel path's state at that round, beside the largest
    difference of any candidate between the two paths' states there.  A gap
    above one ulp and above that difference is a fault; a near tie within
    them is how two rightly rounded paths part."""
    from repro_torch.core.lu.sequential import lu_masked_sequential, lu_masked_sequential_batched
    from repro_torch.kernels import backend as bk_mod

    n, v, B = 128, 32, 64
    rec = {name: _RecordingBackend(bk_mod.get_backend(name)) for name in ("cuda", "ref")}
    for name, r in rec.items():
        bk_mod.register_backend(f"{name}_recording", r, overwrite=True)
    faults = []
    for dt in MIXED_DTYPES:
        sh = MIXED_SHORT[dt]
        for batched in (False, True):
            A = torch.randn(*((B,) if batched else ()), n, n, generator=gen, device=dev).to(dt)
            out = {}
            for name, r in rec.items():
                r.panels.clear()
                lu = lu_masked_sequential_batched if batched else lu_masked_sequential
                out[name] = lu(A, v, f"{name}_recording", device=dev)
            rows_k, rows_p = out["cuda"][1], out["ref"][1]
            lanes = [None] if not batched else range(B)
            differing = []
            for lane in lanes:
                rk = rows_k if lane is None else rows_k[lane]
                rp = rows_p if lane is None else rows_p[lane]
                diff = (rk != rp).nonzero()
                if not len(diff):
                    continue
                k = int(diff[0])
                step, rr = divmod(k, v)
                cand = {}
                for name, r in rec.items():
                    P, W = r.panels[step]
                    if lane is not None:
                        P, W = P[lane], W[lane]
                    cand[name] = _round_candidates(P, W, rr)
                ck = cand["cuda"]
                i, j = int(rk[k]), int(rp[k])
                ulp = float(storage_ulp(torch.maximum(ck[i], ck[j]), dt))
                gap = float((ck[i] - ck[j]).abs()) / ulp
                spread = float((cand["cuda"] - cand["ref"]).abs().max()) / ulp
                differing.append({"lane": lane, "pivot": k, "kernel_row": i, "plain_row": j,
                                  "gap_ulps": gap, "state_spread_ulps": spread})
                if gap > max(1.0, spread):
                    faults.append((sh, batched, differing[-1]))
            emit("mixed_plain_128", dtype=sh, batched=batched, N=n, v=v,
                 systems=B if batched else 1,
                 rows_equal_systems=(B if batched else 1) - len(differing),
                 differing=differing[:8])
    for name in rec:
        bk_mod._BACKENDS.pop(f"{name}_recording", None)
    if faults:
        raise AssertionError(f"pivots part beyond a near tie: {faults}")


def _mixed_requests(rng, count: int):
    """Ragged well-conditioned requests (G / sqrt(n) + 2 I, n uniform in
    SERVE_MIN_N..SERVE_N) with every other one asking for refinement to
    MIXED_LOW_TOL, from a seeded numpy generator."""
    import numpy as np

    out = []
    for i, n in enumerate(rng.integers(SERVE_MIN_N, SERVE_N + 1, size=count)):
        A = (rng.standard_normal((n, n)) / np.sqrt(n) + 2 * np.eye(n)).astype(np.float32)
        out.append((A, rng.standard_normal(n).astype(np.float32),
                    MIXED_LOW_TOL if i % 2 else None))
    return out


def _check_mixed_answers(requests, answers, phase: str, dt) -> dict:
    """HPL residuals: refined answers against f32's eps (< 16), plain ones
    against the compute dtype's eps, as accurate as its factors allow."""
    out = {"refined": [], "plain": []}
    for (A, b, tol), x in zip(requests, answers):
        r = hpl_residuals(torch.from_numpy(A), x.cpu().float(), torch.from_numpy(b))
        scale = 1.0 if tol else torch.finfo(torch.float32).eps / torch.finfo(dt).eps
        out["refined" if tol else "plain"].append(float(r) * scale)
    worst = {k: max(v) for k, v in out.items()}
    if not all(w < HPL_RESIDUAL_MAX for w in worst.values()):
        raise AssertionError(f"{phase}: HPL scaled residuals {worst}")
    return worst


def serving_mixed_sync(dt=torch.bfloat16, count: int = 192, phase: str = "serving_mixed_sync",
                       strategy: str = "auto", make=_mixed_requests,
                       kernel: str = "lu_panel_batched",
                       update: str = "fused_trsm_schur_batched") -> None:
    """SolveEngine(512) on a bf16 plan: ragged requests, half of them refined;
    `kernel` must have been launched, and the last `update` call must have
    taken its `MIXED_UPDATE_MODE`."""
    import numpy as np
    from repro_torch.api import SolverConfig
    from repro_torch.serving import SolveEngine

    requests = make(np.random.default_rng(2), count)
    eng = SolveEngine(SERVE_N, SolverConfig(strategy=strategy,
                                            compute_dtype=str(dt).removeprefix("torch.")))
    upd = _wrappers()[update]
    upd.mode = None
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = [eng.submit_system(A, b, refine_tol=tol) for A, b, tol in requests]
    xs = eng.flush_systems()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    st = eng.stats()
    worst = _check_mixed_answers(requests, [xs[t] for t in tickets], phase, dt)
    emit(phase, dtype=MIXED_SHORT[dt], N=SERVE_N, strategy=strategy, requests=count,
         wall_s=wall_s, requests_per_s=count / wall_s, launches=launches,
         refined_systems=st["refined_systems"], refine_iters_total=st["refine_iters_total"],
         refine_nonconverged=st["refine_nonconverged"], hpl_residual_max=worst,
         batched_factorizations=st["batched_factorizations"], last_update_mode=upd.mode)
    if st["refined_systems"] != sum(1 for *_, t in requests if t) or \
            st["refine_nonconverged"] or launches[kernel] == 0 or \
            upd.mode != MIXED_UPDATE_MODE[update]:
        raise AssertionError(f"{phase}: {st}, launches {launches}, {update} took {upd.mode!r}")


def serving_mixed_async(dt=torch.bfloat16, per_tenant: int = 32,
                        phase: str = "serving_mixed_async", strategy: str = "auto",
                        make=_mixed_requests, kernel: str = "lu_panel_batched",
                        update: str = "fused_trsm_schur_batched") -> None:
    """AsyncSolveEngine(512) on a bf16 plan: four tenant threads, half of the
    requests refined; `kernel` must have been launched, and the last `update`
    call must have taken its `MIXED_UPDATE_MODE`."""
    import threading

    import numpy as np
    from repro_torch.api import SolverConfig
    from repro_torch.serving import AsyncSolveEngine

    reqs = [make(np.random.default_rng(30 + t), per_tenant) for t in range(ASYNC_TENANTS)]
    futures: list[list] = [[] for _ in range(ASYNC_TENANTS)]
    eng = AsyncSolveEngine(SERVE_N, SolverConfig(strategy=strategy,
                                                 compute_dtype=str(dt).removeprefix("torch.")),
                           max_batch=ASYNC_MAX_BATCH, max_delay_ms=ASYNC_DELAY_MS)
    upd = _wrappers()[update]
    upd.mode = None
    reset_launches()

    def tenant(t: int) -> None:
        for A, b, tol in reqs[t]:
            futures[t].append(eng.submit(A, b, tenant=f"tenant{t}", refine_tol=tol))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=tenant, args=(t,)) for t in range(ASYNC_TENANTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    answers = [[f.result(timeout=300) for f in futs] for futs in futures]
    wall_s = time.perf_counter() - t0
    eng.close()
    launches = read_launches()
    st = eng.stats()
    total = ASYNC_TENANTS * per_tenant
    worst = [_check_mixed_answers(r, a, phase, dt) for r, a in zip(reqs, answers)]
    worst = {k: max(w[k] for w in worst) for k in worst[0]}
    emit(phase, dtype=MIXED_SHORT[dt], N=SERVE_N, strategy=strategy, requests=total,
         wall_s=wall_s,
         requests_per_s=total / wall_s, latency_ms=st["async"]["latency_ms"],
         served=st["async"]["served"], spilled=st["async"]["spilled"],
         failed=st["async"]["failed"], refined_systems=st["refined_systems"],
         refine_iters_total=st["refine_iters_total"],
         refine_nonconverged=st["refine_nonconverged"], launches=launches,
         hpl_residual_max=worst, last_update_mode=upd.mode)
    refined = sum(1 for r in reqs for *_, t in r if t)
    if (st["async"]["served"] + st["async"]["spilled"] != total or st["async"]["failed"]
            or st["refined_systems"] + st["async"]["spilled"] < refined
            or st["refine_nonconverged"] or launches[kernel] == 0
            or upd.mode != MIXED_UPDATE_MODE[update]):
        raise AssertionError(f"{phase}: {st['async']}, refined "
                             f"{st['refined_systems']} of {refined}, launches {launches}, "
                             f"{update} took {upd.mode!r}")


# --------------------------------------------------------------------------
# Mixed precision on the Cholesky kernels and the 2.5D schedules: the bf16
# and f16 entry points of chol_panel, trsm_right_upper, trsm_left_lower and
# schur_update (rows 5-12 of PERF.md's kernel table) and the paths they
# open: sequential_chol single and batched, its engines, and conflux,
# baseline2d and cholesky25d on a 1x1x1 grid and on eight gloo ranks.
# --------------------------------------------------------------------------


def _library_refusal(fn) -> str | None:
    """None where `fn()` runs, else the first line of its error: whether a
    PyTorch call takes 2-byte operands on this card."""
    try:
        fn()
        torch.cuda.synchronize()
        return None
    except (RuntimeError, NotImplementedError) as e:
        return str(e).splitlines()[0][:160]


# The 2-byte trsm_right_upper cases: (Bb or None for a single system, R, v,
# U's kind, special input, the body the launcher's rule gives).
RIGHT_MIXED_CASES = (
    (None, N, CHOL_V, "mT", None, "wide"), (BATCH, BATCH_N, CHOL_V, "mT", None, "wide"),
    (8, 2000, 24, "mT", None, "wide"), (None, 2000, 24, "mT", None, "wide"),
    (8, 1000, 1, "mT", None, "plain"), (8, 1000, 31, "upper", None, "plain"),
    (8, 1000, 33, "mT", None, "smem"), (4, 300, 128, "mT", None, "smem"),
    (None, 1, CHOL_V, "mT", None, "wide"), (None, 9, CHOL_V, "mT", None, "wide"),
    (None, 100_000, CHOL_V, "upper", None, "wide"),
    (None, 1000, CHOL_V, "mT", "window", "wide"),
    (None, 1000, CHOL_V, "mT", "window_off1", "plain"),
    (4, 777, CHOL_V, "upper", "nan_inf", "wide"), (4, 777, CHOL_V, "upper", "zero_diag", "wide"),
    (4, 777, CHOL_V, "upper", "overflow", "wide"))


def right_solve_inputs(Bb, R: int, v: int, ukind: str, special, dt, gen, dev):
    """(B, U) of a 2-byte trsm_right_upper case: U = L00^T of an SPD block
    ("mT", a transposed view, as the Cholesky paths pass it) or a plain
    upper U with its diagonal raised by 4 ("upper", as the LU conflux path
    passes U00); B standard normal with its top quarter of rows zero, as the
    paths pass it; [R, v] and [v, v] where Bb is None, else [Bb, R, v] and
    [Bb, v, v].  `special`: "window" (B the middle v columns of a [R, 3v]
    buffer), "window_off1" (one column further in), "nan_inf" (a NaN and an
    inf row), "zero_diag" (U[5, 5] = 0) or "overflow" (U's diagonal 1/1024,
    B times 4000: f16 quotients past 65504)."""
    from repro_torch.kernels import ref

    nb = 1 if Bb is None else Bb
    if ukind == "mT":
        U = ref.chol_panel_batched(spd((nb, v, v), gen, dev)).mT.to(dt)
    else:
        U = torch.triu(torch.randn(nb, v, v, generator=gen, device=dev))
        U.diagonal(dim1=-2, dim2=-1).add_(4.0)
        if special == "overflow":
            U = torch.diag_embed(torch.full((nb, v), 1 / 1024, device=dev))
        U = U.to(dt)
    Bm = torch.randn(nb, R, v, generator=gen, device=dev)
    if special == "overflow":
        Bm *= 4000.0
    Bm = Bm.to(dt)
    if special in ("window", "window_off1"):
        c0 = v + (special == "window_off1")
        Bm = torch.zeros(nb, R, 3 * v, device=dev, dtype=dt)[..., c0:c0 + v].copy_(Bm)
    Bm[:, :R // 4] = 0.0
    if special == "nan_inf":
        Bm[:, R // 2, v // 3] = float("nan")
        Bm[:, R // 2 + 1, 0] = float("inf")
    if special == "zero_diag":
        U[:, 5, 5] = 0.0
    return (Bm, U) if Bb is not None else (Bm[0], U[0])


def kernel_rows_mixed_chol(dev, gen) -> list[dict]:
    """The bf16 and f16 entry points of chol_panel, trsm_right_upper,
    trsm_left_lower and schur_update (single and batched) against their
    plain versions, at the paths' shapes and the bodies' edges: chol_panel
    bit for bit, the solves and the update within one ulp plus
    FUSED_REL_TOL; batched lanes bit for bit against the single call; every
    schur_update call in the body that `stream_mode` predicts, and that
    body the one reckoned for the case.  Returns the kernels line's sixteen
    rows (launches filled in later)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import schur_update as su_mod
    from repro_torch.kernels import trsm as trsm_mod

    rows = []
    for dt in MIXED_DTYPES:
        sh = MIXED_SHORT[dt]
        eye = torch.eye(CHOL_V, device=dev, dtype=dt)
        chol_lib = _library_refusal(lambda: torch.linalg.cholesky_ex(eye))
        tri_lib = _library_refusal(lambda: torch.linalg.solve_triangular(eye, eye, upper=True))

        # chol_panel[_batched]: the batched path's stack in a strided buffer
        # (lane 0 the single path's block), the register body's edges v = 1
        # and 31, the shared-memory body at v = 33 and 128, a block that is
        # not SPD and one with an inf below the diagonal: bit for bit.
        for B, v in ((BATCH, CHOL_V), (64, 1), (64, 31), (64, 33), (8, 128)):
            buf = torch.zeros(B, v, 2 * v, device=dev, dtype=dt)
            buf[:, :, v:] = spd((B, v, v), gen, dev).to(dt)
            blocks = buf[:, :, v:]
            bad = blocks.clone()
            bad[:, min(5, v - 1), min(5, v - 1)] = -1.0
            inf = blocks.clone()
            if v > 1:
                inf[:, v - 1, (v - 1) // 2] = float("inf")
            check = {}
            for case, X in (("spd", blocks), ("not_spd", bad), ("inf_entry", inf)):
                L_k = ops.chol_panel_batched(X)
                check[f"{case}_bit_identical"] = same_bits(L_k, ref.chol_panel_batched(X))
                for b in (0, B - 1):
                    check[f"{case}_lane{b}_equals_single"] = same_bits(ops.chol_panel(X[b]),
                                                                       L_k[b])
            emit("kernel_chol_panel_batched_mixed", dtype=sh, shape=[B, v, v],
                 body="registers" if v <= 32 else "shared memory", **check)
            if not all(check.values()):
                raise AssertionError(f"chol_panel {sh} [{B}, {v}, {v}]: {check}")
            if (B, v) != (BATCH, CHOL_V):
                continue
            one = blocks[0]
            lib = ("none: torch.linalg.cholesky_ex refuses 2-byte operands on this card "
                   f"({chol_lib})" if chol_lib else "torch.linalg.cholesky_ex")
            for single in (True, False):
                kernel, plain, X = ((ops.chol_panel, ref.chol_panel, one) if single else
                                    (ops.chol_panel_batched, ref.chol_panel_batched, blocks))
                nb = 1 if single else B
                library = None if chol_lib else (lambda X=X: torch.linalg.cholesky_ex(X))
                rows.append({
                    "name": ("chol_panel" if single else "chol_panel_batched") + f"[{sh}]",
                    "route": "cuda", "source": "src/repro_torch/kernels/csrc/chol_panel.cu",
                    "replaces": "src/repro/kernels/chol_panel.py:" + ("50" if single else "66"),
                    "max_abs_err": float((kernel(X).float() - plain(X).float()).abs().max()),
                    "ms": time_ms(lambda k=kernel, X=X: k(X)),
                    "plain_ms": time_ms(lambda p=plain, X=X: p(X), reps=3),
                    **bound(2 * 2 * nb * v * v, nb * chol_ops(v)),
                    "library_ms": None if library is None else time_ms(library),
                    **device_fields(lambda k=kernel, X=X: k(X), library),
                    "library": lib,
                })

        # trsm_right_upper[_batched] (`right_solve_inputs`): the paths'
        # shapes, v = 24 (single and batched), 1, 31, 33 and 128, R = 1, 9
        # and 100,000, B a column window of a wider matrix and one offset by
        # one column, NaN / inf rows, a zero on U's diagonal, and f16
        # quotients past 65504.  Each case's body, reckoned from the
        # launcher's rule (B's base 16-byte aligned, its row and batch
        # strides and v whole runs of 8 values; v <= 32): "wide" for the
        # paths' shapes, v = 24 (3 runs a row), R = 1 and 9 (a partial
        # warp), the window (32 values in: 64 B) and the special inputs;
        # "plain" for v = 1 and 31 and the window one column further in
        # (66 B); "smem" for v = 33 and 128.
        for Bb, R, v, ukind, special, body in RIGHT_MIXED_CASES:
            nb = 1 if Bb is None else Bb
            Bm, U = right_solve_inputs(Bb, R, v, ukind, special, dt, gen, dev)
            single = Bb is None
            kernel = ops.trsm_right_upper if single else ops.trsm_right_upper_batched
            plain = ref.trsm_right_upper if single else ref.trsm_right_upper_batched
            X_k = kernel(Bm, U)
            mode = (trsm_mod.trsm_right_upper if single else
                    trsm_mod.trsm_right_upper_batched).mode
            X_p = plain(Bm, U)
            torch.cuda.synchronize()
            err, ratio, check = mixed_kernel_check(X_k, X_p, dt)
            check["zero_rows_as_plain"] = same_bits(X_k[..., :R // 4, :], X_p[..., :R // 4, :])
            check["mode_as_predicted"] = mode == trsm_mod.right_mode(Bm, U)
            check["mode_as_reckoned"] = mode == body
            if special == "overflow" and dt == torch.float16:
                check["overflows_to_inf"] = bool(X_p.isinf().any())
            if not single:
                for b in (0, Bb - 1):
                    check[f"lane{b}_equals_single"] = same_bits(
                        ops.trsm_right_upper(Bm[b], U[b]), X_k[b])
            emit("kernel_trsm_right_upper_mixed", dtype=sh, shape=[nb, R, v], U=ukind,
                 special=special, ldb=Bm.stride(-2), mode=mode,
                 body="registers" if v <= 32 else "shared memory",
                 max_abs_err=err, err_over_allowance=ratio, **check)
            if not all(check.values()):
                raise AssertionError(f"trsm_right_upper {sh} [{nb}, {R}, {v}] {special}: "
                                     f"{ratio} of the allowance, {check}")
            if special or (R, v) not in ((N, CHOL_V), (BATCH_N, CHOL_V)):
                continue
            out = torch.empty_like(Bm)
            rows.append({
                "name": ("trsm_right_upper" if single else "trsm_right_upper_batched") +
                        f"[{sh}]",
                "route": "cuda", "source": "src/repro_torch/kernels/csrc/trsm.cu",
                "replaces": "src/repro/kernels/trsm.py:" + ("78" if single else "96"),
                "max_abs_err": err, "mode": mode, "ms": time_ms(lambda k=kernel: k(Bm, U)),
                "plain_ms": time_ms(lambda p=plain: p(Bm, U)),
                **bound(2 * nb * (2 * R * v + v * v), nb * R * v * v),
                "library_ms": None, **device_fields(lambda k=kernel: k(Bm, U)),
                "library": "none: torch.linalg.solve_triangular refuses 2-byte operands on "
                           f"this card ({tri_lib})" if tri_lib else
                           "none measured: solve_triangular took 2-byte operands",
                # A yardstick of the bytes alone: one copy of B into a new
                # tensor of X's shape (U aside).
                "copy_device_ms": device_ms(lambda o=out, b=Bm: o.copy_(b)),
            })
            del out

        # trsm_left_lower[_batched]: the flat paths' [32, 16384] (unit, as
        # conflux, and not, as cholesky25d), a ragged strided B (v = 24), the
        # register body's edge v = 1, the shared-memory body at v = 33 and
        # 128; the batched form at 256 x [32, 512], lanes against the single
        # call.
        def lower(lead, v, unit):
            L = 0.3 * torch.tril(torch.randn(*lead, v, v, generator=gen, device=dev), -1)
            return (L + (1.0 if unit else 2.0) * torch.eye(v, device=dev)).to(dt)

        for lead, v, C, unit, strided in (((), CONFLUX_V, N, True, False),
                                          ((), CONFLUX_V, N, False, False),
                                          ((), 24, 777, True, True), ((), 1, 63, True, False),
                                          ((), 33, 65, False, True), ((), 128, 1000, True, False),
                                          ((BATCH,), CONFLUX_V, BATCH_N, True, False),
                                          ((BATCH,), CONFLUX_V, BATCH_N, False, False)):
            L = lower(lead, v, unit)
            buf = torch.randn(*lead, v, 2 * C if strided else C, generator=gen,
                              device=dev).to(dt)
            Bm = buf[..., C:] if strided else buf
            batched = bool(lead)
            kernel = ops.trsm_left_lower_batched if batched else ops.trsm_left_lower
            plain = ref.trsm_left_lower_batched if batched else ref.trsm_left_lower
            X_k, X_p = kernel(L, Bm, unit=unit), plain(L, Bm, unit=unit)
            torch.cuda.synchronize()
            err, ratio, check = mixed_kernel_check(X_k, X_p, dt)
            if batched:
                for b in (0, lead[0] - 1):
                    check[f"lane{b}_equals_single"] = same_bits(
                        ops.trsm_left_lower(L[b], Bm[b], unit=unit), X_k[b])
            emit("kernel_trsm_left_lower_mixed", dtype=sh, shape=[*lead, v, C], unit=unit,
                 strided=strided, max_abs_err=err, err_over_allowance=ratio, **check)
            if not all(check.values()):
                raise AssertionError(f"trsm_left_lower {sh} {[*lead, v, C]}: {ratio} of the "
                                     f"allowance, {check}")
            if (v, C, unit) not in ((CONFLUX_V, N, True), (CONFLUX_V, BATCH_N, True)):
                continue
            nb = lead[0] if batched else 1
            rows.append({
                "name": ("trsm_left_lower_batched" if batched else "trsm_left_lower") +
                        f"[{sh}]",
                "route": "cuda", "source": "src/repro_torch/kernels/csrc/trsm.cu",
                "replaces": "src/repro/kernels/trsm.py:" + ("133" if batched else "115"),
                "max_abs_err": err, "ms": time_ms(lambda k=kernel: k(L, Bm)),
                "plain_ms": time_ms(lambda p=plain: p(L, Bm)),
                **bound(2 * nb * (v * v + 2 * v * C), nb * v * (v - 1) * C),
                "library_ms": None, **device_fields(lambda k=kernel: k(L, Bm)),
                "library": "none: torch.linalg.solve_triangular refuses 2-byte operands on "
                           f"this card ({tri_lib})" if tri_lib else
                           "none measured: solve_triangular took 2-byte operands",
                **({"note": "on no path but the auditor's kernel check (audit phase), "
                            "which launches it in f32 and bf16"}
                   if batched else {}),
            })

        # schur_update[_batched]: the paths' shapes, K = 1, 33 and 64, ragged
        # M and N, an odd row stride, a window of a wider matrix, a batch of
        # one, NaN / inf in A and L, and f16 results past 65504 ("overflow":
        # one product a result, +-300 x +-300).  Each case's body, reckoned
        # from the stream's rule (16-byte aligned bases, row and batch
        # strides of whole 16-byte runs, K <= 64): the wgmma stream for the
        # paths' shapes, a full chunk (K = 64 at 512 x 512), the window (64
        # columns in: 128 B; row stride 4128), the batch of one, "special"
        # (rows of 2000 B) and "overflow"; the plain loads where a row of A
        # is 1000 or 2002 B (300 x 500, 777 x 1001, odd_lda) and where L's
        # rows are 2 or 66 B (K = 1, 33).  The library call is torch.addmm /
        # baddbmm in the same dtype (cuBLAS accumulates 2-byte products in
        # f32 and rounds once).
        modes = {}
        for Bb, M, C, K, kind, body in (
                (None, N, N, CHOL_V, None, "wgmma"),
                (BATCH, BATCH_N, BATCH_N, CHOL_V, None, "wgmma"),
                (8, 300, 500, 1, None, "plain"), (8, 300, 500, 33, None, "plain"),
                (8, 300, 500, 64, None, "plain"), (8, 512, 512, 64, None, "wgmma"),
                (8, 777, 1001, CHOL_V, None, "plain"),
                (1, BATCH_N, BATCH_N, CHOL_V, None, "wgmma"),
                (None, 1000, 1000, CHOL_V, "odd_lda", "plain"),
                (None, 4064, 4064, CHOL_V, "window", "wgmma"),
                (4, 777, 1000, CHOL_V, "special", "wgmma"),
                (None, 512, 512, CHOL_V, "overflow", "wgmma")):
            lead = () if Bb is None else (Bb,)
            if kind == "odd_lda":
                A = torch.randn(*lead, M, C + 1, generator=gen, device=dev).to(dt)[..., :C]
            elif kind == "window":
                A = torch.randn(*lead, M + 32, C + 64, generator=gen,
                                device=dev).to(dt)[..., 32:, 64:]
            else:
                A = torch.randn(*lead, M, C, generator=gen, device=dev).to(dt)
            Lm = torch.randn(*lead, M, K, generator=gen, device=dev).to(dt)
            Um = torch.randn(*lead, K, C, generator=gen, device=dev).to(dt)
            if kind == "special":
                A[..., 5, 7] = float("nan")
                A[..., 9, 100] = float("inf")
                Lm[..., 11, 0] = float("nan")
                Lm[..., 13, K - 1] = float("-inf")
            if kind == "overflow":
                pick = torch.tensor([300.0, -300.0], device=dev)
                Lm.zero_()
                Um.zero_()
                Lm[..., 0] = pick[torch.randint(2, (M,), generator=gen, device=dev)].to(dt)
                Um[..., 0, :] = pick[torch.randint(2, (C,), generator=gen, device=dev)].to(dt)
            kernel = ops.schur_update if Bb is None else ops.schur_update_batched
            plain = ref.schur_update if Bb is None else ref.schur_update_batched
            out_k = kernel(A, Lm, Um)
            mode = (su_mod.schur_update if Bb is None else su_mod.schur_update_batched).mode
            out_p = plain(A, Lm, Um)
            torch.cuda.synchronize()
            err, ratio, check = mixed_kernel_check(out_k, out_p, dt)
            check["mode_as_predicted"] = mode == su_mod.stream_mode(A, Lm, Um)
            check["mode_as_reckoned"] = mode == body
            if kind == "overflow" and dt == torch.float16:
                check["overflows_to_inf"] = bool(out_p.isinf().any())
            if Bb is not None:
                for b in sorted({0, Bb - 1}):
                    check[f"lane{b}_equals_single"] = same_bits(
                        ops.schur_update(A[b], Lm[b], Um[b]), out_k[b])
            case = f"{[*lead, M, C, K]} {kind}"
            modes[case] = mode
            emit("kernel_schur_update_mixed", dtype=sh, shape=[*lead, M, C, K], kind=kind,
                 lda=A.stride(-2), mode=mode, max_abs_err=err, err_over_allowance=ratio,
                 inf_count=int(out_k.isinf().sum()), **check)
            if not all(check.values()):
                raise AssertionError(f"schur_update {sh} {case}: {ratio} of the allowance, "
                                     f"{check}")
            del out_k, out_p
            if kind is not None or (Bb, M, C, K) not in ((None, N, N, CHOL_V),
                                                         (BATCH, BATCH_N, BATCH_N, CHOL_V)):
                continue
            nb = 1 if Bb is None else Bb
            library = torch.addmm if Bb is None else torch.baddbmm
            rows.append({
                "name": ("schur_update" if Bb is None else "schur_update_batched") + f"[{sh}]",
                "route": "cuda", "source": "src/repro_torch/kernels/csrc/schur_update.cu",
                "replaces": "src/repro/kernels/schur_update.py:" + ("52" if Bb is None else "75"),
                "max_abs_err": err, "mode": mode,
                "ms": time_ms(lambda k=kernel: k(A, Lm, Um)),
                "plain_ms": time_ms(lambda p=plain: p(A, Lm, Um)),
                **bound(2 * nb * (2 * M * C + M * K + K * C), 2 * nb * M * C * K),
                "library_ms": time_ms(lambda f=library: f(A, Lm, Um, alpha=-1.0)),
                **device_fields(lambda k=kernel: k(A, Lm, Um),
                                lambda f=library: f(A, Lm, Um, alpha=-1.0)),
                "library": ("torch.addmm" if Bb is None else "torch.baddbmm") +
                           f"(A, L, U, alpha=-1) in {sh}",
            })
            del A, Lm, Um
        emit("schur_update_mixed_modes", dtype=sh, **modes)
        torch.cuda.empty_cache()
    return rows


def mixed_chol_main_path(dev, gen, dt, profile: bool) -> dict:
    """plan(N, strategy="sequential_chol", compute_dtype=bf16 | f16) on an SPD
    A (eigenvalues in about [1, 5]) through the entry points: exactly N / v
    launches of each Cholesky kernel, the last update on the wgmma stream,
    refinement to 1e-6.  Returns the launches of the counted run."""
    from repro_torch.api import SolverConfig, plan

    sh = MIXED_SHORT[dt]
    A = spd((N, N), gen, dev)
    b = torch.randn(N, generator=gen, device=dev)
    p = plan(N, SolverConfig(strategy=CHOL, compute_dtype=str(dt).removeprefix("torch.")))
    steps = N // p.config.v
    launches = _refined_run(p, A, b, f"mixed_chol_{sh}_main_path", expected_launches(
        chol_panel=steps, trsm_right_upper=steps, schur_update=steps), dt, "schur_update",
        N=N, v=p.config.v)
    if profile:
        emit(f"profile_chol_{sh}_execute", **profile_once(lambda: p.execute(A)))
    del A
    torch.cuda.empty_cache()
    return launches


def mixed_plain_chol_128(dev, gen) -> None:
    """The bf16 and f16 Cholesky kernel path against the plain path at
    N = 128, single and batched (64 systems): each entry of L within
    `mixed_path_tol` (a sum in another order lands beside a 2-byte rounding
    boundary now and then, and later steps carry that ulp)."""
    from repro_torch.api import SolverConfig, plan

    n, B = 128, 64
    for dt in MIXED_DTYPES:
        name = str(dt).removeprefix("torch.")
        for shape in (n, (B, n)):
            A = spd((n, n) if shape == n else (B, n, n), gen, dev)
            cfg = SolverConfig(strategy=CHOL, compute_dtype=name)
            L_k = plan(shape, cfg).execute(A).F.float()
            L_p = plan(shape, cfg.with_(backend="ref")).execute(A).F.float()
            err = float((L_k - L_p).abs().max())
            tol = mixed_path_tol(L_p.to(dt))
            emit("mixed_plain_chol_128", dtype=MIXED_SHORT[dt], shape=list(A.shape),
                 L_max_abs_err=err, tol=tol, bit_identical=torch.equal(L_k, L_p))
            if not err <= tol:
                raise AssertionError(f"{name} Cholesky kernel and plain paths differ at "
                                     f"{list(A.shape)}: {err} > {tol}")


# The 2-byte 1x1x1 schedules at the full N: (strategy, hotloop, compute
# dtype).  bf16 runs every schedule's LU or Cholesky body; f16 the flat
# cholesky25d, which reaches trsm_left_lower, chol_panel, trsm_right_upper
# and schur_update.
MIXED_GRID_P1 = (("conflux", "windowed", torch.bfloat16), ("conflux", "flat", torch.bfloat16),
                 ("cholesky25d", "windowed", torch.bfloat16),
                 ("cholesky25d", "flat", torch.float16))


def mixed_grid_p1_path(dev, gen) -> dict:
    """plan(N, strategy=..., grid=GridConfig(1, 1, 1, 32, N), compute_dtype=...)
    in-process for each of MIXED_GRID_P1, on `well_conditioned` (LU) or
    `spd` (Cholesky) A: exact launches, refinement to 1e-6, HPL < 16.
    Returns each dtype's flat launches (the path of trsm_left_lower)."""
    from repro_torch.api import GridConfig, SolverConfig, plan

    steps = N // CONFLUX_V
    grid = GridConfig(1, 1, 1, CONFLUX_V, N)
    body = {"windowed": {"fused_trsm_schur": steps},
            "flat": {"trsm_left_lower": steps, "schur_update": steps}}
    # At Px = 1 the tournament factors each panel twice (`conflux_p1_path`).
    factor = {"conflux": {"lu_panel": 2 * steps, "trsm_right_upper": steps},
              "cholesky25d": {"chol_panel": steps, "trsm_right_upper": steps}}
    flat = {}
    for strategy, hotloop, dt in MIXED_GRID_P1:
        sh = MIXED_SHORT[dt]
        A = spd((N, N), gen, dev) if strategy == "cholesky25d" else well_conditioned(
            (N, N), gen, dev)
        b = torch.randn(N, generator=gen, device=dev)
        p = plan(N, SolverConfig(strategy=strategy, grid=grid, hotloop=hotloop,
                                 compute_dtype=str(dt).removeprefix("torch.")))
        want = expected_launches(**factor[strategy], **body[hotloop])
        update = "fused_trsm_schur" if hotloop == "windowed" else "schur_update"
        launches = _refined_run(p, A, b, f"mixed_grid_p1_{sh}", want, dt, update, N=N,
                                strategy=strategy, hotloop=hotloop, grid=str(grid))
        if hotloop == "flat":
            flat[sh] = launches
        if (strategy, hotloop) == ("conflux", "windowed"):
            emit(f"profile_grid_p1_{sh}_execute", strategy=strategy, hotloop=hotloop,
                 **profile_once(lambda: p.execute(A)))
        del A, p
        torch.cuda.empty_cache()
    return flat


def _mixed_spd_requests(rng, count: int):
    """Ragged SPD requests (`_spd_requests`) with every other one asking for
    refinement to MIXED_LOW_TOL."""
    return [(A, b, MIXED_LOW_TOL if i % 2 else None)
            for i, (A, b) in enumerate(_spd_requests(rng, count))]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.api import SolverConfig, plan
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import lu_panel as lp_mod

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. Device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=smi, name=kind, torch=torch.__version__,
         cuda=torch.version.cuda, matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # 2. Build every kernel from the sources, one nvcc each, in parallel.
    build_s = _build.build()
    regs = {name: [ln.strip() for ln in text.splitlines() if "registers" in ln]
            for name, text in _build.build_log.items()}
    emit("build", seconds=build_s, ptxas=regs)

    # 3. Each kernel against its plain version at the main path's shapes.
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn(N, N, generator=gen, device=dev)
    v = 32

    panel = A[:, 2 * v:3 * v]  # a strided column slice, as the main path passes
    weights = (torch.rand(N, generator=gen, device=dev) > 0.1).float()
    F_k, order_k, ok_k = lp_mod.lu_panel(panel, weights)
    F_p, order_p, ok_p = ref.lu_panel(panel, weights)
    torch.cuda.synchronize()
    masked = weights == 0
    panel_check = {
        "order_equal": torch.equal(order_k, order_p),
        "ok_equal": torch.equal(ok_k, ok_p),
        "F_bit_identical": same_bits(F_k, F_p),
        "masked_rows_untouched": same_bits(F_k[masked], panel[masked]),
        "max_abs_err": float((F_k - F_p).abs().max()),
    }
    emit("kernel_lu_panel", shape=[N, v], weight0_rows=int(masked.sum()), **panel_check)
    if not all(panel_check[k] for k in
               ("order_equal", "ok_equal", "F_bit_identical", "masked_rows_untouched")):
        raise AssertionError(f"lu_panel disagrees with its plain version: {panel_check}")
    n_w1 = int((weights > 0).sum())
    panel_bytes = 4 * (2 * N * v + N) + 5 * v
    panel_row = {
        "name": "lu_panel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lu_panel.cu",
        "replaces": "src/repro/kernels/lu_panel.py:71",
        "max_abs_err": panel_check["max_abs_err"],
        "ms": time_ms(lambda: lp_mod.lu_panel(panel, weights)),
        "plain_ms": time_ms(lambda: ref.lu_panel(panel, weights), reps=3),
        **bound(panel_bytes, panel_ops(N, v, n_w1)),
        "library_ms": None,
        **device_fields(lambda: lp_mod.lu_panel(panel, weights)),
        "library": "none: no single PyTorch call computes a masked LUP with row weights",
        **lu_panel_edges(dev, gen, panel, weights),
    }
    del F_k, F_p

    # fused_trsm_schur: the path's shape on A itself, a [2048, 1536] corner
    # of A (row stride N), then the kernel's edges (`fused_inputs`): a
    # window as the conflux step passes it, an odd row stride, M = 1 with
    # C = 300, C = 1, one item of 625 row tiles split across every block,
    # f64 with v = 128, NaN / inf with zero rows.
    from repro_torch.kernels import fused_schur as fs_mod

    fused_rows = []
    modes = {}
    f32 = torch.float32
    for M, C, vv, unit, dt, form in ((N, N, v, True, f32, "A"), (2048, 1536, 16, False, f32, "A"),
                                     (4064, 4064, v, True, f32, "window"),
                                     (1000, 1000, v, True, f32, "odd_lda"),
                                     (1, 300, v, True, f32, None), (777, 1, v, True, f32, None),
                                     (20000, 256, v, True, f32, None),
                                     (3000, 300, 128, False, torch.float64, None),
                                     (3000, 1000, v, True, f32, "special")):
        if form == "A":
            Am = A[:M, :C]
            L00 = (0.3 * torch.tril(torch.randn(vv, vv, generator=gen, device=dev), -1)
                   + (1.0 if unit else 2.0) * torch.eye(vv, device=dev))
            R01 = torch.randn(vv, C, generator=gen, device=dev)
            L10 = torch.randn(M, vv, generator=gen, device=dev)
        else:
            Am, L00, R01, L10 = fused_inputs((), M, C, vv, unit, dt, form, gen, dev)
        out_k, U_k = ops.fused_trsm_schur(Am, L00, R01, L10, unit=unit)
        mode = fs_mod.fused_trsm_schur.mode
        out_p, U_p = ref.fused_trsm_schur(Am, L00, R01, L10, unit=unit)
        torch.cuda.synchronize()
        err, scale, check = fused_check(out_k, U_k, out_p, U_p)
        case = f"{[M, C, vv]} {dt} unit={unit} {form}"
        modes[case] = mode
        emit("kernel_fused_trsm_schur", shape=[M, C, vv], dtype=str(dt), unit=unit, kind=form,
             lda=Am.stride(0), mode=mode, max_abs_err=err, rel_err=err / scale,
             tol_rel=FUSED_REL_TOL, **check)
        if not all(check.values()):
            raise AssertionError(f"fused_trsm_schur {case}: error {err} (scale {scale}), {check}")
        del out_k, out_p, U_k, U_p
        if M != N:
            continue
        fused_bytes = 4 * (2 * M * C + vv * vv + 2 * vv * C + M * vv)
        fused_ops = 2 * M * C * vv + vv * vv * C

        def library():
            U = torch.linalg.solve_triangular(L00, R01, upper=False, unitriangular=True)
            return torch.addmm(Am, L10, U, alpha=-1.0)

        fused_rows.append({
            "name": "fused_trsm_schur", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_schur.cu",
            "replaces": "src/repro/kernels/fused_schur.py:83",
            "max_abs_err": err,
            "ms": time_ms(lambda: ops.fused_trsm_schur(Am, L00, R01, L10)),
            "plain_ms": time_ms(lambda: ref.fused_trsm_schur(Am, L00, R01, L10)),
            **bound(fused_bytes, fused_ops),
            "library_ms": time_ms(library),
            **device_fields(lambda: ops.fused_trsm_schur(Am, L00, R01, L10), library),
            "library": "torch.linalg.solve_triangular + torch.addmm (two calls)",
        })
    emit("fused_trsm_schur_modes", **modes)

    # 4. The main path, through the entry points, on the default config and
    #    device: the calibrated `auto` picks (strategy, v, backend) from the
    #    committed table, and the launches follow the resolved v, which must
    #    be one the fused stream takes ("tma"): a pick that leaves the stream
    #    for the plain bodies fails here.
    A_main = torch.randn(N, N, generator=gen, device=dev)
    b_main = torch.randn(N, generator=gen, device=dev)
    p = plan(N)
    v_main = p.config.v
    lo, hi = fs_mod._STREAM_V[4]
    want_mode = "tma"
    if not lo <= v_main <= hi:
        raise AssertionError(f"the main path resolved v = {v_main}, outside the fused "
                             f"stream's {lo}..{hi}: {p.config}")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fact = p.execute(A_main)
    torch.cuda.synchronize()
    execute_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    x = fact.solve(b_main)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    resid = hpl_residual(A_main, x, b_main)
    emit("main_path", N=N, v=v_main, strategy=fact.strategy, backend=fact.backend,
         hotloop=p.config.hotloop, calibration=p.config.calibration,
         predicted_wall_us=(p.autotune or {}).get("predicted_wall_us"),
         launches=launches, execute_s=execute_s, solve_s=solve_s, hpl_residual=resid,
         x_finite=bool(torch.isfinite(x).all()), x_shape=list(x.shape),
         last_fused_mode=fs_mod.fused_trsm_schur.mode, want_fused_mode=want_mode)
    if fact.backend != "cuda":
        raise AssertionError(f"main path ran backend {fact.backend!r}, not 'cuda'")
    if fs_mod.fused_trsm_schur.mode != want_mode:
        raise AssertionError(f"the main path's fused call took {fs_mod.fused_trsm_schur.mode!r}, "
                             f"not {want_mode!r} at v = {v_main}")
    if launches != expected_launches(lu_panel=N // v_main, fused_trsm_schur=N // v_main):
        raise AssertionError(f"expected {N // v_main} launches of each kernel, got {launches}")
    if not (torch.isfinite(x).all() and resid < HPL_RESIDUAL_MAX):
        raise AssertionError(f"HPL scaled residual {resid} >= {HPL_RESIDUAL_MAX}")
    rows_main = fact.rows
    del fact, x

    # Where the time goes: one more execute, under the profiler; exactly one
    # lu_panel kernel record per step (its wrapper launches nothing else,
    # `lu_panel_records_per_call`).
    prof = profile_once(lambda: p.execute(A_main))
    emit("profile_execute", **prof)
    panel_records = sum(k["count"] for k in prof["port_kernels"]
                        if k["kernel"].startswith("lu_panel_"))
    if panel_records != N // v_main:
        raise AssertionError(f"profile_execute holds {panel_records} lu_panel kernel records, "
                             f"expected {N // v_main}")

    # The library's LU at the same N, as a yardstick only.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    LU, piv = torch.linalg.lu_factor(A_main)
    torch.cuda.synchronize()
    lib_factor_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_lib = torch.linalg.lu_solve(LU, piv, b_main[:, None])[:, 0]
    torch.cuda.synchronize()
    emit("yardstick_torch_lu", factor_s=lib_factor_s, solve_s=time.perf_counter() - t0,
         hpl_residual=hpl_residual(A_main, x_lib, b_main),
         note="torch.linalg.lu_factor + lu_solve; the port never calls them")
    del LU, piv, x_lib

    # 5. The plain path on the card, against the kernel path, both pinned to
    #    sequential at v = 32 (the calibrated `auto` would pick v and the
    #    backend under them).
    A_small = torch.randn(1024, 1024, generator=gen, device=dev)
    f_k = plan(1024, v32()).execute(A_small)
    f_p = plan(1024, v32(backend="ref")).execute(A_small)
    f_err = float((f_k.F - f_p.F).abs().max())
    f_tol = LU_F_TOL_FACTOR * 1024 * torch.finfo(torch.float32).eps * float(f_p.F.abs().max())
    rows_equal = torch.equal(f_k.rows, f_p.rows)
    emit("plain_path_1024", rows_equal=rows_equal, F_max_abs_err=f_err, tol=f_tol,
         F_max_abs=float(f_p.F.abs().max()))
    if not (rows_equal and f_err <= f_tol):
        raise AssertionError(f"kernel and plain paths differ at N=1024: rows_equal="
                             f"{rows_equal}, F error {f_err}")
    t0 = time.perf_counter()
    f_ref = plan(N, v32(backend="ref")).execute(A_main)
    torch.cuda.synchronize()
    ref_execute_s = time.perf_counter() - t0
    diff = (f_ref.rows != rows_main).nonzero()
    emit("plain_path_16384", execute_s=ref_execute_s, v=32, main_path_v=v_main,
         first_pivot_difference=int(diff[0]) if len(diff) else None,
         hpl_residual_plain=hpl_residual(A_main, f_ref.solve(b_main), b_main),
         hpl_residual_kernels=resid)

    del f_ref, A_main, b_main, rows_main, A
    torch.cuda.empty_cache()


    # 6. The batched path's kernels, its end-to-end run, and the serving tier.
    batched_rows = batched_kernel_rows(dev, gen)
    batched_launches = batched_path(dev, gen)
    plain_batched_path(dev, gen)
    serving_sync()
    serving_async()

    # 7. The Cholesky paths: kernels, single and batched paths, serving.
    chol_rows = chol_kernel_rows(dev, gen)
    chol_launches = chol_main_path(dev, gen)
    chol_batched_launches = chol_batched_path(dev, gen)
    serving_sync("serving_chol_sync", CHOL, _spd_requests, CHOL_SERVE_REQUESTS,
                 CHOL_BATCHED_KERNELS)
    serving_async("serving_chol_async", CHOL, _spd_requests, CHOL_ASYNC_PER_TENANT,
                  CHOL_BATCHED_KERNELS)

    # 8. The distributed schedules: the new kernel, the 1x1x1 grid at the full
    #    N with both hot loops, its plain path at N = 1024, eight gloo ranks.
    trsm_rows = trsm_left_lower_rows(dev, gen)
    conflux_flat_launches = conflux_p1_path(dev, gen, execute_s)
    conflux_p1_plain_1024(dev)
    torchrun = start_torchrun()  # 14 reads it: it runs beside the eight ranks
    new_paths = grid_8ranks()  # with the engine cases of module item 8

    # 8b. Engines on the distributed strategies (module item 8): conflux,
    #    cholesky25d and baseline2d on 1x1x1 grids in this process.
    new_paths.update({f"serving_distributed_p1[{k}]": v
                      for k, v in serving_distributed_p1(dev).items()})

    # 9. Mixed precision (module item 7): the LU kernels' bf16 and f16 entry
    #    points; f64 over f32 factors with refinement beside the f64 kernels;
    #    the 2-byte main paths, batched paths with per-lane tolerances, the
    #    kernel path against the plain path at N = 128; both engines on a
    #    bf16 plan with some requests refined.
    mixed_rows = kernel_rows_mixed(dev, gen)
    mixed_f64_main_path(dev, gen)
    mixed_launches = {MIXED_SHORT[dt]: mixed_low_main_path(dev, gen, dt) for dt in MIXED_DTYPES}
    mixed_batched_launches = {MIXED_SHORT[dt]: mixed_batched_path(dev, gen, dt)
                              for dt in MIXED_DTYPES}
    mixed_plain_128(dev, gen)
    serving_mixed_sync()
    serving_mixed_async()

    # 9b. Mixed precision on the Cholesky kernels and the 2.5D schedules:
    #    the bf16 and f16 entry points of chol_panel, trsm_right_upper,
    #    trsm_left_lower and schur_update; the 2-byte Cholesky paths, single
    #    and batched, refined; both Cholesky engines on a bf16 plan; the
    #    kernel path against the plain path at N = 128; the 1x1x1 schedules
    #    at the full N (the eight-rank bf16 cases ran with phase 8).
    mixed_chol_rows = kernel_rows_mixed_chol(dev, gen)
    mixed_chol_launches = {MIXED_SHORT[dt]: mixed_chol_main_path(dev, gen, dt,
                                                                 dt == torch.bfloat16)
                           for dt in MIXED_DTYPES}
    mixed_chol_batched_launches = {
        MIXED_SHORT[dt]: mixed_batched_path(
            dev, gen, dt, strategy=CHOL, phase="mixed_chol_batched_path", profile=False,
            kernels=("chol_panel_batched", "trsm_right_upper_batched", "schur_update_batched"))
        for dt in MIXED_DTYPES}
    mixed_plain_chol_128(dev, gen)
    serving_mixed_sync(count=CHOL_SERVE_REQUESTS, phase="serving_mixed_chol_sync",
                       strategy=CHOL, make=_mixed_spd_requests, kernel="chol_panel_batched",
                       update="schur_update_batched")
    serving_mixed_async(per_tenant=CHOL_ASYNC_PER_TENANT, phase="serving_mixed_chol_async",
                        strategy=CHOL, make=_mixed_spd_requests, kernel="chol_panel_batched",
                        update="schur_update_batched")
    mixed_flat_launches = mixed_grid_p1_path(dev, gen)

    # 10. The LM serving path: the two kernels, each model served at full
    #    width and depth (one after the other, each freed before the next),
    #    and four groups of each on the kernel path against the plain path.
    lm_rows = lm_kernel_rows(dev, gen)
    lm_launches = {}
    for arch, batch in LM_SERVE:
        lm_launches.update({k: c for k, c in lm_serve(arch, batch).items() if c})
    for arch, _ in LM_SERVE:
        lm_plain_check(arch)

    # 10b. The MoE archs (module item 13): qwen3-moe and jamba served at full
    #    width, depth cut to the card, then each in f32 on the kernel path
    #    against the plain path.
    for arch, batch, layers, short in LM_SERVE_MOE:
        new_paths[f"lm_serve_{short}"] = lm_serve(arch, batch, layers, short)
    for arch, layers in LM_PLAIN_MOE:
        lm_plain_check(arch, layers, torch.float32, LM_MOE_LOGIT_REL_TOL)

    # 11. The calibrated `auto` (module item 9): the committed table's picks,
    #    each pick against the analytic one, the hot-loop profile of the LU
    #    and Cholesky plans, and the calibration tool's smoke fit.  Last, so
    #    that the earlier phases' host-clock times are taken as in earlier
    #    runs, before these phases' large numpy inputs.
    calibrated_auto(dev, kind)  # its own draws
    profile_hotloop_phase()
    calibrate_smoke(kind)

    # 12. The plan auditor (module item 11): the kernels' resources, the
    #    twelve solver kernels at the audit's shapes (trsm_left_lower_batched's
    #    only caller), the 2-byte accumulators, the cache keys and the in-core
    #    plans' collectives; the distributed plans' traced bytes were held to
    #    the model in grid_8ranks.
    audit_launches = audit_phase(dev)

    # 13. Training (module item 13's training part), after every phase of
    #    earlier runs so that their host-clock readings are taken as before:
    #    qwen3-8b and falcon-mamba-7b at full width, four layers, six train
    #    steps each (the kernels in every forward and remat recompute); the
    #    qwen3 steps again in f32 and at a tenth of the lr; two layers of each
    #    in f32, loss and gradients on the kernel path against
    #    the plain path; crash and resume through run_training, and
    #    launch.train then launch.serve --ckpt-dir in subprocesses.
    clis = start_dryrun_clis()  # 13b reads them: they count on the host meanwhile
    train_readings = {}
    for arch, layers, batch, short in LM_TRAIN:
        new_paths[f"lm_train_{short}"], train_readings[short] = lm_train(arch, layers, batch,
                                                                         short)
    # 13a. The dry-run tools on the meta device for lm_train_qwen3's
    #    configuration, held to that phase's measured peak; nothing on the card;
    #    the sharded predictions that lm_train_fsdp, lm_train_tp and
    #    lm_train_ep are held to.
    arch, layers, batch, short = LM_TRAIN[0]
    fsdp_predicted, tp_predicted, ep_predicted, serve_predicted = lm_dryrun(
        arch, layers, batch, train_readings[short])
    lm_train_loss_study(*LM_TRAIN[0][:3])
    for arch, *_ in LM_TRAIN:
        lm_train_plain_check(arch)
    new_paths["lm_train_resume"] = lm_train_resume()

    # 14. Item 13's rest: qwen3-8b trained on one rank and then on two gloo
    #    ranks sharing the card (with compressed_psum on them), launch.train
    #    under torchrun (NCCL, one rank), the bf16 score buffers (kernel and
    #    model), and llama4-maverick served at full width (one group).
    new_paths["lm_train_dp"], dp_one = lm_train_dp()
    # 14a-b. One pair of gloo ranks runs the state sharded over "data" (fsdp:
    #    lm_train_dp's steps on (2, 1)) and then tensor parallelism (tp, kv ->
    #    "model": qwen3-8b and falcon-mamba-7b on (1, 2), the flash and scan
    #    kernels on each rank's heads and channels), each against its
    #    one-rank run and the dry run's count, each driven with the launch
    #    counts set to 0 just before it.  14d. Then serving on a sharded
    #    state (slice 25) on the same pair: LM_SERVE_SHARDED, each against
    #    rank 0's one-device run and dryrun_serve.
    sharded = lm_train_sharded(("fsdp", *(f"tp_{c[4]}" for c in LM_TP),
                                *(f"serve_{c[0]}" for c in LM_SERVE_SHARDED)))
    new_paths["lm_train_fsdp"] = lm_train_fsdp(dp_one, fsdp_predicted, *sharded)
    new_paths["lm_train_tp"] = lm_train_tp(dp_one, tp_predicted, *sharded)
    new_paths.update(lm_serve_sharded(serve_predicted, *sharded))
    # 14c. Expert parallelism (ep -> "model"): one full-width qwen3-moe layer on
    #    the (1, 2) mesh, 64 experts a rank, on a pair of its own: against rank
    #    0's one-device run and dryrun_ep.
    new_paths["lm_train_ep"] = lm_train_ep(ep_predicted,
                                           *lm_train_sharded((f"ep_{LM_EP[4]}",)))
    # 13b. The dry-run CLI's 16x16 cells, started at 13.
    dryrun_cli(clis)
    lm_launch_train_torchrun(torchrun)
    bf16_scores_row = lm_score_bf16_kernels(dev, gen)
    new_paths["lm_score_bf16"] = lm_score_bf16()
    arch, batch, layers, short = LM_SERVE_LLAMA4
    new_paths[f"lm_serve_{short}"] = lm_serve(arch, batch, layers, short)

    panel_row["launches"] = launches["lu_panel"]
    for row in fused_rows:
        row["launches"] = launches["fused_trsm_schur"]
    for row in batched_rows:
        row["launches"] = batched_launches[row["name"]]
    for row in chol_rows:
        counts = chol_batched_launches if row["name"].endswith("_batched") else chol_launches
        row["launches"] = counts[row["name"]]
    for row in trsm_rows:
        row["launches"] = conflux_flat_launches[row["name"]]
        if row["name"] == "trsm_left_lower_batched":  # the auditor's kernel check
            row["launches"] = audit_launches["float32"][row["name"]]
            row["note"] = "on no path but the auditor's kernel check (audit phase)"
    for row in lm_rows:
        row["launches"] = lm_launches[row["name"]]
        if row["name"] == "flash_attention":
            row["bf16_scores"] = bf16_scores_row  # qwen3-8b's prefill shape
    for row in mixed_rows:
        base, sh = row["name"].rstrip("]").split("[")
        counts = mixed_batched_launches if base.endswith("_batched") else mixed_launches
        row["launches"] = counts[sh][base]
    for row in mixed_chol_rows:
        base, sh = row["name"].rstrip("]").split("[")
        if base == "trsm_left_lower_batched":  # the auditor's, in bf16 only
            row["launches"] = audit_launches.get(
                {"bf16": "bfloat16", "f16": "float16"}[sh], {}).get(base, 0)
        elif base.startswith("trsm_left_lower"):
            row["launches"] = mixed_flat_launches[sh][base]
        else:
            counts = (mixed_chol_batched_launches if base.endswith("_batched")
                      else mixed_chol_launches)
            row["launches"] = counts[sh][base]
    rows = [panel_row, *fused_rows, *batched_rows, *chol_rows, *trsm_rows, *mixed_rows,
            *mixed_chol_rows, *lm_rows]
    # This slice's paths beside the main path's count: each was driven with
    # the counts set to 0 just before it and read just after.
    for row in rows:
        row["launches_on_new_paths"] = {path: counts[row["name"]]
                                        for path, counts in new_paths.items()
                                        if counts.get(row["name"])}
    emit("device_ms_windows", **WINDOWS)
    for row in rows:
        row["kernel_ms"] = row["ms"]
        row["host_ms"] = row["ms"] - row["device_ms"]
    print(json.dumps({"kernels": rows, "card": smi}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
