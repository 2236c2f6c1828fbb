#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (deepconsensus_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero (nothing is caught):

1. Print the card's name and power limit, then build the native BGZF /
   TFRecord library (native/bgzf.cpp, g++, into build/native/) and every
   CUDA kernel from csrc/ (one nvcc per source, all at once) and print
   nvcc's
   register/spill/shared-memory report, the attention core's dynamic
   shared memory at the ragged slot length and the condenser's, and the
   blocks an SM of K8-K10 and of K6's two passes.
2. Hold each kernel against its plain PyTorch version on the card at
   its path's shapes, full width, in float32 (rtol = atol = 1e-4) and
   bfloat16 (rtol = atol = 2e-2; K3 exact), and time kernel, plain
   version and a library yardstick with CUDA events: K1
   embed-condense-attention, K2 encoder block and K3 output plane at
   1024 windows x 100 positions; K4 ragged embed-condense-attention and
   one K2 block with lengths at 512 slots x 200 positions holding every
   slot composition (one 200, two 100s, a lone 100, empty), compared on
   valid positions only; K2's int8 variant (the same weights quantized
   as `run --quantize_matmuls int8` loads them, in bfloat16 also cast as
   --inference_dtype bfloat16 casts them) on the same inputs: a full
   block and the FFN-only layer-0 block at 1024 x 100, and a full block
   with lengths at 512 x 200, bounded at the peak of the activations'
   type (every int8 value is exact in bfloat16), its library yardstick
   K2's PyTorch calls on the dequantized weights; for each full K2 and
   K2 int8 block (with and without lengths) its launches timed one by
   one (`stages`: q/k/v GEMM, attention core, output GEMM, fused FFN,
   and the per-call weight operands); K1 and K4 likewise (`stages`: the
   tensor-core condenser, q/k/v GEMM, attention core, output GEMM, and
   the per-call preparation of their operands); K3 also on the device
   alone (200 calls replayed from one CUDA graph), beside its plain
   version and `max` + `searchsorted`; K11 (the alignment DP's forward, with and
   without its rows) and K12 (its backward) at 256 x 100 x 100 float32
   costs, loss_reg 0.1, mixed lengths: scores rtol 1e-5 (atol 1e-4),
   gradients rtol 1e-4, atol 1e-5, plus each kernel's time at one batch
   row (the serial chain of 199 diagonals alone); K13 and K14 (the
   banded DP's forward, with and without rows, and backward) at the same
   costs with lengths 0 and m, W = 12 and W = 100 = m, loss_reg 0.1 and
   the hard minimum, with K11's gates against the plain banded DP and,
   at W = 100, against K11/K12 too (timed there as well, `w100_ms`); K5 (banded attention
   forward), K7 (its dropout forward; `mask_ms`: its time over K5's) and
   K6 (its backward, with and without the mask; its `stages`: its two
   passes, each launched alone) at 256 windows x 100 positions x 2 heads
   of 140, band 12, with the float32 / bfloat16 tolerances above, and
   the blocks an SM of the forward (`blocks_per_sm`); K8 (the
   block-banded flash forward, without and with its logsumexp, lse
   rtol = atol = 1e-4), K9 (dq) and K10 (dk/dv) at 256 windows x 200
   positions x 2 heads of 140, band 12, the same tolerances; library
   yardsticks: scaled_dot_product_attention with the band as its mask
   (K5, K8) and its autograd backward (K6; K9 and K10 together), timed
   only; and K11/K12 once more at m = n = 200 (train_flash's DP) and
   at m = n = 500 (long_window's), with the same gates and timed as at
   100 (their `m200` and `m500` entries). The attention core alone
   (csrc/ragged_attention.cu, which
   K1, K2 and K4 launch) on a K2 block's q/k/v at 1,024 x 100 and at
   512 x 200 with lengths, in both softmax dtypes, against its plain
   version (float32 softmax 1e-4, bfloat16 2e-2), beside SDPA with the
   band (and window) mask on the same q/k/v. The attn_softmax_dtype=
   bfloat16 variant of K1, K2 (float and int8, with and without
   lengths) and K4 on the same inputs, each against its plain version
   at the bfloat16 tolerance in either compute dtype, with its `stages`:
   the bf16 softmax rounds each logit, so where the two versions' float32
   logits may round to neighbouring bf16 values and that step could move
   the output by 1e-2 or more (bf16_flips), the position is set apart
   (finite only); the max error everywhere, the share of elements beyond
   1e-4 and the share set apart are printed.
3. The paths, each with every kernel's launch count reset just before
   its run and read just after, in bfloat16 and float32, then float32
   again through the plain versions on the card; full-width seeded
   weights:
   a. L = 100 `cli run`: synthetic BAMs of 128 ZMWs x 2,000 bp x 10
      subreads, non-zero ReZero alphas;
   b. ragged slots `cli run`: the same with seeded `wl` window widths
      (60-200), --use_ccs_smart_windows --window_buckets 100,200
      --use_ragged_kernel;
   c. `cli train` (transformer_learn_values+custom, batch 256): synthetic
      TFRecord shards of 1,024 training and 256 eval examples, one
      epoch of 4 steps and the final eval; the plain run takes the
      plain DP;
   d. `train_attn`: c's `cli train` with --set use_pallas_attention=true
      in bfloat16 and float32 (no plain run: c's float32 run, whose
      attention is the module route under the same dropout masks, is
      the reference);
   e. `train_band`: c's `cli train` with --set band_width=12, in
      bfloat16 and float32, then float32 through the plain banded DP on
      the card;
   f. `long_window`: one full-width forward and backward at L = 500
      (batch 256, attention dropout 0) through the ring route, through
      the module route forced on the same inputs and weights, and with
      use_pallas_attention, in float32 and bfloat16;
   g. `train_flash`: c's `cli train` with --set max_length=200 --set
      attention_dropout=0 --set use_pallas_attention=true on shards of
      200-wide windows (1,024 training, 256 eval), in bfloat16 and
      float32, and float32 with the flag off (the module route at the
      same masks: the reference); then one full-width float32 forward
      and backward at L = 200 with non-zero alphas, K8-K10 vs the
      module route;
   h. `buckets`: b's BAMs with --use_ccs_smart_windows --window_buckets
      100,200 and no --use_ragged_kernel (per-bucket packs of 1,024),
      use_pallas_attention set: bfloat16, float32, float32 through the
      plain versions, float32 with the flag off;
   i. `int8`: a's `cli run` with --quantize_matmuls int8, over float32
      params: with --inference_dtype bfloat16, in float32, and float32
      through the plain versions;
   j. `evaluate`: `cli evaluate` on c's float32 checkpoint over c's 256
      eval examples, float32 and with --quantize_matmuls int8; and the
      same on a's seeded weights (--weights/--params);
   k. `softmax_bf16`: a's and b's `cli run` over params with
      attn_softmax_dtype=bfloat16 (bfloat16, float32, float32 plain),
      a's int8 run in float32 with it, and c's `cli train --set
      attn_softmax_dtype=bfloat16` in float32 (the module route);
   l. `pipeline` (right after a and b): a's and b's `cli run` in
      bfloat16 at --batch_zmws 16 (8 featurize batches), with the
      pipeline's defaults (cross-batch packing, dispatch depth 8) and
      with the serial settings (--dispatch_depth 1
      --no_cross_batch_packing), a's with --cpus 4 (the featurization
      pool) and with a .bam output; then `stage_split`: a's bfloat16 run
      once per --end_after_stage cut after a warm-up run;
   n. `train_data` (after g): the data half of `cli train` on b's BAMs
      and their synthetic truth (testing/synthetic.py): `cli preprocess
      --use_ccs_smart_windows` at --cpus 0 and --cpus 2 (gated
      byte-identical, every split with examples), then at
      --example_width 200 and with fixed 100-wide windows (training mode
      drops windows wider than --example_width, as the reference does);
      the streaming loader alone (two workers: first batch, examples/s);
      one epoch of `cli train --window_buckets 100,200` over the 100-
      and 200-wide examples with --set streaming=true loader_workers=2
      augment=true use_pallas_attention=true attention_dropout=0, batch
      256, 6 steps, in bfloat16 and float32 (gates: K5, K6, K8 with lse,
      K9, K10, K11 and K12 launched, K7 never, n_train_forward_shapes
      2, finite losses and gradient norms); one f32 step on a fixed
      batch of each bucket through the kernels against the plain route
      (module attention, plain DP): losses 1e-4, gradient norms 1e-3,
      parameters 1e-5; three f32 steps with --set remat=true against
      three without, serial stream: parameters within 1e-5, losses 1e-5,
      peak memory no higher. Prints the per-bucket step ms, peak bytes,
      loader examples/s and preprocess ZMWs/s.
   m. `faults` (after l): a's `cli run` in bfloat16 at --batch_zmws 16
      with a fault injected, each against an unfaulted run of the same
      process: a corrupt ZMW under --on_zmw_error skip, ccs-fallback and
      fail; a poisoned window; an OOM at pack 2 under --on_device_error
      degrade (bisected to K1-K3 at batch 512) and fail; a 6 s device
      spin at pack 2 under --dispatch_timeout 2; a crash after two
      batches and --resume, on a and on b; --shard 0/2 and 1/2; --cpus 4
      --batch_timeout 30 with a worker killed; --trace and `cli trace`;
      `cli validate` on the clean and a truncated BAM pair
      (faults_gates says what each gate holds).
   Every `run` prints its stage seconds (BAM decode, featurize,
   triage/format, model, stitch), the untimed remainder, the card's
   H2D / forward / D2H time by CUDA events, the model stage's idle share
   and which BAM decoder ran, and fails unless it was the native one.
   Gates: each path's kernels launched (a: K1-K3, b: K4, K2, K3, c: K11
   once per step and eval batch, K12 once per step, no K5-K7; d: K7 and
   K6 once per layer and step, K5 once per layer and eval batch, K11
   and K12 as c), and for a and b one
   read per ZMW, float32 kernels vs plain base ids differ at <= 1e-4 of
   the delivered positions and qualities by <= 1, bfloat16 vs float32
   ids agree on >= 99% of them and qualities within BF16_QV_GATE where
   they agree; for b also each bucket >= 20% of model windows, slots
   holding one 200 and two 100s both occur, and the last pack is
   partial; for c every loss and gradient norm finite, the float32
   kernel run's loss within 1e-4 relative of the plain run's at every
   step, and bfloat16's first loss within 2% of float32's; for d every
   loss and gradient norm finite, the float32 losses (every step, and
   the eval loss) within 1e-4 relative of c's float32 run, bfloat16's
   first loss within 2% of float32's, and peak memory printed beside
   c's. The train runs start from Flax's zero ReZero alphas, where
   attention does not reach the loss, so d also takes one full-width
   float32 forward and backward with seeded non-zero alphas through
   K7/K6 and through the module route: loss within 1e-4 relative,
   each parameter's gradient within 1e-3. e: K13 once per step and
   eval batch, K14 once per step, K11/K12 never; every loss and
   gradient norm finite; the float32 losses (every step, and eval)
   within 1e-4 relative of the plain run's; bfloat16's first loss
   within 2% of float32's; step p50 and peak memory printed beside c's.
   f: float32 loss within 1e-5 relative, each parameter's gradient
   within 1e-3 of its norm (long_window_gates says why), the ring route
   once per layer on both ring runs, no attention kernel launched, K11
   and K12 once each per run (the loss at m = n = 500); both routes'
   peak memory printed. g: K8 with lse, K9 and K10 once per layer
   and step, K8 without lse once per layer and eval batch, K11/K12 as
   c, K5-K7 never (and no attention kernel on the module run); every
   loss and gradient norm finite; float32 losses (every step, and eval)
   within 1e-4 relative of the module route's; bfloat16's first loss
   within 2% of float32's; step p50 and peak memory printed beside the
   module route's; the one-batch check as d's (loss 1e-4, gradients
   1e-3). h: one read per ZMW, each bucket >= 20% of model windows, K1
   and K2 (per layer) on each 100-wide pack, K8 without lse once per
   layer of each 200-wide pack, K3 on every pack, no other kernel
   (plain run: none; flag off: no K8); float32 kernels vs the float32
   plain run and vs the flag-off run, and bfloat16 vs float32, with a's
   id and quality gates. i: one read per ZMW, K2 int8 once per layer and
   pack and the float K2 never (no K2 int8 on a, b and h), a's gates
   between the int8 runs (float32 kernels vs plain, bfloat16 vs
   float32), the float32 int8 ids agreeing with a's float32 run on >=
   95% of positions (the reference's bar), n_quantized_matmuls 36 and
   the inference_dtype labels in the sidecar; windows/s and peak memory
   printed beside a's. j: on the checkpoint and on the seeded weights,
   |int8 - float32| alignment_identity within INT8_IDENTITY_GATE and
   every metric finite; K1, K2 int8 and K11 on the checkpoint's int8
   run (the float K2 on its float32 run); the CSV rows printed. k: one
   read per ZMW; the variant's K1 or K4 once per pack, K2 once per
   layer and pack, the core's variant once per K1/K4 and full K2 block,
   K3 once per pack, the float32 softmax's never (the plain run: none);
   float32 kernels vs plain with a's id and quality gates; ids agreeing
   with the float32-softmax run of the same compute dtype on >= 98% of
   delivered positions (the reference's bar for the lever); on the int8
   run K2 int8's variant once per layer and pack, ids as that bar
   against i's float32 run; on the train run every loss and gradient
   norm finite and the first loss within 2% of c's float32 run's. l:
   one read per ZMW, 8 featurize batches, the kernels once per pack
   (K1 or K4, K3) and per layer and pack (K2); pipelined and serial
   FASTQ byte-identical, a's pipelined FASTQ also to a's and to the
   --cpus 4 run's; a's packs: across batches ceil(windows / 1024) with
   pad rows only in the tail, per batch the sum over batches; b's: each
   pack's lengths equal to the ragged packer's plan replayed on the
   recorded submissions, every pipelined pack but the last full, slots
   of one 200 and of two 100s present; the .bam records equal to the
   FASTQ's reads, each with zm, rq and np tags.
4. Where a full-width train step's time goes, in bfloat16 and float32,
   and in bfloat16 with attention through K5-K7, with band_width 12 and
   with attention through K8-K10 at L = 200:
   forward, loss (costs and K11), backward (K12 and autograd) and LAMB
   timed apart (synchronized, median of 5 steps after 2), and one step
   under torch.profiler: the device's busy time (its kernels' time
   summed), the idle share of the unprofiled step, and the kernels that
   take most of it.
5. A `{"kernels": [...]}` line (K1-K14, K2_int8, the attention core and
   the bf16-softmax variant of K1, K2, K2 int8, K4 and the core; each
   row's launches_by_path includes `faults`, the OOM-bisected run,
   `faults_ragged_resume` and `train_data`), the card line again, and
   the last line
   `{"ok": true, "device": {...}}`.

`--kernels-only` stops after phase 2 and prints no result (a first
check of newly written kernels). Without a CUDA device, or away from
the repository, it exits 2 and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, 'build', 'chip_smoke')
SEED = 20
BATCH, LENGTH = 1024, 100
SLOTS, SLOT_LEN = 512, 200
BUCKETS = (100, 200)
N_ZMWS, SEQ_LEN, N_SUBREADS = 128, 2000, 10
TRAIN_CONFIG = 'transformer_learn_values+custom'
TRAIN_BATCH, TRAIN_EXAMPLES, EVAL_EXAMPLES = 256, 1024, 256
DEL_COST, LOSS_REG = 10.0, 0.1
# The train_band path's AlignmentLoss band width (--set band_width=12).
BAND_WIDTH = 12
# The train_flash path's window (--set max_length=200): past
# WHOLE_L_LIMIT (128), below RING_ATTENTION_MIN_LEN (256).
FLASH_LENGTH = 200
# float32 operations per DP cell: forward, the soft minimum of three
# options (3 adds, 3 scalings, 2 max, 3 subtractions, 3 exp, 2 adds, a
# log, an add and a multiply); backward, the same recomputed plus 3
# divisions and 3 multiplications for the weights and 3 adds of the
# adjoint.
FWD_OPS_PER_CELL, BWD_OPS_PER_CELL = 19, 28
# H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA cores,
# bfloat16 on the tensor cores, and device memory bandwidth.
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}
PEAK_BYTES = 3.35e12
TOL = {'float32': 1e-4, 'bfloat16': 2e-2}


def card_line() -> str:
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, iters=10, warmup=2) -> float:
  import torch

  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def graph_ms(fn, iters=200) -> float:
  """Device time of one call of fn: `iters` calls captured in one CUDA
  graph and replayed, so no per-call host cost is in it."""
  import torch

  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(3):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(iters):
      fn()
  graph.replay()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(5):
    graph.replay()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / (5 * iters)


def bound(flops: float, nbytes: float, dtype: str):
  t_ops = flops / PEAK_FLOPS[dtype] * 1e3
  t_bytes = nbytes / PEAK_BYTES * 1e3
  return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def max_err(a, b, tol: float, atol=None) -> float:
  """Max |a - b|; raises unless allclose(a, b, rtol=tol, atol=atol),
  atol defaulting to tol."""
  import torch

  a, b = a.float(), b.float()
  err = float((a - b).abs().max())
  if not torch.allclose(a, b, rtol=tol, atol=tol if atol is None else atol):
    raise AssertionError(f'kernel disagrees with plain: max |err| {err}')
  return err


def make_params(dtype: str):
  from deepconsensus_tpu_torch.models import config

  params = config.get_config('transformer_learn_values+custom')
  config.finalize_params(params)
  params.dtype = dtype
  return params


def fake_rows(params, rng, batch=BATCH, length=LENGTH):
  """[B, R, L] float32 pileup rows in the model's value ranges."""
  import numpy as np

  mp = params.max_passes
  rows = np.zeros((batch, params.total_rows, length), np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  rows[:, 4 * mp + 1:] = rng.uniform(0, 500, rows[:, 4 * mp + 1:].shape)
  return rows


def band_pairs(length: int, win: int) -> int:
  return sum(min(length - 1, i + win) - max(0, i - win) + 1
             for i in range(length))


def ragged_slots(params, rng, device):
  """[SLOTS, R, SLOT_LEN] rows and [SLOTS, 2] lengths cycling through
  every slot composition; pad positions hold zeros."""
  import torch

  from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa

  widths = [[200, 0], [100, 100], [100, 0], [0, 0]] * (SLOTS // 4)
  lengths = torch.tensor(widths, dtype=torch.int32, device=device)
  valid = rwa.slot_geometry(lengths, SLOT_LEN)[3]
  rows = fake_rows(params, rng, SLOTS, SLOT_LEN)
  return torch.from_numpy(rows).to(device) * valid[:, None, :], lengths


def k2_library(x, ws, block, heads: int, attn_mask):
  """K2's block as PyTorch calls on float32 matrices ws = (wq, wk, wv,
  wo, w_filter, w_output): SDPA with attn_mask, matmuls, F.linear."""
  import torch
  import torch.nn.functional as F

  b, length, h = x.shape
  wq, wk, wv, wo, wf, wout = ws
  xf = x.float()
  qkv = [(xf @ w).view(b, length, heads, -1).transpose(1, 2)
         for w in (wq, wk, wv)]
  o = F.scaled_dot_product_attention(*qkv, attn_mask=attn_mask)
  y = xf + block.attn_alpha.float() * (
      o.transpose(1, 2).reshape(b, length, h) @ wo)
  hh = torch.relu(F.linear(y, wf.t(), block.b_filter.float()))
  return y + block.ffn_alpha.float() * F.linear(hh, wout.t(),
                                                block.b_output.float())


def block_matrices(block, dt):
  """A K2 block's six weights as float32 matrices: float weights in the
  compute dtype, int8 ones dequantized (values * scale)."""
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa

  out = []
  for w in (block.wq, block.wk, block.wv, block.wo, block.w_filter,
            block.w_output):
    qw = fwa.as_quantized(w)
    out.append(qw.values.to(dt).float() if qw.scale is None
               else qw.values.float() * qw.scale)
  return out


def int8_blocks(model, dtype: str):
  """K2's blocks of `model`'s weights as `run --quantize_matmuls int8`
  loads them (and, in bfloat16, --inference_dtype bfloat16): the CPU
  state quantized by models/quantize.py, then moved to the model's
  device."""
  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.models import quantize

  params = make_params(dtype)
  params.quantize_matmuls = 'int8'
  if dtype == 'bfloat16':
    params.inference_dtype = 'bfloat16'
  state = {k: v.cpu() for k, v in model.state_dict().items()}
  state, _ = quantize.prepare_inference_variables(state, params)
  return model_lib.inference_model(params, state,
                                   model.device).encoder.kernel_blocks()


def int8_k2_bytes(m: int, h: int, f: int, isz: int, extra: int = 0) -> int:
  """Bytes one int8 K2 block must move: activations in and out in the
  compute dtype, int8 weights, float32 scales, biases and alphas."""
  return (2 * m * h * isz + (4 * h * h + 2 * h * f)
          + (4 * h + f + h + f + h + 2) * 4 + extra)


def k2_stages(x, block, dt, heads: int, win: int, lengths=None,
              softmax_dtype='float32') -> dict:
  """One K2 block's launches timed one by one with CUDA events (ms), on
  the inputs the block hands each: the q/k/v GEMM, the attention core,
  the output GEMM (with the attention residual), the fused FFN, and the
  per-call weight operands (gemm_operand's casts and joins). Timing
  launches: no launch counter moves."""
  import torch

  from deepconsensus_tpu_torch.ops import _kernels
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa

  b, length, h = x.shape
  m, dev = b * length, x.device
  x2 = x.reshape(m, h)

  def operands():
    return (fwa.gemm_operand((block.wq, block.wk, block.wv), dt),
            fwa.gemm_operand((block.wo,), dt),
            fwa.gemm_operand((block.w_filter,), dt),
            fwa.gemm_operand((block.w_output,), dt))

  (wqkv, qkv_scale), (wo, wo_scale), (wf, f_scale), (wout, o_scale) = (
      operands())
  alpha_a, alpha_f = (torch.as_tensor(a, dtype=torch.float32,
                                      device=dev).reshape(1)
                      for a in (block.attn_alpha, block.ffn_alpha))
  b_f = block.b_filter.float().contiguous()
  b_o = block.b_output.float().contiguous()
  qkv = torch.empty((m, 3 * h), dtype=torch.float32, device=dev)
  o = torch.empty((m, h), dtype=torch.float32, device=dev)
  ffn_in = torch.empty((m, h), dtype=torch.float32, device=dev)
  out = torch.empty((m, h), dtype=dt, device=dev)
  stages = {
      'qkv_gemm_ms': lambda: _kernels.gemm(
          x2, wqkv, qkv, compute_dtype=dt, scale=(h // heads) ** -0.5,
          scale_cols=h, col_scale=qkv_scale),
      'attention_ms': lambda: _kernels.attention(
          qkv, o, batch=b, length=length, num_heads=heads, win=win,
          lengths=lengths,
          softmax_dtype=fwa.resolve_softmax_dtype(softmax_dtype)),
      'o_gemm_ms': lambda: _kernels.gemm(
          o, wo, ffn_in, compute_dtype=dt, col_scale=wo_scale, res=x2,
          alpha=alpha_a),
      'ffn_ms': lambda: _kernels.ffn(
          ffn_in, wf, wout, out, b_filter=b_f, b_output=b_o, alpha=alpha_f,
          compute_dtype=dt, filter_scale=f_scale, output_scale=o_scale),
      'operands_ms': operands,
  }
  for fn in stages.values():  # in order: each stage's inputs exist
    fn()
  torch.cuda.synchronize()
  return {name: cuda_ms(fn) for name, fn in stages.items()}


def k1_stages(rows, tables, w_cond, wq, wk, wv, wo, pos, *, specs,
              table_keys, num_heads, attn_win_size, compute_dtype,
              lengths=None, softmax_dtype='float32') -> dict:
  """K1's (K4's, with lengths) launches timed one by one with CUDA
  events (ms), on the inputs each gets in the wrapper: the per-call
  preparation (the condenser's operands and the two GEMMs' weight
  operands), the embedding-gather condenser, the q/k/v GEMM, the
  attention core and the output GEMM. Timing launches: no launch
  counter moves."""
  import torch

  from deepconsensus_tpu_torch.ops import _kernels
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa

  dt = compute_dtype
  b, _, length = rows.shape
  h = w_cond.shape[1]
  m, dev = b * length, rows.device

  def prepare():
    return (fwa.condense_operands(tables, w_cond, pos, specs=specs,
                                  table_keys=table_keys, compute_dtype=dt,
                                  n_rows=rows.shape[1]),
            fwa.gemm_operand((wq, wk, wv), dt), fwa.gemm_operand((wo,), dt))

  ops, (wqkv, qkv_scale), (wo_v, wo_scale) = prepare()
  x = torch.empty((b, length, h), dtype=torch.float32, device=dev)
  x_base = None if dt == torch.float32 else torch.empty_like(x, dtype=dt)
  x2 = x.view(m, h)
  qkv = torch.empty((m, 3 * h), dtype=torch.float32, device=dev)
  o = torch.empty((m, h), dtype=torch.float32, device=dev)
  out = torch.empty((m, h), dtype=dt, device=dev)
  win = length - 1 if attn_win_size is None else int(attn_win_size)
  stages = {
      'condense_ms': lambda: fwa.condense(rows, ops, x, x_base, lengths),
      'qkv_gemm_ms': lambda: _kernels.gemm(
          x2, wqkv, qkv, compute_dtype=dt, scale=(h // num_heads) ** -0.5,
          scale_cols=h, col_scale=qkv_scale),
      'attention_ms': lambda: _kernels.attention(
          qkv, o, batch=b, length=length, num_heads=num_heads, win=win,
          lengths=lengths,
          softmax_dtype=fwa.resolve_softmax_dtype(softmax_dtype)),
      'o_gemm_ms': lambda: _kernels.gemm(o, wo_v, out, compute_dtype=dt,
                                         col_scale=wo_scale),
      'prepare_ms': prepare,
  }
  for fn in stages.values():  # in order: each stage's inputs exist
    fn()
  torch.cuda.synchronize()
  return {name: cuda_ms(fn) for name, fn in stages.items()}


def _logits(qkv, batch: int, length: int, heads: int):
  """(q k^T, |q| |k|^T) in float64, [B, heads, L, L], of a qkv [B*L, 3H]."""
  import torch

  hidden = qkv.shape[1] // 3
  q, k = (t.double().reshape(batch, length, heads, hidden // heads)
          for t in (qkv[:, :hidden], qkv[:, hidden:2 * hidden]))
  return (torch.einsum('blnd,bmnd->bnlm', q, k),
          torch.einsum('blnd,bmnd->bnlm', q.abs(), k.abs()))


def bf16_flips(qkv_kernel, qkv_plain, *, batch: int, length: int,
               heads: int, mask, threshold: float = TOL['bfloat16'] / 2):
  """[B, L] bool: the positions whose output the bfloat16 softmax's own
  discontinuity may move by `threshold` or more between two correct
  versions. A logit is ambiguous when, computed exactly from each
  version's own q and k (upstream float32 rounding differs: K1/K4's
  condenser, the projections), the two round to different bf16 values,
  or either lies within 2^-18 of sum_d |q_d k_d| of a bf16 rounding edge
  (the float32 sums of one logit by the tensor cores and by a matmul
  differ by up to ~2^-20 of that on the card). One bf16 step of a logit
  moves its row's output by at most weight x (e^step - 1) x 2 max|v|; a
  position is set apart when an ambiguous logit of its row, in any head,
  may move it that far, or is the row's maximum (whose step shifts every
  other logit's bf16(s - m)). mask: [B, L, L] or [L, L] bool, or None."""
  import torch

  bf = torch.bfloat16
  hidden = qkv_plain.shape[1] // 3
  sk, mk = _logits(qkv_kernel, batch, length, heads)
  sp, mp = _logits(qkv_plain, batch, length, heads)
  amb = sk.float().to(bf) != sp.float().to(bf)
  for s, m in ((sk, mk), (sp, mp)):
    d = m * 2.0 ** -18
    amb |= (s - d).float().to(bf) != (s + d).float().to(bf)
  full = torch.ones_like(amb) if mask is None else (
      mask[:, None] if mask.dim() == 3 else mask).expand_as(amb)
  sd = sp.float().to(bf).double().masked_fill(~full, -float('inf'))
  step = torch.exp2(torch.floor(torch.log2(
      sd.abs().clamp_min(2.0 ** -126))) - 7)
  weight = torch.softmax(sd, dim=-1)
  vmax = qkv_plain[:, 2 * hidden:].abs().reshape(
      batch, length, heads, -1).amax(dim=(1, 3)).double()
  effect = weight * torch.expm1(step) * 2 * vmax[:, :, None, None]
  is_max = sd == sd.amax(dim=-1, keepdim=True)
  flag = amb & full & ((effect >= threshold) | is_max)
  return flag.any(-1).any(1)


def variant_check(kernel, plain, keep=None) -> dict:
  """The attn_softmax_dtype=bfloat16 variant, kernel() against its plain
  version plain(): within the bfloat16 tolerance (in either compute
  dtype) on every position a window holds (keep, [B, L] bool) whose
  attention rows the two versions take through the same bf16 logits
  (bf16_flips, from the q/k/v each version's attention core was handed,
  recorded); the others must be finite. Returns the max error there and
  everywhere, the share of elements beyond 1e-4 and the share of
  positions set apart."""
  import torch

  from deepconsensus_tpu_torch.ops import _kernels
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa

  kcalls, pcalls = [], []
  attention, core = _kernels.attention, fwa.attention_core_plain

  def rec_kernel(qkv, out, **kw):
    kcalls.append(qkv.clone())
    return attention(qkv, out, **kw)

  def rec_plain(qkv, **kw):
    pcalls.append((qkv, kw))
    return core(qkv, **kw)

  _kernels.attention, fwa.attention_core_plain = rec_kernel, rec_plain
  try:
    got, want = kernel(), plain()
  finally:
    _kernels.attention, fwa.attention_core_plain = attention, core
  torch.cuda.synchronize()
  got = got if isinstance(got, tuple) else (got,)
  want = want if isinstance(want, tuple) else (want,)
  if keep is None:
    keep = torch.ones(got[0].shape[:2], dtype=torch.bool,
                      device=got[0].device)
  apart = torch.zeros_like(keep)
  if len(kcalls) != len(pcalls):
    raise AssertionError(f'{len(kcalls)} kernel attention calls, '
                         f'{len(pcalls)} plain')
  for qkv_k, (qkv_p, kw) in zip(kcalls, pcalls):
    mask = kw.get('mask')
    if mask is None:
      mask = _band(kw['length'], kw['attn_win_size'], qkv_p.device)
    apart |= bf16_flips(qkv_k, qkv_p, batch=kw['batch'],
                        length=kw['length'], heads=kw['num_heads'],
                        mask=mask)
  inner = keep & ~apart
  if not all(torch.isfinite(g[keep].float()).all() for g in got):
    raise AssertionError('the bf16-softmax kernel wrote non-finite values')
  err = max(max_err(g[inner], w[inner], TOL['bfloat16'])
            for g, w in zip(got, want))
  diffs = [(g[keep].float() - w[keep].float()).abs() for g, w in zip(got, want)]
  return {'max_abs_err': err,
          'max_abs_err_all': max(float(d.max()) for d in diffs),
          'share_beyond_1e-4': sum(int((d > 1e-4).sum()) for d in diffs)
          / sum(d.numel() for d in diffs),
          'share_set_apart': float(apart[keep].float().mean())}


def _band(length: int, win, device):
  import torch

  if win is None:
    return None
  i = torch.arange(length, device=device)
  return (i[:, None] - i[None, :]).abs() <= win


def core_entry(qkv, *, batch: int, length: int, heads: int, win: int,
               softmax_dtype: str, lengths=None) -> dict:
  """The attention core alone (csrc/ragged_attention.cu) on the q/k/v a
  block's projection gives, against attention_core_plain on the
  positions a window holds (float32 softmax 1e-4, bfloat16 2e-2, the
  share beyond 1e-4 printed), timed beside SDPA with the band (and the
  slots' window) mask on the same q/k/v. Bound: qkv read and o written
  once, against the band's products at the float32 peak."""
  import torch
  import torch.nn.functional as F

  from deepconsensus_tpu_torch.ops import _kernels
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
  from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa

  dev = qkv.device
  hidden = qkv.shape[1] // 3
  sdt = fwa.resolve_softmax_dtype(softmax_dtype)
  out = torch.empty((batch * length, hidden), dtype=torch.float32,
                    device=dev)

  def kernel():
    _kernels.attention(qkv, out, batch=batch, length=length,
                       num_heads=heads, win=win, lengths=lengths,
                       softmax_dtype=sdt)

  if lengths is None:
    mask = _band(length, win, dev)[None].expand(batch, length, length)
    keep = torch.ones(batch * length, dtype=torch.bool, device=dev)
  else:
    mask = rwa.ragged_attention_mask(lengths, length, win)
    keep = rwa.slot_geometry(lengths, length)[3].reshape(-1)

  def plain():
    return fwa.attention_core_plain(
        qkv, batch=batch, length=length, num_heads=heads, attn_win_size=win,
        mask=mask, softmax_dtype=sdt)

  kernel()
  want = plain()
  torch.cuda.synchronize()
  if sdt == torch.float32:
    errs = {'max_abs_err': max_err(out[keep], want[keep], TOL['float32']),
            'share_beyond_1e-4': float(
                ((out[keep] - want[keep]).abs() > 1e-4).float().mean())}
  else:
    apart = bf16_flips(qkv, qkv, batch=batch, length=length, heads=heads,
                       mask=mask).reshape(-1)
    inner = keep & ~apart
    diff = (out[keep] - want[keep]).abs()
    errs = {'max_abs_err': max_err(out[inner], want[inner],
                                   TOL['bfloat16']),
            'max_abs_err_all': float(diff.max()),
            'share_beyond_1e-4': float((diff > 1e-4).float().mean()),
            'share_set_apart': float(apart[keep].float().mean())}
  q, k, v = (t.reshape(batch, length, heads, hidden // heads).transpose(1, 2)
             for t in qkv.split(hidden, dim=1))
  sdpa_mask = mask[:, None]
  pairs = int(mask.sum())
  nbytes = qkv.numel() * 4 + out.numel() * 4 + (
      0 if lengths is None else lengths.numel() * 4)
  flops = 4 * pairs * hidden
  t_bound, by = bound(flops, nbytes, 'float32')
  return dict(
      **errs, ms=cuda_ms(kernel), plain_ms=cuda_ms(plain),
      library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
          q, k, v, attn_mask=sdpa_mask, scale=1.0)),
      bound_ms=t_bound, bound_by=by, flops=flops, bytes=nbytes, pairs=pairs)


def block_qkv(x, block, dt, heads: int):
  """A K2 block's q/k/v projection of x [B, L, H] as the kernel path
  makes it (fused GEMM, q scaled): [B*L, 3H] float32."""
  import torch

  from deepconsensus_tpu_torch.ops import _kernels
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa

  b, length, h = x.shape
  wqkv, qkv_scale = fwa.gemm_operand((block.wq, block.wk, block.wv), dt)
  qkv = torch.empty((b * length, 3 * h), dtype=torch.float32,
                    device=x.device)
  _kernels.gemm(x.reshape(b * length, h), wqkv, qkv, compute_dtype=dt,
                scale=(h // heads) ** -0.5, scale_cols=h, col_scale=qkv_scale)
  return qkv


def check_kernels(dtype: str, device: str = 'cuda') -> dict:
  """Phase 2 for one dtype: each kernel vs its plain version."""
  import numpy as np
  import torch
  import torch.nn.functional as F

  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.ops import fused_encoder_block as feb
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
  from deepconsensus_tpu_torch.ops import output_plane
  from deepconsensus_tpu_torch.calibration import lib as calibration_lib

  dev = torch.device(device)
  params = make_params(dtype)
  dt = fwa.resolve_dtype(dtype)
  isz = 4 if dtype == 'float32' else 2
  model = model_lib.DeepConsensusModel(params, device=dev)
  model.init_weights(torch.Generator().manual_seed(SEED))
  rng = np.random.default_rng(SEED)
  rows = torch.from_numpy(fake_rows(params, rng)).to(dev)
  h, heads, win = params.hidden_size, params.num_heads, params.attn_win_size
  f = params.filter_size
  m = BATCH * LENGTH
  pairs = band_pairs(LENGTH, win) * BATCH
  tables, keys = model.tables()
  a0 = model.encoder.layer('self_attention', 0)
  pos = model._position_encoding(LENGTH, dt, dev)
  k1_args = (rows, tables, model.condenser.matrix(), a0.query.matrix(),
             a0.key.matrix(), a0.value.matrix(),
             a0.output_transform.matrix(), pos)
  k1_kw = dict(specs=model.specs, table_keys=keys, num_heads=heads,
               attn_win_size=win, compute_dtype=dt)
  out = {}

  # K1
  got = fwa.fused_embed_condense_attention(*k1_args, **k1_kw)
  want = fwa.fused_embed_condense_attention_plain(*k1_args, **k1_kw)
  torch.cuda.synchronize()
  err = max(max_err(g, w, TOL[dtype]) for g, w in zip(got, want))
  cond_in = model.condenser.kernel.shape[0]
  flops = 2 * m * cond_in * h + 2 * m * h * 4 * h + 4 * pairs * h
  nbytes = (rows.numel() * 4 + sum(t.numel() for t in tables.values()) * isz
            + (cond_in * h + 4 * h * h + LENGTH * h) * isz + 2 * m * h * isz)
  wq, wk, wv, wo = (w.to(dt) for w in k1_args[3:7])
  band = (torch.arange(LENGTH, device=dev)[:, None]
          - torch.arange(LENGTH, device=dev)[None, :]).abs() <= win

  def k1_library():
    ids = fwa.prepare_ids(rows, model.specs).long()
    emb = torch.cat([
        (tables[keys[s.table_idx]].to(dt).float()
         * s.width ** 0.5)[ids[:, s.row_start:s.row_start + s.n_rows]]
        .permute(0, 2, 1, 3).reshape(BATCH, LENGTH, -1)
        for s in model.specs], -1)
    x = emb @ model.condenser.matrix().to(dt).float() + pos.float()
    qkv = [(x @ w.float()).view(BATCH, LENGTH, heads, -1).transpose(1, 2)
           for w in (wq, wk, wv)]
    o = F.scaled_dot_product_attention(*qkv, attn_mask=band)
    return o.transpose(1, 2).reshape(BATCH, LENGTH, h) @ wo.float()

  t_bound, by = bound(flops, nbytes, dtype)
  out['K1'] = dict(
      max_abs_err=err, ms=cuda_ms(
          lambda: fwa.fused_embed_condense_attention(*k1_args, **k1_kw)),
      plain_ms=cuda_ms(lambda: fwa.fused_embed_condense_attention_plain(
          *k1_args, **k1_kw)),
      library_ms=cuda_ms(k1_library), bound_ms=t_bound, bound_by=by,
      stages=k1_stages(*k1_args, **k1_kw), flops=flops, bytes=nbytes)
  # K1 with attn_softmax_dtype=bfloat16: the same inputs, work and
  # yardstick (SDPA's softmax is float32's).
  sm = dict(softmax_dtype='bfloat16')
  checked = variant_check(
      lambda: fwa.fused_embed_condense_attention(*k1_args, **k1_kw, **sm),
      lambda: fwa.fused_embed_condense_attention_plain(*k1_args, **k1_kw,
                                                       **sm))
  out['K1_bf16_softmax'] = dict(
      **checked, ms=cuda_ms(
          lambda: fwa.fused_embed_condense_attention(*k1_args, **k1_kw,
                                                     **sm)),
      plain_ms=cuda_ms(lambda: fwa.fused_embed_condense_attention_plain(
          *k1_args, **k1_kw, **sm)),
      library_ms=cuda_ms(k1_library), bound_ms=t_bound, bound_by=by,
      stages=k1_stages(*k1_args, **k1_kw, **sm), flops=flops, bytes=nbytes)

  # K2: a full block (attention + FFN) on realistic activations, and the
  # layer-0 FFN-only block.
  alpha0 = model.encoder.layer('attention_wrapper', 0).alpha
  x = (want[0] + alpha0.to(dt) * want[1]).contiguous()
  blocks = model.encoder.kernel_blocks()
  k2_kw = dict(num_heads=heads, attn_win_size=win, compute_dtype=dt)
  errs = []
  for block in (blocks[1], blocks[0]):
    got = feb.fused_encoder_stack(x, [block], **k2_kw)
    want2 = feb.fused_encoder_stack_plain(x, [block], **k2_kw)
    torch.cuda.synchronize()
    errs.append(max_err(got, want2, TOL[dtype]))
  b1 = blocks[1]
  flops = 2 * m * h * 4 * h + 4 * pairs * h + 4 * m * h * f
  nbytes = (2 * m * h + 4 * h * h + 2 * h * f) * isz + (f + h + 2) * 4

  ws = block_matrices(b1, dt)
  t_bound, by = bound(flops, nbytes, dtype)
  out['K2'] = dict(
      max_abs_err=max(errs), ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [b1], **k2_kw)),
      plain_ms=cuda_ms(lambda: feb.fused_encoder_stack_plain(
          x, [b1], **k2_kw)),
      library_ms=cuda_ms(lambda: k2_library(x, ws, b1, heads, band)),
      bound_ms=t_bound, bound_by=by,
      ffn_only_ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [blocks[0]], **k2_kw)),
      stages=k2_stages(x, b1, dt, heads, win), flops=flops, bytes=nbytes)
  # The attention core alone, on block 1's q/k/v of these activations,
  # in both softmax dtypes.
  qkv = block_qkv(x, b1, dt, heads)
  for sdt in ('float32', 'bfloat16'):
    out['attention_core' + ('' if sdt == 'float32' else '_bf16_softmax')] = (
        core_entry(qkv, batch=BATCH, length=LENGTH, heads=heads, win=win,
                   softmax_dtype=sdt))
  errs = []
  for block in (blocks[1], blocks[0]):
    errs.append(variant_check(
        lambda: feb.fused_encoder_stack(x, [block], **k2_kw, **sm),
        lambda: feb.fused_encoder_stack_plain(x, [block], **k2_kw, **sm)))
  out['K2_bf16_softmax'] = dict(
      **{k: max(e[k] for e in errs) for k in errs[0]}, ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [b1], **k2_kw, **sm)),
      plain_ms=cuda_ms(lambda: feb.fused_encoder_stack_plain(
          x, [b1], **k2_kw, **sm)),
      library_ms=cuda_ms(lambda: k2_library(x, ws, b1, heads, band)),
      bound_ms=t_bound, bound_by=by,
      ffn_only_ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [blocks[0]], **k2_kw, **sm)),
      stages=k2_stages(x, b1, dt, heads, win, softmax_dtype='bfloat16'),
      flops=flops, bytes=nbytes)

  # K2 int8: the same activations, the same weights quantized as `run
  # --quantize_matmuls int8` loads them. The peak is the activations'
  # type's: every int8 value is exact in bfloat16, so a bfloat16 MMA
  # with float32 accumulation forms the same products.
  qblocks = int8_blocks(model, dtype)
  errs = []
  for block in (qblocks[1], qblocks[0]):
    got = feb.fused_encoder_stack(x, [block], **k2_kw)
    want2 = feb.fused_encoder_stack_plain(x, [block], **k2_kw)
    torch.cuda.synchronize()
    errs.append(max_err(got, want2, TOL[dtype]))
  q1 = qblocks[1]
  qws = block_matrices(q1, dt)
  nbytes = int8_k2_bytes(m, h, f, isz)
  t_bound, by = bound(flops, nbytes, dtype)
  out['K2_int8'] = dict(
      max_abs_err=max(errs), ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [q1], **k2_kw)),
      plain_ms=cuda_ms(lambda: feb.fused_encoder_stack_plain(
          x, [q1], **k2_kw)),
      library_ms=cuda_ms(lambda: k2_library(x, qws, q1, heads, band)),
      bound_ms=t_bound, bound_by=by,
      ffn_only_ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [qblocks[0]], **k2_kw)),
      ffn_only_plain_ms=cuda_ms(
          lambda: feb.fused_encoder_stack_plain(x, [qblocks[0]], **k2_kw)),
      stages=k2_stages(x, q1, dt, heads, win), flops=flops, bytes=nbytes)
  errs = []
  for block in (qblocks[1], qblocks[0]):
    errs.append(variant_check(
        lambda: feb.fused_encoder_stack(x, [block], **k2_kw, **sm),
        lambda: feb.fused_encoder_stack_plain(x, [block], **k2_kw, **sm)))
  out['K2_int8_bf16_softmax'] = dict(
      **{k: max(e[k] for e in errs) for k in errs[0]}, ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [q1], **k2_kw, **sm)),
      plain_ms=cuda_ms(lambda: feb.fused_encoder_stack_plain(
          x, [q1], **k2_kw, **sm)),
      library_ms=cuda_ms(lambda: k2_library(x, qws, q1, heads, band)),
      bound_ms=t_bound, bound_by=by,
      ffn_only_ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [qblocks[0]], **k2_kw, **sm)),
      stages=k2_stages(x, q1, dt, heads, win, softmax_dtype='bfloat16'),
      flops=flops, bytes=nbytes)

  # K3 (float32 preds in both runs; exact), with tied maxima and
  # probabilities placed exactly on thresholds.
  thr = output_plane.quality_thresholds(
      calibration_lib.parse_calibration_string('skip'), 93)
  logits = torch.from_numpy(rng.normal(0, 3, (BATCH, LENGTH, 5))
                            .astype(np.float32)).to(dev)
  preds = torch.softmax(logits, -1)
  preds[0, :, :] = 0.2
  preds[1, :, 1] = preds[1, :, 3] = 0.45
  on = torch.from_numpy(thr[rng.integers(0, len(thr), LENGTH)]).to(dev)
  preds[2, :, 2] = on
  thr_dev = torch.from_numpy(thr).to(dev)
  got = output_plane.phred_epilogue(preds, thr_dev)
  want3 = output_plane.phred_epilogue_plain(preds, thr_dev)
  torch.cuda.synchronize()
  for g, w in zip(got, want3):
    if not torch.equal(g, w):
      raise AssertionError('K3 disagrees with its plain version')
  nbytes = preds.numel() * 4 + thr.size * 4 + 2 * m

  def k3_library():
    mx, ids = preds.max(-1)
    return ids, torch.searchsorted(thr_dev, mx, right=True)

  # A launch of either takes a few microseconds: many calls in a row, so
  # that the host's per-call cost, not the clock's noise, is what counts.
  t_bound, _ = bound(m * (5 + len(thr)), nbytes, 'float32')
  many = dict(iters=200, warmup=20)
  out['K3'] = dict(
      max_abs_err=0.0,
      ms=cuda_ms(lambda: output_plane.phred_epilogue(preds, thr_dev), **many),
      plain_ms=cuda_ms(
          lambda: output_plane.phred_epilogue_plain(preds, thr_dev), **many),
      library_ms=cuda_ms(k3_library, **many), bound_ms=t_bound,
      bound_by='bytes',
      # The same three on the device alone (host cost excluded).
      device_ms=graph_ms(lambda: output_plane.phred_epilogue(preds, thr_dev)),
      plain_device_ms=graph_ms(
          lambda: output_plane.phred_epilogue_plain(preds, thr_dev)),
      library_device_ms=graph_ms(k3_library),
      flops=m * (5 + len(thr)), bytes=nbytes)
  return out


def check_ragged_kernels(dtype: str, device: str = 'cuda') -> dict:
  """Phase 2 for one dtype on ragged slots: K4 and one K2 block with
  lengths vs their plain versions, on valid positions."""
  import numpy as np
  import torch
  import torch.nn.functional as F

  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.ops import fused_encoder_block as feb
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
  from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa

  dev = torch.device(device)
  params = make_params(dtype)
  dt = fwa.resolve_dtype(dtype)
  isz = 4 if dtype == 'float32' else 2
  model = model_lib.DeepConsensusModel(params, device=dev)
  model.init_weights(torch.Generator().manual_seed(SEED))
  rng = np.random.default_rng(SEED + 1)
  rows, lengths = ragged_slots(params, rng, dev)
  h, heads, win = params.hidden_size, params.num_heads, params.attn_win_size
  f = params.filter_size
  m = SLOTS * SLOT_LEN
  mask = rwa.ragged_attention_mask(lengths, SLOT_LEN, win)
  _, start, _, valid = rwa.slot_geometry(lengths, SLOT_LEN)
  pairs = int(mask.sum())
  tables, keys = model.tables()
  a0 = model.encoder.layer('self_attention', 0)
  pos = model._position_encoding(SLOT_LEN, dt, dev)
  k4_args = (rows, lengths, tables, model.condenser.matrix(),
             a0.query.matrix(), a0.key.matrix(), a0.value.matrix(),
             a0.output_transform.matrix(), pos)
  k4_kw = dict(specs=model.specs, table_keys=keys, num_heads=heads,
               attn_win_size=win, compute_dtype=dt)
  out = {}

  got = rwa.ragged_embed_condense_attention(*k4_args, **k4_kw)
  want = rwa.ragged_embed_condense_attention_plain(*k4_args, **k4_kw)
  torch.cuda.synchronize()
  if not all(torch.isfinite(g.float()).all() for g in got):
    raise AssertionError('K4 wrote non-finite values')
  err = max(max_err(g[valid], w[valid], TOL[dtype])
            for g, w in zip(got, want))
  cond_in = model.condenser.kernel.shape[0]
  flops = 2 * m * cond_in * h + 2 * m * h * 4 * h + 4 * pairs * h
  nbytes = (rows.numel() * 4 + lengths.numel() * 4
            + sum(t.numel() for t in tables.values()) * isz
            + (cond_in * h + 4 * h * h + SLOT_LEN * h) * isz + 2 * m * h * isz)
  wq, wk, wv, wo = (w.to(dt) for w in k4_args[4:8])
  sdpa_mask = mask[:, None]

  def k4_library():
    ids = fwa.prepare_ids(rows, model.specs).long()
    emb = torch.cat([
        (tables[keys[s.table_idx]].to(dt).float()
         * s.width ** 0.5)[ids[:, s.row_start:s.row_start + s.n_rows]]
        .permute(0, 2, 1, 3).reshape(SLOTS, SLOT_LEN, -1)
        for s in model.specs], -1)
    x = (emb @ model.condenser.matrix().to(dt).float()
         + rwa.pos_contribution(start, valid, pos))
    qkv = [(x @ w.float()).view(SLOTS, SLOT_LEN, heads, -1).transpose(1, 2)
           for w in (wq, wk, wv)]
    o = F.scaled_dot_product_attention(*qkv, attn_mask=sdpa_mask)
    return o.transpose(1, 2).reshape(SLOTS, SLOT_LEN, h) @ wo.float()

  t_bound, by = bound(flops, nbytes, dtype)
  out['K4'] = dict(
      max_abs_err=err, ms=cuda_ms(
          lambda: rwa.ragged_embed_condense_attention(*k4_args, **k4_kw)),
      plain_ms=cuda_ms(lambda: rwa.ragged_embed_condense_attention_plain(
          *k4_args, **k4_kw)),
      library_ms=cuda_ms(k4_library), bound_ms=t_bound, bound_by=by,
      stages=k1_stages(rows, *k4_args[2:], **k4_kw, lengths=lengths),
      flops=flops, bytes=nbytes, pairs=pairs,
      valid_positions=int(valid.sum()))
  sm = dict(softmax_dtype='bfloat16')
  checked = variant_check(
      lambda: rwa.ragged_embed_condense_attention(*k4_args, **k4_kw, **sm),
      lambda: rwa.ragged_embed_condense_attention_plain(*k4_args, **k4_kw,
                                                        **sm), valid)
  out['K4_bf16_softmax'] = dict(
      **checked, ms=cuda_ms(
          lambda: rwa.ragged_embed_condense_attention(*k4_args, **k4_kw,
                                                      **sm)),
      plain_ms=cuda_ms(lambda: rwa.ragged_embed_condense_attention_plain(
          *k4_args, **k4_kw, **sm)),
      library_ms=cuda_ms(k4_library), bound_ms=t_bound, bound_by=by,
      stages=k1_stages(rows, *k4_args[2:], **k4_kw, lengths=lengths, **sm),
      flops=flops, bytes=nbytes)

  # One full K2 block with lengths, on the residual K4's plain version
  # gives.
  alpha0 = model.encoder.layer('attention_wrapper', 0).alpha
  x = (want[0] + alpha0.to(dt) * want[1]).contiguous()
  b1 = model.encoder.kernel_blocks()[1]
  k2_kw = dict(num_heads=heads, attn_win_size=win, compute_dtype=dt,
               lengths=lengths)
  got = feb.fused_encoder_stack(x, [b1], **k2_kw)
  want2 = feb.fused_encoder_stack_plain(x, [b1], **k2_kw)
  torch.cuda.synchronize()
  err = max_err(got[valid], want2[valid], TOL[dtype])
  flops = 2 * m * h * 4 * h + 4 * pairs * h + 4 * m * h * f
  nbytes = ((2 * m * h + 4 * h * h + 2 * h * f) * isz + (f + h + 2) * 4
            + lengths.numel() * 4)

  ws = block_matrices(b1, dt)
  t_bound, by = bound(flops, nbytes, dtype)
  out['K2_lengths'] = dict(
      max_abs_err=err, ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [b1], **k2_kw)),
      plain_ms=cuda_ms(lambda: feb.fused_encoder_stack_plain(
          x, [b1], **k2_kw)),
      library_ms=cuda_ms(lambda: k2_library(x, ws, b1, heads, sdpa_mask)),
      bound_ms=t_bound, bound_by=by,
      stages=k2_stages(x, b1, dt, heads, win, lengths), flops=flops,
      bytes=nbytes)
  qkv = block_qkv(x, b1, dt, heads)
  for sdt in ('float32', 'bfloat16'):
    out['attention_core_lengths'
        + ('' if sdt == 'float32' else '_bf16_softmax')] = core_entry(
            qkv, batch=SLOTS, length=SLOT_LEN, heads=heads, win=win,
            softmax_dtype=sdt, lengths=lengths)
  checked = variant_check(
      lambda: feb.fused_encoder_stack(x, [b1], **k2_kw, **sm),
      lambda: feb.fused_encoder_stack_plain(x, [b1], **k2_kw, **sm), valid)
  out['K2_lengths_bf16_softmax'] = dict(
      **checked, ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [b1], **k2_kw, **sm)),
      plain_ms=cuda_ms(lambda: feb.fused_encoder_stack_plain(
          x, [b1], **k2_kw, **sm)),
      library_ms=cuda_ms(lambda: k2_library(x, ws, b1, heads, sdpa_mask)),
      bound_ms=t_bound, bound_by=by,
      stages=k2_stages(x, b1, dt, heads, win, lengths,
                       softmax_dtype='bfloat16'), flops=flops, bytes=nbytes)

  # K2 int8 with lengths: the same slots, the weights quantized.
  q1 = int8_blocks(model, dtype)[1]
  got = feb.fused_encoder_stack(x, [q1], **k2_kw)
  want2 = feb.fused_encoder_stack_plain(x, [q1], **k2_kw)
  torch.cuda.synchronize()
  err = max_err(got[valid], want2[valid], TOL[dtype])
  qws = block_matrices(q1, dt)
  nbytes = int8_k2_bytes(m, h, f, isz, lengths.numel() * 4)
  t_bound, by = bound(flops, nbytes, dtype)
  out['K2_int8_lengths'] = dict(
      max_abs_err=err, ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [q1], **k2_kw)),
      plain_ms=cuda_ms(lambda: feb.fused_encoder_stack_plain(
          x, [q1], **k2_kw)),
      library_ms=cuda_ms(lambda: k2_library(x, qws, q1, heads, sdpa_mask)),
      bound_ms=t_bound, bound_by=by,
      stages=k2_stages(x, q1, dt, heads, win, lengths), flops=flops,
      bytes=nbytes)
  checked = variant_check(
      lambda: feb.fused_encoder_stack(x, [q1], **k2_kw, **sm),
      lambda: feb.fused_encoder_stack_plain(x, [q1], **k2_kw, **sm), valid)
  out['K2_int8_lengths_bf16_softmax'] = dict(
      **checked, ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [q1], **k2_kw, **sm)),
      plain_ms=cuda_ms(lambda: feb.fused_encoder_stack_plain(
          x, [q1], **k2_kw, **sm)),
      library_ms=cuda_ms(lambda: k2_library(x, qws, q1, heads, sdpa_mask)),
      bound_ms=t_bound, bound_by=by,
      stages=k2_stages(x, q1, dt, heads, win, lengths,
                       softmax_dtype='bfloat16'), flops=flops, bytes=nbytes)
  return out


def check_wavefront_kernels(device: str = 'cuda') -> dict:
  """Phase 2 for the alignment DP (float32 costs in both compute
  dtypes): K11 without and with rows, K12 on those rows, vs the plain
  DP and its autograd, at train's m = n = LENGTH, train_flash's m = n =
  FLASH_LENGTH and long_window's m = n = LONG_INSERT_WINDOW_LEN (two DP
  rows a lane there); the last two's times and bounds go under 'm200'
  and 'm500'."""
  import numpy as np
  import torch

  from deepconsensus_tpu_torch.models import config as config_lib
  from deepconsensus_tpu_torch.ops import wavefront
  from deepconsensus_tpu_torch.ops import wavefront_cuda

  dev = torch.device(device)
  rng = np.random.default_rng(SEED + 2)
  b = TRAIN_BATCH
  grad = torch.from_numpy(rng.uniform(0.5, 2, b).astype(np.float32)).to(dev)
  out = {'K11': {}, 'K12': {}}
  for m in (LENGTH, FLASH_LENGTH, config_lib.LONG_INSERT_WINDOW_LEN):
    n = m
    lens = rng.integers(m // 2, m + 1, b).astype(np.int32)
    lens[:2] = (0, m)
    subs = torch.from_numpy(rng.uniform(0, 8, (b, m, n)).astype(np.float32))
    ins = torch.from_numpy(rng.uniform(0, 8, (b, n)).astype(np.float32))
    subs, ins = subs.to(dev), ins.to(dev)
    lens = torch.from_numpy(lens).to(dev)
    dp = (DEL_COST, lens, LOSS_REG)

    def k11(s=subs, i=ins, lengths=lens):
      return wavefront_cuda.alignment_scores_with_rows(s, i, DEL_COST,
                                                       lengths, LOSS_REG)

    want = wavefront.alignment_scan(subs, ins, *dp)
    no_rows = wavefront_cuda.alignment_scores(subs, ins, *dp)
    scores, rows = k11()
    s_req = subs.clone().requires_grad_(True)
    i_req = ins.clone().requires_grad_(True)
    plain_value = wavefront.alignment_scan(s_req, i_req, *dp)

    def k12(s=subs, i=ins, lengths=lens, r=rows, g=grad):
      return wavefront_cuda.launch_bwd(s, i, lengths, r, g, DEL_COST,
                                       LOSS_REG)

    def k12_plain(v=plain_value, s_=s_req, i_=i_req):
      return torch.autograd.grad(v, (s_, i_), grad, retain_graph=True)

    d_subs, d_ins = k12()
    want_ds, want_di = k12_plain()
    torch.cuda.synchronize()
    err11 = max(max_err(no_rows, want, 1e-5, 1e-4),
                max_err(scores, want, 1e-5, 1e-4))
    err12 = max(max_err(d_subs, want_ds, 1e-4, 1e-5),
                max_err(d_ins, want_di, 1e-4, 1e-5))
    # The autograd route as the loss calls it.
    s2, i2 = subs.clone().requires_grad_(True), ins.clone().requires_grad_(
        True)
    value = wavefront_cuda.alignment_scores_vjp(s2, i2, lens, DEL_COST,
                                                LOSS_REG)
    g_s, g_i = torch.autograd.grad(value, (s2, i2), grad)
    err11 = max(err11, max_err(value.detach(), want, 1e-5, 1e-4))
    err12 = max(err12, max_err(g_s, want_ds, 1e-4, 1e-5),
                max_err(g_i, want_di, 1e-4, 1e-5))
    # Bytes: each input read once, each output written once. Operations:
    # the cells this run's lengths need, (len + 1) x (n + 1) per row.
    cells = int(((lens.long() + 1) * (n + 1)).sum())
    in_bytes = (subs.numel() + ins.numel() + lens.numel()) * 4
    rows_bytes = rows.numel() * 4
    fwd_bytes = in_bytes + b * 4 + rows_bytes
    bwd_bytes = in_bytes + rows_bytes + b * 4 + (subs.numel() + ins.numel()) * 4
    one = (subs[:1], ins[:1], lens[:1])
    _, rows1 = k11(*one)
    t11, by11 = bound(cells * FWD_OPS_PER_CELL, fwd_bytes, 'float32')
    t12, by12 = bound(cells * BWD_OPS_PER_CELL, bwd_bytes, 'float32')
    k11_entry = dict(
        max_abs_err=err11, ms=cuda_ms(k11),
        no_rows_ms=cuda_ms(lambda: wavefront_cuda.alignment_scores(
            subs, ins, *dp)),
        plain_ms=cuda_ms(lambda: wavefront.alignment_scan(subs, ins, *dp)),
        library_ms=None, bound_ms=t11, bound_by=by11,
        serial_floor_ms=cuda_ms(lambda: k11(*one)),
        flops=cells * FWD_OPS_PER_CELL, bytes=fwd_bytes)
    k12_entry = dict(
        max_abs_err=err12, ms=cuda_ms(k12), plain_ms=cuda_ms(k12_plain),
        library_ms=None, bound_ms=t12, bound_by=by12,
        serial_floor_ms=cuda_ms(lambda: k12(*one, rows1, grad[:1])),
        flops=cells * BWD_OPS_PER_CELL, bytes=bwd_bytes)
    if m == LENGTH:
      out['K11'].update(k11_entry)
      out['K12'].update(k12_entry)
    else:
      out['K11'][f'm{m}'] = k11_entry
      out['K12'][f'm{m}'] = k12_entry
      for name in ('K11', 'K12'):
        out[name]['max_abs_err'] = max(out[name]['max_abs_err'],
                                       out[name][f'm{m}']['max_abs_err'])
  return out


def band_cells(lens, n: int, width: int) -> int:
  """DP cells the banded scores of these lengths need: (x, y) with
  x <= len, y <= min(n, len + width), |y - x| <= width."""
  total = 0
  for length in lens.tolist():
    y_end = min(n, length + width)
    total += sum(max(0, min(y_end, x + width) - max(0, x - width) + 1)
                 for x in range(length + 1))
  return total


def check_band_kernels(device: str = 'cuda') -> dict:
  """Phase 2 for the banded DP (float32 costs): K13 without and with
  rows, K14 on those rows, vs the plain banded DP and its autograd, at
  W = 12 and W = 100 = m, loss_reg 0.1 and the hard minimum; at W = 100
  also vs K11/K12, whose DP the band then covers, and timed apart
  (`w100_ms`: eight band slots a lane where W = 12 takes one)."""
  import numpy as np
  import torch

  from deepconsensus_tpu_torch.ops import wavefront
  from deepconsensus_tpu_torch.ops import wavefront_cuda

  dev = torch.device(device)
  rng = np.random.default_rng(SEED + 6)
  b, m = TRAIN_BATCH, LENGTH
  lens = rng.integers(m // 2, m + 1, b).astype(np.int32)
  lens[:2] = (0, m)
  subs = torch.from_numpy(rng.uniform(0, 8, (b, m, m)).astype(np.float32))
  ins = torch.from_numpy(rng.uniform(0, 8, (b, m)).astype(np.float32))
  subs, ins, lens = subs.to(dev), ins.to(dev), torch.from_numpy(lens).to(dev)
  grad = torch.from_numpy(rng.uniform(0.5, 2, b).astype(np.float32)).to(dev)
  errs = {'K13': [], 'K14': [], 'K13_vs_K11': [], 'K14_vs_K12': []}
  timed, wide = {}, {}
  for width in (BAND_WIDTH, m):
    for reg in (LOSS_REG, None):
      def k13(s=subs, i=ins, lengths=lens, w=width, r=reg):
        return wavefront_cuda.banded_alignment_scores_with_rows(
            s, i, DEL_COST, lengths, w, r)

      def plain(s=subs, i=ins, w=width, r=reg):
        return wavefront.banded_alignment_scan(s, i, DEL_COST, lens, w, r)

      want = plain()
      no_rows = wavefront_cuda.banded_alignment_scores(subs, ins, DEL_COST,
                                                       lens, width, reg)
      scores, rows = k13()
      s_req = subs.clone().requires_grad_(True)
      i_req = ins.clone().requires_grad_(True)
      plain_value = plain(s_req, i_req)

      def k14(s=subs, i=ins, lengths=lens, r_=rows, g=grad, w=width, r=reg):
        return wavefront_cuda.launch_band_bwd(s, i, lengths, r_, g, w,
                                              DEL_COST, r)

      def k14_plain(v=plain_value, s_=s_req, i_=i_req):
        return torch.autograd.grad(v, (s_, i_), grad, retain_graph=True)

      d_subs, d_ins = k14()
      want_ds, want_di = k14_plain()
      torch.cuda.synchronize()
      if not bool(torch.isfinite(d_subs).all() and torch.isfinite(d_ins).all()):
        raise AssertionError(f'K14 wrote non-finite gradients (W={width})')
      errs['K13'].append(max(max_err(no_rows, want, 1e-5, 1e-4),
                             max_err(scores, want, 1e-5, 1e-4)))
      errs['K14'].append(max(max_err(d_subs, want_ds, 1e-4, 1e-5),
                             max_err(d_ins, want_di, 1e-4, 1e-5)))
      if width >= m:
        full, full_rows = wavefront_cuda.alignment_scores_with_rows(
            subs, ins, DEL_COST, lens, reg)
        f_ds, f_di = wavefront_cuda.launch_bwd(subs, ins, lens, full_rows,
                                               grad, DEL_COST, reg)
        torch.cuda.synchronize()
        errs['K13_vs_K11'].append(max_err(scores, full, 1e-5, 1e-4))
        errs['K14_vs_K12'].append(max(max_err(d_subs, f_ds, 1e-4, 1e-5),
                                      max_err(d_ins, f_di, 1e-4, 1e-5)))
        if reg == LOSS_REG:
          wide = dict(K13=cuda_ms(k13), K14=cuda_ms(k14))
      if width == BAND_WIDTH and reg == LOSS_REG:
        one = (subs[:1], ins[:1], lens[:1])
        _, rows1 = k13(*one)
        timed = dict(
            k13_ms=cuda_ms(k13), no_rows_ms=cuda_ms(
                lambda: wavefront_cuda.banded_alignment_scores(
                    subs, ins, DEL_COST, lens, BAND_WIDTH, LOSS_REG)),
            k13_plain_ms=cuda_ms(plain),
            k13_floor_ms=cuda_ms(lambda: k13(*one)),
            k14_ms=cuda_ms(k14), k14_plain_ms=cuda_ms(k14_plain),
            k14_floor_ms=cuda_ms(lambda: k14(*one, rows1, grad[:1])),
            rows_bytes=rows.numel() * 4)
  # Bytes: each input read once (the costs: the band's cells only, the
  # part the function reads), each output written once. Operations: the
  # banded cells this run's lengths need.
  cells = band_cells(lens.cpu(), m, BAND_WIDTH)
  band_subs = b * sum(min(m - 1, i + BAND_WIDTH) - max(0, i - BAND_WIDTH) + 1
                      for i in range(m))
  in_bytes = (band_subs + ins.numel() + lens.numel()) * 4
  fwd_bytes = in_bytes + b * 4 + timed['rows_bytes']
  bwd_bytes = (in_bytes + timed['rows_bytes'] + b * 4
               + (subs.numel() + ins.numel()) * 4)
  out = {}
  t_bound, by = bound(cells * FWD_OPS_PER_CELL, fwd_bytes, 'float32')
  out['K13'] = dict(
      max_abs_err=max(errs['K13']), ms=timed['k13_ms'],
      no_rows_ms=timed['no_rows_ms'], plain_ms=timed['k13_plain_ms'],
      library_ms=None, bound_ms=t_bound, bound_by=by,
      serial_floor_ms=timed['k13_floor_ms'],
      max_abs_err_vs_K11=max(errs['K13_vs_K11']), w100_ms=wide['K13'],
      flops=cells * FWD_OPS_PER_CELL, bytes=fwd_bytes)
  t_bound, by = bound(cells * BWD_OPS_PER_CELL, bwd_bytes, 'float32')
  out['K14'] = dict(
      max_abs_err=max(errs['K14']), ms=timed['k14_ms'],
      plain_ms=timed['k14_plain_ms'], library_ms=None, bound_ms=t_bound,
      bound_by=by, serial_floor_ms=timed['k14_floor_ms'],
      max_abs_err_vs_K12=max(errs['K14_vs_K12']), w100_ms=wide['K14'],
      flops=cells * BWD_OPS_PER_CELL, bytes=bwd_bytes)
  return out


def check_banded_attention_kernels(dtype: str, device: str = 'cuda') -> dict:
  """Phase 2 for one dtype: K5, K7 and K6 (with and without the mask)
  at the train path's attention shapes, vs their plain versions."""
  import numpy as np
  import torch
  import torch.nn.functional as F

  from deepconsensus_tpu_torch.ops import _build
  from deepconsensus_tpu_torch.ops import banded_attention as ba
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa

  dev = torch.device(device)
  params = make_params(dtype)
  dt = fwa.resolve_dtype(dtype)
  isz = 4 if dtype == 'float32' else 2
  b, length, heads = TRAIN_BATCH, LENGTH, params.num_heads
  d, win = params.hidden_size // heads, params.attn_win_size
  rng = np.random.default_rng(SEED + 4)
  q, k, v, do = (torch.from_numpy(rng.normal(size=(b, length, heads, d))
                                  .astype(np.float32)).to(dev, dt)
                 for _ in range(4))
  q = (q * d ** -0.5).contiguous()
  keep = 1.0 - params.attention_dropout
  mask = torch.from_numpy((rng.random((b, heads, length, length)) < keep)
                          .astype(np.uint8)).to(dev)
  tol = TOL[dtype]

  def k5():
    return ba.banded_attention(q, k, v, win)

  def k5_plain():
    return ba.banded_attention_plain(q, k, v, win)

  def k7():
    return ba.banded_attention_dropout(q, k, v, mask, win, keep)

  def k7_plain():
    return ba.banded_attention_dropout_plain(q, k, v, mask, win, keep)

  def k6(m=mask, kp=keep):
    return ba.banded_attention_bwd(q, k, v, m, do, win, kp)

  def k6_plain(m=mask, kp=keep):
    return ba.banded_attention_bwd_plain(q, k, v, m, do, win, kp)

  err5 = max_err(k5(), k5_plain(), tol)
  err7 = max_err(k7(), k7_plain(), tol)
  err6 = max(max_err(g, w, tol) for m, kp in ((mask, keep), (None, 1.0))
             for g, w in zip(k6(m, kp), k6_plain(m, kp)))
  torch.cuda.synchronize()
  # Bytes: each input read once, each output written once, the mask's
  # band only (the function reads nothing outside it). Operations: the
  # band's products, 2*D per (query, key) pair for each of q.k and p.v
  # forward, and of q.k, do.v, dv, dq and dk backward.
  pairs = band_pairs(length, win) * b * heads
  tensor = q.numel() * isz
  band_bytes = pairs  # one uint8 of the mask per in-band pair
  out = {}
  sdpa_in = [x.transpose(1, 2) for x in (q, k, v)]
  band = (torch.arange(length, device=dev)[:, None]
          - torch.arange(length, device=dev)[None, :]).abs() <= win

  def k5_library():
    return F.scaled_dot_product_attention(*sdpa_in, attn_mask=band,
                                          scale=1.0)

  # The forward's blocks an SM at this head width (K5's and K7's fewer).
  fwd_blocks = _build.load(
      'banded_attention').dc_banded_attention_blocks_per_sm(
          0, int(dtype == 'bfloat16'), d)
  t_bound, by = bound(4 * d * pairs, 4 * tensor, dtype)
  out['K5'] = dict(max_abs_err=err5, ms=cuda_ms(k5), plain_ms=cuda_ms(k5_plain),
                   library_ms=cuda_ms(k5_library), bound_ms=t_bound,
                   bound_by=by, flops=4 * d * pairs, bytes=4 * tensor,
                   blocks_per_sm=fwd_blocks)
  t_bound, by = bound(4 * d * pairs, 4 * tensor + band_bytes, dtype)
  k7_ms = cuda_ms(k7)
  out['K7'] = dict(max_abs_err=err7, ms=k7_ms, plain_ms=cuda_ms(k7_plain),
                   library_ms=None, bound_ms=t_bound, bound_by=by,
                   flops=4 * d * pairs, bytes=4 * tensor + band_bytes,
                   blocks_per_sm=fwd_blocks,
                   mask_ms=k7_ms - out['K5']['ms'])
  leaves = [x.detach().requires_grad_(True) for x in sdpa_in]
  sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=band,
                                            scale=1.0)
  do_t = do.transpose(1, 2)

  def k6_library():
    return torch.autograd.grad(sdpa_out, leaves, do_t, retain_graph=True)

  t_bound, by = bound(10 * d * pairs, 7 * tensor + band_bytes, dtype)
  out['K6'] = dict(max_abs_err=err6, ms=cuda_ms(k6), plain_ms=cuda_ms(k6_plain),
                   library_ms=cuda_ms(k6_library), bound_ms=t_bound,
                   bound_by=by, no_mask_ms=cuda_ms(lambda: k6(None, 1.0)),
                   stages=k6_stages(q, k, v, mask, do, win, keep),
                   flops=10 * d * pairs, bytes=7 * tensor + band_bytes)
  return out


def k6_stages(q, k, v, mask, do, win: int, keep: float) -> dict:
  """K6's two passes, each launched alone through its C entry point
  (dc_banded_attention_bwd_pass) on buffers made once: pass 1 (dq and
  the rows' softmax statistics), then pass 2 (dk, dv) on pass 1's
  statistics. Not counted as launches."""
  import torch

  from deepconsensus_tpu_torch.ops import _build
  from deepconsensus_tpu_torch.ops import banded_attention as ba

  b, length, heads, d = q.shape
  lib = _build.load('banded_attention')
  outs = [torch.empty_like(q) for _ in range(3)]
  stats = torch.empty((b, heads, length, 3), dtype=torch.float32,
                      device=q.device)
  ptr = _build.ptr
  args = (ptr(q), ptr(k), ptr(v), ptr(mask), ptr(do), float(keep),
          *map(ptr, outs), ptr(stats), int(q.dtype == torch.bfloat16), b,
          length, heads, d, ba.kernel_win(length, win))

  def run(n):
    return lambda: _build.launch(lib.dc_banded_attention_bwd_pass,
                                 f'K6 pass {n}', q.device, n, *args)

  run(1)()  # the statistics pass 2 reads
  return {'pass1': cuda_ms(run(1)), 'pass2': cuda_ms(run(2))}


def check_flash_kernels(dtype: str, device: str = 'cuda') -> dict:
  """Phase 2 for one dtype: K8 (without and with its logsumexp), K9 and
  K10 at train_flash's attention shapes (256 windows x 200 positions x 2
  heads of 140, band 12) vs their plain versions; K9 and K10 on the plain
  forward's lse and delta."""
  import numpy as np
  import torch
  import torch.nn.functional as F

  from deepconsensus_tpu_torch.ops import flash_band_attention as fba
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa

  dev = torch.device(device)
  params = make_params(dtype)
  dt = fwa.resolve_dtype(dtype)
  isz = 4 if dtype == 'float32' else 2
  b, length, heads = TRAIN_BATCH, FLASH_LENGTH, params.num_heads
  d, win = params.hidden_size // heads, params.attn_win_size
  rng = np.random.default_rng(SEED + 8)
  q, k, v, do = (torch.from_numpy(rng.normal(size=(b, length, heads, d))
                                  .astype(np.float32)).to(dev, dt)
                 for _ in range(4))
  q = (q * d ** -0.5).contiguous()
  tol = TOL[dtype]
  want_o, lse = fba.flash_band_attention_plain(q, k, v, win, with_lse=True)
  delta = fba.row_delta(do, want_o)
  stats = (lse, delta)

  def k8(with_lse=False):
    return fba.flash_band_attention(q, k, v, win, with_lse=with_lse)

  def k8_plain():
    return fba.flash_band_attention_plain(q, k, v, win)

  def k9():
    return fba.flash_band_dq(q, k, v, do, *stats, win)

  def k9_plain():
    return fba.flash_band_dq_plain(q, k, v, do, *stats, win)

  def k10():
    return fba.flash_band_dkdv(q, k, v, do, *stats, win)

  def k10_plain():
    return fba.flash_band_dkdv_plain(q, k, v, do, *stats, win)

  got_o, got_lse = k8(with_lse=True)
  err8 = max(max_err(k8(), want_o, tol), max_err(got_o, want_o, tol),
             max_err(got_lse, lse, 1e-4))
  err9 = max_err(k9(), k9_plain(), tol)
  err10 = max(max_err(g, w, tol) for g, w in zip(k10(), k10_plain()))
  torch.cuda.synchronize()
  # Bytes: each input read once, each output written once (lse and delta
  # [B, H, L] float32). Operations: the band's products, 2*D per (query,
  # key) pair for q.k and p.v forward, q.k, do.v and ds.k for dq, and
  # q.k, do.v, w.do and ds.q for dk/dv.
  pairs = band_pairs(length, win) * b * heads
  tensor = q.numel() * isz
  row = b * heads * length * 4
  sdpa_in = [x.transpose(1, 2) for x in (q, k, v)]
  band = (torch.arange(length, device=dev)[:, None]
          - torch.arange(length, device=dev)[None, :]).abs() <= win

  def k8_library():
    return F.scaled_dot_product_attention(*sdpa_in, attn_mask=band,
                                          scale=1.0)

  leaves = [x.detach().requires_grad_(True) for x in sdpa_in]
  sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=band,
                                            scale=1.0)
  do_t = do.transpose(1, 2)
  # One call computes dq, dk and dv: the yardstick of K9 and K10 together.
  bwd_library_ms = cuda_ms(lambda: torch.autograd.grad(
      sdpa_out, leaves, do_t, retain_graph=True))
  out = {}
  t_bound, by = bound(4 * d * pairs, 4 * tensor, dtype)
  lse_bound, _ = bound(4 * d * pairs, 4 * tensor + row, dtype)
  out['K8'] = dict(max_abs_err=err8, ms=cuda_ms(k8),
                   lse_ms=cuda_ms(lambda: k8(with_lse=True)),
                   plain_ms=cuda_ms(k8_plain), library_ms=cuda_ms(k8_library),
                   bound_ms=t_bound, bound_by=by, lse_bound_ms=lse_bound,
                   flops=4 * d * pairs, bytes=4 * tensor)
  t_bound, by = bound(6 * d * pairs, 5 * tensor + 2 * row, dtype)
  out['K9'] = dict(max_abs_err=err9, ms=cuda_ms(k9), plain_ms=cuda_ms(k9_plain),
                   library_ms=bwd_library_ms, library_covers='K9+K10',
                   bound_ms=t_bound, bound_by=by, flops=6 * d * pairs,
                   bytes=5 * tensor + 2 * row)
  t_bound, by = bound(8 * d * pairs, 6 * tensor + 2 * row, dtype)
  out['K10'] = dict(max_abs_err=err10, ms=cuda_ms(k10),
                    plain_ms=cuda_ms(k10_plain), library_ms=bwd_library_ms,
                    library_covers='K9+K10', bound_ms=t_bound, bound_by=by,
                    flops=8 * d * pairs, bytes=6 * tensor + 2 * row)
  return out


def counted_modules():
  """Kernel name -> (module, launch counter attribute); K8_lse is K8
  with its logsumexp; _bf16_softmax: the attn_softmax_dtype=bfloat16
  variant; attention_core: the core K1, K2 and K4 launch."""
  from deepconsensus_tpu_torch.ops import _kernels
  from deepconsensus_tpu_torch.ops import banded_attention as ba
  from deepconsensus_tpu_torch.ops import flash_band_attention as fba
  from deepconsensus_tpu_torch.ops import fused_encoder_block as feb
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
  from deepconsensus_tpu_torch.ops import output_plane
  from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa
  from deepconsensus_tpu_torch.ops import wavefront_cuda

  return {'K1': (fwa, 'n_launches'), 'K2': (feb, 'n_launches'),
          'K2_int8': (feb, 'n_launches_int8'),
          'K3': (output_plane, 'n_launches'), 'K4': (rwa, 'n_launches'),
          'K5': (ba, 'n_fwd_launches'), 'K6': (ba, 'n_bwd_launches'),
          'K7': (ba, 'n_dropout_fwd_launches'),
          'K8': (fba, 'n_fwd_launches'), 'K8_lse': (fba, 'n_fwd_lse_launches'),
          'K9': (fba, 'n_dq_launches'), 'K10': (fba, 'n_dkdv_launches'),
          'K11': (wavefront_cuda, 'n_fwd_launches'),
          'K12': (wavefront_cuda, 'n_bwd_launches'),
          'K13': (wavefront_cuda, 'n_band_fwd_launches'),
          'K14': (wavefront_cuda, 'n_band_bwd_launches'),
          'K1_bf16_softmax': (fwa, 'n_launches_bf16_softmax'),
          'K2_bf16_softmax': (feb, 'n_launches_bf16_softmax'),
          'K2_int8_bf16_softmax': (feb, 'n_launches_int8_bf16_softmax'),
          'K4_bf16_softmax': (rwa, 'n_launches_bf16_softmax'),
          'attention_core': (_kernels, 'n_attention_launches'),
          'attention_core_bf16_softmax': (
              _kernels, 'n_attention_bf16_softmax_launches')}


def reset_launches() -> None:
  for mod, attr in counted_modules().values():
    setattr(mod, attr, 0)


def read_launches() -> dict:
  return {k: getattr(mod, attr) for k, (mod, attr) in
          counted_modules().items()}


CORE_SOURCE = 'deepconsensus_tpu_torch/csrc/ragged_attention.cu'
# Rows of the kernels line and their phase-2 entries with lengths.
LENGTHS_ROWS = {
    'K2': 'K2_lengths', 'K2_int8': 'K2_int8_lengths',
    'K2_bf16_softmax': 'K2_lengths_bf16_softmax',
    'K2_int8_bf16_softmax': 'K2_int8_lengths_bf16_softmax',
    'attention_core': 'attention_core_lengths',
    'attention_core_bf16_softmax': 'attention_core_lengths_bf16_softmax'}
# The kernels each path must launch.
PATH_KERNELS = {'L100': ('K1', 'K2', 'K3'), 'ragged': ('K4', 'K2', 'K3'),
                'train': ('K11', 'K12'),
                'train_attn': ('K5', 'K6', 'K7', 'K11', 'K12'),
                'train_band': ('K13', 'K14'),
                'train_flash': ('K8', 'K8_lse', 'K9', 'K10', 'K11', 'K12'),
                'buckets': ('K1', 'K2', 'K3', 'K8'),
                'int8': ('K1', 'K2_int8', 'K3'),
                'evaluate': ('K1', 'K2_int8', 'K11')}
RUN_PATHS = ('L100', 'ragged')
BUCKET_FLAGS = ('--use_ccs_smart_windows', '--window_buckets',
                ','.join(map(str, BUCKETS)))
RAGGED_FLAGS = BUCKET_FLAGS + ('--use_ragged_kernel',)


def run_main_path(path: str, bams, weights, dtype: str, plain: bool = False,
                  attn: bool = False, softmax_bf16: bool = False,
                  extra=(), tag: str = '', output_ext: str = 'fastq',
                  batch_zmws: int = N_ZMWS, record_packer=None):
  """One `run` over the synthetic BAMs on one path ('L100', 'ragged',
  'buckets' or 'int8'; attn: params with use_pallas_attention; 'int8':
  the L100 run with --quantize_matmuls int8, and in bfloat16
  --inference_dtype bfloat16 over float32 params; softmax_bf16: params
  with attn_softmax_dtype=bfloat16; extra: more `cli run` flags, tag:
  the output's suffix; record_packer: a list that receives the ragged
  packer's add/flush calls); returns (counters, launch counts,
  delivered-position ids and quals, per-pack lengths, seconds, peak
  bytes). The planes are read where the pipeline delivers them,
  ModelRunner.finalize, in finalize order. Raises unless the BAMs were
  decoded natively."""
  import numpy as np
  import torch

  from deepconsensus_tpu_torch import cli
  from deepconsensus_tpu_torch.inference import engine as engine_lib
  from deepconsensus_tpu_torch.inference import runner as runner_lib

  ragged = path == 'ragged'
  smart = path not in ('L100', 'int8')
  levers = []
  if path == 'int8':
    levers = ['--quantize_matmuls', 'int8']
    if dtype == 'bfloat16':
      levers += ['--inference_dtype', 'bfloat16']
  flag = ('_attn' if attn else '') + ('_bf16sm' if softmax_bf16 else '')
  params_path = os.path.join(WORK, f'params_{dtype}{flag}.json')
  params = make_params('float32' if levers else dtype)
  params.use_pallas_attention = attn
  if softmax_bf16:
    params.attn_softmax_dtype = 'bfloat16'
  if levers:
    params_path = os.path.join(WORK, f'params_{path}_{dtype}{flag}.json')
  with open(params_path, 'w') as f:
    json.dump(params.to_dict(), f)
  out = os.path.join(
      WORK, f'out_{path}_{dtype}{flag}{"_plain" if plain else ""}{tag}'
      f'.{output_ext}')
  planes = []
  finalize = runner_lib.ModelRunner.finalize
  add = engine_lib._RaggedPacker.add
  flush = engine_lib._RaggedPacker.flush

  def recording_finalize(self, handle):
    ids, quals = finalize(self, handle)
    planes.append((np.array(ids), np.array(quals),
                   np.array(handle.lengths) if handle.ragged else None))
    return ids, quals

  def recording_add(self, rows, tickets):
    record_packer.append(('add', int(rows.shape[2]), len(rows)))
    return add(self, rows, tickets)

  def recording_flush(self, drain=True):
    record_packer.append(('flush', drain))
    return flush(self, drain)

  argv = ['run', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
          '--weights', weights, '--params', params_path, '--output', out,
          '--batch_size', str(BATCH), '--batch_zmws', str(batch_zmws),
          '--min_quality', '0', '--skip_windows_above', '0', *extra]
  if smart:
    argv += RAGGED_FLAGS if ragged else BUCKET_FLAGS
  argv += levers
  runner_lib.ModelRunner.finalize = recording_finalize
  if record_packer is not None:
    engine_lib._RaggedPacker.add = recording_add
    engine_lib._RaggedPacker.flush = recording_flush
  torch.cuda.reset_peak_memory_stats()
  reset_launches()
  t0 = time.perf_counter()
  try:
    if plain:
      from deepconsensus_tpu_torch.models import config as config_lib
      from deepconsensus_tpu_torch.models import weights as weights_lib

      params = config_lib.read_params_from_json(params_path)
      options = runner_lib.InferenceOptions(
          batch_size=BATCH, batch_zmws=batch_zmws, min_quality=0,
          skip_windows_above=0, use_ccs_smart_windows=smart,
          window_buckets=BUCKETS if smart else None,
          use_ragged_kernel=ragged,
          quantize_matmuls='int8' if levers else None,
          inference_dtype='bfloat16' if '--inference_dtype' in levers
          else None)
      runner = runner_lib.ModelRunner(
          params, weights_lib.from_flax_params(
              weights_lib.load_npz(weights), params),
          options, plain=True)
      runner_lib.run_inference(bams[0], bams[1], out, runner)
    elif cli.main(argv) != 0:
      raise AssertionError(f'cli run failed ({path}, {dtype})')
  finally:
    runner_lib.ModelRunner.finalize = finalize
    engine_lib._RaggedPacker.add = add
    engine_lib._RaggedPacker.flush = flush
  seconds = time.perf_counter() - t0
  launches = read_launches()
  with open(out + '.inference.json') as f:
    counters = json.load(f)
  if counters['bam_decoder'] != 'native':
    raise AssertionError(f'{path} {dtype}{tag}: the BAMs were decoded by '
                         f'{counters["bam_decoder"]}, not natively')
  ids, quals, lengths = [], [], []
  for pid, pq, pl in planes:
    if pl is not None:  # a ragged pack: keep the windows' positions
      lengths.append(pl)
      keep = np.arange(pid.shape[1])[None, :] < pl.sum(1)[:, None]
      pid, pq = pid[keep], pq[keep]
    ids.append(pid.reshape(-1))
    quals.append(pq.reshape(-1).astype(np.int32))
  return (counters, launches, np.concatenate(ids), np.concatenate(quals),
          lengths, seconds, torch.cuda.max_memory_allocated())


def stage_fields(counters) -> dict:
  """A run's stage seconds, untimed remainder, decoder and the card's
  share of the model stage's wall time not busy with packs."""
  return {'bam_decoder': counters['bam_decoder'],
          'bam_open_seconds': counters.get('bam_open_seconds'),
          **{k: counters.get(k) for k in STAGE_KEYS},
          'model_device_seconds': counters.get('model_device_seconds'),
          'model_stage_wall_seconds': counters.get(
              'model_stage_wall_seconds'),
          'model_idle_share': counters.get('model_idle_share'),
          'transfer_overlap_fraction': counters.get(
              'transfer_overlap_fraction'),
          'n_featurize_batches': counters.get('n_featurize_batches')}


STAGE_CUTS = ('dc_input', 'tf_examples', 'run_model', 'full')
STAGE_KEYS = ('bam_decode_seconds', 'featurize_seconds',
              'triage_format_seconds', 'model_seconds', 'stitch_seconds',
              'untimed_seconds', 'h2d_seconds', 'device_forward_seconds',
              'd2h_seconds')


def stage_split(bams, weights, dtype: str = 'bfloat16') -> dict:
  """The L100 `cli run` once per --end_after_stage cut (BAM decode
  only, + featurize, + model, full), after one full run that warms the
  process up (printed as the cut `warmup`): each cut's wall clock and
  its stage seconds, printed as `stage_split` lines; returns {cut:
  counters}."""
  from deepconsensus_tpu_torch import cli

  params_path = os.path.join(WORK, f'params_split_{dtype}.json')
  with open(params_path, 'w') as f:
    json.dump(make_params(dtype).to_dict(), f)
  cuts = {}
  for cut in ('warmup',) + STAGE_CUTS:
    out = os.path.join(WORK, f'out_split_{cut}.fastq')
    argv = ['run', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
            '--weights', weights, '--params', params_path, '--output', out,
            '--batch_size', str(BATCH), '--batch_zmws', str(N_ZMWS),
            '--min_quality', '0', '--skip_windows_above', '0',
            '--end_after_stage', 'full' if cut == 'warmup' else cut]
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
      raise AssertionError(f'cli run --end_after_stage {cut} failed')
    seconds = time.perf_counter() - t0
    with open(out + '.inference.json') as f:
      cuts[cut] = counters = json.load(f)
    print(json.dumps({
        'phase': 'stage_split', 'cut': cut, 'dtype': dtype,
        'seconds': seconds,
        'total_seconds': counters['total_seconds'],
        'windows': counters.get('n_windows_to_model', 0),
        **stage_fields(counters)}), flush=True)
    if counters['bam_decoder'] != 'native':
      raise AssertionError(f'stage split {cut}: BAMs decoded by '
                           f'{counters["bam_decoder"]}')
  return cuts


PIPELINE_BATCH_ZMWS = 16
SERIAL_FLAGS = ('--dispatch_depth', '1', '--no_cross_batch_packing')


def main_path_line(path: str, label: str, run) -> None:
  counters, launches = run[:2]
  n_win = counters['n_windows_to_model']
  print(json.dumps({
      'phase': 'main_path', 'path': path, 'run': label,
      'launches': launches, 'reads': counters['success'],
      'windows': n_win, 'packs': counters['n_model_packs'],
      'windows_by_bucket': counters['n_windows_by_bucket'],
      'pad_rows': counters['n_model_pad_rows'], 'seconds': run[5],
      'total_seconds': counters['total_seconds'],
      'windows_per_s': n_win / counters['total_seconds'],
      'model_windows_per_s': n_win / counters['model_seconds'],
      'device_windows_per_s': (n_win / counters['model_device_seconds']
                               if counters['model_device_seconds'] else None),
      'peak_bytes': run[6], **stage_fields(counters)}), flush=True)


def replay_ragged_plan(calls) -> list:
  """The lengths rows of every pack the ragged packer cuts for a
  recorded sequence of add(width, count) / flush(drain) calls, from
  the packer itself on a stub runner."""
  import types

  import numpy as np

  from deepconsensus_tpu_torch.inference import engine as engine_lib

  cut = []

  class Stub:

    def dispatch_ragged(self, pack, lengths):
      cut.append(np.array(lengths))
      return pack

    def finalize(self, pack):
      zeros = np.zeros(pack.shape[::2][:2], np.uint8)
      return zeros, zeros

  packer = engine_lib._RaggedPacker(
      Stub(), types.SimpleNamespace(batch_size=BATCH, dispatch_depth=1),
      BUCKETS, deliver=lambda *_: None)
  for call in calls:
    if call[0] == 'add':
      packer.add(np.zeros((call[2], 1, call[1], 1), np.float32),
                 [None] * call[2])
    else:
      packer.flush(call[1])
  return cut


def fastq_diff(a: bytes, b: bytes) -> dict:
  """Reads whose name or bases differ, reads whose qualities differ,
  and the largest quality difference, between two FASTQ files."""
  import numpy as np

  def reads(data):
    lines = data.split(b'\n')
    return [(lines[i], lines[i + 1], lines[i + 3])
            for i in range(0, len(lines) - 1, 4)]

  ra, rb = reads(a), reads(b)
  diff = {'reads': [len(ra), len(rb)], 'bases_differ': 0, 'quals_differ': 0,
          'max_qual_diff': 0}
  for (na, sa, qa), (nb, sb, qb) in zip(ra, rb):
    if (na, sa) != (nb, sb):
      diff['bases_differ'] += 1
    elif qa != qb:
      diff['quals_differ'] += 1
      d = np.abs(np.frombuffer(qa, np.uint8).astype(int)
                 - np.frombuffer(qb, np.uint8).astype(int))
      diff['max_qual_diff'] = max(diff['max_qual_diff'], int(d.max()))
  return diff


def batch_windows(out: str) -> list:
  """Windows per featurize batch, from a run's <output>.runtime.csv."""
  import csv

  with open(out + '.runtime.csv', newline='') as f:
    return [int(r['n_examples']) for r in csv.DictReader(f)
            if r['stage'] == 'preprocess']


def pipeline_gates(bams, weights) -> dict:
  """Phase 3l: the L100 and ragged `cli run` in bfloat16 at
  --batch_zmws 16 (8 featurize batches), pipelined (the defaults) and
  with the serial settings (--dispatch_depth 1 --no_cross_batch_packing),
  then the pipelined L100 run with --cpus 4 and with a .bam output.
  Gates: one read per ZMW and the BAMs decoded natively on every run;
  pipelined and serial FASTQ byte-identical (L100: also to a's
  128-ZMW run), and the --cpus 4 FASTQ to the pipelined one; the
  kernels once per pack (K1 or K4, K3) and per layer and pack (K2);
  L100's packs: cut across batches ceil(windows / 1024) with the pad
  rows of the end-of-input tail only, per batch the sum over batches;
  ragged: every pack's lengths equal to the packer's plan replayed on
  the recorded submissions, every pipelined pack but the last full,
  and slots of one 200 and of two 100s both present; the .bam output's
  records equal to the FASTQ's reads, each with zm, rq and np tags.
  Raises on a failed gate."""
  import numpy as np

  from deepconsensus_tpu_torch.io import bam as bam_lib
  from deepconsensus_tpu_torch.utils import phred

  layers = make_params('float32').num_hidden_layers
  bz = PIPELINE_BATCH_ZMWS
  gates = {}
  checks = []
  outputs = {}
  for path in RUN_PATHS:
    first = 'K4' if path == 'ragged' else 'K1'
    for label, extra in (('pipelined', ()), ('serial', SERIAL_FLAGS),
                         ('cpus4', ('--cpus', '4'))):
      if label == 'cpus4' and path != 'L100':
        continue
      record = []
      tag = f'_bz{bz}_{label}'
      run = run_main_path(path, bams[path], weights, 'bfloat16', extra=extra,
                          tag=tag, batch_zmws=bz, record_packer=record)
      main_path_line(path, f'bfloat16{tag}', run)
      out = os.path.join(WORK, f'out_{path}_bfloat16{tag}.fastq')
      with open(out, 'rb') as f:
        outputs[path, label] = f.read()
      counters, launches, _, _, lengths = run[:5]
      packs = counters['n_model_packs']
      key = f'{path}_{label}'
      gates[f'{key}_packs'] = packs
      want = {first: packs, 'K2': layers * packs, 'K3': packs}
      checks += [
          (counters['success'] == N_ZMWS, f'{key}: not one read per ZMW'),
          (counters['n_featurize_batches'] == N_ZMWS // bz,
           f'{key}: not {N_ZMWS // bz} featurize batches'),
          ({k: launches[k] for k in want} == want,
           f'{key}: launches {launches} differ from {want}')]
      windows = counters['n_windows_to_model']
      if path == 'L100':
        per_batch = batch_windows(out)
        expect = (-(-windows // BATCH) if label != 'serial'
                  else sum(-(-n // BATCH) for n in per_batch))
        checks += [
            (packs == expect, f'{key}: {packs} packs, want {expect}'),
            (counters['n_model_pad_rows'] == packs * BATCH - windows,
             f'{key}: pad rows other than the packs\' tails')]
        continue
      plan = replay_ragged_plan(record)
      full = [int(l.sum()) == SLOTS * SLOT_LEN for l in lengths]
      slots = np.concatenate(lengths)
      gates[f'{key}_partial_packs'] = full.count(False)
      checks += [
          (len(plan) == len(lengths) == packs
           and all(np.array_equal(a, b) for a, b in zip(plan, lengths)),
           f'{key}: packs differ from the packer\'s plan'),
          ((slots == [200, 0]).all(1).any()
           and (slots == [100, 100]).all(1).any(),
           f'{key}: slots of both compositions did not occur')]
      if label == 'pipelined':
        checks.append((all(full[:-1]) and not full[-1],
                       f'{key}: a pack before the last is partial'))
      else:
        checks.append((full.count(False) <= N_ZMWS // bz,
                       f'{key}: more partial packs than featurize batches'))
    same = outputs[path, 'pipelined'] == outputs[path, 'serial']
    gates[f'{path}_pipelined_vs_serial_identical'] = same
    gates[f'{path}_pipelined_vs_serial_diff'] = fastq_diff(
        outputs[path, 'pipelined'], outputs[path, 'serial'])
    checks.append((same, f'{path}: pipelined and serial FASTQ differ'))
  with open(os.path.join(WORK, 'out_ragged_bfloat16.fastq'), 'rb') as f:
    gates['ragged_bz16_vs_bz128_diff'] = fastq_diff(
        f.read(), outputs['ragged', 'pipelined'])
  with open(os.path.join(WORK, 'out_L100_bfloat16.fastq'), 'rb') as f:
    same = f.read() == outputs['L100', 'pipelined']
  gates['L100_bz16_vs_bz128_identical'] = same
  gates['L100_cpus4_identical'] = (
      outputs['L100', 'cpus4'] == outputs['L100', 'pipelined'])
  checks += [(same, 'L100: 16- and 128-ZMW featurize batches differ'),
             (gates['L100_cpus4_identical'],
              'L100: the --cpus 4 FASTQ differs')]
  tag = f'_bz{bz}_bam'
  run = run_main_path('L100', bams['L100'], weights, 'bfloat16', tag=tag,
                      batch_zmws=bz, output_ext='bam')
  main_path_line('L100', f'bfloat16{tag}', run)
  lines = outputs['L100', 'pipelined'].split(b'\n')
  reads = [(lines[i][1:].decode(), lines[i + 1], lines[i + 3])
           for i in range(0, len(lines) - 1, 4)]
  with bam_lib.BamReader(os.path.join(WORK, f'out_L100_bfloat16{tag}.bam')
                         ) as reader:
    records = list(reader)
  decoded = [(r.qname, r.seq.encode(),
              phred.quality_scores_to_string(r.quals).encode())
             for r in records]
  gates['bam_records'] = len(records)
  checks += [
      (run[0]['output_format'] == 'bam' and decoded == reads,
       'the .bam records differ from the FASTQ reads'),
      (all({'zm', 'rq', 'np'} <= set(r.tags) for r in records),
       'a .bam record lacks zm, rq or np')]
  return enforce('pipeline', gates, checks)


FAULT_ZMW = 150  # the corrupted / poisoned / killed ZMW (batch 4 of 8)
HANG_SECONDS, DISPATCH_TIMEOUT = 6, 2
POOL_BATCH_TIMEOUT = 30
TRACE_BUSY_GATE = 0.10


def fastq_records(data: bytes) -> list:
  """A FASTQ's records, each its four lines as bytes."""
  lines = data.split(b'\n')
  return [b'\n'.join(lines[i:i + 4]) + b'\n'
          for i in range(0, len(lines) - 1, 4)]


def record_name(record: bytes) -> str:
  return record.split(b'\n', 1)[0][1:].decode()


def fault_run(tag: str, bams, model, extra=(), env=None,
              ragged: bool = False, expect=None,
              record_halves=None) -> dict:
  """One bfloat16 `cli run` of the faults path (model: the params.json
  and weights paths) at --batch_zmws 16 with
  fault-injection env vars set for its duration (the once-a-process
  hooks re-armed first). expect: the exception type the run must raise
  (the run is then a failing one). record_halves: a list that receives
  (batch size, launches) for each pack OOM bisection re-runs. Returns
  the counters (the sidecar, partial on a failed run), launches,
  output bytes, dead letters, wall seconds and the output path."""
  from deepconsensus_tpu_torch import cli
  from deepconsensus_tpu_torch import faults
  from deepconsensus_tpu_torch.inference import engine as engine_lib

  out = os.path.join(WORK, f'out_faults_{tag}.fastq')
  argv = ['run', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
          '--weights', model[1], '--params', model[0],
          '--output', out, '--batch_size', str(BATCH),
          '--batch_zmws', str(PIPELINE_BATCH_ZMWS), '--min_quality', '0',
          '--skip_windows_above', '0', *extra]
  if ragged:
    argv += RAGGED_FLAGS
  saved = {k: os.environ.get(k) for k in (env or {})}
  os.environ.update(env or {})
  faults._fired.clear()
  run_pack_at = engine_lib._WindowPacker._run_pack_at

  def recording_run_pack_at(self, pack, tickets, seq, batch_size):
    before = read_launches()
    run_pack_at(self, pack, tickets, seq, batch_size)
    after = read_launches()
    record_halves.append((batch_size, {k: after[k] - before[k]
                                       for k in ('K1', 'K2', 'K3')}))

  if record_halves is not None:
    engine_lib._WindowPacker._run_pack_at = recording_run_pack_at
  reset_launches()
  error = None
  t0 = time.perf_counter()
  try:
    rc = cli.main(argv)
  except Exception as e:  # the failing runs' gates read it
    if expect is None or not isinstance(e, expect):
      raise
    error, rc = e, None
  finally:
    seconds = time.perf_counter() - t0
    engine_lib._WindowPacker._run_pack_at = run_pack_at
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
  if expect is not None and error is None:
    raise AssertionError(f'faults {tag}: the run did not raise {expect}')
  if expect is None and rc != 0:
    raise AssertionError(f'faults {tag}: cli run exited {rc}')
  result = {'launches': read_launches(), 'seconds': seconds, 'out': out,
            'error': error, 'letters': []}
  with open(out + '.inference.json') as f:
    result['counters'] = json.load(f)
  if os.path.exists(out):
    with open(out, 'rb') as f:
      result['bytes'] = f.read()
  if os.path.exists(out + '.failed.jsonl'):
    result['letters'] = faults.read_dead_letters(out + '.failed.jsonl')
  return result


def clear_outputs(tag: str) -> None:
  """Removes a faults run's output, sidecars, manifest and tmp file
  from an earlier call of the script."""
  out = os.path.join(WORK, f'out_faults_{tag}.fastq')
  for suffix in ('', '.tmp', '.progress.json', '.failed.jsonl',
                 '.inference.json', '.runtime.csv'):
    if os.path.exists(out + suffix):
      os.unlink(out + suffix)


def faults_gates(bams, weights) -> dict:
  """Phase 3m, the `faults` path: the L100 `cli run` in bfloat16 at
  --batch_zmws 16 (8 featurize batches), each gate against an
  unfaulted run of the same process (the ragged gate against an
  unfaulted ragged run):

  a. ZMW 150's subreads lose their pw tags (testing/faults.corrupt_zmw):
     under --on_zmw_error skip the FASTQ is the reference's minus that
     read, byte for byte, with one dead letter (featurize, permanent);
     under ccs-fallback that read is its draft CCS read and qualities
     and every other read the reference's; under fail the run raises.
  b. DCTPU_FAULT_POISON_WINDOW names ZMW 150: only the molecules of the
     one failed pack are dead-lettered (stage model), every other read
     is the reference's.
  c. An OOM at pack 2 under --on_device_error degrade: the FASTQ is the
     reference's byte for byte, n_oom_bisections >= 1, and K1, K2 and K3
     launch at the half batch (512) for both halves; under fail the run
     raises DeviceOomError.
  d. A hang at pack 2 (the device spin, 6 s) under --dispatch_timeout 2
     and skip: the run finishes, the hung pack's molecules are
     dead-lettered as DispatchTimeoutError, every other read is the
     reference's; its wall clock is printed.
  e. DCTPU_FAULT_CRASH_AFTER_BATCHES=2: the run raises, leaves no final
     output, keeps the manifest and .tmp, and writes partial: true;
     --resume then gives the reference's FASTQ byte for byte, with
     n_zmw_resume_skipped the committed groups, and leaves no .tmp or
     manifest. The same on the ragged path: the read set and ids equal
     the ragged reference's, qualities within 1; the reads that differ
     in any byte are counted.
  f. --shard 0/2 and 1/2: their reads together, sorted, are the
     reference's.
  g. --cpus 4 --batch_timeout 30 with DCTPU_FAULT_KILL_ZMW on ZMW 150
     (once, by a token file): the pool is re-spawned once, the FASTQ is
     the reference's, and no /dev/shm segment of the run is left.
  h. --trace: the FASTQ is the untraced reference's; `cli trace --json`
     lists the six stages and device_gaps; the spans' card busy time
     (union of h2d_transfer and device_compute) is within 10% of the
     run's model_device_seconds; both runs' total_seconds printed.
  i. `cli validate` passes the clean BAM pair (rc 0) and locates the
     damage in a truncated subreads BAM (rc 1).

  Prints one gates line and raises on a failed gate. Returns (gates,
  {path label: launches})."""
  import contextlib
  import glob
  import io

  import numpy as np

  from deepconsensus_tpu_torch import cli
  from deepconsensus_tpu_torch import faults
  from deepconsensus_tpu_torch.io import bam as bam_lib
  from deepconsensus_tpu_torch.obs import summarize
  from deepconsensus_tpu_torch.ops import device_spin
  from deepconsensus_tpu_torch.testing import faults as fault_files

  params_path = os.path.join(WORK, 'params_faults_bfloat16.json')
  with open(params_path, 'w') as f:
    json.dump(make_params('bfloat16').to_dict(), f)
  model = (params_path, weights)
  l100 = bams['L100']
  layers = make_params('float32').num_hidden_layers
  name = f'm00001_000000_000000/{FAULT_ZMW}/ccs'
  gates, checks, seconds, launches = {}, [], {}, {}

  def run(tag, *args, **kw):
    clear_outputs(tag)
    result = fault_run(tag, *args, **kw)
    seconds[tag] = result['seconds']
    return result

  ref = run('reference', l100, model)
  records = fastq_records(ref['bytes'])
  others = [r for r in records if record_name(r) != name]
  checks.append((len(records) == N_ZMWS, 'reference: not one read per ZMW'))

  # a. A corrupt ZMW.
  corrupt = os.path.join(WORK, 'bams_faults_corrupt')
  os.makedirs(corrupt, exist_ok=True)
  corrupt = (os.path.join(corrupt, 'subreads_to_ccs.bam'), l100[1])
  fault_files.corrupt_zmw(l100[0], corrupt[0], FAULT_ZMW)
  skip = run('corrupt_skip', corrupt, model, ('--on_zmw_error', 'skip'))
  letters = [(e['zmw'], e['stage'], e['kind']) for e in skip['letters']]
  gates['a_skip_letters'] = letters
  checks += [
      (skip['bytes'] == b''.join(others),
       'a: skip is not the reference minus the corrupt read'),
      (letters == [(name, 'featurize', 'permanent')],
       'a: not one featurize dead letter for the corrupt ZMW')]
  fallback = run('corrupt_fallback', corrupt, model,
                 ('--on_zmw_error', 'ccs-fallback'))
  with bam_lib.BamReader(l100[1]) as reader:
    draft = next(r for r in reader if r.qname == name)
  got = fastq_records(fallback['bytes'])
  want = (f'@{name}\n{draft.seq}\n+\n'.encode()
          + bytes((np.asarray(draft.quals) + 33).astype(np.uint8)) + b'\n')
  checks += [
      (want in got and [r for r in got if r != want] == others,
       'a: ccs-fallback read is not the draft CCS read, or others differ'),
      (fallback['counters']['n_fallback_emitted'] == 1,
       'a: not one fallback read emitted')]
  failed = run('corrupt_fail', corrupt, model, expect=Exception)
  gates['a_fail_error'] = type(failed['error']).__name__
  checks.append((failed['counters'].get('partial') is True,
                 'a: the failed run is not marked partial'))

  # b. A poisoned window.
  poisoned = run('poison', l100, model, ('--on_zmw_error', 'skip'),
                 env={faults.ENV_POISON_WINDOW: f'/{FAULT_ZMW}/'})
  members = {e['zmw'] for e in poisoned['letters']}
  gates['b_quarantined_zmws'] = len(members)
  gates['b_pack_windows'] = sum(e['n_windows_in_pack']
                                for e in poisoned['letters'])
  checks += [
      (name in members and {e['stage'] for e in poisoned['letters']}
       == {'model'}
       and len({e['model_pack'] for e in poisoned['letters']}) == 1
       and gates['b_pack_windows'] <= BATCH,
       'b: the dead letters are not one failed pack\'s molecules'),
      (fastq_records(poisoned['bytes'])
       == [r for r in records if record_name(r) not in members],
       'b: a read outside the failed pack differs')]

  # c. OOM at pack 2.
  halves = []
  oom = run('oom_degrade', l100, model, ('--on_device_error', 'degrade'),
            env={faults.ENV_DEVICE_OOM_AT_PACK: '2'}, record_halves=halves)
  launches['faults'] = oom['launches']
  half = [k for b, k in halves if b == BATCH // 2]
  gates['c_n_oom_bisections'] = oom['counters']['n_oom_bisections']
  gates['c_half_batch_launches'] = half
  checks += [
      (oom['bytes'] == ref['bytes'],
       'c: the bisected run differs from the reference'),
      (gates['c_n_oom_bisections'] >= 1, 'c: no OOM bisection'),
      (len(half) == 2 and all(k == {'K1': 1, 'K2': layers, 'K3': 1}
                              for k in half),
       'c: K1, K2 and K3 did not launch once a layer at the half batch')]
  oom_fail = run('oom_fail', l100, model, expect=faults.DeviceOomError,
                 env={faults.ENV_DEVICE_OOM_AT_PACK: '2'})
  gates['c_fail_error'] = type(oom_fail['error']).__name__

  # d. A hang at pack 2.
  spins = device_spin.n_launches
  hang = run('hang', l100, model,
             ('--on_zmw_error', 'skip', '--dispatch_timeout',
              str(DISPATCH_TIMEOUT)),
             env={faults.ENV_DEVICE_HANG_AT_PACK: '2',
                  faults.ENV_DEVICE_HANG_S: str(HANG_SECONDS)})
  members = {e['zmw'] for e in hang['letters']}
  gates['d_wall_seconds'] = hang['seconds']
  gates['d_reference_wall_seconds'] = ref['seconds']
  gates['d_dead_lettered_zmws'] = len(members)
  checks += [
      (device_spin.n_launches == spins + 1, 'd: the spin did not launch'),
      (hang['counters']['n_dispatch_timeouts'] == 1,
       'd: not one dispatch timeout'),
      (members and all(e['error'].startswith('DispatchTimeoutError')
                       for e in hang['letters']),
       'd: the hung pack\'s molecules are not dead-lettered as '
       'DispatchTimeoutError'),
      (fastq_records(hang['bytes'])
       == [r for r in records if record_name(r) not in members],
       'd: a read outside the hung pack differs')]

  # e. Crash and resume, L100 and ragged.
  def crash_and_resume(tag, inputs, ragged):
    clear_outputs(tag)
    crashed = fault_run(tag, inputs, model, ragged=ragged,
                        expect=RuntimeError,
                        env={faults.ENV_CRASH_AFTER_BATCHES: '2'})
    out = crashed['out']
    with open(out + '.progress.json') as f:
      committed = json.load(f)['groups_done']
    checks.extend([
        (not os.path.exists(out) and os.path.exists(out + '.tmp'),
         f'e {tag}: a final output exists, or the .tmp does not'),
        (crashed['counters'].get('partial') is True,
         f'e {tag}: the crashed run is not marked partial')])
    resumed = fault_run(tag, inputs, model, ('--resume',), ragged=ragged)
    seconds[f'{tag}_crash'] = crashed['seconds']
    seconds[f'{tag}_resume'] = resumed['seconds']
    checks.extend([
        (resumed['counters']['n_zmw_resume_skipped'] == committed,
         f'e {tag}: n_zmw_resume_skipped is not the committed groups'),
        (not os.path.exists(out + '.tmp')
         and not os.path.exists(out + '.progress.json'),
         f'e {tag}: a .tmp or manifest is left')])
    gates[f'e_{tag}_committed_groups'] = committed
    return resumed

  resumed = crash_and_resume('resume_L100', l100, False)
  checks.append((resumed['bytes'] == ref['bytes'],
                 'e: the resumed L100 FASTQ differs from the reference'))
  ragged_ref = run('ragged_reference', bams['ragged'], model, ragged=True)
  resumed = crash_and_resume('resume_ragged', bams['ragged'], True)
  launches['faults_ragged_resume'] = resumed['launches']
  diff = fastq_diff(ragged_ref['bytes'], resumed['bytes'])
  a, b = fastq_records(ragged_ref['bytes']), fastq_records(resumed['bytes'])
  gates['e_ragged_diff'] = diff
  gates['e_ragged_reads_differing'] = sum(x != y for x, y in zip(a, b))
  checks.append(
      ([record_name(r) for r in a] == [record_name(r) for r in b]
       and diff['bases_differ'] == 0 and diff['max_qual_diff'] <= 1,
       'e: the resumed ragged reads differ beyond qualities within 1'))

  # f. Shards.
  shard_reads = []
  for i in range(2):
    shard = run(f'shard{i}', l100, model, ('--shard', f'{i}/2'))
    shard_reads += fastq_records(shard['bytes'])
    gates[f'f_shard{i}_reads'] = shard['counters']['success']
  checks.append((sorted(shard_reads) == sorted(records),
                 'f: the shards together are not the reference\'s reads'))

  # g. A worker killed in the pool.
  token = os.path.join(WORK, 'faults_kill_token')
  if os.path.exists(token):
    os.unlink(token)
  prefix = f'dctorch_{os.getpid()}_'
  pool = run('pool', l100, model,
             ('--cpus', '4', '--batch_timeout', str(POOL_BATCH_TIMEOUT),
              '--on_zmw_error', 'skip'),
             env={faults.ENV_KILL_ZMW: name, faults.ENV_KILL_TOKEN: token})
  left = glob.glob(f'/dev/shm/{prefix}*')
  gates['g_pool_respawns'] = pool['counters'].get('n_pool_respawns', 0)
  gates['g_shm_segments_left'] = len(left)
  checks += [
      (os.path.exists(token), 'g: the worker was not killed'),
      (gates['g_pool_respawns'] == 1, 'g: the pool was not re-spawned once'),
      (pool['bytes'] == ref['bytes'], 'g: the pool run differs'),
      (not left, 'g: /dev/shm segments of the run are left')]

  # h. Tracing.
  trace_path = os.path.join(WORK, 'faults_trace.jsonl')
  if os.path.exists(trace_path):
    os.unlink(trace_path)
  traced = run('traced', l100, model, ('--trace', trace_path))
  os.environ.pop('DCTPU_TRACE', None)
  stdout = io.StringIO()
  with contextlib.redirect_stdout(stdout):
    rc = cli.main(['trace', trace_path, '--json'])
  summary = json.loads(stdout.getvalue())
  events = summarize.load_trace(trace_path)
  busy = summarize._union_s([
      (e['ts'], e['ts'] + e['dur']) for e in events
      if e.get('name') in ('h2d_transfer', 'device_compute')])
  device = traced['counters']['model_device_seconds']
  gates['h_stages'] = summary['stage_counts']
  gates['h_device_gaps'] = summary['device_gaps']
  gates['h_trace_busy_seconds'] = busy
  gates['h_model_device_seconds'] = device
  gates['h_traced_total_seconds'] = traced['counters']['total_seconds']
  gates['h_untraced_total_seconds'] = ref['counters']['total_seconds']
  checks += [
      (rc == 0 and set(summary['stage_counts']) == {
          'featurize', 'pack_wait', 'h2d_transfer', 'device_compute',
          'finalize_drain', 'stitch'} and 'device_gaps' in summary,
       'h: the trace lacks a stage or device_gaps'),
      (traced['bytes'] == ref['bytes'], 'h: the traced FASTQ differs'),
      (device is not None and abs(busy - device) <= TRACE_BUSY_GATE * device,
       'h: the trace\'s card busy time is not within 10% of '
       'model_device_seconds')]

  # i. cli validate.
  truncated = os.path.join(WORK, 'bams_faults_truncated.bam')
  shutil.copy(l100[0], truncated)
  fault_files.truncate_file(truncated, fraction=0.5)
  reports = []
  for subreads in (l100[0], truncated):
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
      rc = cli.main(['validate', '--subreads_to_ccs', subreads,
                     '--ccs_bam', l100[1]])
    reports.append((rc, json.loads(stdout.getvalue())))
  (rc_ok, clean), (rc_bad, damaged) = reports
  errors = damaged['files'][0]['errors']
  gates['i_validate'] = {
      'clean_rc': rc_ok, 'truncated_rc': rc_bad,
      'truncated_records_read': damaged['files'][0]['n_records'],
      'truncated_error': errors[0] if errors else None}
  checks += [
      (rc_ok == 0 and clean['ok'], 'i: the clean pair does not validate'),
      (rc_bad == 1 and errors and errors[0]['file'] == truncated,
       'i: the truncated BAM is not reported with its file')]
  gates['seconds'] = seconds
  return enforce('faults', gates, checks), launches


def enforce(path: str, gates: dict, checks) -> dict:
  """Prints a path's gate values, then raises on the first failed
  (ok, message) check."""
  print(json.dumps({'phase': 'gates', 'path': path, **gates}), flush=True)
  for ok, message in checks:
    if not ok:
      raise AssertionError(f'{path}: {message}')
  return gates


def path_gates(path: str, runs) -> dict:
  """Slice 1's id/quality gates on one path's delivered positions; for
  the ragged path also bucket shares, slot compositions and a partial
  last pack. Raises on a failed gate."""
  import numpy as np

  from deepconsensus_tpu_torch.models import config as config_lib

  ids32, q32 = runs['float32'][2:4]
  idsp, qp = runs['float32_plain'][2:4]
  ids16, q16 = runs['bfloat16'][2:4]
  same = ids32 == idsp
  agree16 = ids16 == ids32
  gates = {
      'f32_vs_plain_id_mismatch': float(1 - same.mean()),
      'f32_vs_plain_max_qual_diff': int(np.abs(q32 - qp)[same].max()),
      'bf16_vs_f32_id_agreement': float(agree16.mean()),
      'bf16_vs_f32_max_qv_diff': int(np.abs(q16 - q32)[agree16].max()),
  }
  checks = [
      (gates['f32_vs_plain_id_mismatch'] <= 1e-4,
       'f32 kernels vs plain: too many id mismatches'),
      (gates['f32_vs_plain_max_qual_diff'] <= 1,
       'f32 kernels vs plain: qualities differ by > 1'),
      (gates['bf16_vs_f32_id_agreement'] >= 0.99,
       'bf16 vs f32: ids agree on < 99% of positions'),
      (gates['bf16_vs_f32_max_qv_diff'] <= config_lib.BF16_QV_GATE,
       'bf16 vs f32: QV differs by > BF16_QV_GATE'),
  ]
  if path == 'ragged':
    counters, _, _, _, lengths = runs['bfloat16']
    by_bucket = counters['n_windows_by_bucket']
    total = sum(by_bucket.values())
    gates['bucket_share'] = {w: n / total for w, n in by_bucket.items()}
    slots = np.concatenate(lengths)
    gates['slots_one_200'] = int((slots == [200, 0]).all(1).sum())
    gates['slots_two_100'] = int((slots == [100, 100]).all(1).sum())
    gates['last_pack_fill'] = float(lengths[-1].sum()
                                    / (SLOTS * SLOT_LEN))
    checks += [
        (len(by_bucket) == len(BUCKETS)
         and min(gates['bucket_share'].values()) >= 0.2,
         'a bucket holds < 20% of model windows'),
        (gates['slots_one_200'] and gates['slots_two_100'],
         'slots of both compositions did not occur'),
        (gates['last_pack_fill'] < 1, 'the last pack is not partial'),
    ]
  return enforce(path, gates, checks)


def softmax_bf16_gates(path: str, runs, f32_softmax_runs) -> dict:
  """The softmax_bf16 path's gates on one of a's and b's runs with
  attn_softmax_dtype=bfloat16: each kernel run launched the variant (K1
  or K4 once per pack, K2 once per layer and pack, the attention core
  once per K1/K4 and full K2 block, K3 once per pack) and the float32
  softmax's never, the plain run none; float32 kernels vs plain with a's
  id and quality gates; and ids agreeing with the float32-softmax run of
  the same compute dtype on >= 98% of delivered positions (the
  reference's bar for the lever, tests/test_fused_hotpath.py). Raises on
  a failed gate."""
  import numpy as np

  layers = make_params('float32').num_hidden_layers
  first = 'K4' if path == 'ragged' else 'K1'
  ids32, q32 = runs['float32'][2:4]
  idsp, qp = runs['float32_plain'][2:4]
  same = ids32 == idsp
  gates = {
      'f32_vs_plain_id_mismatch': float(1 - same.mean()),
      'f32_vs_plain_max_qual_diff': int(np.abs(q32 - qp)[same].max()),
      'bf16_vs_f32_id_agreement': float(
          (runs['bfloat16'][2] == ids32).mean()),
  }
  checks = [
      (gates['f32_vs_plain_id_mismatch'] <= 1e-4,
       'f32 kernels vs plain: too many id mismatches'),
      (gates['f32_vs_plain_max_qual_diff'] <= 1,
       'f32 kernels vs plain: qualities differ by > 1'),
  ]
  gates['launches'] = {}
  for label in ('bfloat16', 'float32', 'float32_plain'):
    ids = runs[label][2]
    ref = f32_softmax_runs[label][2]
    key = f'{label}_vs_float32_softmax_id_agreement'
    gates[key] = float((ids == ref).mean()) if len(ids) == len(ref) else 0.0
    checks.append((gates[key] >= 0.98, f'{label}: ids agree with the '
                   'float32-softmax run on < 98% of positions'))
    counters, launches = runs[label][:2]
    packs = counters['n_model_packs']
    want = {f'{first}_bf16_softmax': packs, 'K2_bf16_softmax': layers * packs,
            'attention_core_bf16_softmax': layers * packs, 'K3': packs,
            first: 0, 'K2': 0, 'K2_int8': 0, 'attention_core': 0}
    if label == 'float32_plain':
      want = dict.fromkeys(want, 0)
    gates['launches'][label] = {n: launches[n] for n in want}
    checks.append((gates['launches'][label] == want,
                   f'{label}: launches differ from {want}'))
  return enforce(f'softmax_bf16_{path}', gates, checks)


def softmax_bf16_int8_gates(run, int8_f32) -> dict:
  """The softmax_bf16 path's int8 run (a's `cli run --quantize_matmuls
  int8` in float32 over params with attn_softmax_dtype=bfloat16): K2
  int8's variant once per layer and pack and no float32-softmax K2, one
  read per ZMW, and ids agreeing with the int8 path's float32 run on >=
  98% of delivered positions. Raises on a failed gate."""
  layers = make_params('float32').num_hidden_layers
  counters, launches, ids = run[:3]
  packs = counters['n_model_packs']
  gates = {
      'launches': {n: launches[n] for n in (
          'K1_bf16_softmax', 'K2_int8_bf16_softmax', 'K2_int8', 'K2',
          'K2_bf16_softmax', 'K3')},
      'vs_float32_softmax_id_agreement': float((ids == int8_f32).mean())
      if len(ids) == len(int8_f32) else 0.0,
  }
  want = {'K1_bf16_softmax': packs, 'K2_int8_bf16_softmax': layers * packs,
          'K2_int8': 0, 'K2': 0, 'K2_bf16_softmax': 0, 'K3': packs}
  return enforce('softmax_bf16_int8', gates, [
      (gates['launches'] == want, f'launches differ from {want}'),
      (counters['success'] == N_ZMWS, 'not one read per ZMW'),
      (gates['vs_float32_softmax_id_agreement'] >= 0.98,
       'ids agree with the float32-softmax int8 run on < 98%'),
  ])


def softmax_bf16_train_gates(run, train_f32) -> dict:
  """`cli train --set attn_softmax_dtype=bfloat16` in float32 on the
  module route: every loss and gradient norm finite, the first loss
  within 2% of the train path's float32 first loss, no attention kernel
  launched. Raises on a failed gate."""
  gates = {
      'losses': run['losses'],
      'first_loss_rel_diff_vs_float32_softmax': abs(
          run['losses'][0] - train_f32['losses'][0])
      / abs(train_f32['losses'][0]),
      'attention_kernel_launches': [run['launches'][n] for n in (
          'K5', 'K6', 'K7')],
  }
  finite = all(math.isfinite(x) for x in run['losses'] + run['grad_norms']
               + [run['eval']['eval/loss']])
  return enforce('softmax_bf16_train', gates, [
      (len(run['losses']) == TRAIN_EXAMPLES // TRAIN_BATCH,
       'the run did not take one epoch of steps'),
      (finite, 'a loss, gradient norm or eval loss is not finite'),
      (gates['first_loss_rel_diff_vs_float32_softmax'] <= 0.02,
       'the first loss differs from the float32 softmax run\'s by > 2%'),
      (gates['attention_kernel_launches'] == [0, 0, 0],
       'the module route launched K5-K7'),
  ])


def int8_gates(runs, l100_f32) -> dict:
  """The int8 path's gates: the kernel run vs the plain run (float32)
  as slice 1's, bfloat16 vs float32 (both int8) with the bf16 gates,
  and the float32 int8 run's ids against the unquantized float32 L100
  run's at the reference's bar (tests/test_quantized_inference.py:
  agreement >= 0.95). Raises on a failed gate."""
  import numpy as np

  from deepconsensus_tpu_torch.models import config as config_lib

  ids32, q32 = runs['float32'][2:4]
  idsp, qp = runs['float32_plain'][2:4]
  ids16, q16 = runs['bfloat16'][2:4]
  same = ids32 == idsp
  agree16 = ids16 == ids32
  gates = {
      'f32_vs_plain_id_mismatch': float(1 - same.mean()),
      'f32_vs_plain_max_qual_diff': int(np.abs(q32 - qp)[same].max()),
      'bf16_vs_f32_id_agreement': float(agree16.mean()),
      'bf16_vs_f32_max_qv_diff': int(np.abs(q16 - q32)[agree16].max()),
      'int8_vs_float_f32_id_agreement': float((ids32 == l100_f32).mean()),
      'n_quantized_matmuls': {k: r[0]['n_quantized_matmuls']
                              for k, r in runs.items()},
      'inference_dtype': {k: r[0]['inference_dtype']
                          for k, r in runs.items()},
  }
  layers = make_params('float32').num_hidden_layers
  checks = [
      (gates['f32_vs_plain_id_mismatch'] <= 1e-4,
       'f32 kernels vs plain: too many id mismatches'),
      (gates['f32_vs_plain_max_qual_diff'] <= 1,
       'f32 kernels vs plain: qualities differ by > 1'),
      (gates['bf16_vs_f32_id_agreement'] >= 0.99,
       'bf16 vs f32: ids agree on < 99% of positions'),
      (gates['bf16_vs_f32_max_qv_diff'] <= config_lib.BF16_QV_GATE,
       'bf16 vs f32: QV differs by > BF16_QV_GATE'),
      (len(ids32) == len(l100_f32)
       and gates['int8_vs_float_f32_id_agreement'] >= 0.95,
       'int8 vs float32 weights: ids agree on < 95% of positions'),
      (all(v == 6 * layers for v in gates['n_quantized_matmuls'].values()),
       f'n_quantized_matmuls is not {6 * layers}'),
      (gates['inference_dtype'] == {'bfloat16': 'bfloat16',
                                    'float32': 'float32',
                                    'float32_plain': 'float32'},
       'inference_dtype labels are wrong'),
  ]
  for label in ('bfloat16', 'float32'):
    counters, launches = runs[label][:2]
    checks.append((launches['K2_int8'] == layers * counters['n_model_packs']
                   and launches['K2'] == 0,
                   f'{label}: K2 int8 did not launch once per block and '
                   'pack, or the float K2 launched'))
  plain = runs['float32_plain'][1]
  checks.append((plain['K2_int8'] == plain['K2'] == 0,
                 'the plain run launched K2'))
  return enforce('int8', gates, checks)


def run_evaluate_path(source, eval_shards: str, quantize: bool,
                      tag: str = ''):
  """`cli evaluate` over eval shards in float32 (quantize: with
  --quantize_matmuls int8); source: its weight arguments (--checkpoint
  of a `cli train` run, or --weights/--params). Returns (metrics read
  back from inference.csv, launch counts, seconds, peak bytes)."""
  import csv

  import torch

  from deepconsensus_tpu_torch import cli

  out = os.path.join(
      WORK, f'evaluate{tag}_{"int8" if quantize else "float32"}')
  argv = ['evaluate', *source, '--eval_path', eval_shards, '--out_dir', out,
          '--batch_size', str(TRAIN_BATCH)]
  if quantize:
    argv += ['--quantize_matmuls', 'int8']
  torch.cuda.reset_peak_memory_stats()
  reset_launches()
  t0 = time.perf_counter()
  if cli.main(argv) != 0:
    raise AssertionError(f'cli evaluate failed ({argv})')
  seconds = time.perf_counter() - t0
  launches = read_launches()
  with open(os.path.join(out, 'inference.csv')) as f:
    header, row = list(csv.reader(f))
  return (dict(zip(header, map(float, row))), launches, seconds,
          torch.cuda.max_memory_allocated())


def evaluate_gates(runs, seeded) -> dict:
  """The evaluate path's gates: on the checkpoint (runs) and on the
  seeded weights (seeded), |int8 - float32| alignment identity within
  INT8_IDENTITY_GATE and every metric finite; the checkpoint's int8 run
  through K1, K2 int8 and K11 (its float32 run through the float K2).
  Raises on a failed gate."""
  from deepconsensus_tpu_torch.models import config as config_lib

  def delta(pair):
    return abs(pair['int8'][0]['alignment_identity']
               - pair['float32'][0]['alignment_identity'])

  gates = {
      'alignment_identity_delta': delta(runs),
      'seeded_alignment_identity_delta': delta(seeded),
      'launches': {k: {n: r[1][n] for n in ('K1', 'K2', 'K2_int8', 'K11')}
                   for k, r in runs.items()},
  }
  checks = [
      (gates['alignment_identity_delta'] <= config_lib.INT8_IDENTITY_GATE,
       'checkpoint: int8 alignment identity differs from float32 by more '
       'than INT8_IDENTITY_GATE'),
      (gates['seeded_alignment_identity_delta']
       <= config_lib.INT8_IDENTITY_GATE,
       'seeded weights: int8 alignment identity differs from float32 by '
       'more than INT8_IDENTITY_GATE'),
      (all(math.isfinite(v) for pair in (runs, seeded)
           for r in pair.values() for v in r[0].values()),
       'a metric is not finite'),
      (all(runs['int8'][1][k] for k in PATH_KERNELS['evaluate'])
       and runs['int8'][1]['K2'] == 0,
       'the int8 run did not launch K1, K2 int8 and K11 (or launched the '
       'float K2)'),
      (runs['float32'][1]['K2'] and runs['float32'][1]['K2_int8'] == 0,
       'the float32 run did not take the float K2'),
  ]
  return enforce('evaluate', gates, checks)


def run_train_path(shards, dtype: str, plain: bool = False,
                   attn: bool = False, band: bool = False,
                   flash: bool = False, softmax_bf16: bool = False) -> dict:
  """One `cli train` epoch over the synthetic shards (plain: the same
  through run_training with the plain DP; attn: with
  --set use_pallas_attention=true; band: with --set band_width=12;
  flash: with --set max_length=200 --set attention_dropout=0, on shards
  of that width; softmax_bf16: with --set attn_softmax_dtype=bfloat16);
  returns the run's launches, per-step losses and
  gradient norms, eval metrics and summary."""
  from deepconsensus_tpu_torch import cli
  from deepconsensus_tpu_torch.models import config as config_lib
  from deepconsensus_tpu_torch.models import train as train_lib

  route = ''.join(name for name, on in (('_flash', flash), ('_attn', attn),
                                        ('_band', band),
                                        ('_bf16sm', softmax_bf16)) if on)
  out = os.path.join(WORK, f'train{route}_{dtype}'
                     f'{"_plain" if plain else ""}')
  shutil.rmtree(out, ignore_errors=True)
  overrides = {'dtype': dtype, 'log_every_n_steps': 1}
  if flash:
    overrides.update(max_length=FLASH_LENGTH, attention_dropout=0.0)
  if attn:
    overrides['use_pallas_attention'] = True
  if band:
    overrides['band_width'] = BAND_WIDTH
  if softmax_bf16:
    overrides['attn_softmax_dtype'] = 'bfloat16'
  reset_launches()
  t0 = time.perf_counter()
  if plain:
    params = config_lib.get_config(TRAIN_CONFIG)
    params.update(overrides)
    config_lib.finalize_params(params)
    params.batch_size = TRAIN_BATCH
    train_lib.run_training(params, out, [shards[0]], [shards[1]],
                           num_epochs=1, plain=True)
  elif cli.main([
      'train', '--config', TRAIN_CONFIG, '--out_dir', out, '--train_path',
      shards[0], '--eval_path', shards[1], '--num_epochs', '1',
      '--batch_size', str(TRAIN_BATCH),
      *(a for k, v in overrides.items()
        for a in ('--set', f'{k}={str(v).lower()}'))
  ]) != 0:
    raise AssertionError(f'cli train failed ({dtype})')
  seconds = time.perf_counter() - t0
  launches = read_launches()
  with open(os.path.join(out, 'metrics.jsonl')) as f:
    entries = [json.loads(line) for line in f]
  train = [e for e in entries if e['split'] == 'train']
  return {
      'launches': launches, 'seconds': seconds,
      'losses': [e['loss'] for e in train],
      'grad_norms': [e['grad_norm'] for e in train],
      'step_seconds': [e['step_seconds'] for e in train],
      'eval': [e for e in entries if e['split'] == 'eval'][-1],
      'summary': [e for e in entries if e['split'] == 'summary'][-1],
  }


def common_train_gates(runs):
  """Gates every train path shares: each run took one epoch's steps,
  every loss, gradient norm and eval loss is finite, and bfloat16's
  first loss is within 2% of float32's. Returns (gates, checks)."""
  steps = TRAIN_EXAMPLES // TRAIN_BATCH
  f32, bf16 = runs['float32'], runs['bfloat16']
  gates = {
      'steps': {k: len(r['losses']) for k, r in runs.items()},
      'bf16_vs_f32_first_loss_rel_diff': abs(
          bf16['losses'][0] - f32['losses'][0]) / abs(f32['losses'][0]),
  }
  finite = all(math.isfinite(x) for r in runs.values()
               for x in r['losses'] + r['grad_norms'] + [r['eval'][
                   'eval/loss']])
  checks = [
      (all(v == steps for v in gates['steps'].values()),
       f'a run did not take {steps} steps'),
      (finite, 'a loss, gradient norm or eval loss is not finite'),
      (gates['bf16_vs_f32_first_loss_rel_diff'] <= 0.02,
       'bf16 vs f32: the first loss differs by > 2%'),
  ]
  return gates, checks


def train_gates(runs) -> dict:
  """The train path's gates; raises on a failed one."""
  steps = TRAIN_EXAMPLES // TRAIN_BATCH
  eval_batches = EVAL_EXAMPLES // TRAIN_BATCH
  f32, plain = runs['float32'], runs['float32_plain']
  rel = [abs(a - b) / abs(b) for a, b in zip(f32['losses'], plain['losses'])]
  gates, checks = common_train_gates(runs)
  gates.update({
      'f32_vs_plain_max_rel_loss_diff': max(rel),
      'attention_kernel_launches': {k: [r['launches'][n] for n in (
          'K5', 'K6', 'K7')] for k, r in runs.items()},
  })
  checks += [
      (all(runs[k]['launches']['K11'] == steps + eval_batches
           and runs[k]['launches']['K12'] == steps
           for k in ('bfloat16', 'float32')),
       'K11/K12 did not launch once per step (and K11 per eval batch)'),
      (plain['launches']['K11'] == plain['launches']['K12'] == 0,
       'the plain run launched the DP kernels'),
      (all(v == [0, 0, 0]
           for v in gates['attention_kernel_launches'].values()),
       'the module-route runs launched K5-K7'),
      (gates['f32_vs_plain_max_rel_loss_diff'] <= 1e-4,
       'f32 kernels vs plain DP: a step loss differs by > 1e-4 relative'),
  ]
  return enforce('train', gates, checks)


def train_attn_gates(runs, module_f32: dict) -> dict:
  """The train_attn path's gates against the module-route float32 run
  (the same shards, seed and dropout masks); raises on a failed one."""
  steps = TRAIN_EXAMPLES // TRAIN_BATCH
  eval_batches = EVAL_EXAMPLES // TRAIN_BATCH
  layers = make_params('float32').num_hidden_layers
  f32 = runs['float32']
  rel = [abs(a - b) / abs(b) for a, b in zip(f32['losses'],
                                             module_f32['losses'])]
  eval_rel = abs(f32['eval']['eval/loss'] - module_f32['eval']['eval/loss']
                 ) / abs(module_f32['eval']['eval/loss'])
  want = {'K5': layers * eval_batches, 'K6': layers * steps,
          'K7': layers * steps, 'K11': steps + eval_batches, 'K12': steps}
  gates, checks = common_train_gates(runs)
  gates.update({
      'launches': {k: {n: r['launches'][n] for n in want}
                   for k, r in runs.items()},
      'f32_vs_module_route_max_rel_loss_diff': max(rel),
      'f32_vs_module_route_eval_loss_rel_diff': eval_rel,
      'peak_bytes': {k: r['summary']['peak_bytes'] for k, r in runs.items()},
  })
  checks += [
      (all(v == want for v in gates['launches'].values()),
       f'launches differ from {want}'),
      (gates['f32_vs_module_route_max_rel_loss_diff'] <= 1e-4,
       'f32 attention kernels vs the module route: a step loss differs by '
       '> 1e-4 relative'),
      (eval_rel <= 1e-4, 'f32 attention kernels vs the module route: the '
       'eval loss differs by > 1e-4 relative'),
  ]
  return enforce('train_attn', gates, checks)


def train_band_gates(runs, module: dict) -> dict:
  """The train_band path's gates (K13/K14 against the plain banded DP on
  the card); `module` holds the train path's runs, whose step times and
  peak memory are printed beside. Raises on a failed gate."""
  steps = TRAIN_EXAMPLES // TRAIN_BATCH
  eval_batches = EVAL_EXAMPLES // TRAIN_BATCH
  f32, plain = runs['float32'], runs['float32_plain']
  rel = [abs(a - b) / abs(b) for a, b in zip(f32['losses'], plain['losses'])]
  eval_rel = abs(f32['eval']['eval/loss'] - plain['eval']['eval/loss']
                 ) / abs(plain['eval']['eval/loss'])
  want = {'K11': 0, 'K12': 0, 'K13': steps + eval_batches, 'K14': steps}
  gates, checks = common_train_gates(runs)
  gates.update({
      'launches': {k: {n: r['launches'][n] for n in want}
                   for k, r in runs.items()},
      'f32_vs_plain_max_rel_loss_diff': max(rel),
      'f32_vs_plain_eval_loss_rel_diff': eval_rel,
      'step_p50_ms': {k: 1e3 * r['summary']['train_step_p50_s']
                      for k, r in runs.items()},
      'train_step_p50_ms': {k: 1e3 * r['summary']['train_step_p50_s']
                            for k, r in module.items()},
      'peak_bytes': {k: r['summary']['peak_bytes'] for k, r in runs.items()},
      'train_peak_bytes': {k: r['summary']['peak_bytes']
                           for k, r in module.items()},
  })
  checks += [
      (all(gates['launches'][k] == want for k in ('bfloat16', 'float32')),
       f'launches differ from {want}'),
      (all(v == 0 for v in gates['launches']['float32_plain'].values()),
       'the plain run launched a DP kernel'),
      (max(rel) <= 1e-4,
       'f32 K13/K14 vs the plain banded DP: a step loss differs by > 1e-4 '
       'relative'),
      (eval_rel <= 1e-4, 'f32 K13 vs the plain banded DP: the eval loss '
       'differs by > 1e-4 relative'),
  ]
  return enforce('train_band', gates, checks)


def train_flash_gates(runs, module_f32: dict) -> dict:
  """The train_flash path's gates against the module-route float32 run
  at the same window, shards, seed and masks; raises on a failed one."""
  steps = TRAIN_EXAMPLES // TRAIN_BATCH
  eval_batches = EVAL_EXAMPLES // TRAIN_BATCH
  layers = make_params('float32').num_hidden_layers
  f32 = runs['float32']
  rel = [abs(a - b) / abs(b) for a, b in zip(f32['losses'],
                                             module_f32['losses'])]
  eval_rel = abs(f32['eval']['eval/loss'] - module_f32['eval']['eval/loss']
                 ) / abs(module_f32['eval']['eval/loss'])
  want = {'K8': layers * eval_batches, 'K8_lse': layers * steps,
          'K9': layers * steps, 'K10': layers * steps, 'K5': 0, 'K6': 0,
          'K7': 0, 'K11': steps + eval_batches, 'K12': steps}
  gates, checks = common_train_gates(runs)
  gates.update({
      'launches': {k: {n: r['launches'][n] for n in want}
                   for k, r in runs.items()},
      'module_route_launches': {n: module_f32['launches'][n] for n in want},
      'f32_vs_module_route_max_rel_loss_diff': max(rel),
      'f32_vs_module_route_eval_loss_rel_diff': eval_rel,
      'step_p50_ms': {k: 1e3 * r['summary']['train_step_p50_s']
                      for k, r in runs.items()},
      'module_route_step_p50_ms': 1e3 * module_f32['summary'][
          'train_step_p50_s'],
      'peak_bytes': {k: r['summary']['peak_bytes'] for k, r in runs.items()},
      'module_route_peak_bytes': module_f32['summary']['peak_bytes'],
  })
  checks += [
      (all(v == want for v in gates['launches'].values()),
       f'launches differ from {want}'),
      (all(gates['module_route_launches'][n] == 0
           for n in ('K5', 'K6', 'K7', 'K8', 'K8_lse', 'K9', 'K10')),
       'the module-route run launched an attention kernel'),
      (max(rel) <= 1e-4, 'f32 flash kernels vs the module route: a step '
       'loss differs by > 1e-4 relative'),
      (eval_rel <= 1e-4, 'f32 flash kernels vs the module route: the eval '
       'loss differs by > 1e-4 relative'),
  ]
  return enforce('train_flash', gates, checks)


def buckets_gates(runs) -> dict:
  """The buckets path's gates: one read per ZMW, each bucket >= 20% of
  model windows, K1-K3 on each 100-wide pack, K8 (no lse) once per
  layer of each 200-wide pack and K3 there, no other kernel; float32
  kernels vs the float32 plain run and vs the float32 flag-off run
  (module route) on delivered positions, and bfloat16 vs float32.
  Raises on a failed gate."""
  import numpy as np

  from deepconsensus_tpu_torch.models import config as config_lib

  layers = make_params('float32').num_hidden_layers
  ids32, q32 = runs['float32'][2:4]
  ids16, q16 = runs['bfloat16'][2:4]
  agree16 = ids16 == ids32
  gates = {
      'bf16_vs_f32_id_agreement': float(agree16.mean()),
      'bf16_vs_f32_max_qv_diff': int(np.abs(q16 - q32)[agree16].max()),
  }
  checks = [
      (gates['bf16_vs_f32_id_agreement'] >= 0.99,
       'bf16 vs f32: ids agree on < 99% of positions'),
      (gates['bf16_vs_f32_max_qv_diff'] <= config_lib.BF16_QV_GATE,
       'bf16 vs f32: QV differs by > BF16_QV_GATE'),
  ]
  for ref in ('float32_plain', 'float32_flag_off'):
    ids, quals = runs[ref][2:4]
    same = ids32 == ids
    gates[f'f32_vs_{ref[8:]}_id_mismatch'] = float(1 - same.mean())
    gates[f'f32_vs_{ref[8:]}_max_qual_diff'] = int(
        np.abs(q32 - quals)[same].max())
    checks += [
        (gates[f'f32_vs_{ref[8:]}_id_mismatch'] <= 1e-4,
         f'f32 kernels vs {ref}: too many id mismatches'),
        (gates[f'f32_vs_{ref[8:]}_max_qual_diff'] <= 1,
         f'f32 kernels vs {ref}: qualities differ by > 1'),
    ]
  counters = runs['bfloat16'][0]
  by_bucket = counters['n_windows_by_bucket']
  total = sum(by_bucket.values())
  gates['bucket_share'] = {w: n / total for w, n in by_bucket.items()}
  gates['packs_by_bucket'] = counters['n_model_packs_by_bucket']
  gates['launches'] = {}
  for label, run in runs.items():
    packs = run[0]['n_model_packs_by_bucket']
    p100, p200 = packs.get(str(BUCKETS[0]), 0), packs.get(str(BUCKETS[1]), 0)
    want = dict.fromkeys(counted_modules(), 0)
    if label != 'float32_plain':
      # The attention core: K1's and each full K2 block's.
      want.update(K1=p100, K2=layers * p100, K3=p100 + p200,
                  attention_core=layers * p100)
    if label in ('bfloat16', 'float32'):
      want['K8'] = layers * p200
    gates['launches'][label] = {n: run[1][n] for n in want if want[n]
                                or run[1][n]}
    checks.append((run[1] == want, f'{label}: launches differ from {want}'))
  checks.append((len(by_bucket) == len(BUCKETS)
                 and min(gates['bucket_share'].values()) >= 0.2,
                 'a bucket holds < 20% of model windows'))
  return enforce('buckets', gates, checks)


def long_window_gates(device: str = 'cuda', batch: int = TRAIN_BATCH
                      ) -> dict:
  """Phase 3f (the ring route): one full-width forward and backward of
  the model at LONG_INSERT_WINDOW_LEN = 500 with attention dropout 0
  (the other dropouts at the config's rates, one seeded generator per
  run), seeded non-zero ReZero alphas, in float32 and bfloat16: through
  the ring route, through the module route forced on the same inputs,
  weights and masks, and with use_pallas_attention (which must take the
  ring route). Gates: float32 loss within 1e-5 relative; each
  parameter's gradient (the norm of the difference over the norm)
  within 1e-3: at L = 500 float32 rounding alone moves a leaf's gradient
  by up to ~1e-3 of its norm (the two routes agree to 1e-12 in float64,
  tests/test_torch_ring_attention.py; on an H100 the routes differ by
  1.6e-4 at batch 256 and 1.7e-3 at batch 64, in an embedding or a
  ReZero alpha); the ring route taken once per layer, no attention
  kernel launched and the loss's K11 and K12 once each. Raises on a
  failed gate."""
  import numpy as np
  import torch

  from deepconsensus_tpu_torch.models import config as config_lib
  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.models import train as train_lib
  from deepconsensus_tpu_torch.parallel import ring_attention

  dev = torch.device(device)
  length = config_lib.LONG_INSERT_WINDOW_LEN
  rng = np.random.default_rng(SEED + 7)
  layers = make_params('float32').num_hidden_layers
  host = {'rows': fake_rows(make_params('float32'), rng, batch, length),
          'label': rng.integers(0, 5, (batch, length)).astype(np.float32)}
  gates = {'batch': batch, 'length': length}
  for dtype in ('float32', 'bfloat16'):
    params = make_params(dtype)
    params.attention_dropout = 0.0
    batch_dev = train_lib.batch_to_device(host, dev)
    loss_fn = train_lib.make_loss(params)
    runs = {}
    for route in ('ring', 'module', 'ring_flag'):
      params.use_pallas_attention = route == 'ring_flag'
      model = model_lib.DeepConsensusModel(params, device=dev)
      model.init_weights(torch.Generator().manual_seed(SEED))
      model.requires_grad_(True)
      ring_min = config_lib.RING_ATTENTION_MIN_LEN
      if route == 'module':  # force the [B, N, L, L] module route
        config_lib.RING_ATTENTION_MIN_LEN = 10 ** 9
      ring_attention.n_calls = 0
      reset_launches()
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      t0 = time.perf_counter()
      try:
        preds = model.forward_train(
            batch_dev['rows'], torch.Generator(device=dev).manual_seed(SEED))
        loss = loss_fn(batch_dev['label'], preds)
        loss.backward()
        torch.cuda.synchronize()
      finally:
        config_lib.RING_ATTENTION_MIN_LEN = ring_min
      runs[route] = dict(
          loss=loss.item(), ms=1e3 * (time.perf_counter() - t0),
          peak_bytes=torch.cuda.max_memory_allocated(),
          ring_calls=ring_attention.n_calls,
          attention_launches=sum(read_launches()[n]
                                 for n in ('K5', 'K6', 'K7')),
          dp_launches={n: read_launches()[n] for n in ('K11', 'K12')},
          grads={n: p.grad for n, p in model.named_parameters()})
    ring, module = runs['ring'], runs['module']
    leaf_rel = {n: float((g.float() - module['grads'][n].float()).norm()
                         / module['grads'][n].float().norm().clamp_min(1e-30))
                for n, g in ring['grads'].items()}
    worst = max(leaf_rel, key=leaf_rel.get)
    gates[dtype] = {
        'loss': {k: r['loss'] for k, r in runs.items()},
        'loss_rel_diff': abs(ring['loss'] - module['loss'])
                         / abs(module['loss']),
        'max_leaf_grad_rel_diff': leaf_rel[worst], 'worst_leaf': worst,
        'flag_vs_ring_loss_diff': abs(runs['ring_flag']['loss']
                                      - ring['loss']),
        'ring_calls': {k: r['ring_calls'] for k, r in runs.items()},
        'attention_kernel_launches': {k: r['attention_launches']
                                      for k, r in runs.items()},
        # The loss's DP at m = n = 500: K11 with rows, K12.
        'dp_launches': {k: r['dp_launches'] for k, r in runs.items()},
        'peak_bytes': {k: r['peak_bytes'] for k, r in runs.items()},
        'ms': {k: r['ms'] for k, r in runs.items()},
    }
  f32 = gates['float32']
  checks = [
      (f32['loss_rel_diff'] <= 1e-5,
       'f32 ring vs module route: the loss differs by > 1e-5 relative'),
      (f32['max_leaf_grad_rel_diff'] <= 1e-3,
       f'f32 ring vs module route: gradient of {f32["worst_leaf"]} differs '
       'by > 1e-3 of its norm'),
  ]
  for dtype in ('float32', 'bfloat16'):
    g = gates[dtype]
    checks += [
        (g['ring_calls'] == {'ring': layers, 'module': 0,
                             'ring_flag': layers},
         f'{dtype}: the ring route was not taken once per layer'),
        (all(v == 0 for v in g['attention_kernel_launches'].values()),
         f'{dtype}: an attention kernel launched at L = {length}'),
        (all(v == {'K11': 1, 'K12': 1} for v in g['dp_launches'].values()),
         f'{dtype}: the loss did not launch K11 and K12 once each at L = '
         f'{length}'),
        (all(math.isfinite(v) for v in g['loss'].values()),
         f'{dtype}: a loss is not finite'),
    ]
  return enforce('long_window', gates, checks)


def train_attn_step_gates(device: str = 'cuda', flash: bool = False,
                          batch_size: int = TRAIN_BATCH) -> dict:
  """One full-width float32 training forward and backward with non-zero
  ReZero alphas (seeded U(0.1, 0.3)) on one batch and one dropout seed,
  attention through K7 and K6 (flash: at L = 200 with attention dropout
  0, through K8 with lse, K9 and K10) vs the module route. The train
  runs start from Flax's zero alphas, where attention does not reach
  the loss; here it does. Gates: the loss within 1e-4 relative, each
  parameter's gradient (the norm of the difference over the norm) within
  1e-3 (a ReZero alpha's gradient is one sum over 7M products, taken in
  another order on each route; 1e-5 in a CPU rehearsal at batch 2), and
  the kernels launched once per layer. Raises on a failed gate."""
  import numpy as np
  import torch

  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.models import train as train_lib

  dev = torch.device(device)
  params = make_params('float32')
  length = FLASH_LENGTH if flash else LENGTH
  if flash:
    params.attention_dropout = 0.0
  rng = np.random.default_rng(SEED + (9 if flash else 5))
  batch = train_lib.batch_to_device({
      'rows': fake_rows(params, rng, batch_size, length),
      'label': rng.integers(0, 5, (batch_size, length)).astype(np.float32),
  }, dev)
  loss_fn = train_lib.make_loss(params)
  runs = {}
  for attn in (True, False):
    params.use_pallas_attention = attn
    model = model_lib.DeepConsensusModel(params, device=dev)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model.requires_grad_(True)
    reset_launches()
    preds = model.forward_train(
        batch['rows'], torch.Generator(device=dev).manual_seed(SEED))
    loss = loss_fn(batch['label'], preds)
    loss.backward()
    torch.cuda.synchronize()
    runs[attn] = (loss.item(), dict(model.named_parameters()),
                  read_launches())
  (k_loss, k_params, launches), (m_loss, m_params, _) = runs[True], runs[False]
  leaf_rel = {n: float((k_params[n].grad - p.grad).norm()
                       / p.grad.norm().clamp_min(1e-30))
              for n, p in m_params.items()}
  worst = max(leaf_rel, key=leaf_rel.get)
  layers = params.num_hidden_layers
  want = {'K5': 0, 'K6': layers, 'K7': layers, 'K8': 0, 'K8_lse': 0,
          'K9': 0, 'K10': 0}
  if flash:
    want.update(K6=0, K7=0, K8_lse=layers, K9=layers, K10=layers)
  gates = {
      'length': length, 'batch': batch_size,
      'loss_rel_diff': abs(k_loss - m_loss) / abs(m_loss),
      'max_leaf_grad_rel_diff': leaf_rel[worst], 'worst_leaf': worst,
      'attention_leaf_grad_rel_diff': max(
          v for n, v in leaf_rel.items() if 'self_attention' in n),
      'launches': {n: launches[n] for n in want},
  }
  return enforce('train_flash_step' if flash else 'train_attn_step', gates, [
      (gates['launches'] == want,
       f'the attention kernels did not launch as {want}'),
      (gates['loss_rel_diff'] <= 1e-4, 'the loss differs by > 1e-4'),
      (gates['max_leaf_grad_rel_diff'] <= 1e-3,
       f'gradient of {worst} differs by > 1e-3 relative'),
  ])


def dq_kernel_of(key: str):
  """'false' for K9 and 'true' for K6's first pass (the kSoftmax
  argument of band_tiles.cuh's band_dq_kernel) in a profiler kernel
  name, else None."""
  match = re.search(r'band_dq_kernel<[^,]+, (true|false)', key)
  return match.group(1) if match else None


def train_step_breakdown(dtype: str, steps: int = 5, attn: bool = False,
                         band: bool = False, flash: bool = False) -> dict:
  """Phase 4 for one dtype: one full-width batch of TRAIN_BATCH seeded
  windows, the training step split into its stages, then one step
  under torch.profiler (attn: attention through K5-K7; band: the loss
  with band_width 12, K13/K14; flash: attention through K8-K10 at
  L = 200, attention dropout 0)."""
  import numpy as np
  import torch
  from torch.profiler import ProfilerActivity, profile

  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.models import train as train_lib

  dev = torch.device('cuda')
  params = make_params(dtype)
  params.use_pallas_attention = attn or flash
  params.band_width = BAND_WIDTH if band else None
  length = FLASH_LENGTH if flash else LENGTH
  if flash:
    params.attention_dropout = 0.0
  model = model_lib.DeepConsensusModel(params, device=dev)
  model.init_weights(torch.Generator().manual_seed(SEED))
  model.requires_grad_(True)
  lamb = train_lib.Lamb(model.named_parameters(), params, 100)
  loss_fn = train_lib.make_loss(params)
  rng = np.random.default_rng(SEED + 3)
  batch = train_lib.batch_to_device({
      'rows': fake_rows(params, rng, TRAIN_BATCH, length),
      'label': rng.integers(0, 5, (TRAIN_BATCH, length)).astype(np.float32),
  }, dev)
  generator = torch.Generator(device=dev).manual_seed(SEED)
  stages = ('forward', 'loss', 'backward', 'optimizer')
  times = {k: [] for k in stages}

  def step(record: bool) -> None:
    marks = [time.perf_counter()]

    def mark():
      torch.cuda.synchronize()
      marks.append(time.perf_counter())

    for p in model.parameters():
      p.grad = None
    preds = model.forward_train(batch['rows'], generator)
    mark()
    loss = loss_fn(batch['label'], preds)
    mark()
    loss.backward()
    mark()
    lamb.step({n: p.grad for n, p in model.named_parameters()})
    mark()
    if record:
      for name, a, b in zip(stages, marks, marks[1:]):
        times[name].append((b - a) * 1e3)

  for i in range(2 + steps):
    step(record=i >= 2)
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    step(record=False)
  kernels = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
  top = sorted(kernels, key=lambda e: e.self_device_time_total,
               reverse=True)[:12]
  stage_ms = {k: statistics.median(v) for k, v in times.items()}
  step_ms = sum(stage_ms.values())
  # The profiler slows the host, so the idle share sets the profiled
  # step's kernel time against the unprofiled step's wall time.
  return {
      'stage_ms': stage_ms, 'step_ms': step_ms,
      'device_kernel_ms': device_ms,
      'device_idle_share': 1 - device_ms / step_ms,
      # K5-K7 (csrc/banded_attention.cu's kernels; K6's first pass is
      # band_tiles.cuh's band_dq_kernel<T, true>) in the profiled step.
      'banded_attention_ms': sum(e.self_device_time_total for e in kernels
                                 if 'banded_' in e.key
                                 or dq_kernel_of(e.key) == 'true') / 1e3,
      # K8-K10 (csrc/flash_band_attention.cu's kernels; K9 is
      # band_dq_kernel<T, false>) in the profiled step.
      'flash_attention_ms': sum(e.self_device_time_total for e in kernels
                                if 'flash_' in e.key
                                or dq_kernel_of(e.key) == 'false') / 1e3,
      # K11-K14 (csrc/wavefront.cu's kernels) in the profiled step.
      'alignment_dp_ms': sum(e.self_device_time_total for e in kernels
                             if 'wavefront_' in e.key or 'band_fwd' in e.key
                             or 'band_bwd' in e.key) / 1e3,
      'top_kernels_ms': [[e.key[:100], e.self_device_time_total / 1e3,
                          e.count] for e in top],
  }


# train_data: the data half of `cli train`. Training-mode preprocess
# keeps the reference's single-width rule (a window wider than
# --example_width is dropped), so the 200 bucket's examples come from a
# second preprocess at --example_width 200 over the smart windows, and
# the 100 bucket's from fixed 100-wide windows (the reference's default
# geometry; smart windows of <= 100 are ~30% of this cell's).
TRAIN_DATA_EXAMPLES = 1536  # n_examples_train: 6 steps of TRAIN_BATCH
TRAIN_DATA_BUFFER = 1024    # the reservoir (the presets' 1e6 never fills)
TRAIN_DATA_WORKERS = 2
TRAIN_DATA_SET = {'streaming': True, 'loader_workers': TRAIN_DATA_WORKERS,
                  'n_examples_train': TRAIN_DATA_EXAMPLES,
                  'buffer_size': TRAIN_DATA_BUFFER, 'augment': True,
                  'use_pallas_attention': True, 'attention_dropout': 0.0,
                  'log_every_n_steps': 1}


def run_preprocess_path(bams, truth, tag: str, cpus: int, width: int,
                        smart: bool) -> dict:
  """One `cli preprocess` (training mode) into WORK/<tag>; returns its
  seconds, ZMWs a second, summary and output directory."""
  from deepconsensus_tpu_torch import cli

  out = os.path.join(WORK, tag)
  shutil.rmtree(out, ignore_errors=True)
  t0 = time.perf_counter()
  if cli.main([
      'preprocess', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
      '--truth_to_ccs', truth[0], '--truth_bed', truth[1], '--truth_split',
      truth[2], '--output', os.path.join(out, '@split', '@split.tfrecord.gz'),
      '--cpus', str(cpus), '--example_width', str(width),
      *(('--use_ccs_smart_windows',) if smart else ())]) != 0:
    raise AssertionError(f'cli preprocess failed ({tag})')
  seconds = time.perf_counter() - t0
  with open(os.path.join(out, 'summary', 'summary.summary.training.json')
            ) as f:
    summary = json.load(f)
  return {'out': out, 'seconds': seconds, 'summary': summary,
          'zmws_per_s': summary['n_zmw_processed'] / seconds}


def tree_bytes(root: str) -> dict:
  out = {}
  for dirpath, _, files in os.walk(root):
    for name in files:
      with open(os.path.join(dirpath, name), 'rb') as f:
        out[os.path.relpath(os.path.join(dirpath, name), root)] = f.read()
  return out


def run_train_data(train_paths, eval_paths, dtype: str, tag: str,
                   overrides: dict, buckets=BUCKETS) -> dict:
  """One `cli train --window_buckets 100,200` epoch (buckets=None: no
  --window_buckets); returns its launches, per-step losses, widths,
  times and gradient norms, eval metrics, summary and `faults`
  counters."""
  from deepconsensus_tpu_torch import cli

  out = os.path.join(WORK, f'train_data_{tag}')
  shutil.rmtree(out, ignore_errors=True)
  reset_launches()
  t0 = time.perf_counter()
  if cli.main([
      'train', '--config', TRAIN_CONFIG, '--out_dir', out, '--train_path',
      *train_paths, '--eval_path', *eval_paths, '--num_epochs', '1',
      '--batch_size', str(TRAIN_BATCH),
      *(('--window_buckets', ','.join(map(str, buckets))) if buckets
        else ()),
      *(a for k, v in {'dtype': dtype, **overrides}.items()
        for a in ('--set', f'{k}={str(v).lower()}'))]) != 0:
    raise AssertionError(f'cli train failed ({tag})')
  seconds = time.perf_counter() - t0
  launches = read_launches()
  with open(os.path.join(out, 'metrics.jsonl')) as f:
    entries = [json.loads(line) for line in f]
  train = [e for e in entries if e['split'] == 'train']
  return {
      'out': out, 'launches': launches, 'seconds': seconds,
      'losses': [e['loss'] for e in train],
      'widths': [e['window_width'] for e in train],
      'step_seconds': [e['step_seconds'] for e in train],
      'grad_norms': [e['grad_norm'] for e in train],
      'eval': [e for e in entries if e['split'] == 'eval'][-1],
      'summary': [e for e in entries if e['split'] == 'summary'][-1],
      'faults': [e for e in entries if e['split'] == 'faults'][-1],
  }


def loader_rate(train_paths, batches: int = 8) -> dict:
  """The streaming loader alone at the path's settings (bucketed, two
  workers, batch TRAIN_BATCH): seconds to the first batch (worker
  start-up and the reservoir fill) and examples a second over the next
  `batches` (host clock)."""
  from deepconsensus_tpu_torch.models import data as data_lib

  params = make_params('float32')
  params.window_buckets = BUCKETS
  ds = data_lib.StreamingDataset(
      train_paths, params, batch_size=TRAIN_BATCH,
      buffer_size=TRAIN_DATA_BUFFER, seed=SEED, workers=TRAIN_DATA_WORKERS)
  it = iter(ds)
  try:
    t0 = time.perf_counter()
    next(it)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(batches):
      next(it)
    rate = batches * TRAIN_BATCH / (time.perf_counter() - t0)
  finally:
    it.close()
  return {'first_batch_s': first, 'examples_per_s': rate,
          'parsed_by_worker': {k: v for k, v in ds.counters.items()
                               if k.startswith('n_parsed_worker_')}}


def train_data_step_gates(train_paths, device: str = 'cuda') -> dict:
  """One f32 step on a fixed batch of each bucket (100, then 200, one
  parameter set and one LAMB state; seeded weights, non-zero ReZero
  alphas, no dropout): the kernel route (K5/K6 at 100, K8 with lse, K9,
  K10 at 200, K11/K12 at both) against the plain route (the module
  route's attention and the plain DP, plain=True). Gates, the train
  paths' tolerances: each step's loss within 1e-4 relative, its
  gradient norm within 1e-3, the parameters after both steps within
  1e-5; the kernels launched per layer and step on the kernel route,
  none on the plain one."""
  import torch

  from deepconsensus_tpu_torch.models import data as data_lib
  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.models import train as train_lib

  dev = torch.device(device)
  params = make_params('float32')
  params.update(attention_dropout=0.0, relu_dropout=0.0,
                layer_postprocess_dropout=0.0, window_buckets=BUCKETS)
  fixed = {}
  for batch in data_lib.DatasetIterator(train_paths, params, TRAIN_BATCH,
                                        shuffle=False).epoch():
    fixed.setdefault(batch['rows'].shape[2], batch)
  runs = {}
  for route in ('kernels', 'plain'):
    params.use_pallas_attention = route == 'kernels'
    model = model_lib.DeepConsensusModel(params, device=dev)
    model.init_weights(torch.Generator().manual_seed(SEED))
    model.requires_grad_(True)
    lamb = train_lib.Lamb(model.named_parameters(), params, 10)
    loss_fn = train_lib.make_loss(params, plain=route == 'plain')
    reset_launches()
    steps = [train_lib.train_step(
        model, lamb, loss_fn, train_lib.batch_to_device(fixed[w], dev),
        torch.Generator(device=dev)) for w in BUCKETS]
    torch.cuda.synchronize()
    runs[route] = ([float(m['loss']) for m in steps],
                   [float(m['grad_norm']) for m in steps],
                   {n: p.detach().clone()
                    for n, p in model.named_parameters()}, read_launches())
  (k_loss, k_norm, k_params, launches), (p_loss, p_norm, p_params,
                                         plain_launches) = (
                                             runs['kernels'], runs['plain'])
  layers = params.num_hidden_layers
  want = {'K5': layers, 'K6': layers, 'K7': 0, 'K8': 0, 'K8_lse': layers,
          'K9': layers, 'K10': layers, 'K11': 2, 'K12': 2}
  gates = {
      'widths': list(BUCKETS),
      'loss_rel_diff': [abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss)],
      'grad_norm_rel_diff': [abs(a - b) / abs(b)
                             for a, b in zip(k_norm, p_norm)],
      'max_param_diff': max(float((k_params[n] - p).abs().max())
                            for n, p in p_params.items()),
      'launches': {n: launches[n] for n in want},
  }
  return enforce('train_data_step', gates, [
      (gates['launches'] == want, f'the kernels did not launch as {want}'),
      (not any(plain_launches[n] for n in want),
       'the plain route launched a kernel'),
      (max(gates['loss_rel_diff']) <= 1e-4, 'a loss differs by > 1e-4'),
      (max(gates['grad_norm_rel_diff']) <= 1e-3,
       'a gradient norm differs by > 1e-3'),
      (gates['max_param_diff'] <= 1e-5,
       'the parameters differ by > 1e-5 after the two steps'),
  ])


def train_data_gates(bams, device: str = 'cuda') -> dict:
  """The train_data path on the ragged cell's BAMs and their synthetic
  truth: `cli preprocess --use_ccs_smart_windows` at --cpus 0 and 2
  (gated byte-identical, every split with examples), the 200-wide and
  the fixed 100-wide examples, then one epoch of `cli train
  --window_buckets 100,200` streamed through two loader workers with
  augmentation, use_pallas_attention and attention dropout 0, in
  bfloat16 and float32 (gates: K5, K6, K8 with lse, K9, K10, K11, K12
  launched, no K7; two step geometries; finite losses), the fixed-batch
  step gate, and three f32 steps with remat against three without
  (serial stream: the same batches; parameters and losses within 1e-5,
  peak memory no higher). Returns the bfloat16 run's launches."""
  import numpy as np

  from deepconsensus_tpu_torch.testing import synthetic

  t_path = time.perf_counter()
  truth = synthetic.write_synthetic_truth(bams[1],
                                          os.path.join(WORK, 'truth'))
  pre = {
      'smart_100_cpus0': run_preprocess_path(bams, truth, 'ex_smart100_c0',
                                             0, 100, True),
      'smart_100_cpus2': run_preprocess_path(bams, truth, 'ex_smart100_c2',
                                             2, 100, True),
      'smart_200_cpus2': run_preprocess_path(bams, truth, 'ex_smart200',
                                             2, 200, True),
      'fixed_100_cpus2': run_preprocess_path(bams, truth, 'ex_fixed100',
                                             2, 100, False),
  }
  for tag, r in pre.items():
    print(json.dumps({'phase': 'main_path', 'path': 'train_data',
                      'run': f'preprocess_{tag}', 'seconds': r['seconds'],
                      'zmws_per_s': r['zmws_per_s'], **{
                          k: v for k, v in r['summary'].items()
                          if k.startswith(('n_zmw', 'n_examples'))}}),
          flush=True)
  same = (tree_bytes(pre['smart_100_cpus0']['out'])
          == tree_bytes(pre['smart_100_cpus2']['out']))
  split_examples = {tag: {s: r['summary'].get(f'n_examples_{s}', 0)
                          for s in ('train', 'eval', 'test')}
                    for tag, r in pre.items()}
  enforce('train_data_preprocess', {
      'cpus0_cpus2_byte_identical': same, 'split_examples': split_examples,
  }, [(same, '--cpus 0 and --cpus 2 shards differ'),
      (all(n > 0 for v in split_examples.values() for n in v.values()),
       'a split has no examples')])
  train_paths = [os.path.join(pre[t]['out'], 'train', '*')
                 for t in ('fixed_100_cpus2', 'smart_200_cpus2')]
  # Eval over the eval and test splits: one batch of each width.
  eval_paths = [os.path.join(pre[t]['out'], split, '*')
                for t in ('fixed_100_cpus2', 'smart_200_cpus2')
                for split in ('eval', 'test')]
  rate = loader_rate(train_paths)
  print(json.dumps({'phase': 'main_path', 'path': 'train_data',
                    'run': 'loader', **rate}), flush=True)
  runs = {dtype: run_train_data(train_paths, eval_paths, dtype, dtype,
                                TRAIN_DATA_SET)
          for dtype in ('bfloat16', 'float32')}
  for dtype, r in runs.items():
    print(json.dumps({
        'phase': 'main_path', 'path': 'train_data', 'run': dtype,
        'launches': r['launches'], 'seconds': r['seconds'],
        'losses': r['losses'], 'widths': r['widths'],
        'step_ms': [1e3 * t for t in r['step_seconds']],
        'grad_norms': r['grad_norms'], 'eval_loss': r['eval'].get(
            'eval/loss'),
        'step_p50_ms_by_width': {
            w: 1e3 * r['summary'][f'train_step_p50_s_width_{w}']
            for w in BUCKETS
            if f'train_step_p50_s_width_{w}' in r['summary']},
        'peak_bytes': r['summary']['peak_bytes'], 'faults': r['faults']}),
          flush=True)
  steps = TRAIN_DATA_EXAMPLES // TRAIN_BATCH
  want = ('K5', 'K6', 'K8_lse', 'K9', 'K10', 'K11', 'K12')
  gates = {
      'launches': {k: {n: r['launches'][n] for n in want + ('K7',)}
                   for k, r in runs.items()},
      'forward_shapes': {k: r['faults']['n_train_forward_shapes']
                         for k, r in runs.items()},
      'steps': {k: len(r['losses']) for k, r in runs.items()},
      'batches_by_bucket': {k: {w: r['faults'].get(
          f'n_train_batches_by_bucket_{w}', 0) for w in BUCKETS}
                            for k, r in runs.items()},
  }
  checks = [
      (all(all(v[n] > 0 for n in want) and v['K7'] == 0
           for v in gates['launches'].values()),
       f'a kernel of {want} never launched (or K7 did)'),
      (all(v == 2 for v in gates['forward_shapes'].values()),
       'n_train_forward_shapes != 2'),
      (all(v == steps for v in gates['steps'].values()),
       f'a run did not take {steps} steps'),
      (all(math.isfinite(x) for r in runs.values()
           for x in r['losses'] + r['grad_norms']
           + [r['eval'].get('eval/loss', math.nan)]),
       'a loss, gradient norm or the eval loss is not finite'),
  ]
  enforce('train_data', gates, checks)
  train_data_step_gates(train_paths, device)
  # Three steps (the first pays remat's one-time set-up), in a serial
  # stream: the same batches in both runs.
  remat_set = {**TRAIN_DATA_SET, 'loader_workers': 0,
               'n_examples_train': 3 * TRAIN_BATCH}
  remat = {on: run_train_data(train_paths, eval_paths, 'float32',
                              f'remat_{on}', {**remat_set, 'remat': on})
           for on in (False, True)}
  weights = [np.load(os.path.join(remat[on]['out'], 'weights.npz'))
             for on in (False, True)]
  diff = max(float(np.abs(weights[0][k] - weights[1][k]).max())
             for k in weights[0].files)
  peaks = {str(on): remat[on]['summary']['peak_bytes'] for on in remat}
  loss_rel = [abs(a - b) / abs(b) for a, b in zip(remat[True]['losses'],
                                                  remat[False]['losses'])]
  enforce('train_data_remat', {
      'max_param_diff': diff, 'peak_bytes': peaks,
      'loss_rel_diff': loss_rel,
      'step_ms': {str(on): [1e3 * t for t in remat[on]['step_seconds']]
                  for on in remat},
      'widths': {str(on): remat[on]['widths'] for on in remat},
      'losses': {str(on): remat[on]['losses'] for on in remat},
      'path_seconds': time.perf_counter() - t_path,
  }, [(diff <= 1e-5, 'remat moved a parameter by > 1e-5 after 3 steps'),
      (len(loss_rel) == 3 and max(loss_rel) <= 1e-5,
       'a remat step loss differs by > 1e-5 relative'),
      (peaks['True'] <= peaks['False'], 'remat raised the peak memory')])
  return runs['bfloat16']['launches']


def make_run_inputs():
  """The `run` paths' synthetic BAMs ({'L100': ..., 'ragged': ...}) and
  the seeded full-width weights (.npz), under WORK."""
  import torch

  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.models import weights as weights_lib
  from deepconsensus_tpu_torch.testing import synthetic

  os.makedirs(WORK, exist_ok=True)
  bams = {path: synthetic.write_synthetic_zmw_bams(
      os.path.join(WORK, f'bams_{path}'), n_zmws=N_ZMWS,
      n_subreads=N_SUBREADS, seq_len=SEQ_LEN, seed=SEED,
      smart_windows=path == 'ragged') for path in RUN_PATHS}
  model = model_lib.DeepConsensusModel(make_params('float32'), device='cpu')
  model.init_weights(torch.Generator().manual_seed(SEED))
  weights = os.path.join(WORK, 'weights.npz')
  weights_lib.save_npz(weights, weights_lib.to_flax_params(
      model.state_dict()))
  return bams, weights


def main(argv) -> int:
  kernels_only = '--kernels-only' in argv
  try:
    import torch
  except ImportError:
    print('chip_smoke: torch is not installed', file=sys.stderr)
    return 2
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device', file=sys.stderr)
    return 2
  if not os.path.isdir(os.path.join(REPO, 'deepconsensus_tpu_torch')):
    print('chip_smoke: run from a checkout of the repository',
          file=sys.stderr)
    return 2
  sys.path.insert(0, REPO)

  card = card_line()
  print(card, flush=True)

  from deepconsensus_tpu_torch import native
  from deepconsensus_tpu_torch.ops import _build
  from deepconsensus_tpu_torch.ops import _kernels
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
  from deepconsensus_tpu_torch.testing import synthetic

  t0 = time.perf_counter()
  if native.get_lib() is None:
    raise AssertionError('the native BGZF library did not build')
  print(json.dumps({'phase': 'build_native', 'library': os.path.relpath(
      native.library_path(), REPO), 'seconds': time.perf_counter() - t0}))
  t0 = time.perf_counter()
  paths = _build.build_all()
  print(json.dumps({'phase': 'build', 'seconds': time.perf_counter() - t0}))
  for name, path in paths.items():
    log = path.with_suffix('.log')
    if log.exists():
      for line in log.read_text().splitlines():
        if 'registers' in line or 'spill' in line or 'smem' in line:
          print(f'ptxas {name}: {line.strip()}')
  p = make_params('float32')
  specs, keys, cond_in = fwa.build_family_specs(p)
  layout = fwa.condense_layout(specs, tuple(
      next(sp.vocab * sp.width for sp in specs if sp.table_idx == i)
      for i in range(len(keys))), p.total_rows)
  print(json.dumps({
      'phase': 'attention_smem', 'block_limit_bytes': 232448,
      'dynamic_smem_bytes': {
          length: _kernels.attention_smem_bytes(
              length, p.hidden_size, p.num_heads, p.attn_win_size)
          for length in (LENGTH, SLOT_LEN, 256)},
      # K8-K10's tiles: one size for every L and band (the largest of
      # the three kernels, either dtype), and the blocks of K8, K10 and
      # K9 an SM holds, [float32, bf16]; the same for the K5 / K7
      # forward and K6's two passes.
      'flash_smem_bytes': _build.load(
          'flash_band_attention').dc_flash_band_smem_bytes(
              p.hidden_size // p.num_heads),
      'flash_blocks_per_sm': {
          name: [_build.load(
              'flash_band_attention').dc_flash_band_blocks_per_sm(
                  kernel, is_bf16, p.hidden_size // p.num_heads)
                 for is_bf16 in (0, 1)]
          for kernel, name in enumerate(('K8', 'K10', 'K9'))},
      'banded_blocks_per_sm': {
          name: [_build.load(
              'banded_attention').dc_banded_attention_blocks_per_sm(
                  n, is_bf16, p.hidden_size // p.num_heads)
                 for is_bf16 in (0, 1)]
          for n, name in enumerate(('K5_K7', 'K6_pass1', 'K6_pass2'))},
      # K1/K4's condenser at the main path's tables, rows and K.
      'condense_smem_bytes': {
          dtype: _kernels.embed_condense_smem_bytes(
              fwa.resolve_dtype(dtype), layout.entries, p.total_rows,
              cond_in) for dtype in ('bfloat16', 'float32')}}), flush=True)

  kernels = {}
  for dtype in ('float32', 'bfloat16'):
    result = check_kernels(dtype)
    result.update(check_ragged_kernels(dtype))
    result.update(check_banded_attention_kernels(dtype))
    result.update(check_flash_kernels(dtype))
    for name, r in result.items():
      print(json.dumps({'phase': 'kernel', 'kernel': name, 'dtype': dtype,
                        **r}), flush=True)
    kernels[dtype] = result
  dp_kernels = check_wavefront_kernels()
  dp_kernels.update(check_band_kernels())
  for name, r in dp_kernels.items():
    print(json.dumps({'phase': 'kernel', 'kernel': name, 'dtype': 'float32',
                      **r}), flush=True)
  if kernels_only:
    return 0
  bams, weights = make_run_inputs()

  launches_by_path = {}
  main_runs = {}
  for path in RUN_PATHS:
    path_kernels = PATH_KERNELS[path]
    runs = main_runs[path] = {}
    for dtype, plain in (('bfloat16', False), ('float32', False),
                         ('float32', True)):
      counters, launches, ids, quals, lengths, seconds, peak = run_main_path(
          path, bams[path], weights, dtype, plain)
      label = dtype + ('_plain' if plain else '')
      runs[label] = (counters, launches, ids, quals, lengths, seconds, peak)
      main_path_line(path, label, runs[label])
      if counters['success'] != N_ZMWS:
        raise AssertionError(f'{path} {label}: {counters["success"]} reads, '
                             f'want {N_ZMWS}')
      if not plain and not all(launches[k] for k in path_kernels):
        raise AssertionError(
            f'{path} {label}: a kernel of the path never launched: '
            f'{launches}')
      if launches['K2_int8']:
        raise AssertionError(f'{path} {label}: K2 int8 launched without '
                             'int8 weights')
    path_gates(path, {k: r[:5] for k, r in runs.items()})
    launches_by_path[path] = runs['bfloat16'][1]
  pipeline_gates(bams, weights)
  stage_split(bams['L100'], weights)
  launches_by_path.update(faults_gates(bams, weights)[1])
  int8_runs = {}
  for dtype, plain in (('bfloat16', False), ('float32', False),
                       ('float32', True)):
    label = dtype + ('_plain' if plain else '')
    counters, launches, ids, quals, _, seconds, peak = run_main_path(
        'int8', bams['L100'], weights, dtype, plain)
    int8_runs[label] = (counters, launches, ids, quals)
    n_win = counters['n_windows_to_model']
    l100 = main_runs['L100'][label]
    print(json.dumps({
        'phase': 'main_path', 'path': 'int8', 'run': label,
        'launches': launches, 'reads': counters['success'],
        'windows': n_win, 'packs': counters['n_model_packs'],
        'n_quantized_matmuls': counters['n_quantized_matmuls'],
        'inference_dtype': counters['inference_dtype'], 'seconds': seconds,
        'windows_per_s': n_win / counters['total_seconds'],
        'model_windows_per_s': n_win / counters['model_seconds'],
        'model_seconds': counters['model_seconds'], 'peak_bytes': peak,
        'l100_windows_per_s': l100[0]['n_windows_to_model']
        / l100[0]['total_seconds'],
        'l100_model_windows_per_s': l100[0]['n_windows_to_model']
        / l100[0]['model_seconds'],
        'l100_peak_bytes': l100[6], **stage_fields(counters)}), flush=True)
    if counters['success'] != N_ZMWS:
      raise AssertionError(f'int8 {label}: {counters["success"]} reads, '
                           f'want {N_ZMWS}')
  int8_gates(int8_runs, main_runs['L100']['float32'][2])
  launches_by_path['int8'] = int8_runs['bfloat16'][1]
  # softmax_bf16: a's and b's runs over params with
  # attn_softmax_dtype=bfloat16, then a's int8 run in float32.
  for path in RUN_PATHS:
    runs = {}
    for dtype, plain in (('bfloat16', False), ('float32', False),
                         ('float32', True)):
      label = dtype + ('_plain' if plain else '')
      counters, launches, ids, quals, lengths, seconds, peak = run_main_path(
          path, bams[path], weights, dtype, plain, softmax_bf16=True)
      runs[label] = (counters, launches, ids, quals, lengths)
      n_win = counters['n_windows_to_model']
      ref = main_runs[path][label][0]
      print(json.dumps({
          'phase': 'main_path', 'path': 'softmax_bf16', 'run_path': path,
          'run': label, 'launches': launches, 'reads': counters['success'],
          'windows': n_win, 'packs': counters['n_model_packs'],
          'seconds': seconds,
          'windows_per_s': n_win / counters['total_seconds'],
          'model_windows_per_s': n_win / counters['model_seconds'],
          'model_seconds': counters['model_seconds'], 'peak_bytes': peak,
          'float32_softmax_windows_per_s': ref['n_windows_to_model']
          / ref['total_seconds'],
          'float32_softmax_model_windows_per_s': ref['n_windows_to_model']
          / ref['model_seconds'], **stage_fields(counters)}), flush=True)
      if counters['success'] != N_ZMWS:
        raise AssertionError(f'softmax_bf16 {path} {label}: '
                             f'{counters["success"]} reads, want {N_ZMWS}')
    softmax_bf16_gates(path, runs, main_runs[path])
    launches_by_path[f'softmax_bf16_{path}'] = runs['bfloat16'][1]
  run = run_main_path('int8', bams['L100'], weights, 'float32',
                      softmax_bf16=True)
  print(json.dumps({
      'phase': 'main_path', 'path': 'softmax_bf16', 'run_path': 'int8',
      'run': 'float32', 'launches': run[1], 'reads': run[0]['success'],
      'windows': run[0]['n_windows_to_model'], 'seconds': run[5],
      'model_windows_per_s': run[0]['n_windows_to_model']
      / run[0]['model_seconds']}), flush=True)
  softmax_bf16_int8_gates(run, int8_runs['float32'][2])
  launches_by_path['softmax_bf16_int8'] = run[1]
  runs = {}
  for dtype, plain, attn in (('bfloat16', False, True),
                             ('float32', False, True),
                             ('float32', True, True),
                             ('float32', False, False)):
    label = dtype + ('_plain' if plain else '') + ('' if attn else '_flag_off')
    counters, launches, ids, quals, _, seconds, peak = run_main_path(
        'buckets', bams['ragged'], weights, dtype, plain, attn)
    runs[label] = (counters, launches, ids, quals)
    n_win = counters['n_windows_to_model']
    print(json.dumps({
        'phase': 'main_path', 'path': 'buckets', 'run': label,
        'launches': launches, 'reads': counters['success'],
        'windows': n_win, 'packs': counters['n_model_packs'],
        'packs_by_bucket': counters['n_model_packs_by_bucket'],
        'windows_by_bucket': counters['n_windows_by_bucket'],
        'pad_rows_by_bucket': counters['n_model_pad_rows_by_bucket'],
        'seconds': seconds,
        'windows_per_s': n_win / counters['total_seconds'],
        'model_windows_per_s': n_win / counters['model_seconds'],
        'peak_bytes': peak, **stage_fields(counters)}), flush=True)
    if counters['success'] != N_ZMWS:
      raise AssertionError(f'buckets {label}: {counters["success"]} reads, '
                           f'want {N_ZMWS}')
    if launches['K2_int8']:
      raise AssertionError(f'buckets {label}: K2 int8 launched without '
                           'int8 weights')
  buckets_gates(runs)
  launches_by_path['buckets'] = runs['bfloat16'][1]

  shards = []
  for split, count, seed in (('train', TRAIN_EXAMPLES, SEED),
                             ('eval', EVAL_EXAMPLES, SEED + 1)):
    shutil.rmtree(os.path.join(WORK, f'shards_{split}'), ignore_errors=True)
    synthetic.write_synthetic_tfrecords(
        os.path.join(WORK, f'shards_{split}'), n_shards=4,
        n_examples=count, max_passes=20, max_length=LENGTH, seed=seed)
    shards.append(os.path.join(WORK, f'shards_{split}', '*.tfrecord.gz'))
  runs = {}
  for dtype, plain in (('bfloat16', False), ('float32', False),
                       ('float32', True)):
    label = dtype + ('_plain' if plain else '')
    runs[label] = r = run_train_path(shards, dtype, plain)
    summary = r['summary']
    print(json.dumps({
        'phase': 'main_path', 'path': 'train', 'run': label,
        'launches': r['launches'], 'seconds': r['seconds'],
        'losses': r['losses'], 'grad_norms': r['grad_norms'],
        'step_ms': [1e3 * t for t in r['step_seconds']],
        'step_p50_ms': 1e3 * summary['train_step_p50_s'],
        'examples_per_s': summary['train_examples_per_s'],
        'peak_bytes': summary['peak_bytes'],
        'eval_loss': r['eval']['eval/loss']}), flush=True)
  train_gates(runs)
  launches_by_path['train'] = runs['bfloat16']['launches']
  r = run_train_path(shards, 'float32', softmax_bf16=True)
  print(json.dumps({
      'phase': 'main_path', 'path': 'softmax_bf16', 'run_path': 'train',
      'run': 'float32', 'launches': r['launches'], 'seconds': r['seconds'],
      'losses': r['losses'], 'grad_norms': r['grad_norms'],
      'float32_softmax_losses': runs['float32']['losses'],
      'step_p50_ms': 1e3 * r['summary']['train_step_p50_s'],
      'eval_loss': r['eval']['eval/loss']}), flush=True)
  softmax_bf16_train_gates(r, runs['float32'])
  from deepconsensus_tpu_torch.models import train as train_lib

  checkpoint = train_lib.latest_checkpoint(
      os.path.join(WORK, 'train_float32', 'checkpoints'))
  eval_runs = {}
  for quantize in (False, True):
    label = 'int8' if quantize else 'float32'
    eval_runs[label] = r = run_evaluate_path(
        ['--checkpoint', checkpoint], shards[1], quantize)
    print(json.dumps({
        'phase': 'main_path', 'path': 'evaluate', 'run': label,
        'checkpoint': os.path.relpath(checkpoint, REPO), 'csv': r[0],
        'launches': r[1], 'seconds': r[2], 'peak_bytes': r[3]}),
          flush=True)
  # The checkpoint's ReZero alphas are still near Flax's zeros after 4
  # steps, so int8 barely reaches its predictions; the seeded `run`
  # weights (alphas U(0.1, 0.3)) hold the lever to the gate on a model
  # whose residual branches count.
  seeded = {}
  for quantize in (False, True):
    label = 'int8' if quantize else 'float32'
    seeded[label] = r = run_evaluate_path(
        ['--weights', weights, '--params',
         os.path.join(WORK, 'params_float32.json')], shards[1], quantize,
        tag='_seeded')
    print(json.dumps({
        'phase': 'main_path', 'path': 'evaluate',
        'run': f'seeded_weights_{label}', 'csv': r[0], 'seconds': r[2],
        'peak_bytes': r[3]}), flush=True)
  evaluate_gates(eval_runs, seeded)
  launches_by_path['evaluate'] = eval_runs['int8'][1]
  attn_runs = {}
  for dtype in ('bfloat16', 'float32'):
    attn_runs[dtype] = r = run_train_path(shards, dtype, attn=True)
    summary = r['summary']
    print(json.dumps({
        'phase': 'main_path', 'path': 'train_attn', 'run': dtype,
        'launches': r['launches'], 'seconds': r['seconds'],
        'losses': r['losses'], 'grad_norms': r['grad_norms'],
        'step_ms': [1e3 * t for t in r['step_seconds']],
        'step_p50_ms': 1e3 * summary['train_step_p50_s'],
        'examples_per_s': summary['train_examples_per_s'],
        'peak_bytes': summary['peak_bytes'],
        'module_route_peak_bytes': runs[dtype]['summary']['peak_bytes'],
        'module_route_step_p50_ms': 1e3 * runs[dtype]['summary'][
            'train_step_p50_s'],
        'eval_loss': r['eval']['eval/loss']}), flush=True)
  train_attn_gates(attn_runs, runs['float32'])
  train_attn_step_gates()
  launches_by_path['train_attn'] = attn_runs['bfloat16']['launches']
  band_runs = {}
  for dtype, plain in (('bfloat16', False), ('float32', False),
                       ('float32', True)):
    label = dtype + ('_plain' if plain else '')
    band_runs[label] = r = run_train_path(shards, dtype, plain, band=True)
    summary = r['summary']
    print(json.dumps({
        'phase': 'main_path', 'path': 'train_band', 'run': label,
        'launches': r['launches'], 'seconds': r['seconds'],
        'losses': r['losses'], 'grad_norms': r['grad_norms'],
        'step_ms': [1e3 * t for t in r['step_seconds']],
        'step_p50_ms': 1e3 * summary['train_step_p50_s'],
        'examples_per_s': summary['train_examples_per_s'],
        'peak_bytes': summary['peak_bytes'],
        'train_step_p50_ms': 1e3 * runs[label]['summary'][
            'train_step_p50_s'],
        'train_peak_bytes': runs[label]['summary']['peak_bytes'],
        'eval_loss': r['eval']['eval/loss']}), flush=True)
  train_band_gates(band_runs, runs)
  launches_by_path['train_band'] = band_runs['bfloat16']['launches']
  flash_shards = []
  for split, count, seed in (('train', TRAIN_EXAMPLES, SEED + 2),
                             ('eval', EVAL_EXAMPLES, SEED + 3)):
    out = os.path.join(WORK, f'flash_shards_{split}')
    shutil.rmtree(out, ignore_errors=True)
    synthetic.write_synthetic_tfrecords(
        out, n_shards=4, n_examples=count, max_passes=20,
        max_length=FLASH_LENGTH, seed=seed)
    flash_shards.append(os.path.join(out, '*.tfrecord.gz'))
  flash_runs = {}
  for dtype, attn in (('bfloat16', True), ('float32', True),
                      ('float32', False)):
    label = dtype + ('' if attn else '_module')
    flash_runs[label] = r = run_train_path(flash_shards, dtype, attn=attn,
                                           flash=True)
    summary = r['summary']
    print(json.dumps({
        'phase': 'main_path', 'path': 'train_flash', 'run': label,
        'launches': r['launches'], 'seconds': r['seconds'],
        'losses': r['losses'], 'grad_norms': r['grad_norms'],
        'step_ms': [1e3 * t for t in r['step_seconds']],
        'step_p50_ms': 1e3 * summary['train_step_p50_s'],
        'examples_per_s': summary['train_examples_per_s'],
        'peak_bytes': summary['peak_bytes'],
        'eval_loss': r['eval']['eval/loss']}), flush=True)
  module_f32 = flash_runs.pop('float32_module')
  train_flash_gates(flash_runs, module_f32)
  train_attn_step_gates(flash=True)
  launches_by_path['train_flash'] = flash_runs['bfloat16']['launches']
  launches_by_path['train_data'] = train_data_gates(bams['ragged'])
  long_window_gates()
  for dtype, route in (('bfloat16', 'train'), ('float32', 'train'),
                       ('bfloat16', 'train_attn'), ('bfloat16', 'train_band'),
                       ('bfloat16', 'train_flash')):
    print(json.dumps({'phase': 'train_breakdown', 'dtype': dtype,
                      'route': route, **train_step_breakdown(
                          dtype, attn=route == 'train_attn',
                          band=route == 'train_band',
                          flash=route == 'train_flash')}), flush=True)

  sources = {
      'K1': ('deepconsensus_tpu_torch/csrc/embed_condense.cu',
             'deepconsensus_tpu/ops/fused_window_attention.py:349', 'L100'),
      'K2': ('deepconsensus_tpu_torch/csrc/mma_gemm.cuh',
             'deepconsensus_tpu/ops/fused_encoder_block.py:264', 'L100'),
      'K2_int8': ('deepconsensus_tpu_torch/csrc/mma_gemm.cuh',
                  'deepconsensus_tpu/ops/fused_encoder_block.py:264',
                  'int8'),
      'K3': ('deepconsensus_tpu_torch/csrc/phred_epilogue.cu',
             'deepconsensus_tpu/ops/output_plane.py:236', 'L100'),
      'K4': ('deepconsensus_tpu_torch/csrc/ragged_attention.cu',
             'deepconsensus_tpu/ops/ragged_window_attention.py:320',
             'ragged'),
      'K5': ('deepconsensus_tpu_torch/csrc/banded_attention.cu',
             'deepconsensus_tpu/ops/banded_attention.py:93', 'train_attn'),
      'K6': ('deepconsensus_tpu_torch/csrc/banded_attention.cu',
             'deepconsensus_tpu/ops/banded_attention.py:222', 'train_attn'),
      'K7': ('deepconsensus_tpu_torch/csrc/banded_attention.cu',
             'deepconsensus_tpu/ops/banded_attention.py:281', 'train_attn'),
      'K8': ('deepconsensus_tpu_torch/csrc/flash_band_attention.cu',
             'deepconsensus_tpu/ops/flash_band_attention.py:182',
             'train_flash'),
      'K9': ('deepconsensus_tpu_torch/csrc/flash_band_attention.cu',
             'deepconsensus_tpu/ops/flash_band_attention.py:370',
             'train_flash'),
      'K10': ('deepconsensus_tpu_torch/csrc/flash_band_attention.cu',
              'deepconsensus_tpu/ops/flash_band_attention.py:417',
              'train_flash'),
      # The attention core K1, K2 and K4 share (their `_attention`), and
      # the attn_softmax_dtype=bfloat16 variant, whose softmax lives in
      # it (static in each pallas_call).
      'attention_core': (CORE_SOURCE,
                         'deepconsensus_tpu/ops/fused_encoder_block.py:101',
                         'L100'),
      'attention_core_bf16_softmax': (
          CORE_SOURCE, 'deepconsensus_tpu/ops/fused_encoder_block.py:134',
          'softmax_bf16_L100'),
      'K1_bf16_softmax': (
          CORE_SOURCE, 'deepconsensus_tpu/ops/fused_window_attention.py:354',
          'softmax_bf16_L100'),
      'K2_bf16_softmax': (
          CORE_SOURCE, 'deepconsensus_tpu/ops/fused_encoder_block.py:270',
          'softmax_bf16_L100'),
      'K2_int8_bf16_softmax': (
          CORE_SOURCE, 'deepconsensus_tpu/ops/fused_encoder_block.py:270',
          'softmax_bf16_int8'),
      'K4_bf16_softmax': (
          CORE_SOURCE,
          'deepconsensus_tpu/ops/ragged_window_attention.py:325',
          'softmax_bf16_ragged'),
  }
  # K8's launches count both its variants (without and with lse).
  launches_by_path = {k: {**v, 'K8': v['K8'] + v['K8_lse']}
                      for k, v in launches_by_path.items()}
  line = []
  for name, (source, replaces, path) in sources.items():
    r = kernels['bfloat16'][name]
    entry = {
        'name': name, 'route': 'cuda', 'source': source,
        'replaces': replaces, 'launches': launches_by_path[path][name],
        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
        'bound_by': r['bound_by'], 'library_ms': r['library_ms'],
        'dtype': 'bfloat16', 'status': 'ported', 'path': path,
        'launches_by_path': {k: v[name] for k, v in launches_by_path.items()},
        'float32_ms': kernels['float32'][name]['ms'],
        'float32_max_abs_err': kernels['float32'][name]['max_abs_err'],
    }
    if name in LENGTHS_ROWS:  # the lengths variant
      lname = LENGTHS_ROWS[name]
      lv = kernels['bfloat16'][lname]
      entry.update({f'lengths_{k}': lv[k] for k in (
          'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'library_ms')})
      entry['lengths_float32_ms'] = kernels['float32'][lname]['ms']
      entry['lengths_float32_max_abs_err'] = kernels['float32'][lname][
          'max_abs_err']
      if 'stages' in r:
        entry.update(stages=r['stages'], lengths_stages=lv['stages'],
                     float32_stages=kernels['float32'][name]['stages'],
                     lengths_float32_stages=kernels['float32'][lname][
                         'stages'])
    if name in ('K1', 'K4', 'K1_bf16_softmax', 'K4_bf16_softmax'):
      entry.update(stages=r['stages'],
                   float32_stages=kernels['float32'][name]['stages'])
    if 'share_beyond_1e-4' in r:
      entry['share_beyond_1e-4'] = r['share_beyond_1e-4']
      entry['float32_share_beyond_1e-4'] = kernels['float32'][name][
          'share_beyond_1e-4']
    if name == 'K3':
      entry.update({k: r[k] for k in ('device_ms', 'plain_device_ms',
                                      'library_device_ms')})
    if name == 'K2_int8':
      entry.update(float32_bound_ms=kernels['float32'][name]['bound_ms'],
                   ffn_only_ms=r['ffn_only_ms'])
    if name in ('K5', 'K7'):  # the forward's blocks an SM; K7 over K5
      entry.update(blocks_per_sm=r['blocks_per_sm'],
                   float32_blocks_per_sm=kernels['float32'][name][
                       'blocks_per_sm'])
      if name == 'K7':
        entry.update(mask_ms=r['mask_ms'],
                     float32_mask_ms=kernels['float32']['K7']['mask_ms'])
    if name == 'K6':  # K5's backward: no mask; each pass alone
      entry['no_mask_ms'] = r['no_mask_ms']
      entry['no_mask_float32_ms'] = kernels['float32']['K6']['no_mask_ms']
      entry.update(stages=r['stages'],
                   float32_stages=kernels['float32']['K6']['stages'])
    if name == 'K8':  # with its logsumexp (train_flash's steps)
      entry.update(lse_ms=r['lse_ms'], lse_bound_ms=r['lse_bound_ms'],
                   lse_float32_ms=kernels['float32']['K8']['lse_ms'])
    if name in ('K9', 'K10'):
      entry['library_covers'] = r['library_covers']
    line.append(entry)
  for name, replaces, path in (
      ('K11', 'deepconsensus_tpu/ops/wavefront_pallas.py:231', 'train'),
      ('K12', 'deepconsensus_tpu/ops/wavefront_pallas.py:487', 'train'),
      ('K13', 'deepconsensus_tpu/ops/wavefront_pallas.py:698', 'train_band'),
      ('K14', 'deepconsensus_tpu/ops/wavefront_pallas.py:905', 'train_band')):
    r = dp_kernels[name]
    extra = {k: r[k] for k in ('no_rows_ms', 'max_abs_err_vs_K11',
                               'max_abs_err_vs_K12', 'w100_ms') if k in r}
    line.append({
        'name': name, 'route': 'cuda',
        'source': 'deepconsensus_tpu_torch/csrc/wavefront.cu',
        'replaces': replaces, 'launches': launches_by_path[path][name],
        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
        'bound_by': r['bound_by'], 'library_ms': None, 'dtype': 'float32',
        'status': 'ported', 'path': path,
        'launches_by_path': {k: v[name] for k, v in launches_by_path.items()},
        'serial_floor_ms': r['serial_floor_ms'], **extra})
  print(json.dumps({'kernels': line}))
  print(card_line())
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
