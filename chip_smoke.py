#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (deepconsensus_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero (nothing is caught):

1. Print the card's name and power limit, then build every CUDA kernel
   from csrc/ (one nvcc per source, all at once) and print nvcc's
   register/spill/shared-memory report and the attention core's dynamic
   shared memory at the ragged slot length.
2. Hold each kernel against its plain PyTorch version on the card at
   its path's shapes, full width, in float32 (rtol = atol = 1e-4) and
   bfloat16 (rtol = atol = 2e-2; K3 exact), and time kernel, plain
   version and a library yardstick with CUDA events: K1
   embed-condense-attention, K2 encoder block and K3 output plane at
   1024 windows x 100 positions; K4 ragged embed-condense-attention and
   one K2 block with lengths at 512 slots x 200 positions holding every
   slot composition (one 200, two 100s, a lone 100, empty), compared on
   valid positions only; K11 (the alignment DP's forward, with and
   without its rows) and K12 (its backward) at 256 x 100 x 100 float32
   costs, loss_reg 0.1, mixed lengths: scores rtol 1e-5 (atol 1e-4),
   gradients rtol 1e-4, atol 1e-5, plus each kernel's time at one batch
   row (the serial chain of 199 diagonals alone).
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
      plain DP.
   Gates: each path's kernels launched (a: K1-K3, b: K4, K2, K3, c: K11
   once per step and eval batch, K12 once per step), and for a and b one
   read per ZMW, float32 kernels vs plain base ids differ at <= 1e-4 of
   the delivered positions and qualities by <= 1, bfloat16 vs float32
   ids agree on >= 99% of them and qualities within BF16_QV_GATE where
   they agree; for b also each bucket >= 20% of model windows, slots
   holding one 200 and two 100s both occur, and the last pack is
   partial; for c every loss and gradient norm finite, the float32
   kernel run's loss within 1e-4 relative of the plain run's at every
   step, and bfloat16's first loss within 2% of float32's.
4. Where a full-width train step's time goes, in bfloat16 and float32:
   forward, loss (costs and K11), backward (K12 and autograd) and LAMB
   timed apart (synchronized, median of 5 steps after 2), and one step
   under torch.profiler: the device's busy time (its kernels' time
   summed), the idle share of the unprofiled step, and the kernels that
   take most of it.
5. A `{"kernels": [...]}` line (K1-K4, K11, K12), the card line again,
   and the last line `{"ok": true, "device": {...}}`.

`--kernels-only` stops after phase 2 and prints no result (a first
check of newly written kernels). Without a CUDA device, or away from the repository, it exits 2 and
prints no result.
"""
from __future__ import annotations

import json
import math
import os
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
      flops=flops, bytes=nbytes)

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

  def k2_library():
    xf = x.float()
    qkv = [(xf @ w.to(dt).float()).view(BATCH, LENGTH, heads, -1)
           .transpose(1, 2) for w in (b1.wq, b1.wk, b1.wv)]
    o = F.scaled_dot_product_attention(*qkv, attn_mask=band)
    y = xf + b1.attn_alpha * (o.transpose(1, 2).reshape(BATCH, LENGTH, h)
                              @ b1.wo.to(dt).float())
    hh = torch.relu(F.linear(y, b1.w_filter.to(dt).float().t(), b1.b_filter))
    return y + b1.ffn_alpha * F.linear(hh, b1.w_output.to(dt).float().t(),
                                       b1.b_output)

  t_bound, by = bound(flops, nbytes, dtype)
  out['K2'] = dict(
      max_abs_err=max(errs), ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [b1], **k2_kw)),
      plain_ms=cuda_ms(lambda: feb.fused_encoder_stack_plain(
          x, [b1], **k2_kw)),
      library_ms=cuda_ms(k2_library), bound_ms=t_bound, bound_by=by,
      ffn_only_ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [blocks[0]], **k2_kw)),
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

  t_bound, _ = bound(m * (5 + len(thr)), nbytes, 'float32')
  out['K3'] = dict(
      max_abs_err=0.0,
      ms=cuda_ms(lambda: output_plane.phred_epilogue(preds, thr_dev)),
      plain_ms=cuda_ms(
          lambda: output_plane.phred_epilogue_plain(preds, thr_dev)),
      library_ms=cuda_ms(k3_library), bound_ms=t_bound, bound_by='bytes',
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
      flops=flops, bytes=nbytes, pairs=pairs,
      valid_positions=int(valid.sum()))

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

  def k2_library():
    xf = x.float()
    qkv = [(xf @ w.to(dt).float()).view(SLOTS, SLOT_LEN, heads, -1)
           .transpose(1, 2) for w in (b1.wq, b1.wk, b1.wv)]
    o = F.scaled_dot_product_attention(*qkv, attn_mask=sdpa_mask)
    y = xf + b1.attn_alpha * (o.transpose(1, 2).reshape(SLOTS, SLOT_LEN, h)
                              @ b1.wo.to(dt).float())
    hh = torch.relu(F.linear(y, b1.w_filter.to(dt).float().t(), b1.b_filter))
    return y + b1.ffn_alpha * F.linear(hh, b1.w_output.to(dt).float().t(),
                                       b1.b_output)

  t_bound, by = bound(flops, nbytes, dtype)
  out['K2_lengths'] = dict(
      max_abs_err=err, ms=cuda_ms(
          lambda: feb.fused_encoder_stack(x, [b1], **k2_kw)),
      plain_ms=cuda_ms(lambda: feb.fused_encoder_stack_plain(
          x, [b1], **k2_kw)),
      library_ms=cuda_ms(k2_library), bound_ms=t_bound, bound_by=by,
      flops=flops, bytes=nbytes)
  return out


def check_wavefront_kernels(device: str = 'cuda') -> dict:
  """Phase 2 for the alignment DP (float32 costs in both compute
  dtypes): K11 without and with rows, K12 on those rows, vs the plain
  DP and its autograd."""
  import numpy as np
  import torch

  from deepconsensus_tpu_torch.ops import wavefront
  from deepconsensus_tpu_torch.ops import wavefront_cuda

  dev = torch.device(device)
  rng = np.random.default_rng(SEED + 2)
  b, m, n = TRAIN_BATCH, LENGTH, LENGTH
  lens = rng.integers(m // 2, m + 1, b).astype(np.int32)
  lens[:2] = (0, m)
  subs = torch.from_numpy(rng.uniform(0, 8, (b, m, n)).astype(np.float32))
  ins = torch.from_numpy(rng.uniform(0, 8, (b, n)).astype(np.float32))
  subs, ins, lens = subs.to(dev), ins.to(dev), torch.from_numpy(lens).to(dev)
  grad = torch.from_numpy(rng.uniform(0.5, 2, b).astype(np.float32)).to(dev)
  dp = (DEL_COST, lens, LOSS_REG)

  def k11(s=subs, i=ins, lengths=lens):
    return wavefront_cuda.alignment_scores_with_rows(s, i, DEL_COST,
                                                     lengths, LOSS_REG)

  want = wavefront.alignment_scan(subs, ins, *dp)
  no_rows = wavefront_cuda.alignment_scores(subs, ins, *dp)
  scores, rows = k11()
  s_req, i_req = subs.clone().requires_grad_(True), ins.clone().requires_grad_(
      True)
  plain_value = wavefront.alignment_scan(s_req, i_req, *dp)

  def k12(s=subs, i=ins, lengths=lens, r=rows, g=grad):
    return wavefront_cuda.launch_bwd(s, i, lengths, r, g, DEL_COST, LOSS_REG)

  def k12_plain():
    return torch.autograd.grad(plain_value, (s_req, i_req), grad,
                               retain_graph=True)

  d_subs, d_ins = k12()
  want_ds, want_di = k12_plain()
  torch.cuda.synchronize()
  err11 = max(max_err(no_rows, want, 1e-5, 1e-4),
              max_err(scores, want, 1e-5, 1e-4))
  err12 = max(max_err(d_subs, want_ds, 1e-4, 1e-5),
              max_err(d_ins, want_di, 1e-4, 1e-5))
  # Bytes: each input read once, each output written once. Operations:
  # the cells this run's lengths need, (len + 1) x (n + 1) per row.
  cells = int(((lens.long() + 1) * (n + 1)).sum())
  in_bytes = (subs.numel() + ins.numel() + lens.numel()) * 4
  rows_bytes = rows.numel() * 4
  fwd_bytes = in_bytes + b * 4 + rows_bytes
  bwd_bytes = in_bytes + rows_bytes + b * 4 + (subs.numel() + ins.numel()) * 4
  one = (subs[:1], ins[:1], lens[:1])
  _, rows1 = k11(*one)
  out = {}
  t_bound, by = bound(cells * FWD_OPS_PER_CELL, fwd_bytes, 'float32')
  out['K11'] = dict(
      max_abs_err=err11, ms=cuda_ms(k11),
      no_rows_ms=cuda_ms(lambda: wavefront_cuda.alignment_scores(
          subs, ins, *dp)),
      plain_ms=cuda_ms(lambda: wavefront.alignment_scan(subs, ins, *dp)),
      library_ms=None, bound_ms=t_bound, bound_by=by,
      serial_floor_ms=cuda_ms(lambda: k11(*one)),
      flops=cells * FWD_OPS_PER_CELL, bytes=fwd_bytes)
  t_bound, by = bound(cells * BWD_OPS_PER_CELL, bwd_bytes, 'float32')
  out['K12'] = dict(
      max_abs_err=err12, ms=cuda_ms(k12), plain_ms=cuda_ms(k12_plain),
      library_ms=None, bound_ms=t_bound, bound_by=by,
      serial_floor_ms=cuda_ms(lambda: k12(*one, rows1, grad[:1])),
      flops=cells * BWD_OPS_PER_CELL, bytes=bwd_bytes)
  return out


def counted_modules():
  """Kernel name -> (module, launch counter attribute)."""
  from deepconsensus_tpu_torch.ops import fused_encoder_block as feb
  from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
  from deepconsensus_tpu_torch.ops import output_plane
  from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa
  from deepconsensus_tpu_torch.ops import wavefront_cuda

  return {'K1': (fwa, 'n_launches'), 'K2': (feb, 'n_launches'),
          'K3': (output_plane, 'n_launches'), 'K4': (rwa, 'n_launches'),
          'K11': (wavefront_cuda, 'n_fwd_launches'),
          'K12': (wavefront_cuda, 'n_bwd_launches')}


def reset_launches() -> None:
  for mod, attr in counted_modules().values():
    setattr(mod, attr, 0)


def read_launches() -> dict:
  return {k: getattr(mod, attr) for k, (mod, attr) in
          counted_modules().items()}


# The kernels each path must launch.
PATH_KERNELS = {'L100': ('K1', 'K2', 'K3'), 'ragged': ('K4', 'K2', 'K3'),
                'train': ('K11', 'K12')}
RUN_PATHS = ('L100', 'ragged')
RAGGED_FLAGS = ('--use_ccs_smart_windows', '--window_buckets',
                ','.join(map(str, BUCKETS)), '--use_ragged_kernel')


def run_main_path(path: str, bams, weights, dtype: str, plain: bool = False):
  """One `run` over the synthetic BAMs on one path ('L100' or
  'ragged'); returns (counters, launch counts, delivered-position ids
  and quals, per-pack lengths, seconds, peak bytes)."""
  import numpy as np
  import torch

  from deepconsensus_tpu_torch import cli
  from deepconsensus_tpu_torch.inference import runner as runner_lib

  ragged = path == 'ragged'
  params_path = os.path.join(WORK, f'params_{dtype}.json')
  with open(params_path, 'w') as f:
    json.dump(make_params(dtype).to_dict(), f)
  out = os.path.join(
      WORK, f'out_{path}_{dtype}{"_plain" if plain else ""}.fastq')
  planes = []
  predict = runner_lib.ModelRunner.predict
  predict_ragged = runner_lib.ModelRunner.predict_ragged

  def recording_predict(self, rows):
    ids, quals = predict(self, rows)
    planes.append((np.array(ids), np.array(quals), None))
    return ids, quals

  def recording_predict_ragged(self, rows, lengths):
    ids, quals = predict_ragged(self, rows, lengths)
    planes.append((np.array(ids), np.array(quals), np.array(lengths)))
    return ids, quals

  argv = ['run', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
          '--weights', weights, '--params', params_path, '--output', out,
          '--batch_size', str(BATCH), '--batch_zmws', str(N_ZMWS),
          '--min_quality', '0', '--skip_windows_above', '0']
  if ragged:
    argv += RAGGED_FLAGS
  runner_lib.ModelRunner.predict = recording_predict
  runner_lib.ModelRunner.predict_ragged = recording_predict_ragged
  torch.cuda.reset_peak_memory_stats()
  reset_launches()
  t0 = time.perf_counter()
  try:
    if plain:
      from deepconsensus_tpu_torch.models import config as config_lib
      from deepconsensus_tpu_torch.models import weights as weights_lib

      params = config_lib.read_params_from_json(params_path)
      options = runner_lib.InferenceOptions(
          batch_size=BATCH, batch_zmws=N_ZMWS, min_quality=0,
          skip_windows_above=0, use_ccs_smart_windows=ragged,
          window_buckets=BUCKETS if ragged else None,
          use_ragged_kernel=ragged)
      runner = runner_lib.ModelRunner(
          params, weights_lib.from_flax_params(
              weights_lib.load_npz(weights), params),
          options, plain=True)
      runner_lib.run_inference(bams[0], bams[1], out, runner)
    elif cli.main(argv) != 0:
      raise AssertionError(f'cli run failed ({path}, {dtype})')
  finally:
    runner_lib.ModelRunner.predict = predict
    runner_lib.ModelRunner.predict_ragged = predict_ragged
  seconds = time.perf_counter() - t0
  launches = read_launches()
  with open(out + '.inference.json') as f:
    counters = json.load(f)
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
  print(json.dumps({'phase': 'gates', 'path': path, **gates}), flush=True)
  for ok, message in checks:
    if not ok:
      raise AssertionError(f'{path}: {message}')
  return gates


def run_train_path(shards, dtype: str, plain: bool = False) -> dict:
  """One `cli train` epoch over the synthetic shards (plain: the same
  through run_training with the plain DP); returns the run's launches,
  per-step losses and gradient norms, eval metrics and summary."""
  from deepconsensus_tpu_torch import cli
  from deepconsensus_tpu_torch.models import config as config_lib
  from deepconsensus_tpu_torch.models import train as train_lib

  out = os.path.join(WORK, f'train_{dtype}{"_plain" if plain else ""}')
  shutil.rmtree(out, ignore_errors=True)
  overrides = {'dtype': dtype, 'log_every_n_steps': 1}
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
      *(a for k, v in overrides.items() for a in ('--set', f'{k}={v}'))
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


def train_gates(runs) -> dict:
  """The train path's gates; raises on a failed one."""
  steps = TRAIN_EXAMPLES // TRAIN_BATCH
  eval_batches = EVAL_EXAMPLES // TRAIN_BATCH
  f32, plain, bf16 = runs['float32'], runs['float32_plain'], runs['bfloat16']
  rel = [abs(a - b) / abs(b) for a, b in zip(f32['losses'], plain['losses'])]
  gates = {
      'steps': {k: len(r['losses']) for k, r in runs.items()},
      'f32_vs_plain_max_rel_loss_diff': max(rel),
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
      (all(runs[k]['launches']['K11'] == steps + eval_batches
           and runs[k]['launches']['K12'] == steps
           for k in ('bfloat16', 'float32')),
       'K11/K12 did not launch once per step (and K11 per eval batch)'),
      (plain['launches']['K11'] == plain['launches']['K12'] == 0,
       'the plain run launched the DP kernels'),
      (gates['f32_vs_plain_max_rel_loss_diff'] <= 1e-4,
       'f32 kernels vs plain DP: a step loss differs by > 1e-4 relative'),
      (gates['bf16_vs_f32_first_loss_rel_diff'] <= 0.02,
       'bf16 vs f32: the first loss differs by > 2%'),
  ]
  print(json.dumps({'phase': 'gates', 'path': 'train', **gates}), flush=True)
  for ok, message in checks:
    if not ok:
      raise AssertionError(f'train: {message}')
  return gates


def train_step_breakdown(dtype: str, steps: int = 5) -> dict:
  """Phase 4 for one dtype: one full-width batch of TRAIN_BATCH seeded
  windows, the training step split into its stages, then one step
  under torch.profiler."""
  import numpy as np
  import torch
  from torch.profiler import ProfilerActivity, profile

  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.models import train as train_lib

  dev = torch.device('cuda')
  params = make_params(dtype)
  model = model_lib.DeepConsensusModel(params, device=dev)
  model.init_weights(torch.Generator().manual_seed(SEED))
  model.requires_grad_(True)
  lamb = train_lib.Lamb(model.named_parameters(), params, 100)
  loss_fn = train_lib.make_loss(params)
  rng = np.random.default_rng(SEED + 3)
  batch = train_lib.batch_to_device({
      'rows': fake_rows(params, rng, TRAIN_BATCH),
      'label': rng.integers(0, 5, (TRAIN_BATCH, LENGTH)).astype(np.float32),
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
      'top_kernels_ms': [[e.key[:100], e.self_device_time_total / 1e3,
                          e.count] for e in top],
  }


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

  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.models import weights as weights_lib
  from deepconsensus_tpu_torch.ops import _build
  from deepconsensus_tpu_torch.ops import _kernels
  from deepconsensus_tpu_torch.testing import synthetic

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
  print(json.dumps({
      'phase': 'attention_smem', 'block_limit_bytes': 232448,
      'dynamic_smem_bytes': {
          length: _kernels.attention_smem_bytes(
              length, p.hidden_size, p.num_heads, p.attn_win_size)
          for length in (LENGTH, SLOT_LEN, 256)}}), flush=True)

  kernels = {}
  for dtype in ('float32', 'bfloat16'):
    result = check_kernels(dtype)
    result.update(check_ragged_kernels(dtype))
    for name, r in result.items():
      print(json.dumps({'phase': 'kernel', 'kernel': name, 'dtype': dtype,
                        **r}), flush=True)
    kernels[dtype] = result
  dp_kernels = check_wavefront_kernels()
  for name, r in dp_kernels.items():
    print(json.dumps({'phase': 'kernel', 'kernel': name, 'dtype': 'float32',
                      **r}), flush=True)
  if kernels_only:
    return 0

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

  launches_by_path = {}
  for path in RUN_PATHS:
    path_kernels = PATH_KERNELS[path]
    runs = {}
    for dtype, plain in (('bfloat16', False), ('float32', False),
                         ('float32', True)):
      counters, launches, ids, quals, lengths, seconds, peak = run_main_path(
          path, bams[path], weights, dtype, plain)
      label = dtype + ('_plain' if plain else '')
      runs[label] = (counters, launches, ids, quals, lengths)
      n_win = counters['n_windows_to_model']
      print(json.dumps({
          'phase': 'main_path', 'path': path, 'run': label,
          'launches': launches, 'reads': counters['success'],
          'windows': n_win, 'packs': counters['n_model_packs'],
          'windows_by_bucket': counters['n_windows_by_bucket'],
          'pad_rows': counters['n_model_pad_rows'], 'seconds': seconds,
          'windows_per_s': n_win / counters['total_seconds'],
          'model_windows_per_s': n_win / counters['model_seconds'],
          'model_seconds': counters['model_seconds'],
          'featurize_seconds': counters['featurize_seconds'],
          'peak_bytes': peak}), flush=True)
      if counters['success'] != N_ZMWS:
        raise AssertionError(f'{path} {label}: {counters["success"]} reads, '
                             f'want {N_ZMWS}')
      if not plain and not all(launches[k] for k in path_kernels):
        raise AssertionError(
            f'{path} {label}: a kernel of the path never launched: '
            f'{launches}')
    path_gates(path, runs)
    launches_by_path[path] = runs['bfloat16'][1]

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
  for dtype in ('bfloat16', 'float32'):
    print(json.dumps({'phase': 'train_breakdown', 'dtype': dtype,
                      **train_step_breakdown(dtype)}), flush=True)

  sources = {
      'K1': ('deepconsensus_tpu_torch/csrc/embed_condense.cu',
             'deepconsensus_tpu/ops/fused_window_attention.py:349', 'L100'),
      'K2': ('deepconsensus_tpu_torch/csrc/gemm.cu',
             'deepconsensus_tpu/ops/fused_encoder_block.py:264', 'L100'),
      'K3': ('deepconsensus_tpu_torch/csrc/phred_epilogue.cu',
             'deepconsensus_tpu/ops/output_plane.py:236', 'L100'),
      'K4': ('deepconsensus_tpu_torch/csrc/ragged_attention.cu',
             'deepconsensus_tpu/ops/ragged_window_attention.py:320',
             'ragged'),
  }
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
    if name == 'K2':  # its lengths variant, on the ragged path
      lv = kernels['bfloat16']['K2_lengths']
      entry.update({f'lengths_{k}': lv[k] for k in (
          'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'library_ms')})
      entry['lengths_float32_ms'] = kernels['float32']['K2_lengths']['ms']
    line.append(entry)
  for name, replaces in (('K11', 'deepconsensus_tpu/ops/wavefront_pallas.py:231'),
                         ('K12', 'deepconsensus_tpu/ops/wavefront_pallas.py:487')):
    r = dp_kernels[name]
    line.append({
        'name': name, 'route': 'cuda',
        'source': 'deepconsensus_tpu_torch/csrc/wavefront.cu',
        'replaces': replaces, 'launches': launches_by_path['train'][name],
        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
        'bound_by': r['bound_by'], 'library_ms': None, 'dtype': 'float32',
        'status': 'ported', 'path': 'train',
        'launches_by_path': {k: v[name] for k, v in launches_by_path.items()},
        'serial_floor_ms': r['serial_floor_ms'],
        **({'no_rows_ms': r['no_rows_ms']} if name == 'K11' else {})})
  print(json.dumps({'kernels': line}))
  print(card_line())
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
