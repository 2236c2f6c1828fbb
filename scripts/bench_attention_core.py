#!/usr/bin/env python3
"""Times the port's attention core (csrc/ragged_attention.cu) on one GPU,
against an earlier version of the same source and against PyTorch's
scaled_dot_product_attention with the band as its mask.

  python3 scripts/bench_attention_core.py [--parent DIR]

DIR is an unpacked checkout of an earlier commit (for example
`git archive <commit> | tar -x -C DIR`); its csrc/ragged_attention.cu is
built with the same nvcc flags and called through its own C interface
(qkv, lengths, wps, out, B, L, H, heads, win, stream: a float32 softmax
only). Shapes: the main path's 1,024 windows x 100 (band 12) and 512
ragged slots x 200 (band 12; one 200, two 100s, a lone 100, empty), two
heads of 140, q/k/v drawn from a seed. The two versions are timed in
turns (parent, new, new, parent) with CUDA events, 20 launches each
after a warmup. Prints one JSON line per shape and the card's name and
power limit; with no CUDA device it exits 2.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed(fn, iters=20, warmup=3) -> float:
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


def build_parent(parent: str):
  """The parent's attention core as a ctypes function (its own
  signature, every pointer and the stream as c_void_p)."""
  from deepconsensus_tpu_torch.ops import _build

  src = os.path.join(parent, 'deepconsensus_tpu_torch', 'csrc',
                     'ragged_attention.cu')
  out = os.path.join(REPO, 'build', 'bench_attention_core',
                     'libparent_attention.so')
  os.makedirs(os.path.dirname(out), exist_ok=True)
  subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-I',
                  os.path.dirname(src), '-o', out, src], check=True,
                 capture_output=True)
  fn = ctypes.CDLL(out).dc_attention
  p, i = ctypes.c_void_p, ctypes.c_int
  fn.argtypes = (p, p, i, p, i, i, i, i, i, p)
  fn.restype = i
  return fn


def main(argv) -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument('--parent', help='unpacked checkout of an earlier '
                      'commit whose attention core to time beside this one')
  args = parser.parse_args(argv)
  import torch

  if not torch.cuda.is_available():
    print('bench_attention_core: no CUDA device', file=sys.stderr)
    return 2
  sys.path.insert(0, REPO)
  import torch.nn.functional as F

  from deepconsensus_tpu_torch.ops import _build
  from deepconsensus_tpu_torch.ops import _kernels
  from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa

  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip()
  print(card, flush=True)
  parent = build_parent(args.parent) if args.parent else None
  dev = torch.device('cuda')
  hidden, heads, win = 280, 2, 12
  head_dim = hidden // heads
  gen = torch.Generator().manual_seed(0)
  for name, batch, length, ragged in (('L100', 1024, 100, False),
                                      ('ragged200', 512, 200, True)):
    qkv = torch.randn(batch * length, 3 * hidden, generator=gen).to(dev)
    qkv[:, :hidden] *= head_dim ** -0.5
    out = torch.empty((batch * length, hidden), device=dev)
    lengths = None
    if ragged:
      widths = [[200, 0], [100, 100], [100, 0], [0, 0]] * (batch // 4)
      lengths = torch.tensor(widths, dtype=torch.int32, device=dev)
    mask = (rwa.ragged_attention_mask(lengths, length, win)[:, None]
            if ragged else
            (torch.arange(length, device=dev)[:, None]
             - torch.arange(length, device=dev)[None, :]).abs() <= win)
    q, k, v = (t.reshape(batch, length, heads, head_dim).transpose(1, 2)
               for t in qkv.split(hidden, dim=1))

    def new(sdt):
      return lambda: _kernels.attention(
          qkv, out, batch=batch, length=length, num_heads=heads, win=win,
          lengths=lengths, softmax_dtype=sdt)

    row = {'shape': name, 'batch': batch, 'length': length, 'win': win}
    # Bytes the core must move: qkv in and o out once (and the lengths).
    nbytes = qkv.numel() * 4 + out.numel() * 4 + (
        lengths.numel() * 4 if ragged else 0)
    row['bound_ms'] = nbytes / 3.35e12 * 1e3
    if parent is not None:
      stream = _build.stream_ptr(dev)

      def old():
        _build.check(parent(
            _build.ptr(qkv), _build.ptr(lengths),
            0 if lengths is None else lengths.shape[1], _build.ptr(out),
            batch, length, hidden, heads, win, stream), 'parent attention')

      turns = [timed(old), timed(new(torch.float32)), timed(new(torch.float32)),
               timed(old)]
      row.update(parent_ms=[turns[0], turns[3]], ms=[turns[1], turns[2]])
    else:
      row['ms'] = [timed(new(torch.float32))]
    row['bf16_softmax_ms'] = timed(new(torch.bfloat16))
    row['sdpa_ms'] = timed(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=1.0))
    print(json.dumps(row), flush=True)
  print(card)
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
