#!/usr/bin/env python3
"""Times the port's K6 (csrc/banded_attention.cu's backward of the
banded training attention, with and without the dropout keep-mask) on
one GPU, against an earlier version of the same source, against a copy
of this one built with another block geometry, and against PyTorch's
scaled_dot_product_attention backward with the band as its mask.

  python3 scripts/bench_banded_kernels.py [--parent DIR] [--warps N,...]

DIR is an unpacked checkout of an earlier commit (for example
`git archive <commit> | tar -x -C DIR`); its csrc/banded_attention.cu is
built with the same nvcc flags and called through its own C interface
(dc_banded_attention_bwd), as this checkout's library is, on the same
inputs and output buffers. --warps (default 2,7) builds a copy of this
checkout's source for each N with kBwdWarps = N: blocks of N warps of 16
rows in place of 4 (7: the whole window at L <= 112).
Shapes, two heads of 140 as the model has: the train_attn path's 256
windows x 100 at band 12, no band at the fused route's longest window
(256 x 128) and an odd length (256 x 57, band 12); bfloat16 and float32,
with the mask (keep 0.9) and without; q/k/v/do and the mask drawn from a
seed. The parent and this checkout are timed in turns (parent, new, new,
parent) with CUDA events, 20 calls each after a warmup; beside them this
checkout's two passes each alone (dc_banded_attention_bwd_pass), the
geometry copies, and SDPA's autograd backward (dq, dk and dv; its mask
is the band, no dropout). Each row carries the bytes bound (q, k, v, do
and the mask's band read once, dq, dk, dv written once, at 3.35 TB/s),
the largest |new - parent| and |copy - new|, and the blocks an SM of
each pass in every build. Prints one JSON line per shape, dtype and
mask, and the card's name and power limit first and last; with no CUDA
device it exits 2.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES = 3.35e12
SHAPES = (('train_attn', 256, 100, 12), ('no_band_128', 256, 128, None),
          ('odd_57', 256, 57, 12))
HEADS, HEAD_DIM, KEEP = 2, 140, 0.9
OUT = os.path.join(REPO, 'build', 'bench_banded_kernels')
WARPS = 'constexpr int kBwdWarps = 4;'


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


def build(src: str, name: str, include: str) -> ctypes.CDLL:
  """src built into build/bench_banded_kernels/lib<name>.so with the
  headers of `include`, its entry points typed as this checkout's."""
  from deepconsensus_tpu_torch.ops import _build

  out = os.path.join(OUT, f'lib{name}.so')
  subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-I', include,
                  '-o', out, src], check=True, capture_output=True)
  lib = ctypes.CDLL(out)
  for fn_name, argtypes in _build.SIGNATURES['banded_attention'].items():
    fn = getattr(lib, fn_name, None)
    if fn is not None:
      fn.argtypes = argtypes
      fn.restype = ctypes.c_int
  return lib


def main(argv) -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument('--parent', help='unpacked checkout of an earlier '
                      'commit whose K6 to time beside this one')
  parser.add_argument('--warps', default='2,7',
                      help='warps a block in the geometry copies')
  args = parser.parse_args(argv)
  import torch

  if not torch.cuda.is_available():
    print('bench_banded_kernels: no CUDA device', file=sys.stderr)
    return 2
  sys.path.insert(0, REPO)
  import torch.nn.functional as F

  from deepconsensus_tpu_torch.ops import _build
  from deepconsensus_tpu_torch.ops import banded_attention as ba

  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip()
  print(card, flush=True)
  libs = {'new': _build.load('banded_attention')}
  csrc = os.path.join(REPO, 'deepconsensus_tpu_torch', 'csrc')
  os.makedirs(OUT, exist_ok=True)
  with open(os.path.join(csrc, 'banded_attention.cu')) as f:
    source = f.read()
  if WARPS not in source:
    raise SystemExit(f'the source no longer holds {WARPS!r}')
  copies = [f'warps{n}' for n in args.warps.split(',')]
  for name in copies:
    path = os.path.join(OUT, f'{name}.cu')
    with open(path, 'w') as f:
      f.write(source.replace(WARPS, f'constexpr int kBwdWarps = {name[5:]};'))
    libs[name] = build(path, name, csrc)
  if args.parent:
    parent = os.path.join(args.parent, 'deepconsensus_tpu_torch', 'csrc')
    libs['parent'] = build(os.path.join(parent, 'banded_attention.cu'),
                           'parent', parent)
  occupancy = {
      name: {f'pass{n}': [libs[name].dc_banded_attention_blocks_per_sm(
          n, is_bf16, HEAD_DIM) for is_bf16 in (0, 1)] for n in (1, 2)}
      for name in ['new'] + copies}
  print(json.dumps({'blocks_per_sm_[float32, bf16]': occupancy}),
        flush=True)
  dev = torch.device('cuda')
  ptr = _build.ptr
  for shape, batch, length, win in SHAPES:
    kwin = ba.kernel_win(length, win)
    for dtype in (torch.bfloat16, torch.float32):
      gen = torch.Generator(device=dev).manual_seed(batch + length)
      q, k, v, do = (torch.randn((batch, length, HEADS, HEAD_DIM),
                                 generator=gen, device=dev).to(dtype)
                     for _ in range(4))
      q = (q * HEAD_DIM ** -0.5).contiguous()
      keep_mask = (torch.rand((batch, HEADS, length, length), generator=gen,
                              device=dev) < KEEP).to(torch.uint8)
      band = (torch.arange(length, device=dev)[:, None]
              - torch.arange(length, device=dev)[None, :]).abs() <= kwin
      leaves = [x.detach().transpose(1, 2).requires_grad_(True)
                for x in (q, k, v)]
      sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=band,
                                                scale=1.0)
      do_t = do.transpose(1, 2)
      sdpa_ms = timed(lambda: torch.autograd.grad(sdpa_out, leaves, do_t,
                                                  retain_graph=True))
      tensor = q.numel() * q.element_size()
      for masked in (True, False):
        mask, keep = (keep_mask, KEEP) if masked else (None, 1.0)
        outs = {name: [torch.empty_like(q) for _ in range(3)]
                for name in libs}
        stats = {name: torch.empty((batch, HEADS, length, 3), device=dev)
                 for name in libs}
        tail = (int(dtype == torch.bfloat16), batch, length, HEADS, HEAD_DIM,
                kwin, _build.stream_ptr(dev))

        def call(name, n=None):
          head = (ptr(q), ptr(k), ptr(v), ptr(mask), ptr(do), float(keep),
                  *map(ptr, outs[name]), ptr(stats[name]), *tail)
          lib = libs[name]
          if n is None:
            return lambda: _build.check(lib.dc_banded_attention_bwd(*head),
                                        f'{name} K6')
          return lambda: _build.check(
              lib.dc_banded_attention_bwd_pass(n, *head), f'{name} pass {n}')

        band_bytes = int(band.sum()) * batch * HEADS if masked else 0
        entry = {'shape': shape, 'batch': batch, 'length': length,
                 'win': win, 'dtype': str(dtype).split('.')[-1],
                 'masked': masked,
                 'bound_ms': (7 * tensor + band_bytes) / PEAK_BYTES * 1e3}
        new = call('new')
        if 'parent' in libs:
          old = call('parent')
          turns = [timed(old), timed(new), timed(new), timed(old)]
          entry.update(parent_ms=[turns[0], turns[3]],
                       ms=[turns[1], turns[2]])
          entry['max_abs_diff_vs_parent'] = max(
              float((a.float() - b.float()).abs().max())
              for a, b in zip(outs['new'], outs['parent']))
        else:
          entry['ms'] = [timed(new)]
        entry['pass1_ms'] = timed(call('new', 1))
        entry['pass2_ms'] = timed(call('new', 2))
        for name in copies:
          entry[f'{name}_ms'] = timed(call(name))
          entry[f'{name}_max_abs_diff'] = max(
              float((a.float() - b.float()).abs().max())
              for a, b in zip(outs[name], outs['new']))
        entry['sdpa_bwd_ms'] = sdpa_ms
        print(json.dumps(entry), flush=True)
  print(card)
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
