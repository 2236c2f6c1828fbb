#!/usr/bin/env python3
"""Times the port's flash kernels K8 (csrc/flash_band_attention.cu's
forward, without and with its logsumexp), K9 (its dq pass) and K10 (its
dk/dv pass) on one GPU, against an earlier version of the same source
and against PyTorch's scaled_dot_product_attention with the band as its
mask.

  python3 scripts/bench_flash_kernels.py [--parent DIR]

DIR is an unpacked checkout of an earlier commit (for example
`git archive <commit> | tar -x -C DIR`); its
csrc/flash_band_attention.cu is built with the same nvcc flags and
called through its own C interface (dc_flash_band_fwd,
dc_flash_band_dq, dc_flash_band_dkdv), as this checkout's library is, on
the same inputs and output buffers. Shapes, two heads of 140 as the
model has: the train_flash path's 256 windows x 200 at band 12, the
buckets path's 200-bucket pack (1,024 x 200, band 12) and one wide band
(256 x 200, win 130); bfloat16 and float32, q/k/v/do drawn from a seed,
K9 and K10 on this checkout's lse and delta. The two versions are timed
in turns (parent, new, new, parent) with CUDA events, 20 launches each
after a warmup; SDPA's forward (K8's yardstick) and its autograd
backward (dq, dk and dv together) are timed beside them. Each row carries the bytes bound
(each input read once, each output written once, at 3.35 TB/s) and the
largest |new - parent|. Prints one JSON line per shape, dtype and
kernel, and the card's name and power limit first and last; with no
CUDA device it exits 2.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES = 3.35e12
SHAPES = (('train_flash', 256, 200, 12), ('buckets200', 1024, 200, 12),
          ('wide_band', 256, 200, 130))
HEADS, HEAD_DIM = 2, 140


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


def build_parent(parent: str) -> ctypes.CDLL:
  """The parent's flash library, its entry points typed as this
  checkout's (the C interface is unchanged)."""
  from deepconsensus_tpu_torch.ops import _build

  src = os.path.join(parent, 'deepconsensus_tpu_torch', 'csrc',
                     'flash_band_attention.cu')
  out = os.path.join(REPO, 'build', 'bench_flash_kernels',
                     'libparent_flash.so')
  os.makedirs(os.path.dirname(out), exist_ok=True)
  subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-I',
                  os.path.dirname(src), '-o', out, src], check=True,
                 capture_output=True)
  lib = ctypes.CDLL(out)
  for name in ('dc_flash_band_fwd', 'dc_flash_band_dq',
               'dc_flash_band_dkdv'):
    fn = getattr(lib, name)
    fn.argtypes = _build.SIGNATURES['flash_band_attention'][name]
    fn.restype = ctypes.c_int
  return lib


def main(argv) -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument('--parent', help='unpacked checkout of an earlier '
                      'commit whose flash kernels to time beside these')
  args = parser.parse_args(argv)
  import torch

  if not torch.cuda.is_available():
    print('bench_flash_kernels: no CUDA device', file=sys.stderr)
    return 2
  sys.path.insert(0, REPO)
  import torch.nn.functional as F

  from deepconsensus_tpu_torch.ops import _build
  from deepconsensus_tpu_torch.ops import flash_band_attention as fba

  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip()
  print(card, flush=True)
  new_lib = _build.load('flash_band_attention')
  parent = build_parent(args.parent) if args.parent else None
  dev = torch.device('cuda')
  stream = _build.stream_ptr(dev)
  ptr = _build.ptr
  for shape, batch, length, win in SHAPES:
    for dtype in (torch.bfloat16, torch.float32):
      gen = torch.Generator(device=dev).manual_seed(batch + win)
      q, k, v, do = (torch.randn((batch, length, HEADS, HEAD_DIM),
                                 generator=gen, device=dev).to(dtype)
                     for _ in range(4))
      q = (q * HEAD_DIM ** -0.5).contiguous()
      o, lse = fba.flash_band_attention(q, k, v, win, with_lse=True)
      delta = fba.row_delta(do, o)
      dims = (int(dtype == torch.bfloat16), batch, length, HEADS, HEAD_DIM,
              win)
      outs = {name: [torch.empty_like(q) for _ in range(2)]
              for name in ('new', 'parent')}
      out_lse = {name: torch.empty_like(lse) for name in ('new', 'parent')}

      def fwd(lib, name, with_lse):
        return lambda: _build.check(lib.dc_flash_band_fwd(
            ptr(q), ptr(k), ptr(v), ptr(outs[name][0]),
            ptr(out_lse[name] if with_lse else None), *dims, stream),
            f'{name} K8')

      def dq(lib, name):
        return lambda: _build.check(lib.dc_flash_band_dq(
            ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
            ptr(outs[name][0]), *dims, stream), f'{name} K9')

      def dkdv(lib, name):
        return lambda: _build.check(lib.dc_flash_band_dkdv(
            ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
            ptr(outs[name][0]), ptr(outs[name][1]), *dims, stream),
            f'{name} K10')

      tensor = q.numel() * q.element_size()
      row = lse.numel() * 4
      sdpa_in = [x.transpose(1, 2) for x in (q, k, v)]
      band = (torch.arange(length, device=dev)[:, None]
              - torch.arange(length, device=dev)[None, :]).abs() <= win
      leaves = [x.detach().requires_grad_(True) for x in sdpa_in]
      sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=band,
                                                scale=1.0)
      do_t = do.transpose(1, 2)
      sdpa = {
          'fwd': timed(lambda: F.scaled_dot_product_attention(
              *sdpa_in, attn_mask=band, scale=1.0)),
          'bwd': timed(lambda: torch.autograd.grad(
              sdpa_out, leaves, do_t, retain_graph=True))}
      for kernel, nbytes, sdpa_key, make in (
          ('K8', 4 * tensor, 'fwd', lambda lib, n: fwd(lib, n, False)),
          ('K8_lse', 4 * tensor + row, 'fwd',
           lambda lib, n: fwd(lib, n, True)),
          ('K9', 5 * tensor + 2 * row, 'bwd', dq),
          ('K10', 6 * tensor + 2 * row, 'bwd', dkdv)):
        new = make(new_lib, 'new')
        entry = {'shape': shape, 'batch': batch, 'length': length,
                 'win': win, 'dtype': str(dtype).split('.')[-1],
                 'kernel': kernel, 'bound_ms': nbytes / PEAK_BYTES * 1e3}
        if parent is not None:
          old = make(parent, 'parent')
          turns = [timed(old), timed(new), timed(new), timed(old)]
          entry.update(parent_ms=[turns[0], turns[3]],
                       ms=[turns[1], turns[2]])
          pairs = [(outs['new'][0], outs['parent'][0])]
          if kernel == 'K10':
            pairs.append((outs['new'][1], outs['parent'][1]))
          if kernel == 'K8_lse':
            pairs.append((out_lse['new'], out_lse['parent']))
          entry['max_abs_diff_vs_parent'] = max(
              float((a.float() - b.float()).abs().max()) for a, b in pairs)
        else:
          entry['ms'] = [timed(new)]
        entry['sdpa_ms' if sdpa_key == 'fwd' else 'sdpa_bwd_ms'] = (
            sdpa[sdpa_key])
        print(json.dumps(entry), flush=True)
  print(card)
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
