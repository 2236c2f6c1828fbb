#!/usr/bin/env python3
"""Where the attention core's time goes: times copies of
csrc/ragged_attention.cu with one phase of its resident kernel removed.

  python3 scripts/probe_attention_core.py

Builds, beside the repository's core, copies with: no S (the logits come
from the prefetched q fragments and a shared-memory read, no MMA), no P v
(no v loads, MMAs or stores; the S phase is kept alive by a store that
never fires), and neither (the K staging, q loads and softmax alone).
Each is timed with CUDA events (30 launches after 3) at 1,024 windows x
100, 2 heads of 140, band 12, in both softmax dtypes, on q/k/v drawn
from a seed. The copies compute wrong outputs: they are for timing only.
Prints the card's name and power limit and one line per copy and dtype;
with no CUDA device it exits 2.
"""
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, 'deepconsensus_tpu_torch', 'csrc')

S_PHASE = """  s_tiles<kNT, kVec>(s, qb, ks, kld, 16 * T.c0, rows, T.qr[0], T.qr[1], hd,
                     dpad / 16, g, t);"""
NO_S = """#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
    for (int e = 0; e < 4; ++e) s[nt][e] = qb[nt % 3][e].x + ks[nt * 16 + lane];"""
PV_PHASE = "  const int n_dt = dpad / 8;  // even"
NO_PV = """  if (T.orow[0] && a[0][0][0] == 0x12345678u) T.orow[0][0] = z[0];
  const int n_dt = 0;"""
COPIES = {
    'core': [],
    'no_s': [(S_PHASE, NO_S)],
    'no_pv': [(PV_PHASE, NO_PV)],
    'no_s_no_pv': [(S_PHASE, NO_S), (PV_PHASE, NO_PV)],
}


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print('probe_attention_core: no CUDA device', file=sys.stderr)
    return 2
  sys.path.insert(0, REPO)
  from deepconsensus_tpu_torch.ops import _build

  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip(), flush=True)
  with open(os.path.join(CSRC, 'ragged_attention.cu')) as f:
    source = f.read()
  out_dir = os.path.join(REPO, 'build', 'probe_attention_core')
  os.makedirs(out_dir, exist_ok=True)
  procs = {}
  for name, patches in COPIES.items():
    text = source
    for old, new in patches:
      if old not in text:
        raise SystemExit(f'{name}: the source no longer holds {old!r}')
      text = text.replace(old, new)
    path = os.path.join(out_dir, f'{name}.cu')
    with open(path, 'w') as f:
      f.write(text)
    procs[name] = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, '-I', CSRC, '-o',
         os.path.join(out_dir, f'lib{name}.so'), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
  fns = {}
  p, i = ctypes.c_void_p, ctypes.c_int
  for name, proc in procs.items():
    log = proc.communicate()[0].decode()
    if proc.returncode:
      raise SystemExit(f'nvcc failed for {name}:\n{log[-3000:]}')
    fn = ctypes.CDLL(os.path.join(out_dir, f'lib{name}.so')).dc_attention
    fn.argtypes = (p, p, i, p, i, i, i, i, i, i, i, p)
    fn.restype = i
    fns[name] = fn
  dev = torch.device('cuda')
  batch, length, hidden, heads, win = 1024, 100, 280, 2, 12
  gen = torch.Generator().manual_seed(0)
  qkv = torch.randn(batch * length, 3 * hidden, generator=gen).to(dev)
  qkv[:, :hidden] *= (hidden // heads) ** -0.5
  out = torch.empty((batch * length, hidden), device=dev)
  stream = _build.stream_ptr(dev)
  for bf16 in (0, 1):
    for name, fn in fns.items():
      def call():
        _build.check(fn(_build.ptr(qkv), None, 0, _build.ptr(out), batch,
                        length, hidden, heads, win, bf16, 1, stream), name)
      for _ in range(3):
        call()
      torch.cuda.synchronize()
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(30):
        call()
      end.record()
      torch.cuda.synchronize()
      print(f'{"bfloat16" if bf16 else "float32"} softmax {name}: '
            f'{start.elapsed_time(end) / 30:.4f} ms', flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
