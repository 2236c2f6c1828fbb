#!/usr/bin/env python3
"""Where K8's and K10's time goes: times copies of
csrc/flash_band_attention.cu (with csrc/band_tiles.cuh, the header of
its tiles) with a phase removed.

  python3 scripts/probe_flash_kernels.py

Builds, beside the repository's kernels: `stage_only` (no chunk is
computed: the staging ring, its barriers and the output stores alone)
and `no_pv` (S and the softmax, no P v / w^T do / ds^T q products: the
weights are kept alive by a store that never fires). Each is timed
with CUDA events (20 launches after 3) at train_flash's 256 windows x
200, 2 heads of 140, band 12, in bf16 and float32, on inputs drawn from
a seed; K10 on the repository's lse. Three more copies of
`stage_only`: without the output stores, with 4-byte copies (bf16 rows
of 140 at head 1 are 8-byte aligned: the kernels copy 8 bytes), and
with a ring of 6 stages (every chunk of band 12 in flight at once).
The copies compute wrong outputs: they are for timing only. Prints the
card's name and power limit, each copy's registers and spills, and one
line per copy, kernel and dtype; with no CUDA device it exits 2.
"""
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, 'deepconsensus_tpu_torch', 'csrc')
# The kernels' source and the header of their tiles, patched together.
SOURCES = ('flash_band_attention.cu', 'band_tiles.cuh')

SKIP = '    if (c < blk.c_lo || c > blk.c_hi) continue;'
FWD_PV = """      mma_pair<PP, AP>(acc[d], acc[d + 1], pa, vs, ldv, 8 * (blk.dt0 + d),
                       lane);"""
FWD_NO_PV = '      if (pa[0][0] == 0x12345678u) acc[d][0] += 1.f;'
DKDV_V = """      mma_pair<PP, AP>(acc_v[d], acc_v[d + 1], a, os, ld, 8 * (blk.dt0 + d),
                       lane);"""
DKDV_NO_V = '      if (a[0][0] == 0x12345678u) acc_v[d][0] += 1.f;'
DKDV_K = """      mma_pair<PP, AP>(acc_k[d], acc_k[d + 1], a, qs, ld, 8 * (blk.dt0 + d),
                       lane);"""
DKDV_NO_K = '      if (a[0][0] == 0x12345678u) acc_k[d][0] += 1.f;'
FWD_STORE = '    if (i >= L) continue;\n    const float denom'
DKDV_STORE = '    if (j >= L) continue;\n    const int64_t off'
COPIES = {
    'full': [],
    'stage_only': [(SKIP, '    continue;')],
    'no_pv': [(FWD_PV, FWD_NO_PV), (DKDV_V, DKDV_NO_V), (DKDV_K, DKDV_NO_K)],
    'stage_only_no_store': [(SKIP, '    continue;')] + [
        (x, x.replace('>= L', '>= 0')) for x in (FWD_STORE, DKDV_STORE)],
    'stage_only_4_byte_copies': [(SKIP, '    continue;'),
                                 ('copy_bytes<T>(D, {q, k, v})', '4'),
                                 ('copy_bytes<T>(D, {q, k, v, dout})', '4')],
    'stage_only_6_stages': [(SKIP, '    continue;'),
                            ('kFwdStages = 3;', 'kFwdStages = 6;'),
                            ('sizeof(T) == 4 ? 2 : 3;', 'sizeof(T) == 4 ? 2 : 6;')],
}


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print('probe_flash_kernels: no CUDA device', file=sys.stderr)
    return 2
  sys.path.insert(0, REPO)
  from deepconsensus_tpu_torch.ops import _build

  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip(), flush=True)
  sources = {}
  for file in SOURCES:
    with open(os.path.join(CSRC, file)) as f:
      sources[file] = f.read()
  out_dir = os.path.join(REPO, 'build', 'probe_flash_kernels')
  procs = {}
  for name, patches in COPIES.items():
    texts = dict(sources)
    for old, new in patches:
      if not any(old in text for text in texts.values()):
        raise SystemExit(f'{name}: the sources no longer hold {old!r}')
      texts = {f: text.replace(old, new) for f, text in texts.items()}
    # A directory a copy: the copied source includes the copied header.
    copy_dir = os.path.join(out_dir, name)
    os.makedirs(copy_dir, exist_ok=True)
    for file, text in texts.items():
      with open(os.path.join(copy_dir, file), 'w') as f:
        f.write(text)
    procs[name] = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, '-I', CSRC, '-o',
         os.path.join(out_dir, f'lib{name}.so'),
         os.path.join(copy_dir, SOURCES[0])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
  libs = {}
  sigs = _build.SIGNATURES['flash_band_attention']
  for name, proc in procs.items():
    log = proc.communicate()[0].decode()
    if proc.returncode:
      raise SystemExit(f'nvcc failed for {name}:\n{log[-3000:]}')
    print(name, ' '.join(line.strip() for line in log.splitlines()
                         if 'registers' in line or 'spill' in line),
          flush=True)
    lib = ctypes.CDLL(os.path.join(out_dir, f'lib{name}.so'))
    for fn_name in ('dc_flash_band_fwd', 'dc_flash_band_dkdv'):
      getattr(lib, fn_name).argtypes = sigs[fn_name]
      getattr(lib, fn_name).restype = ctypes.c_int
    libs[name] = lib
  dev = torch.device('cuda')
  batch, length, heads, d, win = 256, 200, 2, 140, 12
  stream = _build.stream_ptr(dev)
  ptr = _build.ptr
  for dtype in (torch.bfloat16, torch.float32):
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn((batch, length, heads, d), generator=gen,
                               device=dev).to(dtype) for _ in range(4))
    q = (q * d ** -0.5).contiguous()
    o, dk, dv = (torch.empty_like(q) for _ in range(3))
    lse = torch.empty((batch, heads, length), device=dev)
    dims = (int(dtype == torch.bfloat16), batch, length, heads, d, win)
    _build.check(libs['full'].dc_flash_band_fwd(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), *dims, stream), 'lse')
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    for name, lib in libs.items():
      calls = {
          'K8': lambda lib=lib: lib.dc_flash_band_fwd(
              ptr(q), ptr(k), ptr(v), ptr(o), None, *dims, stream),
          'K10': lambda lib=lib: lib.dc_flash_band_dkdv(
              ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta),
              ptr(dk), ptr(dv), *dims, stream)}
      for kernel, call in calls.items():
        for _ in range(3):
          _build.check(call(), name)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
          call()
        end.record()
        torch.cuda.synchronize()
        print(f'{str(dtype).split(".")[-1]} {kernel} {name}: '
              f'{start.elapsed_time(end) / 20:.4f} ms', flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
