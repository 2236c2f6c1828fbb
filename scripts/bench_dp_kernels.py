#!/usr/bin/env python3
"""Times the port's alignment-DP kernels K11 (csrc/wavefront.cu's
forward, with and without its rows) and K12 (its backward) on one GPU,
against an earlier version of the same source, and tries each geometry.

  python3 scripts/bench_dp_kernels.py [--parent DIR]

DIR is an unpacked checkout of an earlier commit (for example
`git archive <commit> | tar -x -C DIR`); its csrc/wavefront.cu is built
with the same nvcc flags and called through the same C interface, on the
same inputs. Shapes: the train path's 256 x 100 x 100, train_flash's
256 x 200 x 200 and long_window's 256 x 500 x 500 float32 costs, and one
batch row of each; costs U(0, 8), lengths U[m/2, m] with 0 and m among
them, del 10, loss_reg 0.1, from a seed (as chip_smoke.py draws them).
K12 runs on this checkout's rows (the layout, [m+n+1, B, m+1], is the
parent's). The two versions are timed in turns (parent, new, new,
parent) with CUDA events, 20 launches each after a warmup. Then each
geometry that fits eight warps (1, 2 or 4 cells a lane) is timed from a
copy of this checkout's wavefront.cu whose default_cells_per_lane
returns that number, with the dynamic shared memory it launches with
(the kernel's host-side formula, repeated below). Each row carries the
bytes bound (each input read once, each output written once, at 3.35
TB/s) and the largest |new - parent| of every output. The banded DP's
rows follow: K13 (with and without rows) and K14 on train_band's 256 x
100 costs at band 12 (one slot a lane), on one batch row of them (length
m: the chain's floor), and at bands 40 and 100 (4 and 8 slots a lane),
timed against the parent in the same turns; their bytes count the band's
cells of subs. Prints nvcc's register and shared-memory report for
wavefront.cu, one JSON line per row, and the card's name and power limit
first and last; with no CUDA device it exits 2.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from typing import Dict, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES = 3.35e12
SHAPES = (('train', 256, 100), ('train_flash', 256, 200),
          ('long_window', 256, 500))
# Banded rows: (name, batch rows, m, band width).
BAND_SHAPES = (('train_band', 256, 100, 12), ('train_band', 1, 100, 12),
               ('band_40', 256, 100, 40), ('band_100', 256, 100, 100))
DEL_COST, LOSS_REG, SEED = 10.0, 0.1, 22


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


OUT = os.path.join(REPO, 'build', 'bench_dp_kernels')
CELLS = (1, 2, 4)


def build_libs(parent: Optional[str]) -> Dict[str, ctypes.CDLL]:
  """The parent's wavefront library (if given) and one copy of this
  checkout's per geometry, `cells_C`, built by parallel nvcc runs."""
  from deepconsensus_tpu_torch.ops import _build

  os.makedirs(OUT, exist_ok=True)
  source = open(os.path.join(_build.CSRC, 'wavefront.cu')).read()
  choice = re.compile(r'int default_cells_per_lane\(int m\) \{.*?\n\}\n',
                      re.S)
  if not choice.search(source):
    raise RuntimeError('default_cells_per_lane is gone from wavefront.cu')
  sources = {}
  for cells in CELLS:
    path = os.path.join(OUT, f'cells_{cells}.cu')
    with open(path, 'w') as f:
      f.write(choice.sub(
          f'int default_cells_per_lane(int) {{ return {cells}; }}\n', source))
    sources[f'cells_{cells}'] = path
  if parent:
    sources['parent'] = os.path.join(parent, 'deepconsensus_tpu_torch',
                                     'csrc', 'wavefront.cu')
  procs = {
      name: subprocess.Popen(
          [_build.nvcc_path(), *_build.NVCC_FLAGS, '-I',
           os.path.dirname(src), '-I', str(_build.CSRC), '-o',
           os.path.join(OUT, f'lib{name}.so'), src],
          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
      for name, src in sources.items()}
  libs = {}
  for name, proc in procs.items():
    _, err = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f'nvcc {name}: {err.decode()[-2000:]}')
    lib = ctypes.CDLL(os.path.join(OUT, f'lib{name}.so'))
    for fn, types in _build.SIGNATURES['wavefront'].items():
      getattr(lib, fn).argtypes = types
      getattr(lib, fn).restype = ctypes.c_int
    libs[name] = lib
  return libs


def smem_bytes(m: int, cells: int, bwd: bool) -> Optional[int]:
  """wavefront.cu's dynamic shared memory for K11 (bwd False) or K12 at m
  with `cells` cells a lane (dp_warps, tile_floats, dp_stages and
  dp_smem_bytes there), or None where the geometry needs more than eight
  warps."""
  tile, pitch, ring, max_warps = 8, 9, 32, 8
  link = 4 + 4 * ring
  warps = (m + 32 * cells) // (32 * cells)
  if warps > max_warps:
    return None
  floats = (32 * cells * pitch + 32 * cells + tile
            + ((tile + 1) * (32 * cells + 1) if bwd else 0) + 3) // 4 * 4
  stages = next((s for s in (4, 3)
                 if (warps - 1) * link + warps * s * floats <= 25 * 1024), 2)
  return ((warps - 1) * link + warps * stages * floats) * 4


def costs(batch, m, n, seed):
  import numpy as np
  import torch

  rng = np.random.default_rng(seed)
  lens = rng.integers(m // 2, m + 1, batch).astype(np.int32)
  lens[:2] = (0, m)[:batch]
  dev = torch.device('cuda')
  return (torch.from_numpy(rng.uniform(0, 8, (batch, m, n)).astype(
      np.float32)).to(dev),
          torch.from_numpy(rng.uniform(0, 8, (batch, n)).astype(
              np.float32)).to(dev),
          torch.from_numpy(lens).to(dev),
          torch.from_numpy(rng.uniform(0.5, 2, batch).astype(
              np.float32)).to(dev))


def diff(a, b) -> float:
  return float((a.double() - b.double()).abs().max())


def main(argv) -> int:
  parser = argparse.ArgumentParser()
  parser.add_argument('--parent', help='unpacked checkout of an earlier '
                      'commit whose DP kernels to time beside these')
  args = parser.parse_args(argv)
  import torch

  if not torch.cuda.is_available():
    print('bench_dp_kernels: no CUDA device', file=sys.stderr)
    return 2
  sys.path.insert(0, REPO)
  from deepconsensus_tpu_torch.ops import _build

  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip()
  print(card, flush=True)
  new = _build.load('wavefront')
  log = _build.build_all()['wavefront'].with_suffix('.log')
  for line in log.read_text().splitlines():
    if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
      print('ptxas wavefront:', line.strip())
  libs = build_libs(args.parent)
  parent = libs.get('parent')
  stream = _build.stream_ptr(torch.device('cuda'))
  ptr = _build.ptr
  for shape, full_batch, m in SHAPES:
    for batch in (full_batch, 1):
      n = m
      subs, ins, lens, grad = costs(batch, m, n, SEED + m)
      dp = (batch, m, n, DEL_COST, LOSS_REG, 1, 1e9)
      out = {
          name: dict(scores=torch.empty(batch, device='cuda'),
                     no_rows=torch.empty(batch, device='cuda'),
                     rows=torch.empty((m + n + 1, batch, m + 1),
                                      device='cuda'),
                     d_subs=torch.empty_like(subs),
                     d_ins=torch.empty_like(ins))
          for name in ('new', 'parent')}

      def fwd(lib, name, rows):
        o = out[name]
        return lambda: _build.check(lib.dc_wavefront_fwd(
            ptr(subs), ptr(ins), ptr(lens), *dp,
            ptr(o['scores'] if rows else o['no_rows']),
            ptr(o['rows'] if rows else None), stream), f'{name} K11')

      def bwd(lib, name):
        o = out[name]
        return lambda: _build.check(lib.dc_wavefront_bwd(
            ptr(subs), ptr(ins), ptr(lens), ptr(out['new']['rows']),
            ptr(grad), *dp[:-1], ptr(o['d_subs']), ptr(o['d_ins']), stream),
            f'{name} K12')

      kernels = {'K11': lambda lib, name: fwd(lib, name, True),
                 'K11_no_rows': lambda lib, name: fwd(lib, name, False),
                 'K12': bwd}
      in_bytes = (subs.numel() + ins.numel() + lens.numel()) * 4
      rows_bytes = out['new']['rows'].numel() * 4
      nbytes = {'K11': in_bytes + batch * 4 + rows_bytes,
                'K11_no_rows': in_bytes + batch * 4,
                'K12': in_bytes + rows_bytes + batch * 4 + in_bytes
                       - lens.numel() * 4}
      # Outputs first (K12 reads the new K11's rows), then the turns.
      fwd(new, 'new', True)()
      for name, make in kernels.items():
        make(new, 'new')()
        if parent is not None:
          make(parent, 'parent')()
      torch.cuda.synchronize()
      for name, make in kernels.items():
        row = {'shape': shape, 'batch': batch, 'm': m, 'n': n,
               'kernel': name,
               'bound_ms': nbytes[name] / PEAK_BYTES * 1e3,
               'bytes': nbytes[name]}
        if parent is not None:
          times = [timed(make(lib, tag)) for lib, tag in (
              (parent, 'parent'), (new, 'new'), (new, 'new'),
              (parent, 'parent'))]
          row['ms'] = times[1:3]
          row['parent_ms'] = [times[0], times[3]]
          keys = {'K11': ('scores', 'rows'), 'K11_no_rows': ('no_rows',),
                  'K12': ('d_subs', 'd_ins')}[name]
          row['max_abs_new_minus_parent'] = {
              k: diff(out['new'][k], out['parent'][k]) for k in keys}
        else:
          row['ms'] = [timed(make(new, 'new'))]
        for cells in CELLS:
          smem = smem_bytes(m, cells, name == 'K12')
          if smem is not None:
            row[f'cells_{cells}_ms'] = timed(make(libs[f'cells_{cells}'],
                                                  'new'))
            row[f'cells_{cells}_smem_bytes'] = smem
        print(json.dumps(row), flush=True)
      del out
  band_check(new, parent, stream)
  print(card, flush=True)
  return 0


def band_check(new, parent, stream) -> None:
  """K13 (with and without rows) and K14 at BAND_SHAPES: new vs parent
  in turns (parent, new, new, parent), K14 on the new K13's rows."""
  import torch

  from deepconsensus_tpu_torch.ops import _build

  ptr = _build.ptr
  libs = [('new', new)] + ([('parent', parent)] if parent is not None else [])
  for shape, batch, m, width in BAND_SHAPES:
    subs, ins, lens, grad = costs(256, m, m, SEED)
    if batch == 1:  # the row of length m: every diagonal
      subs, ins, lens, grad = subs[1:2], ins[1:2], lens[1:2], grad[1:2]
    nd = 2 * width + 1
    dp = (batch, m, width, DEL_COST, LOSS_REG, 1, 1e9)
    out = {tag: dict(scores=torch.empty(batch, device='cuda'),
                     no_rows=torch.empty(batch, device='cuda'),
                     rows=torch.empty((2 * m - 1, batch, nd), device='cuda'),
                     d_subs=torch.empty_like(subs),
                     d_ins=torch.empty_like(ins))
           for tag, _ in libs}

    def fwd(lib, tag, rows):
      o = out[tag]
      return lambda: _build.check(lib.dc_band_fwd(
          ptr(subs), ptr(ins), ptr(lens), *dp,
          ptr(o['scores'] if rows else o['no_rows']),
          ptr(o['rows'] if rows else None), stream), f'{tag} K13')

    def bwd(lib, tag):
      o = out[tag]
      return lambda: _build.check(lib.dc_band_bwd(
          ptr(subs), ptr(ins), ptr(lens), ptr(out['new']['rows']),
          ptr(grad), *dp, ptr(o['d_subs']), ptr(o['d_ins']), stream),
          f'{tag} K14')

    kernels = {'K13': lambda lib, tag: fwd(lib, tag, True),
               'K13_no_rows': lambda lib, tag: fwd(lib, tag, False),
               'K14': bwd}
    band_subs = batch * sum(min(m - 1, i + width) - max(0, i - width) + 1
                            for i in range(m))
    in_bytes = (band_subs + ins.numel() + lens.numel()) * 4
    rows_bytes = out['new']['rows'].numel() * 4
    nbytes = {'K13': in_bytes + batch * 4 + rows_bytes,
              'K13_no_rows': in_bytes + batch * 4,
              'K14': in_bytes + rows_bytes + batch * 4
                     + (subs.numel() + ins.numel()) * 4}
    keys = {'K13': ('scores', 'rows'), 'K13_no_rows': ('no_rows',),
            'K14': ('d_subs', 'd_ins')}
    fwd(new, 'new', True)()  # the rows both K14s read
    for name, make in kernels.items():
      for tag, lib in libs:
        make(lib, tag)()
    torch.cuda.synchronize()
    for name, make in kernels.items():
      row = {'shape': shape, 'batch': batch, 'm': m, 'width': width,
             'kernel': name, 'bound_ms': nbytes[name] / PEAK_BYTES * 1e3,
             'bytes': nbytes[name]}
      if parent is not None:
        times = [timed(make(lib, tag)) for lib, tag in (
            (parent, 'parent'), (new, 'new'), (new, 'new'),
            (parent, 'parent'))]
        row['ms'] = times[1:3]
        row['parent_ms'] = [times[0], times[3]]
        row['max_abs_new_minus_parent'] = {
            k: diff(out['new'][k], out['parent'][k]) for k in keys[name]}
      else:
        row['ms'] = [timed(make(new, 'new'))]
      print(json.dumps(row), flush=True)


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
