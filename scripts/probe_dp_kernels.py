#!/usr/bin/env python3
"""Shows what one diagonal of the alignment DP's kernels (K11, K12 in
csrc/wavefront.cu) waits on, on one GPU.

  python3 scripts/probe_dp_kernels.py

Two kinds of rows, each in nanoseconds per diagonal, with CUDA events
around 20 launches replayed from a CUDA graph:

* `chain`: one warp that only runs K11's dependent step, the soft
  minimum (logsumexp3 and soft_min3, cut from wavefront.cu so the
  arithmetic is the kernel's) or the hard one, with or without the
  shuffle that brings the neighbour's value, for 4,096 diagonals. That is
  the floor a diagonal of one warp cannot go below.
* `copies`: wavefront.cu itself, and copies of it with one part taken
  out (the cp.async staging of the costs and rows, the per-diagonal read
  of the warp-to-warp ring, the tile wait), timed on one batch row (m = n
  = 100, length m) and on train's 256 rows, K11 with rows and K12, soft
  minimum. A copy computes wrong values; only its time is read.
* `band`: the same for the banded DP (K13 with and without rows, K14) on
  one batch row and on train_band's 256 rows (m = 100, band 12), soft
  and hard minimum: wavefront.cu and copies without the feeder's
  cp.async copies, its soft-min terms (K14), its output codes (K14), its
  stores of K13's rows and K14's d_subs rows.

Prints the card's name and power limit first and last; with no CUDA
device it exits 2.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, 'build', 'probe_dp_kernels')
DIAGONALS = 4096

CHAIN = r'''
#include <cuda_runtime.h>
#include <math.h>
namespace {
%(functions)s
template <bool kSoft, bool kShuffle>
__global__ void chain(float* out, int diagonals, float reg) {
  const int lane = threadIdx.x & 31;
  const float inv_reg = 1.0f / reg;
  float v1 = lane, v2 = lane + 1.f, n1 = lane + 2.f, n2 = lane + 3.f;
  for (int k = 0; k < diagonals; ++k) {
    const float v = soft_min3(n2 + 1.f, v1 + 2.f, n1 + 3.f, reg, inv_reg,
                              kSoft);
    const float got =
        kShuffle ? __shfl_sync(0xffffffffu, v, (lane + 31) & 31) : v;
    n2 = n1;
    n1 = got;
    v2 = v1;
    v1 = v;
  }
  out[threadIdx.x] = v1 + v2;
}
}  // namespace
extern "C" int dc_chain(float* out, int diagonals, float reg, int soft,
                        int shuffle, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (soft && shuffle) chain<true, true><<<1, 32, 0, s>>>(out, diagonals, reg);
  if (soft && !shuffle) chain<true, false><<<1, 32, 0, s>>>(out, diagonals, reg);
  if (!soft && shuffle) chain<false, true><<<1, 32, 0, s>>>(out, diagonals, reg);
  if (!soft && !shuffle) chain<false, false><<<1, 32, 0, s>>>(out, diagonals, reg);
  return static_cast<int>(cudaGetLastError());
}
'''

# Copies of wavefront.cu with one part taken out: (old text, new text).
CUTS = {
    'no_staging': [('if (kb <= k_last) stage_costs<C>', 'if (false) stage_costs<C>'),
                   ('    if (kb >= kb_last) {\n      stage_costs<C>',
                    '    if (false) {\n      stage_costs<C>')],
    'no_ring_read': [('const float4 e =\n            ld_entry(has_in && lane == 0 && k <= in_last,',
                      'const float4 e =\n            ld_entry(false,'),
                     ('const float4 e =\n            ld_entry(from_in && lane == 31,',
                      'const float4 e =\n            ld_entry(false,')],
    'no_tile_wait': [('    wait_oldest_tile(stages);\n', '')],
}
BAND_CUTS = {
    'no_copies': [
        ('stage_band_costs<C>(dst, dst + T * P, sb, ib, 2 + T * (f + F * r),',
         'if (false) stage_band_costs<C>(dst, dst + T * P, sb, ib, 2 + T * (f + F * r),'),
        ('stage_band_costs<C>(dst, dst + T * P, sb, ib, kb, lane, width, m);', ''),
        ('cp_async<4>(dst + (2 * T + u) * P + G::skew(d),',
         'if (false) cp_async<4>(dst + (2 * T + u) * P + G::skew(d),')],
    'no_terms': [('''const OptionTerms w = option_terms(
          band_at(t, k - 2, d) + sc, band_at(t + 1, k - 1, d + 1) + del_cost,
          band_at(t + 1, k - 1, d - 1) + ic, inv_reg, kSoft);''',
                  'const OptionTerms w = {{sc, ic, 1.f}, 2.f, 0.5f};')],
    'no_codes': [('o[5 * P] = __int_as_float(cell);', 'o[5 * P] = -1;'),
                 ('o[6 * P] = __int_as_float(col);', 'o[6 * P] = -2;')],
    'no_outputs': [('if (with_rows) write_rows(i - S);', ''),
                   ('if (with_rows) write_rows(j);', ''),
                   ('flush_tile(i - S);', ''), ('flush_tile(j);', ''),
                   ('for (int x = m; x >= 1; --x) flush(x);', '')],
}


def graph_ms(fn, iters=20) -> float:
  """Device time of one call: `iters` calls in one CUDA graph, replayed."""
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


def build(sources: dict) -> dict:
  """name -> source text, built by parallel nvcc runs: name -> CDLL."""
  from deepconsensus_tpu_torch.ops import _build

  os.makedirs(OUT, exist_ok=True)
  procs = {}
  for name, source in sources.items():
    path = os.path.join(OUT, f'{name}.cu')
    with open(path, 'w') as f:
      f.write(source)
    procs[name] = subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, '-I', str(_build.CSRC), '-o',
         os.path.join(OUT, f'lib{name}.so'), path],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
  libs = {}
  for name, proc in procs.items():
    _, err = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f'nvcc {name}: {err.decode()[-2000:]}')
    libs[name] = ctypes.CDLL(os.path.join(OUT, f'lib{name}.so'))
  return libs


def cut(source: str, name: str, cuts) -> str:
  for old, new in cuts:
    if old not in source:
      raise RuntimeError(f'{name}: the text to cut is gone from wavefront.cu')
    source = source.replace(old, new)
  return source


def main() -> int:
  import torch

  if not torch.cuda.is_available():
    print('probe_dp_kernels: no CUDA device', file=sys.stderr)
    return 2
  sys.path.insert(0, REPO)
  from deepconsensus_tpu_torch.ops import _build

  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      check=True, capture_output=True, text=True).stdout.strip()
  print(card, flush=True)
  source = open(os.path.join(_build.CSRC, 'wavefront.cu')).read()
  functions = re.search(r'struct LogSumExp3 \{.*?\n\}\n\n__device__ '
                        r'__forceinline__ float soft_min3\(.*?\n\}\n', source,
                        re.S).group(0)
  sources = {'chain': CHAIN % {'functions': functions}, 'as_is': source}
  sources.update({name: cut(source, name, cuts)
                  for name, cuts in CUTS.items()})
  sources.update({f'band_{name}': cut(source, name, cuts)
                  for name, cuts in BAND_CUTS.items()})
  libs = build(sources)
  chain = libs.pop('chain')
  chain.dc_chain.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
  out = torch.empty(32, device='cuda')
  for soft in (1, 0):
    for shuffle in (1, 0):
      ms = graph_ms(lambda: _build.check(chain.dc_chain(
          _build.ptr(out), DIAGONALS, 0.1, soft, shuffle,
          _build.stream_ptr(out.device)), 'chain'))
      print(json.dumps({'row': 'chain', 'soft': soft, 'shuffle': shuffle,
                        'ns_per_diagonal': ms * 1e6 / DIAGONALS}), flush=True)

  for lib in libs.values():
    for fn, types in _build.SIGNATURES['wavefront'].items():
      getattr(lib, fn).argtypes = types
      getattr(lib, fn).restype = ctypes.c_int
  band_libs = {'as_is': libs['as_is']}
  band_libs.update({name[5:]: libs.pop(name) for name in list(libs)
                    if name.startswith('band_')})
  ptr = _build.ptr
  for batch in (1, 256):
    m = n = 100
    gen = torch.Generator(device='cuda').manual_seed(batch)
    subs = torch.rand((batch, m, n), generator=gen, device='cuda') * 8
    ins = torch.rand((batch, n), generator=gen, device='cuda') * 8
    lens = torch.full((batch,), m, dtype=torch.int32, device='cuda')
    grad = torch.ones(batch, device='cuda')
    scores = torch.empty(batch, device='cuda')
    rows = torch.empty((m + n + 1, batch, m + 1), device='cuda')
    d_subs, d_ins = torch.empty_like(subs), torch.empty_like(ins)
    dp = (batch, m, n, 10.0, 0.1, 1)
    row = {'row': 'copies', 'batch': batch, 'm': m, 'n': n}
    for name, lib in libs.items():
      def k11(lib=lib):
        _build.check(lib.dc_wavefront_fwd(
            ptr(subs), ptr(ins), ptr(lens), *dp, 1e9, ptr(scores), ptr(rows),
            _build.stream_ptr(subs.device)), 'K11')

      def k12(lib=lib):
        _build.check(lib.dc_wavefront_bwd(
            ptr(subs), ptr(ins), ptr(lens), ptr(rows), ptr(grad), *dp,
            ptr(d_subs), ptr(d_ins), _build.stream_ptr(subs.device)),
            'K12')

      libs['as_is'].dc_wavefront_fwd(
          ptr(subs), ptr(ins), ptr(lens), *dp, 1e9, ptr(scores), ptr(rows),
          _build.stream_ptr(subs.device))
      row[name] = {kernel: graph_ms(fn) * 1e6 / (m + n - 1)
                   for kernel, fn in (('K11', k11), ('K12', k12))}
    print(json.dumps(row), flush=True)
  for batch in (1, 256):
    m, width = 100, 12
    gen = torch.Generator(device='cuda').manual_seed(batch)
    subs = torch.rand((batch, m, m), generator=gen, device='cuda') * 8
    ins = torch.rand((batch, m), generator=gen, device='cuda') * 8
    lens = torch.full((batch,), m, dtype=torch.int32, device='cuda')
    grad = torch.ones(batch, device='cuda')
    scores = torch.empty(batch, device='cuda')
    rows = torch.empty((2 * m - 1, batch, 2 * width + 1), device='cuda')
    d_subs, d_ins = torch.empty_like(subs), torch.empty_like(ins)
    for soft in (1, 0):
      dp = (batch, m, width, 10.0, 0.1, soft, 1e9)
      row = {'row': 'band', 'batch': batch, 'm': m, 'width': width,
             'soft': soft}
      band_libs['as_is'].dc_band_fwd(ptr(subs), ptr(ins), ptr(lens), *dp,
                                     ptr(scores), ptr(rows),
                                     _build.stream_ptr(subs.device))
      for name, lib in band_libs.items():
        def k13(lib=lib, with_rows=True):
          _build.check(lib.dc_band_fwd(
              ptr(subs), ptr(ins), ptr(lens), *dp, ptr(scores),
              ptr(rows if with_rows else None),
              _build.stream_ptr(subs.device)), 'K13')

        def k14(lib=lib):
          _build.check(lib.dc_band_bwd(
              ptr(subs), ptr(ins), ptr(lens), ptr(rows), ptr(grad), *dp,
              ptr(d_subs), ptr(d_ins), _build.stream_ptr(subs.device)),
              'K14')

        row[name] = {kernel: graph_ms(fn) * 1e6 / (2 * m - 1)
                     for kernel, fn in (
                         ('K13', k13),
                         ('K13_no_rows', lambda k13=k13: k13(with_rows=False)),
                         ('K14', k14))}
      print(json.dumps(row), flush=True)
  print(card, flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
