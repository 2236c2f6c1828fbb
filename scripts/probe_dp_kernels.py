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


def build(name: str, source: str) -> ctypes.CDLL:
  from deepconsensus_tpu_torch.ops import _build

  os.makedirs(OUT, exist_ok=True)
  path = os.path.join(OUT, f'{name}.cu')
  with open(path, 'w') as f:
    f.write(source)
  lib = os.path.join(OUT, f'lib{name}.so')
  subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-I', str(_build.CSRC),
                  '-o', lib, path], check=True, capture_output=True)
  return ctypes.CDLL(lib)


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
  chain = build('chain', CHAIN % {'functions': functions})
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

  libs = {'as_is': source}
  for name, cuts in CUTS.items():
    text = source
    for old, new in cuts:
      if old not in text:
        raise RuntimeError(f'{name}: the text to cut is gone from wavefront.cu')
      text = text.replace(old, new)
    libs[name] = text
  for name in libs:
    lib = build(name, libs[name])
    for fn, types in _build.SIGNATURES['wavefront'].items():
      getattr(lib, fn).argtypes = types
      getattr(lib, fn).restype = ctypes.c_int
    libs[name] = lib
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
  print(card, flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
