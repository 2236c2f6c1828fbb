// K3: device output plane, softmax preds -> uint8 (base id, Phred quality).
//
// Replaces the TPU kernel
// deepconsensus_tpu/ops/output_plane.py::phred_epilogue_pallas
// (_epilogue_kernel). Per position: argmax over the vocabulary, the
// first index winning ties (and, like argmax, the first NaN), and the
// count of float32 thresholds <= the max probability. The thresholds are
// bisected on the host against the numpy quality pipeline, so the
// device evaluates no logarithm and the result is bit-exact.
//
// Bound: reads 4 * vocab bytes and writes 2 bytes per position, ~0.2
// flop per byte: memory-bound, and at the main path's 102,400 positions
// (2.3 MB) a launch's latency is most of its time. A block stages its
// positions' predictions (one contiguous run of positions x vocab
// floats) into shared memory with 16-byte loads, so device memory sees
// every byte once in full sectors; each thread then takes several
// positions. The thresholds are non-decreasing (quality_thresholds
// bisects a monotone map), so the count is an upper-bound binary search:
// at most 8 probes of shared memory for <= 255 thresholds, where the
// linear count took up to 255 compares. A NaN maximum clears none, as
// `p >= thr` is false for it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxThresholds = 255;

__global__ void __launch_bounds__(kThreads)
    phred_epilogue_kernel(const float* __restrict__ preds, int64_t n_pos,
                          int vocab, int per_thread,
                          const float* __restrict__ thresholds, int n_thr,
                          uint8_t* __restrict__ ids,
                          uint8_t* __restrict__ quals) {
  extern __shared__ __align__(16) float rows[];
  __shared__ float thr[kMaxThresholds];
  const int tid = threadIdx.x;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kThreads * per_thread;
  const int64_t left = n_pos - p0;
  const int n = static_cast<int>(left < kThreads * per_thread
                                     ? left
                                     : kThreads * per_thread);
  for (int i = tid; i < n_thr; i += kThreads) thr[i] = thresholds[i];
  // p0 * vocab floats from an aligned base: 16-byte aligned (the block's
  // position count is a multiple of 4).
  const float* src = preds + p0 * vocab;
  const int n_floats = n * vocab;
  const int n4 = n_floats >> 2;
#pragma unroll 4
  for (int i = tid; i < n4; i += kThreads) {
    reinterpret_cast<float4*>(rows)[i] =
        __ldg(reinterpret_cast<const float4*>(src) + i);
  }
  for (int i = 4 * n4 + tid; i < n_floats; i += kThreads) rows[i] = src[i];
  __syncthreads();

  for (int j = tid; j < n; j += kThreads) {
    const float* row = rows + j * vocab;
    float best = row[0];
    int arg = 0;
    for (int v = 1; v < vocab; ++v) {
      const float x = row[v];
      if (x > best || (isnan(x) && !isnan(best))) {
        best = x;
        arg = v;
      }
    }
    // The largest q with thr[q - 1] <= best (thr non-decreasing).
    int q = 0;
#pragma unroll
    for (int step = 128; step > 0; step >>= 1) {
      if (q + step <= n_thr && best >= thr[q + step - 1]) q += step;
    }
    ids[p0 + j] = static_cast<uint8_t>(arg);
    quals[p0 + j] = static_cast<uint8_t>(q);
  }
}

}  // namespace

// preds [n_pos, vocab] float32 (16-byte aligned); thresholds [n_thr]
// float32, non-decreasing, n_thr <= 255.
extern "C" int dc_phred_epilogue(const float* preds, int64_t n_pos, int vocab,
                                 const float* thresholds, int n_thr,
                                 uint8_t* ids, uint8_t* quals,
                                 void* stream_ptr) {
  if (n_thr > kMaxThresholds || n_thr < 0 || vocab < 1 ||
      reinterpret_cast<uintptr_t>(preds) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Positions per thread: 4 while a block's rows fit in 48 KB.
  int per_thread = 4;
  while (per_thread > 1 && kThreads * per_thread * vocab * 4 > 48 * 1024) {
    per_thread >>= 1;
  }
  const int smem = kThreads * per_thread * vocab * 4;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        phred_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t per_block = kThreads * per_thread;
  const int64_t blocks = (n_pos + per_block - 1) / per_block;
  if (blocks == 0) return 0;
  phred_epilogue_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(preds, n_pos, vocab, per_thread,
                                    thresholds, n_thr, ids, quals);
  return static_cast<int>(cudaGetLastError());
}
