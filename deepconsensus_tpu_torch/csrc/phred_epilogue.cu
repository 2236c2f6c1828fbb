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
// Bound: reads 20 bytes and writes 2 bytes per position, ~0.2 flop per
// byte: memory-bound. One thread per position with the (<= 255)
// thresholds staged once per block in shared memory, so device memory
// sees each prediction once and each output byte once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    phred_epilogue_kernel(const float* __restrict__ preds, int64_t n_pos,
                          int vocab, const float* __restrict__ thresholds,
                          int n_thr, uint8_t* __restrict__ ids,
                          uint8_t* __restrict__ quals) {
  __shared__ float thr[256];
  for (int i = threadIdx.x; i < n_thr; i += kThreads) thr[i] = thresholds[i];
  __syncthreads();
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n_pos) return;
  const float* row = preds + p * vocab;
  float best = row[0];
  int arg = 0;
  for (int v = 1; v < vocab; ++v) {
    const float x = row[v];
    if (x > best || (isnan(x) && !isnan(best))) {
      best = x;
      arg = v;
    }
  }
  int q = 0;
  for (int k = 0; k < n_thr; ++k) q += (best >= thr[k]) ? 1 : 0;
  ids[p] = static_cast<uint8_t>(arg);
  quals[p] = static_cast<uint8_t>(q);
}

}  // namespace

extern "C" int dc_phred_epilogue(const float* preds, int64_t n_pos, int vocab,
                                 const float* thresholds, int n_thr,
                                 uint8_t* ids, uint8_t* quals,
                                 void* stream_ptr) {
  if (n_thr > 256 || vocab < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t blocks = (n_pos + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  phred_epilogue_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      preds, n_pos, vocab, thresholds, n_thr, ids, quals);
  return static_cast<int>(cudaGetLastError());
}
