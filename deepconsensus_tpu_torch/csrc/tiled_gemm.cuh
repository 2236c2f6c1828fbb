// The CUDA-core GEMM main loop of K1's and K4's embedding-gather
// condenser (csrc/embed_condense.cu, which replaces the embed/condense
// half of deepconsensus_tpu/ops/fused_window_attention.py::_kernel and
// ragged_window_attention.py::_kernel).
//
// out[M, N] = epilogue(A[M, K] @ B[K, N]), float32 accumulation, with
// B read as float32 or bfloat16. A comes through a loader functor:
// K1's embedding gather, whose "A" is the 560-wide embedded pileup row
// built on the fly from the id planes and the embedding tables, so it
// never exists in device memory. Every dense product (the projections
// and K2's FFN) runs on the tensor cores in mma_gemm.cuh instead; this
// loop stays for the gather because its A is one gathered element per
// thread, which the tensor-core loop's 16-byte cp.async staging cannot
// take. Moving the gather onto the tensor cores is K1's own redesign.
//
// Bound and design: at the main path's shapes (M = 1024 windows x 100
// positions, K = 560, N = 280) the product is compute-bound; a 128x128
// output tile per block with an 8x8 register micro-tile per thread (each
// A and B value read from shared memory serves 8 FMAs) lifts arithmetic
// intensity above the card's float32 ridge point. It runs in float32 on
// the CUDA cores, 67 TFLOP/s at most.
#pragma once

#include "gemm_epilogue.cuh"

namespace dc {

template <int BM, int BN, int BK, int TM, int TN, class ALoad, typename TB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    tiled_gemm_kernel(ALoad aload, const TB* __restrict__ b, int M, int N,
                      int K, Epilogue ep) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kPad = 4;
  __shared__ __align__(16) float As[BK][BM + kPad];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int it = 0; it < (BM * BK) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      int r, c;
      if (ALoad::kMFast) {
        r = idx % BM;
        c = idx / BM;
      } else {
        r = idx / BK;
        c = idx % BK;
      }
      const int m = m0 + r;
      const int k = k0 + c;
      As[c][r] = (m < M && k < K) ? aload(m, k) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < (BK * BN) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int c = idx / BN;
      const int nn = idx % BN;
      const int k = k0 + c;
      const int n = n0 + nn;
      Bs[c][nn] = (k < K && n < N)
                      ? to_f32(b[static_cast<int64_t>(k) * N + n])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&As[kk][ty * TM + i]);
        av[i] = t.x; av[i + 1] = t.y; av[i + 2] = t.z; av[i + 3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + j]);
        bv[j] = t.x; bv[j + 1] = t.y; bv[j + 2] = t.z; bv[j + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float alpha = ep.res ? *ep.alpha : 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const int prow = ep.pos ? pos_row(ep, m) : -1;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) epilogue_store(ep, m, n, N, acc[i][j], alpha, prow);
    }
  }
}

constexpr int kBM = 128, kBN = 128, kBK = 16, kTM = 8, kTN = 8;

template <class ALoad, typename TB>
inline void launch_tiled_gemm(const ALoad& aload, const TB* b, int M, int N,
                              int K, const Epilogue& ep, cudaStream_t stream) {
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  dim3 block((kBM / kTM) * (kBN / kTN));
  tiled_gemm_kernel<kBM, kBN, kBK, kTM, kTN, ALoad, TB>
      <<<grid, block, 0, stream>>>(aload, b, M, N, K, ep);
}

}  // namespace dc
