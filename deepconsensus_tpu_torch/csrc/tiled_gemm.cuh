// Shared tiled GEMM for the port's Hopper kernels (K1 and K2).
//
// out[M, N] = epilogue(A[M, K] @ B[K, N]), float32 accumulation, with A
// read as float32 or bfloat16 and B as float32, bfloat16 or int8. An
// int8 B is K2's int8-weight variant: each value widens to float32 as
// it is staged into shared memory (one byte per thread, neighbouring
// threads on neighbouring columns), so the weight stays int8 in device
// memory, the shared-memory tile is the same float tile as for the
// other types (no int8 alignment to keep there), and the
// per-output-channel scale runs in the epilogue. The A operand comes
// through a loader functor, so the same main loop serves a dense
// row-major matrix
// (projections, FFN) and K1's embedding gather, whose "A" is the
// 560-wide embedded pileup row built on the fly from the id planes and
// the embedding tables, so it never exists in device memory.
//
// Bound: at the main path's shapes (M = 1024 windows x 100 positions)
// every product here has K >= 280 and is compute-bound: ~2.2 flop per
// byte at K=280 in float32 would be memory-bound on a naive kernel, so
// the design keeps a 128x128 output tile per block with an 8x8 register
// micro-tile per thread (each A and B value read from shared memory
// serves 8 FMAs) to lift arithmetic intensity above the card's
// float32 ridge point. It runs on the CUDA cores in float32, not on the
// tensor cores: float32 inputs must stay exact to 1e-4 of the float32
// reference, which TF32 tensor-core math would not hold. wgmma/TMA
// pipelining is later work (PERF.md).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dc {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float load_any(const void* p, int64_t i,
                                          int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, int64_t i, float v,
                                          int is_bf16) {
  if (is_bf16) {
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// Applied per output element, in the reference's op order:
//   y = acc; y *= col_scale[n] (int8 weights: the dequantization,
//   (x @ q) * scale); y *= scale (columns < scale_cols); y += bias[n];
//   y += pos[pos_row(m), n]; y = relu(y); y = res[m, n] + alpha * y
// then y is stored to out (and, when out2 is set, a bfloat16 copy).
// pos_row(m) is m % pos_period; with lengths (ragged slots of
// pos_period positions, lengths [slots, wps] window widths) it is the
// position's offset in its own window, and positions outside every
// window get no pos.
struct Epilogue {
  float scale;
  int scale_cols;
  const float* bias;
  const void* pos;
  int pos_bf16;
  int pos_period;
  int relu;
  const void* res;
  int res_bf16;
  const float* alpha;
  void* out;
  int out_bf16;
  bf16* out2;
  const int* lengths = nullptr;
  int wps = 0;
  const float* col_scale = nullptr;
};

// Row of the position table for token m, or -1 for none.
__device__ __forceinline__ int pos_row(const Epilogue& ep, int m) {
  const int slot = m / ep.pos_period;
  const int p = m - slot * ep.pos_period;
  if (!ep.lengths) return p;
  const int* lens = ep.lengths + static_cast<int64_t>(slot) * ep.wps;
  for (int j = 0, cur = 0; j < ep.wps; ++j) {
    const int w = lens[j];
    if (p < cur + w) return p - cur;
    cur += w;
  }
  return -1;
}

// Dense row-major A[M, K]; neighbouring threads load neighbouring k.
template <typename TA>
struct DenseA {
  static constexpr bool kMFast = false;
  const TA* a;
  int lda;
  __device__ __forceinline__ float operator()(int m, int k) const {
    return to_f32(a[static_cast<int64_t>(m) * lda + k]);
  }
};

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
    const int64_t row = static_cast<int64_t>(m) * N;
    const int prow = ep.pos ? pos_row(ep, m) : -1;
    const int64_t pos_off = static_cast<int64_t>(prow) * N;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      float y = acc[i][j];
      if (ep.col_scale) y *= ep.col_scale[n];
      if (n < ep.scale_cols) y *= ep.scale;
      if (ep.bias) y += ep.bias[n];
      if (prow >= 0) y += load_any(ep.pos, pos_off + n, ep.pos_bf16);
      if (ep.relu) y = fmaxf(y, 0.f);
      if (ep.res) y = load_any(ep.res, row + n, ep.res_bf16) + alpha * y;
      store_any(ep.out, row + n, y, ep.out_bf16);
      if (ep.out2) ep.out2[row + n] = __float2bfloat16_rn(y);
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
