// The fused GEMM epilogue shared by the port's tensor-core main loops:
// mma_gemm.cuh (every dense product: K1's, K2's and K4's projections
// and K2's FFN) and embed_condense.cu (K1's and K4's embedding-gather
// condenser).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dc {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

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

// The epilogue's value of out[m, n] (row-major, N columns) from its
// float32 accumulator; prow is pos_row(m), or -1 without pos; alpha is
// *ep.alpha when ep.res is set.
__device__ __forceinline__ float epilogue_value(const Epilogue& ep, int m,
                                                int n, int N, float y,
                                                float alpha, int prow) {
  if (ep.col_scale) y *= ep.col_scale[n];
  if (n < ep.scale_cols) y *= ep.scale;
  if (ep.bias) y += ep.bias[n];
  if (prow >= 0) {
    y += load_any(ep.pos, static_cast<int64_t>(prow) * N + n, ep.pos_bf16);
  }
  if (ep.relu) y = fmaxf(y, 0.f);
  if (ep.res) {
    y = load_any(ep.res, static_cast<int64_t>(m) * N + n, ep.res_bf16) +
        alpha * y;
  }
  return y;
}

// The epilogue of one output element, stored.
__device__ __forceinline__ void epilogue_store(const Epilogue& ep, int m,
                                               int n, int N, float y,
                                               float alpha, int prow) {
  const int64_t idx = static_cast<int64_t>(m) * N + n;
  y = epilogue_value(ep, m, n, N, y, alpha, prow);
  store_any(ep.out, idx, y, ep.out_bf16);
  if (ep.out2) ep.out2[idx] = __float2bfloat16_rn(y);
}

// The epilogue of out[m, n] and out[m, n + 1], n and N even: one 8-byte
// float32 or 4-byte bf16 store.
__device__ __forceinline__ void epilogue_store2(const Epilogue& ep, int m,
                                                int n, int N, float y0,
                                                float y1, float alpha,
                                                int prow) {
  const int64_t idx = static_cast<int64_t>(m) * N + n;
  y0 = epilogue_value(ep, m, n, N, y0, alpha, prow);
  y1 = epilogue_value(ep, m, n + 1, N, y1, alpha, prow);
  const __nv_bfloat162 pair = __floats2bfloat162_rn(y0, y1);
  if (ep.out_bf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(ep.out) + idx) =
        pair;
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + idx) =
        make_float2(y0, y1);
  }
  if (ep.out2) *reinterpret_cast<__nv_bfloat162*>(ep.out2 + idx) = pair;
}

}  // namespace dc
