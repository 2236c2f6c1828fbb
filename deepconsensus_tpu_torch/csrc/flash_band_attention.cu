// K8 / K9 / K10: block-banded flash attention for windows longer than
// WHOLE_L_LIMIT, forward (with an optional row logsumexp) and backward.
//
// Replaces the TPU kernels in deepconsensus_tpu/ops/flash_band_attention.py:
// K8 `_forward` (`_kernel`, `_kernel_with_lse`), K9 the dq pass of
// `_vjp_bwd` (`_bwd_dq_kernel`) and K10 its dk/dv pass
// (`_bwd_dkv_kernel`). Their semantics, q pre-scaled:
//   s = q k^T, valid = key < L and |i - j| <= win (every key without a
//   band), s = -1e9 where not valid;
//   K8: an online softmax over key tiles, m = max(m, rowmax(s)),
//       p = valid ? exp(s - m) : 0, l = l alpha + sum(p),
//       acc = acc alpha + p v; o = acc / (l == 0 ? 1 : l) and
//       lse = l == 0 ? 0 : m + log(l), so a row with no valid key gives
//       o = 0 and lse = 0;
//   K9 / K10: w = valid ? exp(s - lse) : 0, dw = do v^T,
//       ds = w (dw - delta) with delta = rowsum(do o) given by the caller;
//       K9 dq = ds k; K10 dk = ds^T q, dv = w^T do.
//
// Layout. q, k, v, do and the outputs are [B, L, H, D] float32 or
// bfloat16, read in place (row stride H*D between positions); lse and
// delta are [B, H, L] float32. Loads widen to float32, every sum runs in
// float32, stores round to the input's type.
//
// Design. What makes these flash kernels: a block owns one tile of 32
// rows of one (window b, head h), queries in K8 and K9, keys in K10, and
// walks the other side's partners in fixed tiles of 32 rows through
// shared memory, from the first row the band reaches to the last
// (lo = max(0, r0 - win), hi = min(L, r1 + win); without a band, the
// whole window). So shared memory (3-4 tiles of [32, D] float32, ~54-72
// KB at D = 140) and registers depend on D alone, never on L or the band:
// win = 130 walks more tiles, not bigger ones. Each of the block's 8
// warps owns 4 of its rows, and in a streamed tile lane j takes partner
// j: the lane forms its 4 logits (and do.v products) from shared memory,
// the row max and sums are warp shuffles, and the weighted sums over the
// tile's partners run with one lane per feature (d = lane + 32 c, c < 8,
// so D <= 256), the partner's weight broadcast by __shfl_sync. K8 keeps
// the running (m, l) and the output row in registers; K9 recomputes w
// from the saved lse and accumulates dq; K10 does the same from the key
// side and accumulates dk and dv. No floating-point atomics: every
// output element is written once by one lane, so results repeat from run
// to run. Rows past L, in the last tile, stage as zeros (never garbage:
// 0 * NaN would be NaN) and are masked.
//
// Bound. At B = 256, L = 200, H = 2, D = 140, band 12, K8 reads q, k, v
// and writes o (57.3 MB each in float32), K9 reads five such tensors and
// K10 writes two of its six; the band's products are ~1.4 / 2.1 / 2.8
// GFLOP, so device memory bounds all three in float32 (~68 / 86 / 103
// us at 3.35 TB/s). Each block walks 2 key tiles of 32 for 25 partners
// per row, so the CUDA cores do ~2.5x the band's products from shared
// memory; tensor cores, TMA and double-buffered tiles are later work.
#include <math.h>
#include <stdint.h>

#include "attention_util.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                     // rows per block and per streamed tile
constexpr int kRows = kTile / kWarps;         // rows per warp
constexpr int kChunks = 8;                    // feature chunks of 32: D <= 256
constexpr float kNeg = -1e9f;

using dc::store;
using dc::to_f;
using dc::warp_max;
using dc::warp_sum;

// Shared memory of each kernel, in floats: K8 q [32, D], k [32, D + 1],
// v [32, D]; K9 q, do [32, D], k, v [32, D + 1]; K10 k, v [32, D],
// q, do [32, D + 1], lse, delta [32]. A tile read one row per lane is
// padded to D + 1 floats, so the lanes hit different banks.
size_t fwd_smem(int D) { return sizeof(float) * kTile * (3 * D + 1); }
size_t dq_smem(int D) { return sizeof(float) * kTile * (4 * D + 2); }
size_t dkdv_smem(int D) { return sizeof(float) * kTile * (4 * D + 4); }

// Stages rows [t0, t0 + n) of one head of a [B, L, H, D] tensor into
// xs [kTile, stride], rows n..kTile-1 as zeros.
template <typename T>
__device__ inline void stage(const T* __restrict__ x, int64_t base,
                             int64_t ld, int t0, int n, int D, int stride,
                             float* xs) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    xs[r * stride + d] =
        r < n ? to_f(x[base + static_cast<int64_t>(t0 + r) * ld + d]) : 0.f;
  }
}

// Stages n values of a [B, H, L] float32 row from t0, zeros after.
__device__ inline void stage_row(const float* __restrict__ x, int t0, int n,
                                 float* xs) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    xs[r] = r < n ? x[t0 + r] : 0.f;
  }
}

struct Tile {
  int b, h, r0, n;  // window, head, first row, rows inside L
  int64_t ld, base; // position stride, offset of (b, 0, h, 0)
};

__device__ inline Tile tile_of(int L, int H, int D, int n_tiles) {
  Tile t;
  t.b = blockIdx.x / n_tiles;
  t.r0 = (blockIdx.x - t.b * n_tiles) * kTile;
  t.n = min(kTile, L - t.r0);
  t.h = blockIdx.y;
  t.ld = static_cast<int64_t>(H) * D;
  t.base = static_cast<int64_t>(t.b) * L * t.ld + static_cast<int64_t>(t.h) * D;
  return t;
}

// K8.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int L, int H, int D, int win,
                     int n_tiles) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [kTile, D]
  float* ks = qs + kTile * D;        // [kTile, D + 1]
  float* vs = ks + kTile * (D + 1);  // [kTile, D]
  const Tile t = tile_of(L, H, D, n_tiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage(q, t.base, t.ld, t.r0, t.n, D, D, qs);

  float m[kRows], l[kRows], acc[kRows][kChunks];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[r][c] = 0.f;
  }
  const int lo = max(0, t.r0 - win), hi = min(L, t.r0 + t.n + win);
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    const int nk = min(kTile, hi - k0);
    __syncthreads();  // q staged; the last tile's readers are done
    stage(k, t.base, t.ld, k0, nk, D, D + 1, ks);
    stage(v, t.base, t.ld, k0, nk, D, D, vs);
    __syncthreads();
    float s[kRows] = {};
    const float* kr = ks + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = fmaf(qs[(warp + kWarps * r) * D + d], kd, s[r]);
      }
    }
    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = t.r0 + warp + kWarps * r;
      const bool valid = lane < nk && i < L && abs(i - j) <= win;
      const float sv = valid ? s[r] : kNeg;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = expf(m[r] - m_new);
      const float p = valid ? expf(sv - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc[r][c] *= alpha;
      s[r] = p;
    }
    for (int jj = 0; jj < nk; ++jj) {
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = __shfl_sync(0xffffffffu, s[r], jj);
      const float* vr = vs + jj * D;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float vd = vr[d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(p[r], vd, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = t.r0 + warp + kWarps * r;
    if (i >= L) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    T* orow = o + t.base + static_cast<int64_t>(i) * t.ld;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(orow + d, acc[r][c] / denom);
    }
    if (lse != nullptr && lane == 0) {
      lse[(static_cast<int64_t>(t.b) * H + t.h) * L + i] =
          l[r] == 0.f ? 0.f : m[r] + logf(denom);
    }
  }
}

// K9: dq over query tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int L, int H, int D, int win, int n_tiles) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [kTile, D]
  float* os = qs + kTile * D;        // [kTile, D]: do
  float* ks = os + kTile * D;        // [kTile, D + 1]
  float* vs = ks + kTile * (D + 1);  // [kTile, D + 1]
  const Tile t = tile_of(L, H, D, n_tiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage(q, t.base, t.ld, t.r0, t.n, D, D, qs);
  stage(dout, t.base, t.ld, t.r0, t.n, D, D, os);
  const int64_t stats = (static_cast<int64_t>(t.b) * H + t.h) * L;

  float row_lse[kRows], row_delta[kRows], acc[kRows][kChunks];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = t.r0 + warp + kWarps * r;
    row_lse[r] = i < L ? lse[stats + i] : 0.f;
    row_delta[r] = i < L ? delta[stats + i] : 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[r][c] = 0.f;
  }
  const int lo = max(0, t.r0 - win), hi = min(L, t.r0 + t.n + win);
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    const int nk = min(kTile, hi - k0);
    __syncthreads();
    stage(k, t.base, t.ld, k0, nk, D, D + 1, ks);
    stage(v, t.base, t.ld, k0, nk, D, D + 1, vs);
    __syncthreads();
    float s[kRows] = {}, g[kRows] = {};
    const float* kr = ks + lane * (D + 1);
    const float* vr = vs + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = (warp + kWarps * r) * D + d;
        s[r] = fmaf(qs[row], kd, s[r]);
        g[r] = fmaf(os[row], vd, g[r]);
      }
    }
    const int j = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = t.r0 + warp + kWarps * r;
      const bool valid = lane < nk && i < L && abs(i - j) <= win;
      const float w = valid ? expf(s[r] - row_lse[r]) : 0.f;
      s[r] = w * (g[r] - row_delta[r]);  // ds
    }
    for (int jj = 0; jj < nk; ++jj) {
      float ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) ds[r] = __shfl_sync(0xffffffffu, s[r], jj);
      const float* krow = ks + jj * (D + 1);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float kd = krow[d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][c] = fmaf(ds[r], kd, acc[r][c]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = t.r0 + warp + kWarps * r;
    if (i >= L) continue;
    T* row = dq + t.base + static_cast<int64_t>(i) * t.ld;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(row + d, acc[r][c]);
    }
  }
}

// K10: dk and dv over key tiles, walking the query tiles whose band
// reaches the block's keys.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int L, int H, int D, int win,
                      int n_tiles) {
  extern __shared__ float smem[];
  float* ks = smem;                  // [kTile, D]
  float* vs = ks + kTile * D;        // [kTile, D]
  float* qs = vs + kTile * D;        // [kTile, D + 1]
  float* os = qs + kTile * (D + 1);  // [kTile, D + 1]: do
  float* ls = os + kTile * (D + 1);  // [kTile]: lse
  float* es = ls + kTile;            // [kTile]: delta
  const Tile t = tile_of(L, H, D, n_tiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage(k, t.base, t.ld, t.r0, t.n, D, D, ks);
  stage(v, t.base, t.ld, t.r0, t.n, D, D, vs);
  const int64_t stats = (static_cast<int64_t>(t.b) * H + t.h) * L;

  float acc_k[kRows][kChunks], acc_v[kRows][kChunks];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }
  const int lo = max(0, t.r0 - win), hi = min(L, t.r0 + t.n + win);
  for (int i0 = lo; i0 < hi; i0 += kTile) {
    const int ni = min(kTile, hi - i0);
    __syncthreads();
    stage(q, t.base, t.ld, i0, ni, D, D + 1, qs);
    stage(dout, t.base, t.ld, i0, ni, D, D + 1, os);
    stage_row(lse + stats, i0, ni, ls);
    stage_row(delta + stats, i0, ni, es);
    __syncthreads();
    float s[kRows] = {}, g[kRows] = {};
    const float* qr = qs + lane * (D + 1);
    const float* orr = os + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float qd = qr[d], od = orr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = (warp + kWarps * r) * D + d;
        // The operands of K8's and K9's logit, in the same order.
        s[r] = fmaf(qd, ks[row], s[r]);
        g[r] = fmaf(od, vs[row], g[r]);
      }
    }
    const int i = i0 + lane;
    float w[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = t.r0 + warp + kWarps * r;
      const bool valid = lane < ni && j < L && abs(i - j) <= win;
      w[r] = valid ? expf(s[r] - ls[lane]) : 0.f;
      s[r] = w[r] * (g[r] - es[lane]);  // ds
    }
    for (int ii = 0; ii < ni; ++ii) {
      float wb[kRows], db[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        wb[r] = __shfl_sync(0xffffffffu, w[r], ii);
        db[r] = __shfl_sync(0xffffffffu, s[r], ii);
      }
      const float* qrow = qs + ii * (D + 1);
      const float* orow = os + ii * (D + 1);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          const float qd = qrow[d], od = orow[d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc_v[r][c] = fmaf(wb[r], od, acc_v[r][c]);
            acc_k[r][c] = fmaf(db[r], qd, acc_k[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = t.r0 + warp + kWarps * r;
    if (j >= L) continue;
    const int64_t off = t.base + static_cast<int64_t>(j) * t.ld;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        store(dk + off + d, acc_k[r][c]);
        store(dv + off + d, acc_v[r][c]);
      }
    }
  }
}

// Sets the kernel's dynamic shared memory and returns its grid, or an
// error for shapes the kernels do not take.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int B, int L, int H, int D,
                    dim3* grid, int* n_tiles) {
  if (D <= 0 || D > 32 * kChunks || B < 0 || L < 0 || H <= 0) {
    return cudaErrorInvalidValue;
  }
  *n_tiles = (L + kTile - 1) / kTile;
  *grid = dim3(B * *n_tiles, H);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int L, int H, int D, int win,
               cudaStream_t stream) {
  dim3 grid;
  int n_tiles;
  const size_t smem = fwd_smem(D);
  cudaError_t err = prepare(flash_fwd_kernel<T>, smem, B, L, H, D, &grid,
                            &n_tiles);
  if (err != cudaSuccess || grid.x == 0) return static_cast<int>(err);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, L, H, D, win,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int L,
              int H, int D, int win, cudaStream_t stream) {
  dim3 grid;
  int n_tiles;
  const size_t smem = dq_smem(D);
  cudaError_t err = prepare(flash_dq_kernel<T>, smem, B, L, H, D, &grid,
                            &n_tiles);
  if (err != cudaSuccess || grid.x == 0) return static_cast<int>(err);
  flash_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), L, H, D, win, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int B, int L, int H, int D, int win,
                cudaStream_t stream) {
  dim3 grid;
  int n_tiles;
  const size_t smem = dkdv_smem(D);
  cudaError_t err = prepare(flash_dkdv_kernel<T>, smem, B, L, H, D, &grid,
                            &n_tiles);
  if (err != cudaSuccess || grid.x == 0) return static_cast<int>(err);
  flash_dkdv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, D, win, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest dynamic shared memory of the three kernels at head width D.
extern "C" int dc_flash_band_smem_bytes(int D) {
  return static_cast<int>(dkdv_smem(D));
}

// K8. q, k, v, o: [B, L, H, D] (is_bf16: bfloat16, else float32); lse:
// [B, H, L] float32, or null for none; win: band half-width, L - 1 for
// none.
extern "C" int dc_flash_band_fwd(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int is_bf16, int B,
                                 int L, int H, int D, int win,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, o, lse, B, L, H, D,
                                             win, stream)
                 : launch_fwd<float>(q, k, v, o, lse, B, L, H, D, win,
                                     stream);
}

// K9. do and dq like q; lse, delta: [B, H, L] float32.
extern "C" int dc_flash_band_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int is_bf16,
                                int B, int L, int H, int D, int win,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return is_bf16 ? launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B,
                                            L, H, D, win, stream)
                 : launch_dq<float>(q, k, v, dout, lse, delta, dq, B, L, H,
                                    D, win, stream);
}

// K10. dk, dv like q.
extern "C" int dc_flash_band_dkdv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dk, void* dv, int is_bf16, int B,
                                  int L, int H, int D, int win,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return is_bf16 ? launch_dkdv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk,
                                              dv, B, L, H, D, win, stream)
                 : launch_dkdv<float>(q, k, v, dout, lse, delta, dk, dv, B,
                                      L, H, D, win, stream);
}
