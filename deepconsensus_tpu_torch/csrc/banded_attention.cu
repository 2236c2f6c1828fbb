// K5 / K7 / K6: whole-window banded self-attention for training,
// forward (without and with a dropout keep-mask) and backward.
//
// Replaces the TPU kernels in deepconsensus_tpu/ops/banded_attention.py:
// K5 `banded_attention` (_kernel), K7 `banded_attention_dropout_vjp`
// (_fwd_dropout_kernel) and K6 `_bwd_call` (_bwd_kernel, with and
// without its mask). Those hold a whole [L, L] score block per (batch,
// head) in VMEM and compute in float32; the semantics are:
//   s = q k^T, -1e9 outside |i - j| <= win, m = rowmax, p = exp(s - m);
//   K5: o = (p v) / sum(p);  K7: w = p / sum(p), o = (w * mask/keep) v;
//   K6: w recomputed, drop = mask/keep (or 1), dv = (w drop)^T do,
//       dw = (do v^T) drop, ds = w (dw - rowsum(dw w)), dq = ds k,
//       dk = ds^T q.
// exp(-1e9 - m) is exactly 0.0 in float32 whenever the row keeps an
// in-band logit (the diagonal always is), so every weight outside the
// band is exactly 0, and so are its contributions to o, dv, ds, dq and
// dk. These kernels therefore compute only the band (2*win+1 keys per
// query, 25 at win 12), and read the mask only inside it: exact, not an
// approximation.
//
// Layout. q, k, v, do and the outputs are [B, L, H, D] float32 or
// bfloat16, read in place (row stride H*D between positions, no
// transposes); the mask is [B, H, L, L] uint8. Loads widen to float32,
// every sum runs in float32, stores round to the input's type.
//
// Design. A block owns one (window b, tile of 32 positions, head h),
// 256 threads; a warp takes one position of the tile at a time, one
// lane per band partner (keys for a query, queries for a key), warp
// shuffles for the row max and sums, then one lane per feature for the
// weighted sums. No floating-point atomics anywhere: every output
// element is written once by one lane, so results repeat from run to
// run.
//   * Forward (K5, K7): the tile's queries need the keys within win of
//     the tile, so the block stages the K/V rows [q0 - win, q1 + win)
//     (56 rows at win 12) in shared memory, rows padded to D+1 floats
//     so lanes reading different rows hit different banks.
//   * Backward (K6), two kernels launched back to back. A whole window
//     in float32 (q, k, v, do: 100 x 141 x 4 B each, ~225 KB) does not
//     fit the 227 KB block limit beside anything else, so both tile:
//     - banded_bwd_dq: query tiles with the K/V halo, as the forward. Per
//       query it recomputes s, m, sum and w, forms dw and the rowsum r
//       = sum(dw w), writes dq = sum_j ds k_j, and saves (m, sum, r) to
//       a [B, H, L, 3] float32 scratch;
//     - banded_bwd_dkdv: key tiles with the halo of queries [k0 - win,
//       k1 + win) of q and do staged. Per key it recomputes each
//       partner query's logit in the same order of operations as
//       banded_bwd_dq (so the same w), reads that query's (m, sum, r), and
//       writes dv = sum_i w drop do_i and dk = sum_i ds q_i.
//
// Bound. At B = 256, L = 100, H = 2, D = 140 the forwards read q, k, v
// (28.7 MB each in float32) and write o, and K6 reads q, k, v, do and
// writes dq, dk, dv: a few operations per byte (the band's products are
// ~0.7 GFLOP forward, ~1.7 GFLOP backward), so device memory bounds
// them (~34 / ~60 us in float32 at 3.35 TB/s). The halo re-reads each
// staged row (32 + 2 win) / 32 = 1.75 times, mostly from L2; the lane
// products run from shared memory on the CUDA cores. A first version
// that is right: tensor cores and TMA are later work.
#include <math.h>
#include <stdint.h>

#include "attention_util.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;

using dc::store;
using dc::to_f;
using dc::warp_max;
using dc::warp_sum;

// Rows a tile reaches, and partners of one position.
__host__ __device__ inline int span_rows(int L, int win) {
  return L < kTile + 2 * win ? L : kTile + 2 * win;
}
__host__ __device__ inline int band_len(int L, int win) {
  return L < 2 * win + 1 ? L : 2 * win + 1;
}

// Every kernel here asks for the same shared memory: two staged
// [span, D+1] arrays, two per-warp [D] rows, two per-warp [band] rows.
size_t smem_bytes(int L, int D, int win) {
  return sizeof(float) *
         (2 * static_cast<size_t>(span_rows(L, win)) * (D + 1) +
          2 * kWarps * static_cast<size_t>(D) +
          2 * kWarps * static_cast<size_t>(band_len(L, win)));
}

struct Smem {
  float* a;     // [span, D+1]: K (forward, dq) or Q (dk/dv)
  float* b;     // [span, D+1]: V (forward, dq) or dO (dk/dv)
  float* row0;  // [kWarps, D]: this warp's q (or k)
  float* row1;  // [kWarps, D]: this warp's do (or v)
  float* buf0;  // [kWarps, band]
  float* buf1;  // [kWarps, band]
};

__device__ inline Smem carve(float* smem, int span, int D, int band) {
  Smem s;
  s.a = smem;
  s.b = s.a + span * (D + 1);
  s.row0 = s.b + span * (D + 1);
  s.row1 = s.row0 + kWarps * D;
  s.buf0 = s.row1 + kWarps * D;
  s.buf1 = s.buf0 + kWarps * band;
  return s;
}

// Stages rows [lo, hi) of head h of two [B, L, H, D] tensors.
template <typename T>
__device__ inline void stage(const T* __restrict__ x, const T* __restrict__ y,
                             int64_t base, int64_t ld, int lo, int hi, int D,
                             float* xs, float* ys) {
  for (int idx = threadIdx.x; idx < (hi - lo) * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int64_t off = base + static_cast<int64_t>(lo + r) * ld + d;
    xs[r * (D + 1) + d] = to_f(x[off]);
    ys[r * (D + 1) + d] = to_f(y[off]);
  }
}

// s = sum_d a[d] * b[d], d ascending: every kernel forms a logit or a
// do.v product this way, so the two backward passes agree bit for bit.
__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// K5 (mask null) and K7.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    banded_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ mask, float keep_prob,
                      T* __restrict__ o, int L, int H, int D, int win,
                      int n_tiles) {
  extern __shared__ float smem[];
  const int span = span_rows(L, win), band = band_len(L, win), dp = D + 1;
  const Smem sm = carve(smem, span, D, band);
  const int b = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x - b * n_tiles) * kTile;
  const int q1 = min(L, q0 + kTile);
  const int h = blockIdx.y;
  const int lo = max(0, q0 - win), hi = min(L, q1 + win);
  const int64_t ld = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * ld +
                       static_cast<int64_t>(h) * D;
  stage(k, v, base, ld, lo, hi, D, sm.a, sm.b);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qb = sm.row0 + warp * D;
  float* wb = sm.buf0 + warp * band;
  const uint8_t* mwin =
      mask ? mask + (static_cast<int64_t>(b) * H + h) * L * L : nullptr;
  for (int i = q0 + warp; i < q1; i += kWarps) {
    const int64_t row = base + static_cast<int64_t>(i) * ld;
    for (int d = lane; d < D; d += 32) qb[d] = to_f(q[row + d]);
    __syncwarp();
    const int j0 = max(0, i - win), j1 = min(L - 1, i + win);
    const int nj = j1 - j0 + 1;
    float m = -INFINITY;
    for (int jj = lane; jj < nj; jj += 32) {
      const float s = dot(qb, sm.a + (j0 - lo + jj) * dp, D);
      wb[jj] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int jj = lane; jj < nj; jj += 32) {
      const float p = expf(wb[jj] - m);
      wb[jj] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (mwin) {  // K7: w = p / sum, then times mask / keep_prob
      const uint8_t* mrow = mwin + static_cast<int64_t>(i) * L + j0;
      for (int jj = lane; jj < nj; jj += 32) {
        wb[jj] = (wb[jj] / sum) * (static_cast<float>(mrow[jj]) / keep_prob);
      }
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int jj = 0; jj < nj; ++jj) {
        acc = fmaf(wb[jj], sm.b[(j0 - lo + jj) * dp + d], acc);
      }
      store(o + row + d, mwin ? acc : acc / sum);  // K5 divides last
    }
    __syncwarp();
  }
}

// K6, pass 1: dq per query tile, and each query's (m, sum, r).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    banded_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ mask,
                         const T* __restrict__ dout, float keep_prob,
                         T* __restrict__ dq, float* __restrict__ stats, int L,
                         int H, int D, int win, int n_tiles) {
  extern __shared__ float smem[];
  const int span = span_rows(L, win), band = band_len(L, win), dp = D + 1;
  const Smem sm = carve(smem, span, D, band);
  const int b = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x - b * n_tiles) * kTile;
  const int q1 = min(L, q0 + kTile);
  const int h = blockIdx.y;
  const int lo = max(0, q0 - win), hi = min(L, q1 + win);
  const int64_t ld = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * ld +
                       static_cast<int64_t>(h) * D;
  stage(k, v, base, ld, lo, hi, D, sm.a, sm.b);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* qb = sm.row0 + warp * D;
  float* ob = sm.row1 + warp * D;
  float* wb = sm.buf0 + warp * band;
  float* gb = sm.buf1 + warp * band;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const uint8_t* mwin = mask ? mask + bh * L * L : nullptr;
  for (int i = q0 + warp; i < q1; i += kWarps) {
    const int64_t row = base + static_cast<int64_t>(i) * ld;
    for (int d = lane; d < D; d += 32) {
      qb[d] = to_f(q[row + d]);
      ob[d] = to_f(dout[row + d]);
    }
    __syncwarp();
    const int j0 = max(0, i - win), j1 = min(L - 1, i + win);
    const int nj = j1 - j0 + 1;
    float m = -INFINITY;
    for (int jj = lane; jj < nj; jj += 32) {
      const float s = dot(qb, sm.a + (j0 - lo + jj) * dp, D);
      wb[jj] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int jj = lane; jj < nj; jj += 32) {
      const float p = expf(wb[jj] - m);
      wb[jj] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    const uint8_t* mrow = mwin ? mwin + static_cast<int64_t>(i) * L + j0
                               : nullptr;
    float r = 0.f;
    for (int jj = lane; jj < nj; jj += 32) {
      const float w = wb[jj] / sum;
      const float drop =
          mrow ? static_cast<float>(mrow[jj]) / keep_prob : 1.f;
      const float dw = dot(ob, sm.b + (j0 - lo + jj) * dp, D) * drop;
      wb[jj] = w;
      gb[jj] = dw;
      r += dw * w;
    }
    r = warp_sum(r);
    for (int jj = lane; jj < nj; jj += 32) gb[jj] = wb[jj] * (gb[jj] - r);
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int jj = 0; jj < nj; ++jj) {
        acc = fmaf(gb[jj], sm.a[(j0 - lo + jj) * dp + d], acc);
      }
      store(dq + row + d, acc);
    }
    if (lane == 0) {
      float* st = stats + (bh * L + i) * 3;
      st[0] = m;
      st[1] = sum;
      st[2] = r;
    }
    __syncwarp();
  }
}

// K6, pass 2: dk and dv per key tile, from the stats of pass 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    banded_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const uint8_t* __restrict__ mask,
                           const T* __restrict__ dout, float keep_prob,
                           const float* __restrict__ stats,
                           T* __restrict__ dk, T* __restrict__ dv, int L,
                           int H, int D, int win, int n_tiles) {
  extern __shared__ float smem[];
  const int span = span_rows(L, win), band = band_len(L, win), dp = D + 1;
  const Smem sm = carve(smem, span, D, band);
  const int b = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x - b * n_tiles) * kTile;
  const int k1 = min(L, k0 + kTile);
  const int h = blockIdx.y;
  const int lo = max(0, k0 - win), hi = min(L, k1 + win);
  const int64_t ld = static_cast<int64_t>(H) * D;
  const int64_t base = static_cast<int64_t>(b) * L * ld +
                       static_cast<int64_t>(h) * D;
  stage(q, dout, base, ld, lo, hi, D, sm.a, sm.b);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* kb = sm.row0 + warp * D;
  float* vb = sm.row1 + warp * D;
  float* wb = sm.buf0 + warp * band;  // w * drop
  float* gb = sm.buf1 + warp * band;  // ds
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const uint8_t* mwin = mask ? mask + bh * L * L : nullptr;
  const float* swin = stats + bh * L * 3;
  for (int j = k0 + warp; j < k1; j += kWarps) {
    const int64_t row = base + static_cast<int64_t>(j) * ld;
    for (int d = lane; d < D; d += 32) {
      kb[d] = to_f(k[row + d]);
      vb[d] = to_f(v[row + d]);
    }
    __syncwarp();
    const int i0 = max(0, j - win), i1 = min(L - 1, j + win);
    const int ni = i1 - i0 + 1;
    for (int ii = lane; ii < ni; ii += 32) {
      const int i = i0 + ii;
      const float* st = swin + static_cast<int64_t>(i) * 3;
      // The same operands in the same order as banded_bwd_dq's products.
      const float s = dot(sm.a + (i - lo) * dp, kb, D);
      const float w = expf(s - st[0]) / st[1];
      const float drop =
          mwin ? static_cast<float>(mwin[static_cast<int64_t>(i) * L + j]) /
                     keep_prob
               : 1.f;
      const float dw = dot(sm.b + (i - lo) * dp, vb, D) * drop;
      wb[ii] = w * drop;
      gb[ii] = w * (dw - st[2]);
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc_v = 0.f, acc_k = 0.f;
      for (int ii = 0; ii < ni; ++ii) {
        const int r = (i0 - lo + ii) * dp + d;
        acc_v = fmaf(wb[ii], sm.b[r], acc_v);
        acc_k = fmaf(gb[ii], sm.a[r], acc_k);
      }
      store(dv + row + d, acc_v);
      store(dk + row + d, acc_k);
    }
    __syncwarp();
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v,
               const uint8_t* mask, float keep_prob, void* o, int B, int L,
               int H, int D, int win, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, D, win);
  cudaError_t err = cudaFuncSetAttribute(
      banded_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (L + kTile - 1) / kTile;
  banded_fwd_kernel<T><<<dim3(B * n_tiles, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, keep_prob, static_cast<T*>(o), L, H, D,
      win, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v,
               const uint8_t* mask, const void* dout, float keep_prob,
               void* dq, void* dk, void* dv, float* stats, int B, int L,
               int H, int D, int win, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, D, win);
  cudaError_t err = cudaFuncSetAttribute(
      banded_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(banded_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (L + kTile - 1) / kTile;
  const dim3 grid(B * n_tiles, H);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  banded_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, mask, tdo, keep_prob, static_cast<T*>(dq), stats, L, H, D,
      win, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  banded_bwd_dkdv_kernel<T><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, mask, tdo, keep_prob, stats, static_cast<T*>(dk),
      static_cast<T*>(dv), L, H, D, win, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dc_banded_attention_smem_bytes(int L, int D, int win) {
  return static_cast<int>(smem_bytes(L, D, win));
}

// q, k, v, o: [B, L, H, D] (is_bf16: bfloat16, else float32); mask
// [B, H, L, L] uint8 or null (K5); win: band half-width, L - 1 for none.
extern "C" int dc_banded_attention_fwd(const void* q, const void* k,
                                       const void* v, const uint8_t* mask,
                                       float keep_prob, void* o, int is_bf16,
                                       int B, int L, int H, int D, int win,
                                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, mask, keep_prob, o, B,
                                             L, H, D, win, stream)
                 : launch_fwd<float>(q, k, v, mask, keep_prob, o, B, L, H, D,
                                     win, stream);
}

// K6: dq, dk, dv like q; stats: [B, H, L, 3] float32 scratch.
extern "C" int dc_banded_attention_bwd(const void* q, const void* k,
                                       const void* v, const uint8_t* mask,
                                       const void* dout, float keep_prob,
                                       void* dq, void* dk, void* dv,
                                       float* stats, int is_bf16, int B,
                                       int L, int H, int D, int win,
                                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return is_bf16
             ? launch_bwd<__nv_bfloat16>(q, k, v, mask, dout, keep_prob, dq,
                                         dk, dv, stats, B, L, H, D, win,
                                         stream)
             : launch_bwd<float>(q, k, v, mask, dout, keep_prob, dq, dk, dv,
                                 stats, B, L, H, D, win, stream);
}
