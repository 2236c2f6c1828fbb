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
// delta are [B, H, L] float32. Every sum runs in float32, stores round to
// the input's type.
//
// All three run on the tensor cores with band_tiles.cuh's exact operand
// splits (bf16 one piece; float32 3 x 3 pieces with the 6 products above
// 2^-24 kept; the float32 weights p, w and ds 3 pieces for float32 inputs
// and 2 for bf16). A block of 4 warps owns 64 rows of one (window,
// head), queries in K8 and K9 and keys in K10, each warp one m16 row
// tile; the heads of a tile run in neighbouring blocks. It walks the
// other side's rows the band reaches, [r0 - win, r0 + 64 + win) (88 at
// band 12; the whole window without one), in chunks of 16 through a ring
// of shared-memory stages filled by cp.async (16-byte copies where the
// rows allow, down to 4: 8 for bf16 rows of 140 at head 1), so that the
// copies of the next chunks overlap the MMAs of this one. D is padded
// with zeros to a multiple of 16 (140 -> 144); a block holds at most 144
// output columns in registers, so D > 144 takes two column groups
// (blockIdx.z), each forming the full S. A warp skips the chunks that
// lie wholly outside its 16 rows' band.
//   K8: q [64, D] staged once, K and V chunks in a 3-stage ring. S
//     (16 x 16 per chunk) comes into registers as four independent MMA
//     chains (two n-tiles, even and odd k-steps), the online softmax runs
//     on the accumulators (row max and sum by quad shuffles), P is taken
//     from the accumulators' layout as the A fragment of P v, and the
//     running (m, l) and o (16 x 144 a warp) live in registers. lse is
//     written once per row.
//   K9 (band_tiles.cuh's band_dq_kernel): K10 seen from the query side.
//     q and do [64, D] staged once; k and v chunks in a ring (2 stages
//     float32, 3 bf16). Per chunk S = q k^T and dW = do v^T in one loop
//     (four MMA chains), w = exp(S - lse) and ds = w (dW - delta) on the
//     accumulators (each thread's two rows' lse and delta read once),
//     and dq += ds k with ds as the A fragment and k as the [k][n] B
//     operand (ldmatrix.trans for bf16; read and split from shared
//     memory for float32); dq (72 floats a thread) stays in registers.
//     One accumulator where K10 holds two: built for three bf16 blocks an
//     SM.
//   K10: k and v [64, D] staged once; q, do, lse and delta chunks in a
//     ring (2 stages float32, 3 bf16). Per chunk S^T = k q^T and dW^T =
//     v do^T in one loop (four MMA chains), then w^T = exp(S^T - lse)
//     and ds^T = w^T (dW^T - delta) on the accumulators, and dv += w^T
//     do, dk += ds^T q with w^T and ds^T as A fragments and do and q as B
//     operands; dk and dv (2 x 72 floats a thread) stay in registers.
// Loops over k-steps stay rolled; only the loops over output columns are
// unrolled (their accumulators are registers): the attention core's
// fully unrolled first version outgrew the instruction cache
// (ragged_attention.cu). Output fragments go straight to device memory:
// staging them through shared memory for whole-row stores made the
// stores cheaper alone but K8 slower and K10 no faster (PERF.md). wgmma
// and TMA are not used: the kernels are bound by bytes, not by the MMA
// rate, and wait on the staging, the stores and the S -> softmax -> P v
// chain (scripts/probe_flash_kernels.py); mma.sync keeps the split
// operands in registers where wgmma would want them in shared memory.
// Shared memory at D = 140: K8 96,512 bytes float32 / 48,640 bf16, K9
// 115,712 / 68,096, K10 113,920 / 68,480, so two blocks (float32) or
// more share an SM.
//
// No floating-point atomics: every output element is written once by one
// thread, so results repeat from run to run. Rows past L stage as zeros
// (never garbage: 0 * NaN would be NaN) and are masked.
//
// Bound: bytes. At B = 256, L = 200, H = 2, D = 140, band 12, K8 reads
// q, k, v and writes o (28.7 MB each in bf16, 57.3 MB in float32): 0.034
// ms bf16 / 0.069 float32 at 3.35 TB/s; K9 reads four such tensors and
// lse and delta and writes dq: 0.043 / 0.086 ms; K10 writes two: 0.052 /
// 0.103 ms. The band's products (~1.4 / 2.8 GFLOP) take ~3 us at the bf16
// MMA rate. On an H100 K8 takes 0.12 ms bf16 / 0.26 float32, K9 0.114 /
// 0.300 and K10 0.19 / 0.37 (scripts/bench_flash_kernels.py; the scalar
// kernels 0.42, 0.58 and 0.75). K9 holds 144 registers bf16 / 207
// float32, three blocks an SM / two; f32's 2.6x bf16 is the operand
// splits and the compensated sums (band_tiles.cuh's sd_tiles).
#include "band_tiles.cuh"

namespace {

using namespace dc::band;

// ------------------------------------------------------------------------
// K8 and K10.
// ------------------------------------------------------------------------

constexpr int kFwdStages = 3;

// K8: q [64, ld_pairs], then kFwdStages x {k [16, ld_pairs], v [16,
// ld_cols]}.
template <typename T>
__host__ __device__ inline size_t fwd_q_bytes(int dp) {
  return sizeof(T) * static_cast<size_t>(kBlockRows) * ld_pairs<T>(dp);
}
template <typename T>
__host__ __device__ inline size_t fwd_stage_bytes(int dp) {
  return sizeof(T) * static_cast<size_t>(kChunk) *
         (ld_pairs<T>(dp) + ld_cols<T>(dp));
}
template <typename T>
size_t fwd_smem(int D) {
  return fwd_q_bytes<T>(padded(D)) +
         kFwdStages * fwd_stage_bytes<T>(padded(D));
}

// K10: k, v [64, ld_cols], then bwd_stages x {q, do [16, ld_cols], lse,
// delta [16] float32}.
template <typename T>
__host__ __device__ inline size_t dkdv_kv_bytes(int dp) {
  return 2 * sizeof(T) * static_cast<size_t>(kBlockRows) * ld_cols<T>(dp);
}
template <typename T>
__host__ __device__ inline size_t dkdv_stage_bytes(int dp) {
  return 2 * sizeof(T) * static_cast<size_t>(kChunk) * ld_cols<T>(dp) +
         2 * sizeof(float) * kChunk;
}
template <typename T>
size_t dkdv_smem(int D) {
  return dkdv_kv_bytes<T>(padded(D)) +
         bwd_stages<T>() * dkdv_stage_bytes<T>(padded(D));
}

// K8.
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int L, int H, int D, int win,
                     int n_tiles, int ch) {
  constexpr int AP = in_pieces<T>();
  constexpr int PP = w_pieces<T>();
  constexpr int kStages = kFwdStages;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int dp = padded(D);
  const int ldq = ld_pairs<T>(dp), ldv = ld_cols<T>(dp);
  const size_t stage_bytes = fwd_stage_bytes<T>(dp);
  T* qs = reinterpret_cast<T*>(smem_tc);
  unsigned char* ring = smem_tc + fwd_q_bytes<T>(dp);
  auto k_stage = [&](int s) {
    return reinterpret_cast<T*>(ring + s * stage_bytes);
  };
  auto v_stage = [&](int s) { return k_stage(s) + kChunk * ldq; };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Block blk = block_of(L, H, D, win, n_tiles, warp);

  zero_pad(qs, ldq, kBlockRows, D, dp, tid);
  for (int s = 0; s < kStages; ++s) {
    zero_pad(k_stage(s), ldq, kChunk, D, dp, tid);
    zero_pad(v_stage(s), ldv, kChunk, D, dp, tid);
  }
  const int ld = static_cast<int>(blk.ld);
  auto stage = [&](int c) {
    const int row0 = blk.lo + kChunk * c;
    const int n = min(kChunk, blk.hi - row0);
    const int64_t off = blk.base + static_cast<int64_t>(row0) * ld;
    copy_rows(k_stage(c % kStages), ldq, k + off, ld, kChunk, n, D, ch, tid);
    copy_rows(v_stage(c % kStages), ldv, v + off, ld, kChunk, n, D, ch, tid);
  };
  copy_rows(qs, ldq, q + blk.base + static_cast<int64_t>(blk.r0) * ld, ld,
            kBlockRows, blk.r1 - blk.r0, D, ch, tid);
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < blk.n_chunks) stage(c);
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[kGroupTiles][4];
#pragma unroll
  for (int d = 0; d < kGroupTiles; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int c = 0; c < blk.n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; chunk c - 1's stage is free
    if (c + kStages - 1 < blk.n_chunks) stage(c + kStages - 1);
    cp_async_commit();
    if (c < blk.c_lo || c > blk.c_hi) continue;
    const T* ks = k_stage(c % kStages);
    const T* vs = v_stage(c % kStages);
    float s[2][4], s_odd[2][4];
    s_tiles<T, AP>(s, qs, ks, s_odd, qs, ks, ldq, kChunk * warp, ldq,
                   dp / kChunk, 2, 1, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += s_odd[nt][e];

    const int key0 = blk.lo + kChunk * c;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = key0 + 8 * nt + 2 * t + (e & 1);
        const int i = blk.w0 + g + 8 * (e >> 1);
        const bool valid = j < blk.hi && i < L && abs(i - j) <= win;
        s[nt][e] = valid ? s[nt][e] : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[nt][e];
        const float p = x == -INFINITY ? 0.f : expf(x - m[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = p;
      }
#pragma unroll
    for (int d = 0; d < kGroupTiles; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];
    uint32_t pa[PP][4];
    acc_frag<PP>(pa, s);
#pragma unroll
    for (int d = 0; d < kGroupTiles; d += 2) {
      if (d >= blk.n_dt) break;
      mma_pair<PP, AP>(acc[d], acc[d + 1], pa, vs, ldv, 8 * (blk.dt0 + d),
                       lane);
    }
  }

  const int64_t stats = (static_cast<int64_t>(blk.b) * H + blk.h) * L;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    const int i = blk.w0 + g + 8 * r;
    if (i >= L) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    T* row = o + blk.base + static_cast<int64_t>(i) * ld;
#pragma unroll
    for (int d = 0; d < kGroupTiles; ++d) {
      if (d >= blk.n_dt) break;
      store_pair(row, 8 * (blk.dt0 + d) + 2 * t, D, acc[d][2 * r] / denom,
                 acc[d][2 * r + 1] / denom);
    }
    if (lse != nullptr && blockIdx.z == 0 && t == 0) {
      lse[stats + i] = l[r] == 0.f ? 0.f : m[r] + logf(denom);
    }
  }
}

// K10: dk and dv over key tiles, walking the query chunks whose band
// reaches the block's keys.
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int L, int H, int D, int win,
                      int n_tiles, int ch) {
  constexpr int AP = in_pieces<T>();
  constexpr int PP = w_pieces<T>();
  constexpr int kStages = bwd_stages<T>();
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int dp = padded(D);
  const int ld = ld_cols<T>(dp);
  const size_t stage_bytes = dkdv_stage_bytes<T>(dp);
  T* ks = reinterpret_cast<T*>(smem_tc);
  T* vs = ks + kBlockRows * ld;
  unsigned char* ring = smem_tc + dkdv_kv_bytes<T>(dp);
  auto q_stage = [&](int s) {
    return reinterpret_cast<T*>(ring + s * stage_bytes);
  };
  auto o_stage = [&](int s) { return q_stage(s) + kChunk * ld; };
  auto lse_stage = [&](int s) {
    return reinterpret_cast<float*>(o_stage(s) + kChunk * ld);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Block blk = block_of(L, H, D, win, n_tiles, warp);
  const int64_t stats = (static_cast<int64_t>(blk.b) * H + blk.h) * L;

  zero_pad(ks, ld, kBlockRows, D, dp, tid);
  zero_pad(vs, ld, kBlockRows, D, dp, tid);
  for (int s = 0; s < kStages; ++s) {
    zero_pad(q_stage(s), ld, kChunk, D, dp, tid);
    zero_pad(o_stage(s), ld, kChunk, D, dp, tid);
  }
  const int ldg = static_cast<int>(blk.ld);
  auto stage = [&](int c) {
    const int s = c % kStages;
    const int row0 = blk.lo + kChunk * c;
    const int n = min(kChunk, blk.hi - row0);
    const int64_t off = blk.base + static_cast<int64_t>(row0) * ldg;
    copy_rows(q_stage(s), ld, q + off, ldg, kChunk, n, D, ch, tid);
    copy_rows(o_stage(s), ld, dout + off, ldg, kChunk, n, D, ch, tid);
    if (tid < 2 * kChunk) {  // lse in [0, 16), delta in [16, 32)
      const int r = tid % kChunk;
      const float* src = (tid < kChunk ? lse : delta) + stats;
      const bool ok = r < n;
      cp_async<4>(lse_stage(s) + tid, ok ? src + row0 + r : src, ok);
    }
  };
  const int64_t tile = blk.base + static_cast<int64_t>(blk.r0) * ldg;
  copy_rows(ks, ld, k + tile, ldg, kBlockRows, blk.r1 - blk.r0, D, ch, tid);
  copy_rows(vs, ld, v + tile, ldg, kBlockRows, blk.r1 - blk.r0, D, ch, tid);
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < blk.n_chunks) stage(c);
    cp_async_commit();
  }

  float acc_k[kGroupTiles][4], acc_v[kGroupTiles][4];
#pragma unroll
  for (int d = 0; d < kGroupTiles; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[d][e] = acc_v[d][e] = 0.f;

  for (int c = 0; c < blk.n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; chunk c - 1's stage is free
    if (c + kStages - 1 < blk.n_chunks) stage(c + kStages - 1);
    cp_async_commit();
    if (c < blk.c_lo || c > blk.c_hi) continue;
    const T* qs = q_stage(c % kStages);
    const T* os = o_stage(c % kStages);
    const float* ls = lse_stage(c % kStages);
    // S^T (keys x queries) and dW^T: the operands of K8's and K9's logit.
    float s[2][4], dw[2][4];
    s_tiles<T, AP>(s, ks, qs, dw, vs, os, ld, kChunk * warp, ld, dp / kChunk,
                   1, 0, lane);

    const int i0 = blk.lo + kChunk * c;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * nt + 2 * t + (e & 1);
        const int i = i0 + col;
        const int j = blk.w0 + g + 8 * (e >> 1);
        const bool valid = i < blk.hi && j < L && abs(i - j) <= win;
        const float w = valid ? expf(s[nt][e] - ls[col]) : 0.f;
        s[nt][e] = w;
        dw[nt][e] = w * (dw[nt][e] - ls[kChunk + col]);  // ds
      }
    uint32_t a[PP][4];
    acc_frag<PP>(a, s);
#pragma unroll
    for (int d = 0; d < kGroupTiles; d += 2) {
      if (d >= blk.n_dt) break;
      mma_pair<PP, AP>(acc_v[d], acc_v[d + 1], a, os, ld, 8 * (blk.dt0 + d),
                       lane);
    }
    acc_frag<PP>(a, dw);
#pragma unroll
    for (int d = 0; d < kGroupTiles; d += 2) {
      if (d >= blk.n_dt) break;
      mma_pair<PP, AP>(acc_k[d], acc_k[d + 1], a, qs, ld, 8 * (blk.dt0 + d),
                       lane);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = blk.w0 + g + 8 * r;
    if (j >= L) continue;
    const int64_t off = blk.base + static_cast<int64_t>(j) * ldg;
#pragma unroll
    for (int d = 0; d < kGroupTiles; ++d) {
      if (d >= blk.n_dt) break;
      const int col = 8 * (blk.dt0 + d) + 2 * t;
      store_pair(dk + off, col, D, acc_k[d][2 * r], acc_k[d][2 * r + 1]);
      store_pair(dv + off, col, D, acc_v[d][2 * r], acc_v[d][2 * r + 1]);
    }
  }
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int L, int H, int D, int win,
               cudaStream_t stream) {
  if (bad_shape(B, L, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (L + kBlockRows - 1) / kBlockRows;
  const dim3 grid(B * n_tiles * H, 1, n_groups(D));
  if (grid.x == 0) return 0;
  const size_t smem = fwd_smem<T>(D);
  const cudaError_t err = set_smem(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<T><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, L, H, D, win,
      n_tiles, copy_bytes<T>(D, {q, k, v}));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int B, int L, int H, int D, int win,
                cudaStream_t stream) {
  if (bad_shape(B, L, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (L + kBlockRows - 1) / kBlockRows;
  const dim3 grid(B * n_tiles * H, 1, n_groups(D));
  if (grid.x == 0) return 0;
  const size_t smem = dkdv_smem<T>(D);
  const cudaError_t err = set_smem(flash_dkdv_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkdv_kernel<T><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, D, win, n_tiles,
      copy_bytes<T>(D, {q, k, v, dout}));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------------
// K9: band_tiles.cuh's dq kernel with the given lse and delta.
// ------------------------------------------------------------------------

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int L,
              int H, int D, int win, cudaStream_t stream) {
  if (bad_shape(B, L, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (L + kBlockRows - 1) / kBlockRows;
  const dim3 grid(B * n_tiles * H, 1, n_groups(D));
  if (grid.x == 0) return 0;
  const size_t smem = dq_smem<T>(D);
  auto kernel = band_dq_kernel<T, false>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      nullptr, 1.f, static_cast<T*>(dq), nullptr, L, H, D, win, n_tiles,
      copy_bytes<T>(D, {q, k, v, dout}));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest dynamic shared memory of the three kernels, in either
// dtype, at head width D.
extern "C" int dc_flash_band_smem_bytes(int D) {
  size_t most = 0;
  for (size_t s : {fwd_smem<float>(D), fwd_smem<bf16>(D), dkdv_smem<float>(D),
                   dkdv_smem<bf16>(D), dq_smem<float>(D), dq_smem<bf16>(D)}) {
    most = s > most ? s : most;
  }
  return static_cast<int>(most);
}

// Blocks an SM holds of K8 (dkdv 0), K10 (dkdv 1) or K9 (dkdv 2) at head
// width D.
extern "C" int dc_flash_band_blocks_per_sm(int dkdv, int is_bf16, int D) {
  if (bad_shape(1, 1, 1, D)) return -static_cast<int>(cudaErrorInvalidValue);
  if (dkdv == 2) {
    return is_bf16 ? blocks_per_sm(band_dq_kernel<bf16, false>,
                                   dq_smem<bf16>(D))
                   : blocks_per_sm(band_dq_kernel<float, false>,
                                   dq_smem<float>(D));
  }
  if (dkdv) {
    return is_bf16 ? blocks_per_sm(flash_dkdv_kernel<bf16>, dkdv_smem<bf16>(D))
                   : blocks_per_sm(flash_dkdv_kernel<float>,
                                   dkdv_smem<float>(D));
  }
  return is_bf16 ? blocks_per_sm(flash_fwd_kernel<bf16>, fwd_smem<bf16>(D))
                 : blocks_per_sm(flash_fwd_kernel<float>, fwd_smem<float>(D));
}

// K8. q, k, v, o: [B, L, H, D] (is_bf16: bfloat16, else float32); lse:
// [B, H, L] float32, or null for none; win: band half-width, L - 1 for
// none.
extern "C" int dc_flash_band_fwd(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int is_bf16, int B,
                                 int L, int H, int D, int win,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return is_bf16 ? launch_fwd<bf16>(q, k, v, o, lse, B, L, H, D, win, stream)
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
  return is_bf16 ? launch_dq<bf16>(q, k, v, dout, lse, delta, dq, B, L, H, D,
                                   win, stream)
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
  return is_bf16 ? launch_dkdv<bf16>(q, k, v, dout, lse, delta, dk, dv, B, L,
                                     H, D, win, stream)
                 : launch_dkdv<float>(q, k, v, dout, lse, delta, dk, dv, B,
                                      L, H, D, win, stream);
}