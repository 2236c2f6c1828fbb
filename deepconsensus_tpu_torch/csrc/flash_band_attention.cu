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
// K8 and K10: the tensor cores. Every product runs on bf16
// mma.sync.m16n8k16 with a float32 accumulator, its operands split
// exactly into bf16 pieces as mma_gemm.cuh does: bf16 q, k, v and do are
// one piece; float32 ones 3 x 3 pieces with the 6 products above 2^-24
// kept; the float32 weights p, w and ds (the A operand of P v, w^T do and
// ds^T q) 3 pieces for float32 inputs and 2 (<= 2^-17 relative) for
// bf16. A block of 4 warps owns 64 rows of one (window, head), queries in
// K8 and keys in K10, each warp one m16 row tile; the heads of a tile run
// in neighbouring blocks. It walks the other side's rows the band
// reaches, [r0 - win, r0 + 64 + win) (88 at band 12; the whole window
// without one), in chunks of 16 through a ring of shared-memory stages
// filled by cp.async (16-byte copies where the rows allow, down to 4: 8
// for bf16 rows of 140 at head 1), so that the copies of the next chunks
// overlap the MMAs of this one. D is padded with zeros to a multiple of
// 16 (140 -> 144); a block holds at most 144 output columns in
// registers, so D > 144 takes two column groups (blockIdx.z), each
// forming the full S. A warp skips the chunks that lie wholly outside
// its 16 rows' band.
//   K8: q [64, D] staged once, K and V chunks in a 3-stage ring. S
//     (16 x 16 per chunk) comes into registers as four independent MMA
//     chains (two n-tiles, even and odd k-steps), the online softmax runs
//     on the accumulators (row max and sum by quad shuffles), P is taken
//     from the accumulators' layout as the A fragment of P v, and the
//     running (m, l) and o (16 x 144 a warp) live in registers. lse is
//     written once per row.
//   K10: k and v [64, D] staged once; q, do, lse and delta chunks in a
//     ring (2 stages float32, 3 bf16). Per chunk S^T = k q^T and dW^T =
//     v do^T in one loop (four MMA chains), then w^T = exp(S^T - lse)
//     and ds^T = w^T (dW^T - delta) on the accumulators, and dv += w^T
//     do, dk += ds^T q with w^T and ds^T as A fragments and do and q as B
//     operands (ldmatrix.trans for bf16; read and split from shared
//     memory for float32); dk and dv (2 x 72 floats a thread) stay in
//     registers.
// Loops over k-steps stay rolled; only the loops over output columns are
// unrolled (their accumulators are registers): the attention core's
// fully unrolled first version outgrew the instruction cache
// (ragged_attention.cu). Output fragments go straight to device memory:
// staging them through shared memory for whole-row stores made the
// stores cheaper alone but K8 slower and K10 no faster (PERF.md). wgmma
// is not used: both kernels are bound by bytes, not by the MMA rate, and
// wait on the staging, the stores and the S -> softmax -> P v chain
// (scripts/probe_flash_kernels.py). Shared memory at D = 140: K8 96,512
// bytes float32 / 48,640 bf16, K10 113,920 / 68,480, so two blocks
// (float32) or more share an SM.
//
// K9 is the first port's scalar design: a block owns 32 query rows, its
// 8 warps 4 rows each, and walks the key tiles of 32 rows from the first
// the band reaches to the last through shared memory; lane j takes key
// j, the weighted sums over the tile run with one lane per feature (d =
// lane + 32 c, c < 8, so D <= 256) and every product is a float32 fmaf.
//
// No floating-point atomics: every output element is written once by one
// thread, so results repeat from run to run. Rows past L stage as zeros
// (never garbage: 0 * NaN would be NaN) and are masked.
//
// Bound: bytes. At B = 256, L = 200, H = 2, D = 140, band 12, K8 reads
// q, k, v and writes o (28.7 MB each in bf16, 57.3 MB in float32): 0.034
// ms bf16 / 0.069 float32 at 3.35 TB/s; K10 reads four such tensors and
// lse and delta and writes two: 0.052 / 0.103 ms. The band's products
// (~1.4 / 2.8 GFLOP) take ~3 us at the bf16 MMA rate. On an H100 K8
// takes 0.12 ms bf16 / 0.26 float32 and K10 0.18 / 0.39
// (scripts/bench_flash_kernels.py; the scalar kernels 0.42 and 0.75).
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "attention_util.cuh"
#include "mma_gemm.cuh"

namespace {

using dc::store;
using dc::to_f;
using dc::mma::cp_async;
using dc::mma::cp_async_commit;
using dc::mma::cp_async_wait;
using dc::mma::ldsm_x4;
using dc::mma::ldsm_x4_trans;
using dc::mma::load_a_frag;
using dc::mma::load_b_frag;
using dc::mma::mma_pieces;
using dc::mma::split_pair;

typedef __nv_bfloat16 bf16;

constexpr int kMaxHeadDim = 256;

// ------------------------------------------------------------------------
// K8 and K10 on the tensor cores.
// ------------------------------------------------------------------------

constexpr int kTcThreads = 128;   // 4 warps
constexpr int kBlockRows = 64;    // a block's queries (K8) or keys (K10)
constexpr int kChunk = 16;        // rows per staged chunk and per warp
constexpr int kGroupTiles = 18;   // 8-column output tiles a block holds
constexpr int kFwdStages = 3;

template <typename T>
__host__ __device__ constexpr int dkdv_stages() {
  return sizeof(T) == 4 ? 2 : 3;
}
// bf16 pieces of q, k, v, do and of the weights p, w, ds.
template <typename T>
__host__ __device__ constexpr int in_pieces() {
  return sizeof(T) == 4 ? 3 : 1;
}
template <typename T>
__host__ __device__ constexpr int w_pieces() {
  return sizeof(T) == 4 ? 3 : 2;
}

__host__ __device__ inline int padded(int D) { return (D + 15) / 16 * 16; }
__host__ __device__ inline int n_groups(int D) {
  return (padded(D) / 8 + kGroupTiles - 1) / kGroupTiles;
}

// Row strides (elements) of the staged tiles, multiples of 16 bytes.
// bf16 tiles are read by ldmatrix, 8 rows of 16 bytes that must fall in
// distinct bank groups: 16 x odd bytes apart. A float32 tile read as
// float2 pairs at rows g (A fragments, and B of S = q k^T) wants rows 8
// or 24 banks apart; one read a value at a time at rows 2t (B of P v)
// an odd multiple of 4 banks. K10 reads q and do both ways and takes the
// second for all its tiles (2-way conflicts on the pairs), which keeps
// two float32 blocks an SM.
template <typename T>
__host__ __device__ inline int ld_pairs(int dp) {
  if (sizeof(T) == 2) return dp + 8;
  int ld = dp;
  while (ld % 32 != 8 && ld % 32 != 24) ld += 4;
  return ld;
}
template <typename T>
__host__ __device__ inline int ld_cols(int dp) {
  return sizeof(T) == 2 ? dp + 8 : dp + 4;
}

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

// K10: k, v [64, ld_cols], then dkdv_stages x {q, do [16, ld_cols], lse,
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
         dkdv_stages<T>() * dkdv_stage_bytes<T>(padded(D));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Zeros in columns [D, dp) of rows [0, rows) of a staged tile: the
// padded k-steps and output columns read them; cp.async never writes
// them.
template <typename T>
__device__ __forceinline__ void zero_pad(T* s, int ld, int rows, int D,
                                         int dp, int tid) {
  const int w = dp - D;
  for (int i = tid; i < rows * w; i += kTcThreads) {
    const int r = i / w;
    store(s + r * ld + D + (i - r * w), 0.f);
  }
}

// A thread's walk over the copies of a staged tile, `per` copies of `e`
// elements to a row: copy i = tid + j * kTcThreads is (row r, column c *
// e), stepped without a division.
struct CopyWalk {
  int r, c, dr, dc, per, e;
};

__device__ __forceinline__ CopyWalk copy_walk(int D, int ch, int elem,
                                              int tid) {
  CopyWalk w;
  w.e = ch / elem;
  w.per = D / w.e;
  w.r = tid / w.per;
  w.c = tid - w.r * w.per;
  w.dr = kTcThreads / w.per;
  w.dc = kTcThreads - w.dr * w.per;
  return w;
}

__device__ __forceinline__ void advance(CopyWalk& w) {
  w.r += w.dr;
  w.c += w.dc;
  if (w.c >= w.per) {
    w.c -= w.per;
    ++w.r;
  }
}

// Copies n rows of one head (g points at the first, ld_g elements
// between positions, D elements a row) into rows [0, n) of a staged tile
// and zeros into rows [n, rows): `ch`-byte cp.async copies (16, 8 or 4;
// ch divides D * sizeof(T) and the operands' alignment), or plain 2-byte
// copies for bf16 rows of odd width. The caller commits and waits.
template <typename T>
__device__ __forceinline__ void copy_rows(T* s, int ld, const T* g, int ld_g,
                                          int rows, int n, int D, int ch,
                                          int tid) {
  for (CopyWalk w = copy_walk(D, ch, sizeof(T), tid); w.r < rows;
       advance(w)) {
    const int col = w.c * w.e;
    const bool ok = w.r < n;
    const T* src = ok ? g + w.r * ld_g + col : g;
    T* dst = s + w.r * ld + col;
    if (ch == 16) {
      cp_async<16>(dst, src, ok);
    } else if (ch == 8) {
      cp_async<8>(dst, src, ok);
    } else if (ch == 4) {
      cp_async<4>(dst, src, ok);
    } else {
      store(dst, ok ? to_f(*src) : 0.f);
    }
  }
}

// The B fragments of two 8-row n-tiles (rows n0.., n0 + 8..) of a
// [n][k] tile (k contiguous: the keys of S = q k^T, the queries of
// S^T = k q^T), k-step k0: ldmatrix for bf16; float2 pairs split into BP
// pieces for float32.
template <typename T, int BP>
__device__ __forceinline__ void load_bt_pair(uint32_t (&b)[2][BP][2],
                                             const T* s, int ld, int k0,
                                             int lane) {
  if constexpr (sizeof(T) == 2) {
    uint32_t r[4];
    ldsm_x4(r, s + ((lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                   ((lane >> 3) & 1) * 8);
    b[0][0][0] = r[0];
    b[0][0][1] = r[1];
    b[1][0][0] = r[2];
    b[1][0][1] = r[3];
  } else {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* p = s + (8 * nt + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
      const float2 v0 = *reinterpret_cast<const float2*>(p);
      const float2 v1 = *reinterpret_cast<const float2*>(p + 8);
      split_pair<BP>(v0.x, v0.y, &b[nt][0][0], 2);
      split_pair<BP>(v1.x, v1.y, &b[nt][0][1], 2);
    }
  }
}

// acc0 / acc1 += a (16 x 16) @ the 16 x 8 tiles at columns n0 and n0 + 8
// of a [k][n] tile of 16 rows (v in K8, do and q in K10): ldmatrix.trans
// for bf16, one value at a time split into BP pieces for float32.
template <int AP, int BP, typename T>
__device__ __forceinline__ void mma_pair(float* acc0, float* acc1,
                                         const uint32_t (&a)[AP][4],
                                         const T* s, int ld, int n0,
                                         int lane) {
  if constexpr (sizeof(T) == 2) {
    uint32_t r[4];
    ldsm_x4_trans(r, s + (lane & 15) * ld + n0 + (lane >> 4) * 8);
    const uint32_t b0[1][2] = {{r[0], r[1]}};
    const uint32_t b1[1][2] = {{r[2], r[3]}};
    mma_pieces<AP, 1>(acc0, a, b0);
    mma_pieces<AP, 1>(acc1, a, b1);
  } else {
    uint32_t b0[BP][2], b1[BP][2];
    load_b_frag<float, BP>(s, ld, 0, n0, lane, b0);
    load_b_frag<float, BP>(s, ld, 0, n0 + 8, lane, b1);
    mma_pieces<AP, BP>(acc0, a, b0);
    mma_pieces<AP, BP>(acc1, a, b1);
  }
}

// The A fragment (16 rows x 16 columns) of the accumulators of two
// n-tiles, in P bf16 pieces.
template <int P>
__device__ __forceinline__ void acc_frag(uint32_t (&a)[P][4],
                                         const float (&s)[2][4]) {
  split_pair<P>(s[0][0], s[0][1], &a[0][0], 4);
  split_pair<P>(s[0][2], s[0][3], &a[0][1], 4);
  split_pair<P>(s[1][0], s[1][1], &a[0][2], 4);
  split_pair<P>(s[1][2], s[1][3], &a[0][3], 4);
}

// acc0 = A0 B0^T and acc1 = A1 B1^T (16 x 16 each: two n-tiles), A the
// rows a0.. of a tile, B a [n][k] tile of 16 rows, the first product at
// k-steps 0, step, 2 step, ..., the second at those + off (those below
// n_ks), in one rolled loop: four independent MMA chains whose fragment
// loads overlap. K8 splits its S over even and odd k-steps (step 2, off
// 1; S = acc0 + acc1), K10 forms S^T and dW^T together (step 1, off 0).
template <typename T, int P>
__device__ __forceinline__ void s_tiles(float (&acc0)[2][4], const T* as0,
                                        const T* bs0, float (&acc1)[2][4],
                                        const T* as1, const T* bs1, int lda,
                                        int a0, int ldb, int n_ks, int step,
                                        int off, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[nt][e] = acc1[nt][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < n_ks; kk += step) {
    const bool second = kk + off < n_ks;
    uint32_t a[2][P][4];
    uint32_t b[2][2][P][2];
    load_a_frag<T, P>(as0, lda, a0, kChunk * kk, lane, a[0]);
    load_bt_pair<T, P>(b[0], bs0, ldb, kChunk * kk, lane);
    if (second) {
      load_a_frag<T, P>(as1, lda, a0, kChunk * (kk + off), lane, a[1]);
      load_bt_pair<T, P>(b[1], bs1, ldb, kChunk * (kk + off), lane);
    }
    mma_pieces<P, P>(acc0[0], a[0], b[0][0]);
    mma_pieces<P, P>(acc0[1], a[0], b[0][1]);
    if (second) {
      mma_pieces<P, P>(acc1[0], a[1], b[1][0]);
      mma_pieces<P, P>(acc1[1], a[1], b[1][1]);
    }
  }
}

// Columns c, c + 1 of an output row (c even); pairs where D is even.
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int c, int D, float x0,
                                           float x1) {
  if ((D & 1) == 0) {
    if (c >= D) return;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(row + c) = make_float2(x0, x1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(row + c) =
          __floats2bfloat162_rn(x0, x1);
    }
  } else {
    if (c < D) store(row + c, x0);
    if (c + 1 < D) store(row + c + 1, x1);
  }
}

// What a block of either kernel works out first: its 64 rows, the other
// side's rows the band reaches [lo, hi) in chunks of 16, and the chunks
// [c_lo, c_hi] the warp's 16 rows reach (none for a warp past L).
struct Block {
  int b, h, r0, r1, lo, hi, n_chunks, w0, c_lo, c_hi, dt0, n_dt;
  int64_t ld, base;
};

__device__ __forceinline__ Block block_of(int L, int H, int D, int win,
                                          int n_tiles, int warp) {
  Block k;
  const int tile = blockIdx.x / H;  // heads of one tile run side by side
  k.h = blockIdx.x - tile * H;
  k.b = tile / n_tiles;
  k.r0 = (tile - k.b * n_tiles) * kBlockRows;
  k.r1 = min(L, k.r0 + kBlockRows);
  k.ld = static_cast<int64_t>(H) * D;
  k.base = static_cast<int64_t>(k.b) * L * k.ld + static_cast<int64_t>(k.h) * D;
  k.lo = max(0, k.r0 - win);
  k.hi = min(L, k.r1 + win);
  k.n_chunks = (k.hi - k.lo + kChunk - 1) / kChunk;
  k.w0 = k.r0 + kChunk * warp;
  if (k.w0 < L) {
    k.c_lo = (max(0, k.w0 - win) - k.lo) / kChunk;
    k.c_hi = (min(L - 1, min(L - 1, k.w0 + kChunk - 1) + win) - k.lo) / kChunk;
  } else {
    k.c_lo = 0;
    k.c_hi = -1;
  }
  k.dt0 = blockIdx.z * kGroupTiles;
  k.n_dt = min(kGroupTiles, padded(D) / 8 - k.dt0);
  return k;
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
  constexpr int kStages = dkdv_stages<T>();
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

// The largest copy (16, 8 or 4 bytes; else the element) that divides a
// row of D elements and the base of every operand, whose head offsets
// and row strides are then whole copies too.
template <typename T>
int copy_bytes(int D, std::initializer_list<const void*> ptrs) {
  for (int ch = 16; ch >= 4; ch /= 2) {
    bool ok = (D * sizeof(T)) % ch == 0;
    for (const void* p : ptrs) {
      ok = ok && reinterpret_cast<uintptr_t>(p) % ch == 0;
    }
    if (ok) return ch;
  }
  return static_cast<int>(sizeof(T));
}

// Sets a kernel's dynamic shared memory (and the carveout that lets
// several blocks share an SM).
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

bool bad_shape(int B, int L, int H, int D) {
  return D <= 0 || D > kMaxHeadDim || B < 0 || L < 0 || H <= 0;
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
// K9, the scalar design.
// ------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                     // rows per block and per streamed tile
constexpr int kRows = kTile / kWarps;         // rows per warp
constexpr int kChunks = 8;                    // feature chunks of 32: D <= 256

// K9's shared memory, in floats: q, do [32, D], k, v [32, D + 1]. A tile
// read one row per lane is padded to D + 1 floats, so the lanes hit
// different banks.
size_t dq_smem(int D) { return sizeof(float) * kTile * (4 * D + 2); }

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

// Blocks of K8 or K10 an SM can hold at once (registers and shared
// memory), or minus a cudaError_t.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t smem) {
  cudaError_t err = set_smem(kernel, smem);
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        kTcThreads, smem);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

// The largest dynamic shared memory of the three kernels, in either
// dtype, at head width D.
extern "C" int dc_flash_band_smem_bytes(int D) {
  size_t most = dq_smem(D);
  for (size_t s : {fwd_smem<float>(D), fwd_smem<bf16>(D), dkdv_smem<float>(D),
                   dkdv_smem<bf16>(D)}) {
    most = s > most ? s : most;
  }
  return static_cast<int>(most);
}

// Blocks an SM holds of K8 (dkdv 0) or K10 (dkdv 1) at head width D.
extern "C" int dc_flash_band_blocks_per_sm(int dkdv, int is_bf16, int D) {
  if (bad_shape(1, 1, 1, D)) return -static_cast<int>(cudaErrorInvalidValue);
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
  return is_bf16 ? launch_dkdv<bf16>(q, k, v, dout, lse, delta, dk, dv, B, L,
                                     H, D, win, stream)
                 : launch_dkdv<float>(q, k, v, dout, lse, delta, dk, dv, B,
                                      L, H, D, win, stream);
}
