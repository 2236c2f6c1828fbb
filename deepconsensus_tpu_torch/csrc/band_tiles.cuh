// Tensor-core tiles of the banded attention kernels: the staging,
// fragment and store helpers of K8-K10 (flash_band_attention.cu) and
// K6 (banded_attention.cu), and the dq kernel that K9 and K6's first
// pass share.
//
// Every product runs on bf16 mma.sync.m16n8k16 with a float32
// accumulator, its operands split exactly into bf16 pieces as
// mma_gemm.cuh does: bf16 q, k, v and do are one piece; float32 ones 3 x
// 3 pieces with the 6 products above 2^-24 kept; the float32 weights
// (p, w, w drop, ds: the A operands of the second products) 3 pieces for
// float32 inputs and 2 (<= 2^-17 relative) for bf16. A block of warps
// owns 16 rows a warp of one (window, head) and walks the other side's
// rows its band reaches in chunks of 16 through a ring of shared-memory
// stages filled by cp.async. D is padded with zeros to a multiple of 16
// (140 -> 144); a block holds at most 144 output columns in registers,
// so D > 144 takes two column groups (blockIdx.z), each forming the full
// S. Tensors are [B, L, H, D], row stride H*D between positions; the
// row statistics [B, H, L] float32.
#pragma once

#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "attention_util.cuh"
#include "mma_gemm.cuh"

namespace dc {
namespace band {

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
constexpr int kTcThreads = 128;   // 4 warps
constexpr int kBlockRows = 64;    // a block's rows at 4 warps
constexpr int kChunk = 16;        // rows per staged chunk and per warp
constexpr int kGroupTiles = 18;   // 8-column output tiles a block holds

// bf16 pieces of q, k, v, do and of the weights p, w, ds.
template <typename T>
__host__ __device__ constexpr int in_pieces() {
  return sizeof(T) == 4 ? 3 : 1;
}
template <typename T>
__host__ __device__ constexpr int w_pieces() {
  return sizeof(T) == 4 ? 3 : 2;
}
// Stages of the backward kernels' rings (float32 tiles are twice as
// large; two stages keep two blocks an SM).
template <typename T>
__host__ __device__ constexpr int bwd_stages() {
  return sizeof(T) == 4 ? 2 : 3;
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
// an odd multiple of 4 banks. A tile read both ways takes the second
// (2-way conflicts on the pairs).
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
template <int kThreads = kTcThreads, typename T>
__device__ __forceinline__ void zero_pad(T* s, int ld, int rows, int D,
                                         int dp, int tid) {
  const int w = dp - D;
  for (int i = tid; i < rows * w; i += kThreads) {
    const int r = i / w;
    store(s + r * ld + D + (i - r * w), 0.f);
  }
}

// A thread's walk over the copies of a staged tile, `per` copies of `e`
// elements to a row: copy i = tid + j * kThreads is (row r, column c *
// e), stepped without a division.
struct CopyWalk {
  int r, c, dr, dc, per, e;
};

template <int kThreads = kTcThreads>
__device__ __forceinline__ CopyWalk copy_walk(int D, int ch, int elem,
                                              int tid) {
  CopyWalk w;
  w.e = ch / elem;
  w.per = D / w.e;
  w.r = tid / w.per;
  w.c = tid - w.r * w.per;
  w.dr = kThreads / w.per;
  w.dc = kThreads - w.dr * w.per;
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
template <int kThreads = kTcThreads, typename T>
__device__ __forceinline__ void copy_rows(T* s, int ld, const T* g, int ld_g,
                                          int rows, int n, int D, int ch,
                                          int tid) {
  for (CopyWalk w = copy_walk<kThreads>(D, ch, sizeof(T), tid); w.r < rows;
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
// of a [k][n] tile of 16 rows (v in K8, do and q in K10 and K6's second
// pass, k in K9 and K6's first): ldmatrix.trans for bf16, one value at a
// time split into BP pieces for float32.
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
// 1; S = acc0 + acc1); the backward kernels form S and dW (or their
// transposes) together (step 1, off 0).
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

// S = A0 B0^T and dW = A1 B1^T (16 x 16 each) over all k-steps, as
// s_tiles with step 1, except for how float32 inputs sum. An MMA's
// float32 accumulation truncates, once per MMA at the magnitude of the
// running sum: 54 truncations a row at D = 140 (9 k-steps of 6 piece
// products), biased towards zero. That biased S by ~1e-5 (and so w =
// exp(s - lse) relatively) and dW (|dW| ~ 40) by ~1e-4, of which ds
// keeps all of dW - delta at band 0, where the two cancel (K9's delta
// comes from outside). So each k-step's piece products go into zeroed
// accumulators (16 terms, small), which float32 adds, rounded to
// nearest, take into S, and a compensated sum (Kahan's) into dW. bf16
// inputs (one product a k-step, a bf16 output) accumulate directly. The
// backward kernels form S and dW (or their transposes) here.
template <typename T, int P>
__device__ __forceinline__ void sd_tiles(float (&s)[2][4], float (&dw)[2][4],
                                         const T* as0, const T* bs0,
                                         const T* as1, const T* bs1, int lda,
                                         int a0, int ldb, int n_ks,
                                         int lane) {
  float comp[2][4];  // float32: the compensation of dW's sum
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dw[nt][e] = comp[nt][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < n_ks; ++kk) {
    uint32_t a[2][P][4];
    uint32_t b[2][2][P][2];
    load_a_frag<T, P>(as0, lda, a0, kChunk * kk, lane, a[0]);
    load_bt_pair<T, P>(b[0], bs0, ldb, kChunk * kk, lane);
    load_a_frag<T, P>(as1, lda, a0, kChunk * kk, lane, a[1]);
    load_bt_pair<T, P>(b[1], bs1, ldb, kChunk * kk, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      if constexpr (P == 1) {
        mma_pieces<P, P>(s[nt], a[0], b[0][nt]);
        mma_pieces<P, P>(dw[nt], a[1], b[1][nt]);
      } else {
        float ss[4] = {0.f, 0.f, 0.f, 0.f}, sw[4] = {0.f, 0.f, 0.f, 0.f};
        mma_pieces<P, P>(ss, a[0], b[0][nt]);
        mma_pieces<P, P>(sw, a[1], b[1][nt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] += ss[e];
          const float y = sw[e] - comp[nt][e];
          const float sum = dw[nt][e] + y;
          comp[nt][e] = (sum - dw[nt][e]) - y;
          dw[nt][e] = sum;
        }
      }
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

// What a block works out first: its rows [r0, r1) (16 a warp), the other
// side's rows the band reaches [lo, hi) in chunks of 16, and the chunks
// [c_lo, c_hi] the warp's 16 rows reach (none for a warp past L).
struct Block {
  int b, h, r0, r1, lo, hi, n_chunks, w0, c_lo, c_hi, dt0, n_dt;
  int64_t ld, base;
};

__device__ __forceinline__ Block block_of(int L, int H, int D, int win,
                                          int n_tiles, int warp,
                                          int rows = kBlockRows) {
  Block k;
  const int tile = blockIdx.x / H;  // heads of one tile run side by side
  k.h = blockIdx.x - tile * H;
  k.b = tile / n_tiles;
  k.r0 = (tile - k.b * n_tiles) * rows;
  k.r1 = min(L, k.r0 + rows);
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

// Blocks of a kernel an SM can hold at once (registers and shared
// memory), or minus a cudaError_t.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t smem, int threads = kTcThreads) {
  cudaError_t err = set_smem(kernel, smem);
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                        smem);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

inline bool bad_shape(int B, int L, int H, int D) {
  return D <= 0 || D > kMaxHeadDim || B < 0 || L < 0 || H <= 0;
}

// mask / keep_prob for one mask byte: 0 and 1 (a keep-mask's values) as
// products with 1 / keep_prob, which are the quotients exactly; any other
// byte by division (a division takes about ten instructions).
__device__ __forceinline__ float drop_of(uint32_t m, float keep_prob,
                                         float inv_keep) {
  return m <= 1u ? static_cast<float>(m) * inv_keep
                 : static_cast<float>(m) / keep_prob;
}

// ------------------------------------------------------------------------
// dq over query tiles: K9 and K6's first pass.
//
// A block of kWarps warps owns 16 kWarps query rows of one (window,
// head), each warp one m16 row tile. q and do [rows, D] are staged once;
// k and v walk a ring of bwd_stages chunks of 16 over [r0 - win, r1 +
// win). Per chunk S = q k^T and dW = do v^T come into registers
// (sd_tiles: q and do the A operands, k and v the [n][k] B operands),
// the weights form on the accumulators, and dq += ds k takes ds from the
// accumulators' layout as the A fragment and k as the [k][n] B operand
// (ldmatrix.trans for bf16; read and split from shared memory for
// float32). dq (16 x 144 a warp, 72 floats a thread) stays in registers.
//   kSoftmax false, K9: w = exp(s - lse) in the band, ds = w (dw -
//     delta), lse and delta given; one sweep over the chunks.
//   kSoftmax true, K6's first pass: drop = mask / keep_prob (1 without a
//     mask), read inside the band only. A first sweep takes each row's
//     max m, sum l = sum exp(s - m) and r' = sum exp(s - m) dw drop
//     online (rescaled as the max grows, as K8's softmax), so r = r' / l
//     = rowsum(dw drop w); a second sweep forms S and dW again, w = exp(s
//     - m) (1 / l), ds = w (dw drop - r) and dq. (m, 1 / l, r) go to the
//     [B, H, L, 3] stats scratch for the second pass.
// ------------------------------------------------------------------------

// Shared memory: q, do [rows, ld_pairs], then bwd_stages x {k, v [16,
// ld_cols]}.
template <typename T>
__host__ __device__ inline size_t dq_rows_bytes(int dp, int rows) {
  return 2 * sizeof(T) * static_cast<size_t>(rows) * ld_pairs<T>(dp);
}
template <typename T>
__host__ __device__ inline size_t dq_stage_bytes(int dp) {
  return 2 * sizeof(T) * static_cast<size_t>(kChunk) * ld_cols<T>(dp);
}
template <typename T>
size_t dq_smem(int D, int rows = kBlockRows) {
  return dq_rows_bytes<T>(padded(D), rows) +
         bwd_stages<T>() * dq_stage_bytes<T>(padded(D));
}

// The backward kernels are built for three bf16 blocks of 4 warps an SM
// (68 KB each at D = 140) and two float32 ones (at most 115,712 bytes).
template <typename T, bool kSoftmax, int kWarps = 4>
__global__ void __launch_bounds__(32 * kWarps,
                                  kWarps > 4 ? 1 : sizeof(T) == 2 ? 3 : 2)
    band_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const uint8_t* __restrict__ mask, float keep_prob,
                   T* __restrict__ dq, float* __restrict__ stats, int L,
                   int H, int D, int win, int n_tiles, int ch) {
  constexpr int kThreads = 32 * kWarps, kRows = kChunk * kWarps;
  constexpr int AP = in_pieces<T>();
  constexpr int PP = w_pieces<T>();
  constexpr int kStages = bwd_stages<T>();
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int dp = padded(D);
  const int lda = ld_pairs<T>(dp), ldb = ld_cols<T>(dp);
  const size_t stage_bytes = dq_stage_bytes<T>(dp);
  T* qs = reinterpret_cast<T*>(smem_tc);
  T* os = qs + kRows * lda;
  unsigned char* ring = smem_tc + dq_rows_bytes<T>(dp, kRows);
  auto k_stage = [&](int s) {
    return reinterpret_cast<T*>(ring + s * stage_bytes);
  };
  auto v_stage = [&](int s) { return k_stage(s) + kChunk * ldb; };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Block blk = block_of(L, H, D, win, n_tiles, warp, kRows);
  const int64_t bh = static_cast<int64_t>(blk.b) * H + blk.h;

  zero_pad<kThreads>(qs, lda, kRows, D, dp, tid);
  zero_pad<kThreads>(os, lda, kRows, D, dp, tid);
  for (int s = 0; s < kStages; ++s) {
    zero_pad<kThreads>(k_stage(s), ldb, kChunk, D, dp, tid);
    zero_pad<kThreads>(v_stage(s), ldb, kChunk, D, dp, tid);
  }
  const int ldg = static_cast<int>(blk.ld);
  // Iteration it takes chunk it; K6's second sweep (it >= n_chunks)
  // takes chunk it - n_chunks.
  const int n_it = kSoftmax ? 2 * blk.n_chunks : blk.n_chunks;
  auto chunk_of = [&](int it) {
    return it < blk.n_chunks ? it : it - blk.n_chunks;
  };
  auto stage = [&](int it) {
    const int s = it % kStages;
    const int row0 = blk.lo + kChunk * chunk_of(it);
    const int n = min(kChunk, blk.hi - row0);
    const int64_t off = blk.base + static_cast<int64_t>(row0) * ldg;
    copy_rows<kThreads>(k_stage(s), ldb, k + off, ldg, kChunk, n, D, ch, tid);
    copy_rows<kThreads>(v_stage(s), ldb, v + off, ldg, kChunk, n, D, ch, tid);
  };
  const int64_t tile = blk.base + static_cast<int64_t>(blk.r0) * ldg;
  copy_rows<kThreads>(qs, lda, q + tile, ldg, kRows, blk.r1 - blk.r0, D, ch,
                      tid);
  copy_rows<kThreads>(os, lda, dout + tile, ldg, kRows, blk.r1 - blk.r0, D,
                      ch, tid);
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_it) stage(it);
    cp_async_commit();
  }

  // The thread's rows (g, g + 8), their mask rows (K6, null without a
  // mask) and the statistics of w = exp(s - shift) scale and ds = w (dw -
  // sub): K9's (lse, 1, delta); K6's (m, 1 / l, r), where the first sweep
  // holds the running max m and this thread's share of l and r' in
  // scale and sub (summed over the quad once it is done).
  int rows[2];
  float shift[2], scale[2], sub[2];
  const uint8_t* mrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = blk.w0 + g + 8 * r;
    const bool in = rows[r] < L;
    if constexpr (kSoftmax) {
      shift[r] = -INFINITY;
      scale[r] = sub[r] = 0.f;
    } else {
      shift[r] = in ? lse[bh * L + rows[r]] : 0.f;
      scale[r] = 1.f;
      sub[r] = in ? delta[bh * L + rows[r]] : 0.f;
    }
    mrow[r] = kSoftmax && mask != nullptr && in
                  ? mask + (bh * L + rows[r]) * L
                  : nullptr;
  }
  const float inv_keep = 1.f / keep_prob;

  float acc[kGroupTiles][4];
#pragma unroll
  for (int d = 0; d < kGroupTiles; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk it landed; chunk it - 1's stage is free
    if (it + kStages - 1 < n_it) stage(it + kStages - 1);
    cp_async_commit();
    if (kSoftmax && it == blk.n_chunks) {  // the first sweep is done
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l = quad_sum(scale[r]);
        const float rp = quad_sum(sub[r]);  // every lane shuffles
        scale[r] = l > 0.f ? 1.f / l : 0.f;
        sub[r] = l > 0.f ? rp / l : 0.f;
      }
    }
    const int c = chunk_of(it);
    if (c < blk.c_lo || c > blk.c_hi) continue;
    const T* ks = k_stage(it % kStages);
    const T* vs = v_stage(it % kStages);
    const int key0 = blk.lo + kChunk * c;
    // Which of the thread's 8 positions lie in the band, and their mask
    // bytes, loaded ahead of the products.
    bool valid[2][4];
    uint32_t keep[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = key0 + 8 * nt + 2 * t + (e & 1);
        const int i = rows[e >> 1];
        valid[nt][e] = j < blk.hi && i < L && abs(i - j) <= win;
        keep[nt][e] =
            mrow[e >> 1] != nullptr && valid[nt][e] ? mrow[e >> 1][j] : 1u;
      }
    float s[2][4], dw[2][4];
    sd_tiles<T, AP>(s, dw, qs, ks, os, vs, lda, kChunk * warp, ldb,
                    dp / kChunk, lane);
    if (kSoftmax && mask != nullptr) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dw[nt][e] *= drop_of(keep[nt][e], keep_prob, inv_keep);
        }
    }
    if (kSoftmax && it < blk.n_chunks) {  // first sweep: m, l, r'
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!valid[nt][e]) s[nt][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(shift[r], quad_max(mx[r]));
        const float alpha = m_new == -INFINITY ? 1.f : expf(shift[r] - m_new);
        shift[r] = m_new;
        scale[r] *= alpha;
        sub[r] *= alpha;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = valid[nt][e] ? expf(s[nt][e] - shift[e >> 1]) : 0.f;
          scale[e >> 1] += p;
          sub[e >> 1] += p * dw[nt][e];
        }
      continue;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float w =
            valid[nt][e] ? expf(s[nt][e] - shift[r]) * scale[r] : 0.f;
        s[nt][e] = w * (dw[nt][e] - sub[r]);  // ds
      }
    uint32_t a[PP][4];
    acc_frag<PP>(a, s);
#pragma unroll
    for (int d = 0; d < kGroupTiles; d += 2) {
      if (d >= blk.n_dt) break;
      mma_pair<PP, AP>(acc[d], acc[d + 1], a, ks, ldb, 8 * (blk.dt0 + d),
                       lane);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = rows[r];
    if (i >= L) continue;
    T* row = dq + blk.base + static_cast<int64_t>(i) * ldg;
#pragma unroll
    for (int d = 0; d < kGroupTiles; ++d) {
      if (d >= blk.n_dt) break;
      store_pair(row, 8 * (blk.dt0 + d) + 2 * t, D, acc[d][2 * r],
                 acc[d][2 * r + 1]);
    }
    if constexpr (kSoftmax) {
      if (blockIdx.z == 0 && t == 0) {
        float* st = stats + (bh * L + i) * 3;
        st[0] = shift[r];
        st[1] = scale[r];
        st[2] = sub[r];
      }
    }
  }
}

// ------------------------------------------------------------------------
// The forward: K8 and K5 / K7.
//
// A block of kWarps warps owns 16 kWarps query rows of one (window,
// head), each warp one m16 row tile. q [rows, D] is staged once; k and v
// walk a ring of kFwdStages chunks of 16 over [r0 - win, r1 + win). Per
// chunk S (16 x 16 a warp) comes into registers as four independent MMA
// chains (two n-tiles, even and odd k-steps), the online softmax runs on
// the accumulators (running max m and sum l a row, by quad shuffles; acc
// = acc alpha + P v), P is taken from the accumulators' layout as the A
// fragment of P v, and o (16 x 144 a warp, 72 floats a thread) stays in
// registers; o = acc / l (a row with no valid key gives 0 and lse 0).
//   kMask false: K8, and K5 (lse null).
//   kMask true, K7: l sums p without the mask, and the P fed to P v is p
//     drop, drop = mask / keep_prob, so o = acc / l is the reference's
//     (p / sum(p) mask / keep_prob) v up to rounding. The mask's bytes of
//     the thread's accumulator positions (rows g, g + 8; keys 2t, 2t + 1)
//     are read inside the band only, one byte each (rows of odd L are not
//     aligned), before the chunk's S products so that they arrive under
//     them.
// ------------------------------------------------------------------------

constexpr int kFwdStages = 3;

// q [rows, ld_pairs], then kFwdStages x {k [16, ld_pairs], v [16,
// ld_cols]}.
template <typename T>
__host__ __device__ inline size_t fwd_q_bytes(int dp, int rows = kBlockRows) {
  return sizeof(T) * static_cast<size_t>(rows) * ld_pairs<T>(dp);
}
template <typename T>
__host__ __device__ inline size_t fwd_stage_bytes(int dp) {
  return sizeof(T) * static_cast<size_t>(kChunk) *
         (ld_pairs<T>(dp) + ld_cols<T>(dp));
}
template <typename T>
size_t fwd_smem(int D, int rows = kBlockRows) {
  return fwd_q_bytes<T>(padded(D), rows) +
         kFwdStages * fwd_stage_bytes<T>(padded(D));
}

// The body of the forward kernels: K8's flash_fwd_kernel (no mask, lse
// optional) and K5 / K7's banded_fwd_tc_kernel (lse null).
template <typename T, bool kMask, int kWarps = 4>
__device__ __forceinline__ void softmax_fwd_rows(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const uint8_t* __restrict__ mask,
    float keep_prob, T* __restrict__ o, float* __restrict__ lse, int L,
    int H, int D, int win, int n_tiles, int ch) {
  constexpr int kThreads = 32 * kWarps, kRows = kChunk * kWarps;
  constexpr int AP = in_pieces<T>();
  constexpr int PP = w_pieces<T>();
  constexpr int kStages = kFwdStages;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int dp = padded(D);
  const int ldq = ld_pairs<T>(dp), ldv = ld_cols<T>(dp);
  const size_t stage_bytes = fwd_stage_bytes<T>(dp);
  T* qs = reinterpret_cast<T*>(smem_tc);
  unsigned char* ring = smem_tc + fwd_q_bytes<T>(dp, kRows);
  auto k_stage = [&](int s) {
    return reinterpret_cast<T*>(ring + s * stage_bytes);
  };
  auto v_stage = [&](int s) { return k_stage(s) + kChunk * ldq; };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Block blk = block_of(L, H, D, win, n_tiles, warp, kRows);

  zero_pad<kThreads>(qs, ldq, kRows, D, dp, tid);
  for (int s = 0; s < kStages; ++s) {
    zero_pad<kThreads>(k_stage(s), ldq, kChunk, D, dp, tid);
    zero_pad<kThreads>(v_stage(s), ldv, kChunk, D, dp, tid);
  }
  const int ld = static_cast<int>(blk.ld);
  auto stage = [&](int c) {
    const int row0 = blk.lo + kChunk * c;
    const int n = min(kChunk, blk.hi - row0);
    const int64_t off = blk.base + static_cast<int64_t>(row0) * ld;
    copy_rows<kThreads>(k_stage(c % kStages), ldq, k + off, ld, kChunk, n, D,
                        ch, tid);
    copy_rows<kThreads>(v_stage(c % kStages), ldv, v + off, ld, kChunk, n, D,
                        ch, tid);
  };
  copy_rows<kThreads>(qs, ldq, q + blk.base + static_cast<int64_t>(blk.r0) * ld,
                      ld, kRows, blk.r1 - blk.r0, D, ch, tid);
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < blk.n_chunks) stage(c);
    cp_async_commit();
  }

  // K7: the mask rows of the thread's two query rows (the window's first
  // row for a row past L, never read).
  const uint8_t* mrow[2] = {mask, mask};
  const float inv_keep = 1.f / keep_prob;
  if constexpr (kMask) {
    const uint8_t* mwin =
        mask + (static_cast<int64_t>(blk.b) * H + blk.h) * L * L;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = blk.w0 + g + 8 * r;
      mrow[r] = mwin + static_cast<int64_t>(i < L ? i : 0) * L;
    }
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
    const int key0 = blk.lo + kChunk * c;
    // K7: the mask bytes of the thread's 8 positions in the band, loaded
    // ahead of the products.
    uint32_t keep[2][4];
    if constexpr (kMask) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = key0 + 8 * nt + 2 * t + (e & 1);
          const int i = blk.w0 + g + 8 * (e >> 1);
          const bool valid = j < blk.hi && i < L && abs(i - j) <= win;
          keep[nt][e] = valid ? mrow[e >> 1][j] : 0u;
        }
    }
    float s[2][4], s_odd[2][4];
    s_tiles<T, AP>(s, qs, ks, s_odd, qs, ks, ldq, kChunk * warp, ldq,
                   dp / kChunk, 2, 1, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += s_odd[nt][e];

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
        if constexpr (kMask) {
          s[nt][e] = p * drop_of(keep[nt][e], keep_prob, inv_keep);
        } else {
          s[nt][e] = p;
        }
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

}  // namespace band
}  // namespace dc
