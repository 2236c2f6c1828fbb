// Banded multi-head attention core over fixed windows or ragged slots,
// on the tensor cores: K1 (layer 0), K2 (layers 1+) and K4 (ragged layer
// 0) all run it.
//
// Replaces the per-head score/softmax/weighted-sum loop of the TPU
// kernels deepconsensus_tpu/ops/fused_window_attention.py::_attention,
// deepconsensus_tpu/ops/fused_encoder_block.py::_attention (with and
// without its ragged mask) and
// deepconsensus_tpu/ops/ragged_window_attention.py::_ragged_attention,
// in both of their softmax dtypes (the attn_softmax_dtype lever). The
// TPU kernels compute the full [L, L] score block per head and fill the
// masked logits with -1e9 before the softmax; -1e9 is finite in float32
// and bfloat16 alike, and exp(-1e9 - m) is exactly 0 whenever a row keeps
// one unmasked logit, so only the unmasked logits carry weight. This
// kernel computes just those: exact, not an approximation. Query i of a
// window starting at `start` with width `width` attends to keys
// [max(start, i - win), min(start + width - 1, i + win)].
//
// Ragged slots: with a lengths row [wps] per slot (window widths packed
// back to back from position 0; 0 = unused), each query finds its own
// window from that row, as the TPU kernel derives it (slot_geometry). A
// position past every window has no unmasked key; the TPU kernel's
// softmax is uniform there, but those positions are never delivered, so
// this kernel writes a defined 0. Without lengths every row is one
// window of the full length L.
//
// Input: qkv [B*L, 3H] float32 from the fused q/k/v projection (q already
// scaled by head_dim^-1/2); output o [B*L, H] float32, heads concatenated
// like the reference. q, k and v are float32 in the reference whatever
// the compute dtype, so the products run on bf16 mma.sync with float32
// operands split exactly into bf16 pieces (mma_gemm.cuh):
//   S = q k^T:  3 x 3 pieces, the 6 products above 2^-24 kept;
//   O = P v:    v in 3 pieces; P in 3 pieces for a float32 softmax (the
//               weights e / z) and in 1 for bfloat16, whose numerators
//               bf16(e) are exactly one piece.
// The softmax runs on the S accumulators in registers, row max and sum by
// quad shuffles (no atomics: the same result from run to run), with true
// divisions: a float32 softmax divides each numerator by z (as
// torch.softmax does), a bfloat16 one each output element, o = (sum_j
// bf16(e_j) v_j) / z (the reference divides each weight first: the two
// differ by float32 rounding only). The bfloat16 softmax is the chain of
// ops/fused_window_attention.py::softmax_chain: sd = bf16(s), m =
// max(sd), d = bf16(sd - m), e = exp(d) in float32, z = bf16(sum e).
//
// Tiles: a block (4 warps) owns one (window or slot, 64-query tile,
// head); each warp 16 queries, one m16 row tile. It stages the K rows
// its tile reaches (the tile plus win rows each side: 88 at win 12) with
// 16-byte cp.async into padded shared-memory rows, head_dim padded with
// zeros to a multiple of 16 (140 -> 144, 9 k-steps); each warp reads its
// q fragments, and its v fragments, straight from device memory (a q row
// serves one warp; v rows serve at most three, through the read-only
// cache), so K alone in shared memory (53,504 bytes at win 12) holds four
// blocks on an SM. P is taken from the S accumulators' register layout
// as the A fragment of the P v product, 16 keys at a time. Output
// fragments go straight to device memory, each quad of threads one full
// 32-byte sector. Loops over k-steps and output columns stay rolled:
// fully unrolled, the body outgrew the instruction cache and ran slower
// than the scalar kernel it replaces (1.11 ms against 0.86 at 1,024 x
// 100 on an H100, scripts/bench_attention_core.py). Two kernels:
//   resident (win <= 16, the model's band 12): one key block; a warp's
//     keys lie in 3 chunks of 16 (6 n-tiles, 5 in the band at win 12),
//     whose S stays in registers: one pass.
//   streaming (wider bands, up to slots of 256 without one): K and V in
//     key blocks of 96 rows (115,200 bytes, two blocks an SM) and two
//     passes, the row maxima first, then the numerators and P v chunk by
//     chunk, so every e sees the final max as the reference's does.
//
// Bound: bytes. qkv in and o out once (459 MB at 1,024 x 100, 0.137 ms
// at 3.35 TB/s) against ~40 GFLOP of piece products. On an H100 the
// staging alone runs at that bound; what the kernel adds is the S and
// P v phases' latency (they run at a low instruction rate: neither the
// conversions of the splits nor the MMA rate sets it), which more
// blocks on an SM hide in part.
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_gemm.cuh"

namespace {

using dc::mma::cp_async;
using dc::mma::cp_async_commit;
using dc::mma::cp_async_wait;
using dc::mma::mma_pieces;
using dc::mma::split_pair;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // queries a block owns
constexpr int kKeyBlock = 96;      // K/V rows staged at once
constexpr int kChunks = kKeyBlock / 16;  // 16-key chunks a key block holds
// A warp of the resident kernel holds S for 3 chunks (6 n-tiles): every
// warp's keys at win <= 16, whose K/V rows (<= 96) fit one key block.
constexpr int kResidentChunks = 3;
constexpr int kResidentMaxWin = 16;
constexpr int kMaxHeadDim = 144;
constexpr int kMaxDTiles = kMaxHeadDim / 8;

__host__ __device__ inline int padded_head_dim(int head_dim) {
  return (head_dim + 15) / 16 * 16;
}
// Row strides (floats). K is read as float2 at (row g, column 2t): rows
// must lie 8 or 24 banks apart. V is read one value per thread at rows
// 2t: two rows must lie an odd multiple of 4 banks apart. Both stay
// multiples of 4 floats for 16-byte copies.
__host__ __device__ inline int k_ld(int head_dim) {
  int ld = padded_head_dim(head_dim);
  while (ld % 32 != 8 && ld % 32 != 24) ld += 4;
  return ld;
}
__host__ __device__ inline int v_ld(int head_dim) {
  return padded_head_dim(head_dim) + 4;
}
// K/V rows a 64-query tile reaches at most, and the rows one key block
// stages.
__host__ __device__ inline int staged_rows(int L, int win) {
  const int span = L < kTile + 2 * win ? L : kTile + 2 * win;
  return span < kKeyBlock ? span : kKeyBlock;
}

// Dynamic shared memory: K alone for the resident kernel, K and V for
// the streaming one.
size_t smem_bytes(int L, int head_dim, int win) {
  const int ld = win <= kResidentMaxWin ? k_ld(head_dim)
                                        : k_ld(head_dim) + v_ld(head_dim);
  return sizeof(float) * static_cast<size_t>(staged_rows(L, win)) * ld;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Two q values (columns c, c + 1 of a row; zeros past head_dim or for a
// row that is not there). kVec: 8-byte aligned pairs.
template <bool kVec>
__device__ __forceinline__ float2 load_q(const float* row, int c, int hd) {
  if (row == nullptr) return make_float2(0.f, 0.f);
  if constexpr (kVec) {
    return c < hd ? __ldg(reinterpret_cast<const float2*>(row + c))
                  : make_float2(0.f, 0.f);
  } else {
    return make_float2(c < hd ? __ldg(row + c) : 0.f,
                       c + 1 < hd ? __ldg(row + c + 1) : 0.f);
  }
}

// The q fragment (A of S = q k^T) of k-step k: float2 pairs at (row g,
// 16 k + 2t), (row g + 8, same), (row g, + 8), (row g + 8, + 8).
template <bool kVec>
__device__ __forceinline__ void load_q_frag(float2 (&f)[4], const float* r0,
                                            const float* r1, int k, int t,
                                            int hd) {
  const int c = 16 * k + 2 * t;
  f[0] = load_q<kVec>(r0, c, hd);
  f[1] = load_q<kVec>(r1, c, hd);
  f[2] = load_q<kVec>(r0, c + 8, hd);
  f[3] = load_q<kVec>(r1, c + 8, hd);
}

// k-steps of q in flight ahead of the one multiplied: hides a device-
// memory round trip behind the MMAs of the k-steps before it.
constexpr int kQDepth = 3;

// The first kQDepth q fragments, issued before the caller waits for its
// K/V copies.
template <bool kVec>
__device__ __forceinline__ void prefetch_q(float2 (&qb)[kQDepth][4],
                                           const float* qr0, const float* qr1,
                                           int n_ks, int t, int hd) {
#pragma unroll
  for (int j = 0; j < kQDepth; ++j) {
    load_q_frag<kVec>(qb[j], j < n_ks ? qr0 : nullptr,
                      j < n_ks ? qr1 : nullptr, j, t, hd);
  }
}

// s[nt] = q k^T for NT 8-key n-tiles starting at staged key row row0
// (rows past the staged `rows` read the last one: their logits are
// masked), over all k-steps: 3 x 3 pieces, 6 products. qb holds the
// first kQDepth q fragments (prefetch_q); each slot is refilled with the
// fragment kQDepth k-steps on once split. The k-step loop stays rolled
// (kQDepth copies of its body in the instruction cache).
template <int NT, bool kVec>
__device__ __forceinline__ void s_tiles(float (&s)[NT][4],
                                        float2 (&qb)[kQDepth][4],
                                        const float* ks, int kld, int row0,
                                        int rows, const float* qr0,
                                        const float* qr1, int hd, int n_ks,
                                        int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  const float* krow[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    krow[nt] = ks + min(row0 + 8 * nt + g, rows - 1) * kld + 2 * t;
  }
#pragma unroll 1
  for (int k0 = 0; k0 < n_ks; k0 += kQDepth) {
#pragma unroll
    for (int j = 0; j < kQDepth; ++j) {
      const int k = k0 + j;
      if (k >= n_ks) break;
      uint32_t a[3][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split_pair<3>(qb[j][r].x, qb[j][r].y, &a[0][r], 4);
      }
      if (k + kQDepth < n_ks) {
        load_q_frag<kVec>(qb[j], qr0, qr1, k + kQDepth, t, hd);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 v0 = *reinterpret_cast<const float2*>(krow[nt] + 16 * k);
        const float2 v1 =
            *reinterpret_cast<const float2*>(krow[nt] + 16 * k + 8);
        uint32_t b[3][2];
        split_pair<3>(v0.x, v0.y, &b[0][0], 2);
        split_pair<3>(v1.x, v1.y, &b[0][1], 2);
        mma_pieces<3, 3>(s[nt], a, b);
      }
    }
  }
}

// Masks s[nt] (n-tiles from key key0) to the rows' keys [jlo, jhi]:
// masked logits -inf, the others bf16-rounded in a bfloat16 softmax;
// folds them into the running row maxima m.
template <int NT, bool kBf16Softmax>
__device__ __forceinline__ void mask_s(float (&s)[NT][4], int key0,
                                       const int (&jlo)[2],
                                       const int (&jhi)[2], int t,
                                       float (&m)[2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = key0 + 8 * nt + 2 * t + (e & 1);
      const int r = e >> 1;
      const float x = kBf16Softmax ? bf16_round(s[nt][e]) : s[nt][e];
      s[nt][e] = j >= jlo[r] && j <= jhi[r] ? x : -INFINITY;
      m[r] = fmaxf(m[r], s[nt][e]);
    }
}

// The softmax numerators e of masked logits s at the final row maxima m
// (bf16: e = exp(bf16(s - m)), subnormals flushed as XLA does), summed
// into sum.
template <int NT, bool kBf16Softmax>
__device__ __forceinline__ void numerators(float (&s)[NT][4],
                                           const float (&m)[2],
                                           float (&sum)[2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[nt][e];
      float p = 0.f;
      if (x != -INFINITY && kBf16Softmax) {
        p = expf(bf16_round(x - m[e >> 1]));
        p = p < FLT_MIN ? 0.f : p;
      } else if (x != -INFINITY) {
        p = expf(x - m[e >> 1]);
      }
      sum[e >> 1] += p;
      s[nt][e] = p;
    }
}

// The A fragment of P (16 queries x 16 keys) from the S accumulators of
// the chunk's two n-tiles, in P bf16 pieces.
template <int P>
__device__ __forceinline__ void p_frag(uint32_t (&a)[P][4], const float* s0,
                                       const float* s1) {
  split_pair<P>(s0[0], s0[1], &a[0][0], 4);
  split_pair<P>(s0[2], s0[3], &a[0][1], 4);
  split_pair<P>(s1[0], s1[1], &a[0][2], 4);
  split_pair<P>(s1[2], s1[3], &a[0][3], 4);
}

// The B fragment of v for one chunk (rows row0 + 2t, +1, +8, +9 of v,
// clamped to its `rows`; ld floats apart) and n-tile d (column 8 d + g),
// in 3 pieces. kDevice: v in device memory, read through the read-only
// cache, columns past head_dim read as 0 (the last head's would run past
// the row); else staged in shared memory with zero-padded columns.
template <bool kDevice>
__device__ __forceinline__ void v_frag(uint32_t (&b)[3][2], const float* v,
                                       int ld, int hd, int row0, int rows,
                                       int d, int g, int t) {
  const int r = row0 + 2 * t;
  const int c = 8 * d + g;
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = v + min(r + (i & 1) + 8 * (i >> 1), rows - 1) * ld + c;
    x[i] = kDevice ? (c < hd ? __ldg(p) : 0.f) : *p;
  }
  split_pair<3>(x[0], x[1], &b[0][0], 2);
  split_pair<3>(x[2], x[3], &b[0][1], 2);
}

// Writes a thread's four output values of n-tile d (rows g and g + 8 of
// the warp's 16, columns 8 d + 2t, + 1), each quad one 32-byte sector.
template <bool kVec>
__device__ __forceinline__ void store_o(float* o0, float* o1, const float* v,
                                        int d, int t, int hd) {
  const int c = 8 * d + 2 * t;
  if constexpr (kVec) {
    if (c >= hd) return;
    if (o0) *reinterpret_cast<float2*>(o0 + c) = make_float2(v[0], v[1]);
    if (o1) *reinterpret_cast<float2*>(o1 + c) = make_float2(v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (c + e >= hd) continue;
      if (o0) o0[c + e] = v[e];
      if (o1) o1[c + e] = v[2 + e];
    }
  }
}

// Issues the cp.async copies of K (and/or V) rows [row0, row0 + n_rows)
// of head h into shared memory, zero-filling their padded columns with
// plain stores; the caller commits, waits and syncs.
template <bool kVec>
__device__ __forceinline__ void stage_rows(float* ks, float* vs,
                                           const float* base, int ld3,
                                           int H, int h, int hd, int dpad,
                                           int kld, int vld, int row0,
                                           int n_rows, bool with_k,
                                           bool with_v, int warp, int lane) {
  constexpr int kE = kVec ? 4 : 1;
  const int copies = hd / kE;
  for (int r = warp; r < n_rows; r += kWarps) {
    const float* src = base + static_cast<int64_t>(row0 + r) * ld3 + h * hd;
    for (int c = lane; c < 2 * copies; c += 32) {
      const bool is_v = c >= copies;
      if (is_v ? !with_v : !with_k) continue;
      const int e = (is_v ? c - copies : c) * kE;
      float* dst = is_v ? vs + r * vld + e : ks + r * kld + e;
      cp_async<kE * 4>(dst, src + (is_v ? 2 * H : H) + e, true);
    }
    for (int c = hd + lane; c < dpad; c += 32) {
      if (with_k) ks[r * kld + c] = 0.f;
      if (with_v) vs[r * vld + c] = 0.f;
    }
  }
}

// What every block works out first: its tile, its K/V rows, each thread's
// two query rows and the keys each reaches, and the warp's chunks.
struct Tile {
  int b, q0, q1, h, lo, hi, qw;
  int jlo[2], jhi[2];
  int wlo, whi, c0, c1;
  bool active;
  const float* base;
  const float* qr[2];
  float* orow[2];
};

__device__ __forceinline__ Tile make_tile(const float* qkv, const int* lengths,
                                          int wps, float* out, int L, int H,
                                          int hd, int win, int n_tiles,
                                          int warp, int g) {
  Tile T;
  T.b = blockIdx.x / n_tiles;
  T.q0 = (blockIdx.x - T.b * n_tiles) * kTile;
  T.q1 = min(L, T.q0 + kTile);
  T.h = blockIdx.y;
  T.lo = max(0, T.q0 - win);
  T.hi = min(L, T.q1 + win);
  T.qw = T.q0 + 16 * warp;
  T.base = qkv + static_cast<int64_t>(T.b) * L * 3 * H;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int i = T.qw + g + 8 * s;
    int start = 0, width = i < T.q1 ? L : 0;
    if (lengths != nullptr && i < T.q1) {
      const int* lens = lengths + static_cast<int64_t>(T.b) * wps;
      width = 0;
      for (int j = 0, cur = 0; j < wps; ++j) {
        const int w = __ldg(lens + j);
        if (i < cur + w) {
          start = cur;
          width = w;
          break;
        }
        cur += w;
      }
    }
    T.jlo[s] = width ? max(start, i - win) : INT_MAX;
    T.jhi[s] = width ? min(min(start + width, L) - 1, i + win) : INT_MIN;
    T.qr[s] = width ? T.base + static_cast<int64_t>(i) * 3 * H + T.h * hd
                    : nullptr;
    T.orow[s] = i < T.q1
                    ? out + (static_cast<int64_t>(T.b) * L + i) * H + T.h * hd
                    : nullptr;
  }
  // The warp's keys, in 16-key chunks counted from lo (warp-uniform).
  T.wlo = __reduce_min_sync(0xffffffffu, min(T.jlo[0], T.jlo[1]));
  T.whi = __reduce_max_sync(0xffffffffu, max(T.jhi[0], T.jhi[1]));
  T.active = T.wlo <= T.whi;
  T.c0 = T.active ? (T.wlo - T.lo) >> 4 : 0;
  T.c1 = T.active ? ((T.whi - T.lo) >> 4) + 1 : 0;
  return T;
}

// o = 0 on the rows of a warp whose queries reach no key (past their
// slot's windows).
template <bool kVec>
__device__ __forceinline__ void store_zeros(const Tile& T, int dpad, int t,
                                            int hd) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < dpad / 8; ++d) {
    store_o<kVec>(T.orow[0], T.orow[1], zero, d, t, hd);
  }
}

// The resident kernel (win <= 16: the main path's band 12): K staged in
// one key block; each warp keeps S for its 3 chunks in registers, takes
// the row maxima and sums, and then, n-tile pair by n-tile pair of v's
// columns, forms o from P in registers and writes it, reading v from
// device memory (K alone in shared memory holds four blocks on an SM).
// A float32 softmax divides each numerator by z before P v (as
// torch.softmax does); a bfloat16 one multiplies the exact bf16(e) and
// divides the output.
template <bool kBf16Softmax, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
    attention_resident(const float* __restrict__ qkv,
                       const int* __restrict__ lengths, int wps,
                       float* __restrict__ out, int L, int H, int hd,
                       int win, int n_tiles) {
  extern __shared__ float smem[];
  const int kld = k_ld(hd), vld = v_ld(hd);
  const int dpad = padded_head_dim(hd);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const Tile T = make_tile(qkv, lengths, wps, out, L, H, hd, win, n_tiles,
                           warp, g);
  float* ks = smem;
  const int rows = T.hi - T.lo;
  // The first q fragments travel while K lands.
  stage_rows<kVec>(ks, nullptr, T.base, 3 * H, H, T.h, hd, dpad, kld, vld,
                   T.lo, rows, true, false, warp, lane);
  cp_async_commit();
  float2 qb[kQDepth][4];
  prefetch_q<kVec>(qb, T.qr[0], T.qr[1], dpad / 16, t, hd);
  cp_async_wait<0>();
  __syncthreads();
  if (!T.active) {
    store_zeros<kVec>(T, dpad, t, hd);
    return;
  }
  if (T.c1 - T.c0 > kResidentChunks) __trap();  // the host picked wrong

  constexpr int kNT = 2 * kResidentChunks;
  float s[kNT][4];
  s_tiles<kNT, kVec>(s, qb, ks, kld, 16 * T.c0, rows, T.qr[0], T.qr[1], hd,
                     dpad / 16, g, t);
  float m[2] = {-INFINITY, -INFINITY};
  mask_s<kNT, kBf16Softmax>(s, T.lo + 16 * T.c0, T.jlo, T.jhi, t, m);
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  float sum[2] = {0.f, 0.f};
  numerators<kNT, kBf16Softmax>(s, m, sum);
  float z[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = quad_sum(sum[r]);
    z[r] = kBf16Softmax ? bf16_round(total) : total;
  }
  constexpr int kP = kBf16Softmax ? 1 : 3;
  uint32_t a[kResidentChunks][kP][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float zr = z[e >> 1];
      s[nt][e] = kBf16Softmax ? bf16_round(s[nt][e])
                              : (zr > 0.f ? s[nt][e] / zr : 0.f);
    }
#pragma unroll
  for (int ch = 0; ch < kResidentChunks; ++ch) {
    p_frag<kP>(a[ch], s[2 * ch], s[2 * ch + 1]);
  }
  const float* v = T.base + static_cast<int64_t>(T.lo) * 3 * H + 2 * H +
                   T.h * hd;
  const int n_dt = dpad / 8;  // even
#pragma unroll 1
  for (int d = 0; d < n_dt; d += 2) {
    float acc[2][kResidentChunks][4] = {};
#pragma unroll
    for (int dd = 0; dd < 2; ++dd)
#pragma unroll
      for (int ch = 0; ch < kResidentChunks; ++ch) {
        uint32_t b[3][2];
        v_frag<true>(b, v, 3 * H, hd, 16 * (T.c0 + ch), rows, d + dd, g, t);
        mma_pieces<kP, 3>(acc[dd][ch], a[ch], b);
      }
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[dd][0][e] + acc[dd][1][e] + acc[dd][2][e];
        if (kBf16Softmax) {
          const float zr = z[e >> 1];
          v[e] = zr > 0.f ? v[e] / zr : 0.f;
        }
      }
      store_o<kVec>(T.orow[0], T.orow[1], v, d + dd, t, hd);
    }
  }
}

// The streaming kernel (any band: win > 16, up to slots of 256 without
// one): K/V in key blocks of 96 rows and two passes, the row maxima
// first, then the numerators and P v, chunk by chunk, so that every e
// sees the final max as the reference's does; o accumulates in
// registers across key blocks and is divided by z at the end.
template <bool kBf16Softmax, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    attention_streaming(const float* __restrict__ qkv,
                        const int* __restrict__ lengths, int wps,
                        float* __restrict__ out, int L, int H, int hd,
                        int win, int n_tiles) {
  extern __shared__ float smem[];
  const int kld = k_ld(hd), vld = v_ld(hd);
  const int dpad = padded_head_dim(hd);
  const int n_ks = dpad / 16, n_dt = dpad / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const Tile T = make_tile(qkv, lengths, wps, out, L, H, hd, win, n_tiles,
                           warp, g);
  float* ks = smem;
  float* vs = smem + staged_rows(L, win) * kld;
  const int n_kb = (T.hi - T.lo + kKeyBlock - 1) / kKeyBlock;

  float m[2] = {-INFINITY, -INFINITY};
  for (int kb = 0; kb < n_kb; ++kb) {
    const int rows = min(kKeyBlock, T.hi - T.lo - kb * kKeyBlock);
    stage_rows<kVec>(ks, vs, T.base, 3 * H, H, T.h, hd, dpad, kld, vld,
                     T.lo + kb * kKeyBlock, rows, true, false, warp, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int cb = kb * kChunks;
    for (int c = max(T.c0, cb); c < min(T.c1, cb + kChunks); ++c) {
      float s[2][4];
      float2 qb[kQDepth][4];
      prefetch_q<kVec>(qb, T.qr[0], T.qr[1], n_ks, t, hd);
      s_tiles<2, kVec>(s, qb, ks, kld, 16 * (c - cb), rows, T.qr[0],
                       T.qr[1], hd, n_ks, g, t);
      mask_s<2, kBf16Softmax>(s, T.lo + 16 * c, T.jlo, T.jhi, t, m);
    }
    __syncthreads();
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);

  constexpr int kP = kBf16Softmax ? 1 : 3;
  float o[kMaxDTiles][4] = {};
  float sum[2] = {0.f, 0.f};
  for (int kb = 0; kb < n_kb; ++kb) {
    const int rows = min(kKeyBlock, T.hi - T.lo - kb * kKeyBlock);
    stage_rows<kVec>(ks, vs, T.base, 3 * H, H, T.h, hd, dpad, kld, vld,
                     T.lo + kb * kKeyBlock, rows, true, true, warp, lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int cb = kb * kChunks;
    for (int c = max(T.c0, cb); c < min(T.c1, cb + kChunks); ++c) {
      float s[2][4];
      float2 qb[kQDepth][4];
      prefetch_q<kVec>(qb, T.qr[0], T.qr[1], n_ks, t, hd);
      s_tiles<2, kVec>(s, qb, ks, kld, 16 * (c - cb), rows, T.qr[0],
                       T.qr[1], hd, n_ks, g, t);
      float unused[2] = {-INFINITY, -INFINITY};
      mask_s<2, kBf16Softmax>(s, T.lo + 16 * c, T.jlo, T.jhi, t, unused);
      numerators<2, kBf16Softmax>(s, m, sum);
      if (kBf16Softmax) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = bf16_round(s[nt][e]);
      }
      uint32_t a[kP][4];
      p_frag<kP>(a, s[0], s[1]);
#pragma unroll
      for (int d = 0; d < kMaxDTiles; ++d) {
        if (d >= n_dt) break;
        uint32_t b[3][2];
        v_frag<false>(b, vs, vld, hd, 16 * (c - cb), rows, d, g, t);
        mma_pieces<kP, 3>(o[d], a, b);
      }
    }
    __syncthreads();
  }
  if (!T.active) {
    store_zeros<kVec>(T, dpad, t, hd);
    return;
  }
  float z[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = quad_sum(sum[r]);
    z[r] = kBf16Softmax ? bf16_round(total) : total;
  }
#pragma unroll
  for (int d = 0; d < kMaxDTiles; ++d) {
    if (d >= n_dt) break;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float zr = z[e >> 1];
      v[e] = zr > 0.f ? o[d][e] / zr : 0.f;
    }
    store_o<kVec>(T.orow[0], T.orow[1], v, d, t, hd);
  }
}

template <bool kBf16Softmax, bool kVec>
int launch(const float* qkv, const int* lengths, int wps, float* out, int B,
           int L, int H, int head_dim, int win, cudaStream_t stream) {
  auto kernel = win <= kResidentMaxWin
                    ? attention_resident<kBf16Softmax, kVec>
                    : attention_streaming<kBf16Softmax, kVec>;
  const size_t smem = smem_bytes(L, head_dim, win);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (L + kTile - 1) / kTile;
  dim3 grid(B * n_tiles, H / head_dim);
  kernel<<<grid, kThreads, smem, stream>>>(qkv, lengths, wps, out, L, H,
                                           head_dim, win, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dc_attention_smem_bytes(int L, int H, int num_heads,
                                       int win) {
  return static_cast<int>(smem_bytes(L, H / num_heads, win));
}

// lengths: [B, wps] int32 window widths per slot, or null (one window
// of length L per row). softmax_bf16: the attn_softmax_dtype=bfloat16
// variant. vec: rows of qkv and out 16-byte aligned (head_dim and H
// multiples of 4, 16-byte aligned pointers: 16-byte copies and 8-byte
// q loads and stores); the wrapper says which.
extern "C" int dc_attention(const float* qkv, const int* lengths, int wps,
                            float* out, int B, int L, int H, int num_heads,
                            int win, int softmax_bf16, int vec,
                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int head_dim = H / num_heads;
  if (head_dim > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  if (softmax_bf16) {
    return vec ? launch<true, true>(qkv, lengths, wps, out, B, L, H, head_dim,
                                    win, stream)
               : launch<true, false>(qkv, lengths, wps, out, B, L, H,
                                     head_dim, win, stream);
  }
  return vec ? launch<false, true>(qkv, lengths, wps, out, B, L, H, head_dim,
                                   win, stream)
             : launch<false, false>(qkv, lengths, wps, out, B, L, H, head_dim,
                                    win, stream);
}
