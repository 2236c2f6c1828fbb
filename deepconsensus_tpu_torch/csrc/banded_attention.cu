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
// transposes); the mask is [B, H, L, L] uint8. Every sum runs in
// float32, stores round to the input's type. No floating-point atomics:
// every output element is written once by one thread, so results repeat
// from run to run.
//
// K5 and K7 on the tensor cores: band_tiles.cuh's forward body, the one
// K8 runs (softmax_fwd_rows), in banded_fwd_tc_kernel<T, kMask>. A block
// of 4 warps owns 64 query rows of one (window, head), the heads of a
// tile in neighbouring blocks; q [64, D] is staged once, and K and V walk
// [r0 - win, r1 + win) in chunks of 16 through a 3-stage cp.async ring
// (5 chunks for rows 0-63 and 3 for rows 64-99 at L = 100, band 12; 8
// without a band at L = 128). S = q k^T comes into registers as four MMA
// chains (the exact operand splits below), the online softmax runs on
// the accumulators (running max and sum a row by quad shuffles, acc =
// acc alpha + P v) and o stays in registers; K5 divides by the sum at
// the end. K7's sum takes p without the mask and its P v takes p drop,
// drop = mask / keep_prob from the mask's bytes of the thread's
// accumulator positions, read inside the band only, before the chunk's
// S products; o = acc / sum is the reference's (p / sum(p) drop) v up
// to rounding. D is padded to 144 and
// D > 144 takes two column groups (D <= 256, K6's limit too). At D = 140
// they take 48,640 bytes of shared memory bf16 / 96,512 float32 and
// 143 / 164 registers bf16 (K5 / K7), 179 / 201 float32, no spills:
// three bf16 blocks an SM, two float32. Blocks of 2 warps or of the
// whole window (7) were slower at L = 100 (scripts/bench_banded_kernels.py
// --warps).
//
// K6 on the tensor cores, two kernels launched back to back, both on
// band_tiles.cuh's tiles and exact operand splits (bf16 one piece;
// float32 3 x 3 with the 6 products above 2^-24 kept; the weights 2
// pieces for bf16 inputs, 3 for float32). A block of 4 warps owns 64
// rows of one (window, head), each warp one m16 row tile, and walks the
// other side's rows its band reaches in chunks of 16 through a cp.async
// ring (2 stages float32, 3 bf16); warps skip the chunks outside their
// rows' band; D is padded to a multiple of 16 and D > 144 takes two
// column groups. The mask's bytes of the thread's accumulator positions
// (rows g, g + 8; columns 2t, 2t + 1) are read from device memory inside
// the band only, one byte each (rows of odd L are not aligned), loaded
// before the chunk's products so that they arrive under them.
//   - Pass 1, dq over query tiles (band_tiles.cuh's band_dq_kernel, the
//     kernel K9 runs): q and do staged once, k and v chunks in the ring.
//     A first sweep forms S = q k^T and dW = do v^T per chunk (sd_tiles:
//     float32 sums per k-step and compensated, since ds cancels at band
//     0) and takes each row's max m, sum l and r' = sum p dw drop online
//     on the accumulators (quad shuffles, rescaled as the max grows), so
//     r = r' / l = rowsum(dw drop w) with no [L, L] block anywhere; a
//     second sweep forms S and dW again, w = exp(s - m) (1 / l), ds = w
//     (dw drop - r) and dq += ds k (ds the A fragment, k the [k][n] B
//     operand), dq in registers. (m, 1 / l, r) go to a [B, H, L, 3]
//     float32 scratch. The two sweeps take any band: no band at L = 128
//     walks 8 chunks twice with the same registers as band 12's 3.
//   - Pass 2, dk and dv over key tiles (K10's structure): k and v staged
//     once; q, do and their rows' (m, 1 / l, r) chunks in the ring. Per
//     chunk S^T = k q^T and dW^T = v do^T, w^T = exp(S^T - m) (1 / l),
//     dv += (w^T drop) do and dk += ds^T q with ds^T = w^T (dW^T drop -
//     r); dk and dv (2 x 72 floats a thread) in registers. Its S^T sums
//     in another order than pass 1's S, so the two passes' w differ by
//     rounding (the float32 results stay within 1e-4 of the plain
//     version).
// At D = 140 pass 1 takes 115,712 bytes of shared memory float32 / 68,096
// bf16 and 223 / 163 registers (two blocks an SM / three), pass 2
// 114,048 / 68,672 bytes and 255 / 234 registers (two in either), no
// spills. Blocks of 2 warps (32 rows) or of the whole window (7 warps at
// L <= 112, one block an SM) were slower (scripts/bench_banded_kernels.py
// --warps). wgmma and TMA are not used: as K8-K10's probe showed
// (scripts/probe_flash_kernels.py), these kernels wait on the staging
// and the stores, not on the MMA rate.
//
// Bound. At B = 256, L = 100, H = 2, D = 140 the forwards read q, k, v
// (28.7 MB each in float32) and write o, and K6 reads q, k, v, do and
// the mask's band and writes dq, dk, dv: a few operations per byte (the
// band's products are ~0.7 GFLOP forward, ~1.7 GFLOP backward), so
// device memory bounds them: ~34 / ~60 us in float32 at 3.35 TB/s, K5
// 0.017 and K6 0.030 ms in bf16. On an H100 K5 takes 0.067 ms bf16 /
// 0.130 float32 and K7 0.071 / 0.134 (the first port's scalar forward
// 0.160 / 0.159 and 0.167 / 0.165; SDPA's forward with the band 0.523 /
// 0.202). K6 takes 0.205 ms bf16 with the mask
// (pass 1 0.103, pass 2 0.101) and 0.194 without, 0.457 / 0.444 in
// float32 (scripts/bench_banded_kernels.py; the first port's scalar K6
// 0.51 / 0.50).
#include <math.h>
#include <stdint.h>

#include "band_tiles.cuh"

namespace {

using namespace dc::band;

// ------------------------------------------------------------------------
// K5 and K7 on the tensor cores.
// ------------------------------------------------------------------------

// Warps (16 query rows each) of a K5 / K7 block;
// scripts/bench_banded_kernels.py times copies with other counts.
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdRows = kChunk * kFwdWarps;

// K5 (kMask false) and K7. Built for three bf16 blocks an SM (48,640
// bytes of shared memory at D = 140) and two float32 ones (96,512).
template <typename T, bool kMask>
__global__ void __launch_bounds__(kFwdThreads,
                                  kFwdWarps > 4 ? 1 : sizeof(T) == 2 ? 3 : 2)
    banded_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const uint8_t* __restrict__ mask, float keep_prob,
                         T* __restrict__ o, int L, int H, int D, int win,
                         int n_tiles, int ch) {
  softmax_fwd_rows<T, kMask, kFwdWarps>(q, k, v, mask, keep_prob, o, nullptr,
                                        L, H, D, win, n_tiles, ch);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v,
               const uint8_t* mask, float keep_prob, void* o, int B, int L,
               int H, int D, int win, cudaStream_t stream) {
  if (bad_shape(B, L, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (L + kFwdRows - 1) / kFwdRows;
  const dim3 grid(B * n_tiles * H, 1, n_groups(D));
  if (grid.x == 0) return 0;
  const size_t smem = fwd_smem<T>(D, kFwdRows);
  auto kernel = mask != nullptr ? banded_fwd_tc_kernel<T, true>
                                : banded_fwd_tc_kernel<T, false>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, keep_prob, static_cast<T*>(o), L, H, D,
      win, n_tiles, copy_bytes<T>(D, {q, k, v}));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_blocks_per_sm(int D) {
  const size_t smem = fwd_smem<T>(D, kFwdRows);
  const int k5 = blocks_per_sm(banded_fwd_tc_kernel<T, false>, smem,
                               kFwdThreads);
  const int k7 = blocks_per_sm(banded_fwd_tc_kernel<T, true>, smem,
                               kFwdThreads);
  return k5 < k7 ? k5 : k7;
}

// ------------------------------------------------------------------------
// K6 on the tensor cores.
// ------------------------------------------------------------------------

// Warps (16 rows each) of a K6 block; scripts/bench_banded_kernels.py
// times copies with other counts.
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = kChunk * kBwdWarps;

// Pass 2's shared memory: k, v [rows, ld_cols], then bwd_stages x {q, do
// [16, ld_cols], (m, 1 / l, r) [16][3] float32}.
template <typename T>
__host__ __device__ inline size_t kv_bytes(int dp) {
  return 2 * sizeof(T) * static_cast<size_t>(kBwdRows) * ld_cols<T>(dp);
}
template <typename T>
__host__ __device__ inline size_t qo_stage_bytes(int dp) {
  return 2 * sizeof(T) * static_cast<size_t>(kChunk) * ld_cols<T>(dp) +
         3 * sizeof(float) * kChunk;
}
template <typename T>
size_t dkdv_smem(int D) {
  return kv_bytes<T>(padded(D)) +
         bwd_stages<T>() * qo_stage_bytes<T>(padded(D));
}

// Pass 2: dk and dv over key tiles, walking the query chunks whose band
// reaches the block's keys, from pass 1's (m, 1 / l, r).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, kBwdWarps > 4 ? 1 : 2)
    banded_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const uint8_t* __restrict__ mask,
                           const T* __restrict__ dout, float keep_prob,
                           const float* __restrict__ stats,
                           T* __restrict__ dk, T* __restrict__ dv, int L,
                           int H, int D, int win, int n_tiles, int ch) {
  constexpr int AP = in_pieces<T>();
  constexpr int PP = w_pieces<T>();
  constexpr int kStages = bwd_stages<T>();
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int dp = padded(D);
  const int ld = ld_cols<T>(dp);
  const size_t stage_bytes = qo_stage_bytes<T>(dp);
  T* ks = reinterpret_cast<T*>(smem_tc);
  T* vs = ks + kBwdRows * ld;
  unsigned char* ring = smem_tc + kv_bytes<T>(dp);
  auto q_stage = [&](int s) {
    return reinterpret_cast<T*>(ring + s * stage_bytes);
  };
  auto o_stage = [&](int s) { return q_stage(s) + kChunk * ld; };
  auto st_stage = [&](int s) {
    return reinterpret_cast<float*>(o_stage(s) + kChunk * ld);
  };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Block blk = block_of(L, H, D, win, n_tiles, warp, kBwdRows);
  const int64_t bh = static_cast<int64_t>(blk.b) * H + blk.h;
  const float* swin = stats + bh * L * 3;
  const uint8_t* mwin = mask != nullptr ? mask + bh * L * L : nullptr;
  const float inv_keep = 1.f / keep_prob;
  // The mask's column of the thread's two keys (null without a mask).
  const uint8_t* mcol[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = blk.w0 + g + 8 * r;
    mcol[r] = mwin != nullptr && j < L ? mwin + j : nullptr;
  }

  zero_pad<kBwdThreads>(ks, ld, kBwdRows, D, dp, tid);
  zero_pad<kBwdThreads>(vs, ld, kBwdRows, D, dp, tid);
  for (int s = 0; s < kStages; ++s) {
    zero_pad<kBwdThreads>(q_stage(s), ld, kChunk, D, dp, tid);
    zero_pad<kBwdThreads>(o_stage(s), ld, kChunk, D, dp, tid);
  }
  const int ldg = static_cast<int>(blk.ld);
  auto stage = [&](int c) {
    const int s = c % kStages;
    const int row0 = blk.lo + kChunk * c;
    const int n = min(kChunk, blk.hi - row0);
    const int64_t off = blk.base + static_cast<int64_t>(row0) * ldg;
    copy_rows<kBwdThreads>(q_stage(s), ld, q + off, ldg, kChunk, n, D, ch,
                           tid);
    copy_rows<kBwdThreads>(o_stage(s), ld, dout + off, ldg, kChunk, n, D, ch,
                           tid);
    if (tid < 3 * kChunk) {  // (m, 1 / l, r) of the chunk's rows
      const bool ok = tid < 3 * n;
      cp_async<4>(st_stage(s) + tid, ok ? swin + 3 * row0 + tid : swin, ok);
    }
  };
  const int64_t tile = blk.base + static_cast<int64_t>(blk.r0) * ldg;
  copy_rows<kBwdThreads>(ks, ld, k + tile, ldg, kBwdRows, blk.r1 - blk.r0, D,
                         ch, tid);
  copy_rows<kBwdThreads>(vs, ld, v + tile, ldg, kBwdRows, blk.r1 - blk.r0, D,
                         ch, tid);
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
    const float* st = st_stage(c % kStages);
    const int i0 = blk.lo + kChunk * c;
    // Which of the thread's 8 (key, query) positions lie in the band, and
    // their mask bytes, loaded ahead of the products.
    bool valid[2][4];
    uint32_t keep[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * nt + 2 * t + (e & 1);
        const int j = blk.w0 + g + 8 * (e >> 1);
        valid[nt][e] = i < blk.hi && j < L && abs(i - j) <= win;
        keep[nt][e] = mcol[e >> 1] != nullptr && valid[nt][e]
                          ? mcol[e >> 1][static_cast<int64_t>(i) * L]
                          : 1u;
      }
    // S^T (keys x queries) and dW^T.
    float s[2][4], dw[2][4];
    sd_tiles<T, AP>(s, dw, ks, qs, vs, os, ld, kChunk * warp, ld,
                    dp / kChunk, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* mlr = st + 3 * (8 * nt + 2 * t + (e & 1));
        const float drop =
            mwin != nullptr ? drop_of(keep[nt][e], keep_prob, inv_keep) : 1.f;
        const float w = valid[nt][e] ? expf(s[nt][e] - mlr[0]) * mlr[1] : 0.f;
        s[nt][e] = w * drop;
        dw[nt][e] = w * (dw[nt][e] * drop - mlr[2]);  // ds^T
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

// K6's passes (bit 0: pass 1, dq and the stats; bit 1: pass 2, dk and
// dv), back to back on one stream.
template <typename T>
int launch_bwd(const void* q, const void* k, const void* v,
               const uint8_t* mask, const void* dout, float keep_prob,
               void* dq, void* dk, void* dv, float* stats, int B, int L,
               int H, int D, int win, int passes, cudaStream_t stream) {
  if (bad_shape(B, L, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (L + kBwdRows - 1) / kBwdRows;
  const dim3 grid(B * n_tiles * H, 1, n_groups(D));
  if (grid.x == 0) return 0;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int ch = copy_bytes<T>(D, {q, k, v, dout});
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    auto kernel = band_dq_kernel<T, true, kBwdWarps>;
    const size_t smem = dq_smem<T>(D, kBwdRows);
    err = set_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kBwdThreads, smem, stream>>>(
        tq, tk, tv, tdo, nullptr, nullptr, mask, keep_prob,
        static_cast<T*>(dq), stats, L, H, D, win, n_tiles, ch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 2) {
    const size_t smem = dkdv_smem<T>(D);
    err = set_smem(banded_bwd_dkdv_kernel<T>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    banded_bwd_dkdv_kernel<T><<<grid, kBwdThreads, smem, stream>>>(
        tq, tk, tv, mask, tdo, keep_prob, stats, static_cast<T*>(dk),
        static_cast<T*>(dv), L, H, D, win, n_tiles, ch);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <typename T>
int bwd_blocks_per_sm(int pass, int D) {
  return pass == 1 ? blocks_per_sm(band_dq_kernel<T, true, kBwdWarps>,
                                   dq_smem<T>(D, kBwdRows), kBwdThreads)
                   : blocks_per_sm(banded_bwd_dkdv_kernel<T>, dkdv_smem<T>(D),
                                   kBwdThreads);
}

}  // namespace

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
                                         dk, dv, stats, B, L, H, D, win, 3,
                                         stream)
             : launch_bwd<float>(q, k, v, mask, dout, keep_prob, dq, dk, dv,
                                 stats, B, L, H, D, win, 3, stream);
}

// One of K6's passes alone (pass 1 or 2), for timing each: the arguments
// of dc_banded_attention_bwd after the pass; pass 2 reads the stats pass
// 1 wrote.
extern "C" int dc_banded_attention_bwd_pass(
    int pass, const void* q, const void* k, const void* v,
    const uint8_t* mask, const void* dout, float keep_prob, void* dq,
    void* dk, void* dv, float* stats, int is_bf16, int B, int L, int H,
    int D, int win, void* stream_ptr) {
  if (pass != 1 && pass != 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return is_bf16
             ? launch_bwd<__nv_bfloat16>(q, k, v, mask, dout, keep_prob, dq,
                                         dk, dv, stats, B, L, H, D, win,
                                         pass, stream)
             : launch_bwd<float>(q, k, v, mask, dout, keep_prob, dq, dk, dv,
                                 stats, B, L, H, D, win, pass, stream);
}

// Blocks an SM holds at head width D (registers and shared memory), or
// minus a cudaError_t: pass 0 the forward (the fewer of K5's and K7's),
// 1 and 2 K6's passes.
extern "C" int dc_banded_attention_blocks_per_sm(int pass, int is_bf16,
                                                 int D) {
  if (bad_shape(1, 1, 1, D) || pass < 0 || pass > 2) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  if (pass == 0) {
    return is_bf16 ? fwd_blocks_per_sm<__nv_bfloat16>(D)
                   : fwd_blocks_per_sm<float>(D);
  }
  return is_bf16 ? bwd_blocks_per_sm<__nv_bfloat16>(pass, D)
                 : bwd_blocks_per_sm<float>(pass, D);
}
