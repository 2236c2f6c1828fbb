// Tensor-core GEMMs with exactly split operands: every dense product of
// K1, K2 and K4 (gemm.cu) and K2's fused FFN (ffn.cu).
//
// What they compute is the reference's _dequant_matmul
// (deepconsensus_tpu/ops/fused_encoder_block.py): float32 activations
// times weights widened to float32 (bf16, f32 or int8 values), summed in
// float32. The tensor cores multiply bf16 by bf16 into a float32
// accumulator, and such a product is exact (8 x 8 significant bits). So
// each operand is split, in registers, into bf16 pieces whose sum is the
// operand: x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2). Each
// remainder is exact in float32 (a float minus its own rounding), and
// three pieces hold all 24 bits of a float32. The MMAs then sum the
// cross products of the pieces, largest last:
//   bf16 A (the compute dtype's activations):       1 piece
//   f32 A, bf16 compute:                            2 pieces, A to 16
//     bits (<= 2^-17 relative), far below a bf16 output's rounding
//   f32 A, f32 compute:                             3 pieces (exact)
//   bf16 B, int8 B (int8 is exact in bf16):         1 piece
//   f32 B:                                          3 pieces, and of the
//     products of 3 x 3 pieces the 6 above 2^-24 relative are kept
// Only the order of the float32 sums differs from a float32 matmul.
// The wrapper picks the counts (ops/_kernels.py::split_pieces).
//
// Design for the H100: mma.sync.m16n8k16 (bf16 in, float32 out) fed by
// ldmatrix for bf16 tiles and by 8-byte shared-memory reads, split in
// registers, for float32 ones; a multi-stage ring of shared-memory tiles
// filled by cp.async (16-byte copies; 8-byte ones for int8 weights,
// whose rows of 280 and 840 bytes are 8- but not 16-byte aligned), so
// the loads of tile k+2 overlap the MMAs of tile k; dynamic shared
// memory above 48 KB. Row strides are padded so that neither ldmatrix
// nor the scalar fragment reads conflict on a bank.
#pragma once

#include <type_traits>

#include "gemm_epilogue.cuh"

namespace dc {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One cp.async of BYTES (16 or 8); an invalid copy writes zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A barrier for the `threads` threads that call it with this id (1-15).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16x2 register (lo in the low half), rounded to
// nearest.
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (lo, hi) as P bf16x2 pieces, largest first, written to out[p * stride].
// Each piece rounds what the earlier ones left; that remainder is exact
// in float32.
template <int P>
__device__ __forceinline__ void split_pair(float lo, float hi, uint32_t* out,
                                           int stride) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const uint32_t bits = bf16x2_bits(lo, hi);
    out[p * stride] = bits;
    if (p + 1 < P) {
      lo -= __uint_as_float(bits << 16);
      hi -= __uint_as_float(bits & 0xffff0000u);
    }
  }
}

// Two floats that hold integers of at most 8 significant bits as a
// bf16x2 (lo in the low half): their upper halves, exactly.
__device__ __forceinline__ uint32_t small_ints_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Eight int8 values (8 bytes) as eight bf16 values (16 bytes), exactly
// and without conversion instructions (which issue at a fraction of the
// FMA rate): each byte ^ 0x80 is the value + 128, set into the mantissa
// of 2^23; subtracting 2^23 + 128 leaves the value.
__device__ __forceinline__ uint4 widen_int8x8(uint2 q) {
  uint32_t out[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t w = (h ? q.y : q.x) ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // bytes 0x4B0000bb: 2^23 + byte
      f[k] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + k)) -
             8388736.f;
    }
    out[2 * h] = small_ints_bf16x2(f[0], f[1]);
    out[2 * h + 1] = small_ints_bf16x2(f[2], f[3]);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// d += sum of the piece products a[p] * b[q] with p + q < max(AP, BP),
// the smallest first.
template <int AP, int BP>
__device__ __forceinline__ void mma_pieces(float* d, const uint32_t (&a)[AP][4],
                                           const uint32_t (&b)[BP][2]) {
  constexpr int kTerms = AP > BP ? AP : BP;
#pragma unroll
  for (int s = kTerms - 1; s >= 0; --s) {
#pragma unroll
    for (int p = 0; p < AP; ++p) {
      const int q = s - p;
      if (q >= 0 && q < BP) mma16816(d, a[p], b[q][0], b[q][1]);
    }
  }
}

// The A fragment (rows m0..m0+15, columns k0..k0+15) of a row-major
// shared tile with ld elements per row: ldmatrix for bf16, float2 reads
// split into AP pieces for float32.
template <typename TA, int AP>
__device__ __forceinline__ void load_a_frag(const TA* s, int ld, int m0,
                                            int k0, int lane,
                                            uint32_t (&a)[AP][4]) {
  if constexpr (sizeof(TA) == 2) {
    static_assert(AP == 1, "a bf16 A is one piece");
    ldsm_x4(a[0], s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
  } else {
    const float* p = s + (m0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    const float2 v0 = *reinterpret_cast<const float2*>(p);
    const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * ld);
    const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
    split_pair<AP>(v0.x, v0.y, &a[0][0], 4);
    split_pair<AP>(v1.x, v1.y, &a[0][1], 4);
    split_pair<AP>(v2.x, v2.y, &a[0][2], 4);
    split_pair<AP>(v3.x, v3.y, &a[0][3], 4);
  }
}

// The A fragment of P bf16 piece planes (plane p at s + p * plane).
template <int P>
__device__ __forceinline__ void load_a_planes(const bf16* s, int plane, int ld,
                                              int m0, int k0, int lane,
                                              uint32_t (&a)[P][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    ldsm_x4(a[p], s + p * plane + (m0 + (lane & 15)) * ld + k0 +
                      (lane >> 4) * 8);
  }
}

// The B fragment (rows k0..k0+15, columns n0..n0+7) of a row-major
// [k][n] shared tile: ldmatrix.trans for bf16; for int8 and float32 the
// four values a thread holds, (k0 + 2t, +1, +8, +9; n0 + g), read one by
// one, widened (int8) or split into BP pieces (float32).
template <typename TB, int BP>
__device__ __forceinline__ void load_b_frag(const TB* s, int ld, int k0,
                                            int n0, int lane,
                                            uint32_t (&b)[BP][2]) {
  if constexpr (sizeof(TB) == 2) {
    static_assert(BP == 1, "a bf16 B is one piece");
    ldsm_x2_trans(b[0], s + (k0 + (lane & 15)) * ld + n0);
  } else if constexpr (sizeof(TB) == 1) {
    static_assert(BP == 1, "int8 is exact in one piece");
    const int8_t* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
    b[0][0] = bf16x2_bits(static_cast<float>(p[0]), static_cast<float>(p[ld]));
    b[0][1] = bf16x2_bits(static_cast<float>(p[8 * ld]),
                          static_cast<float>(p[9 * ld]));
  } else {
    const float* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
    split_pair<BP>(p[0], p[ld], &b[0][0], 2);
    split_pair<BP>(p[8 * ld], p[9 * ld], &b[0][1], 2);
  }
}

// acc[i][j] += a[i] @ B[k0 .. k0 + 15, n0 + 8 j .. n0 + 8 j + 7] for MT
// row tiles and NT column tiles of a [k][n] shared tile. A bf16 B comes
// two column tiles per ldmatrix.x4.trans; int8 and float32 tile by tile
// (their widened or split fragments cost registers).
template <int BP, int MT, int NT, int AP, typename TB>
__device__ __forceinline__ void mma_tiles(float (&acc)[MT][NT][4],
                                          const uint32_t (&a)[MT][AP][4],
                                          const TB* s, int ld, int k0, int n0,
                                          int lane) {
  constexpr int kPairs = sizeof(TB) == 2 ? NT / 2 : 0;
#pragma unroll
  for (int j = 0; j < 2 * kPairs; j += 2) {
    uint32_t r[4];
    ldsm_x4_trans(r, s + (k0 + (lane & 15)) * ld + n0 + j * 8 +
                         (lane >> 4) * 8);
    const uint32_t b0[1][2] = {{r[0], r[1]}};
    const uint32_t b1[1][2] = {{r[2], r[3]}};
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma_pieces<AP, 1>(acc[i][j], a[i], b0);
      mma_pieces<AP, 1>(acc[i][j + 1], a[i], b1);
    }
  }
#pragma unroll
  for (int j = 2 * kPairs; j < NT; ++j) {
    uint32_t b[BP][2];
    load_b_frag<TB, BP>(s, ld, k0, n0 + j * 8, lane, b);
#pragma unroll
    for (int i = 0; i < MT; ++i) mma_pieces<AP, BP>(acc[i][j], a[i], b);
  }
}

// cp.async of rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major
// [rows, cols] matrix g (ld_g elements per row) into a shared tile (ld_s
// elements per row), CH bytes per copy; copies past rows or cols write
// zeros. cols must be a multiple of CH / sizeof(T).
template <typename T, int R, int C, int CH, int kThreads>
__device__ __forceinline__ void load_tile(T* s, int ld_s, const T* g,
                                          int ld_g, int rows, int cols,
                                          int r0, int c0, int tid) {
  constexpr int kE = CH / sizeof(T);
  constexpr int kPerRow = C / kE;
  static_assert(C % kE == 0, "tile width is whole copies");
#pragma unroll 4
  for (int i = tid; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kE;
    const int gr = r0 + r;
    const int gc = c0 + c;
    const bool ok = gr < rows && gc < cols;
    cp_async<CH>(s + r * ld_s + c,
                 ok ? g + static_cast<int64_t>(gr) * ld_g + gc : g, ok);
  }
}

// Bytes per cp.async of a B (weight) tile: 8 for int8, whose rows are
// only 8-byte aligned at N = 280 and 840.
template <typename TB>
__host__ __device__ constexpr int b_copy_bytes() {
  return sizeof(TB) == 1 ? 8 : 16;
}

// Padded row strides (elements) of a [k][n] weight tile of width w, so
// that the B fragment reads of one warp hit distinct banks: float32 and
// int8 are read one value per thread at rows k0 + 2t, so two rows must
// lie an odd multiple of 8 banks apart (float32: stride = 4 mod 8 words;
// int8: stride = 16 mod 32 bytes); bf16 is read by ldmatrix.trans, 8
// rows of 16 bytes that must fall in distinct 16-byte bank groups.
template <typename TB>
__host__ __device__ constexpr int b_ld(int w) {
  return sizeof(TB) == 4   ? (w + 7) / 8 * 8 + 4
         : sizeof(TB) == 2 ? (w + 7) / 8 * 8 + 8
                           : (w + 15) / 32 * 32 + 16;
}

// ------------------------------------------------------------------------
// The dense GEMM: out[M, N] = epilogue(A[M, K] @ B[K, N]).
//
// A block computes a 128 x 144 output tile with 8 warps of 32 x 72 (2 x 9
// MMA tiles, 72 float32 accumulators a thread) over 32-deep k tiles in a
// 3-stage ring. 144 columns cover N = 280 in 2 tiles and 840 in 6 with
// 2.8% of the columns masked (128 would mask 27% at N = 280); N = 2048
// takes 15 tiles, 5.5% masked. K = 280 is 8.75 k tiles: the tail's
// columns are zero-filled in shared memory. M (102,400 per pack, any
// value in the tests) is masked per row. Rows of bf16 (560 / 1,680 /
// 4,096 bytes) and float32 (1,120 / 3,360 / 8,192) operands are 16-byte
// aligned; int8 weight rows take 8-byte copies.
// ------------------------------------------------------------------------
template <typename TA, typename TB>
struct GemmTile {
  static constexpr int kBM = 128, kBN = 144, kBK = 32, kStages = 3;
  static constexpr int kThreads = 256, kWM = 32, kWN = 72;
  static constexpr int kMT = kWM / 16, kNT = kWN / 8;
  static constexpr int kALd = kBK + 8;  // 160-byte f32 / 80-byte bf16 rows
  static constexpr int kBLd = b_ld<TB>(kBN);
  static constexpr int kABytes = kBM * kALd * sizeof(TA);
  static constexpr int kBBytes = kBK * kBLd * sizeof(TB);
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kABytes % 128 == 0 && kBBytes % 16 == 0, "stage alignment");
};

template <typename TA, int AP, typename TB, int BP>
__global__ void __launch_bounds__(256, sizeof(TB) == 4 || AP == 3 ? 1 : 2)
    mma_gemm_kernel(const TA* __restrict__ a, const TB* __restrict__ b, int M,
                    int N, int K, int m_begin, Epilogue ep) {
  using T = GemmTile<TA, TB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int n0 = blockIdx.x * T::kBN;
  const int m0 = m_begin + blockIdx.y * T::kBM;
  const int k_tiles = (K + T::kBK - 1) / T::kBK;

  auto stage_a = [&](int s) {
    return reinterpret_cast<TA*>(smem + s * T::kStageBytes);
  };
  auto stage_b = [&](int s) {
    return reinterpret_cast<TB*>(smem + s * T::kStageBytes + T::kABytes);
  };
  auto load = [&](int s, int kt) {
    load_tile<TA, T::kBM, T::kBK, 16, T::kThreads>(
        stage_a(s), T::kALd, a, K, M, K, m0, kt * T::kBK, tid);
    load_tile<TB, T::kBK, T::kBN, b_copy_bytes<TB>(), T::kThreads>(
        stage_b(s), T::kBLd, b, N, K, N, kt * T::kBK, n0, tid);
  };

  float acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();  // tile kt landed; tile kt - 1's stage is free
    const int next = kt + T::kStages - 1;
    if (next < k_tiles) load(next % T::kStages, next);
    cp_async_commit();
    const TA* as = stage_a(kt % T::kStages);
    const TB* bs = stage_b(kt % T::kStages);
#pragma unroll
    for (int k0 = 0; k0 < T::kBK; k0 += 16) {
      uint32_t af[T::kMT][AP][4];
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        load_a_frag<TA, AP>(as, T::kALd, wm * T::kWM + i * 16, k0, lane,
                            af[i]);
      }
      mma_tiles<BP>(acc, af, bs, T::kBLd, k0, wn * T::kWN, lane);
    }
  }

  const float alpha = ep.res ? *ep.alpha : 0.f;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * T::kWM + i * 16 + g + half * 8;
      if (m >= M) continue;
      const int prow = ep.pos ? pos_row(ep, m) : -1;
#pragma unroll
      for (int j = 0; j < T::kNT; ++j) {
        const int n = n0 + wn * T::kWN + j * 8 + 2 * t;
        if (n < N) {
          epilogue_store2(ep, m, n, N, acc[i][j][2 * half],
                          acc[i][j][2 * half + 1], alpha, prow);
        }
      }
    }
  }
}

template <typename TA, int AP, typename TB, int BP>
inline cudaError_t launch_mma_gemm(const TA* a, const TB* b, int M, int N,
                                   int K, const Epilogue& ep,
                                   cudaStream_t stream) {
  using T = GemmTile<TA, TB>;
  auto kernel = mma_gemm_kernel<TA, AP, TB, BP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  // The column tiles of a row tile are neighbours in the grid (x), so
  // they run together and A comes from device memory about once; y holds
  // at most 65,535 row tiles, so a longer A takes several launches.
  constexpr int kMaxRowTiles = 65535;
  const int row_tiles = (M + T::kBM - 1) / T::kBM;
  for (int t0 = 0; t0 < row_tiles; t0 += kMaxRowTiles) {
    const dim3 grid((N + T::kBN - 1) / T::kBN,
                    row_tiles - t0 < kMaxRowTiles ? row_tiles - t0
                                                  : kMaxRowTiles);
    kernel<<<grid, T::kThreads, T::kSmem, stream>>>(a, b, M, N, K,
                                                    t0 * T::kBM, ep);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return launched;
  }
  return cudaSuccess;
}

// ------------------------------------------------------------------------
// K2's FFN in one launch: out = res + alpha * (relu(x @ Wf * fs + bf) @ Wo
// * os + bo), x [M, H] (H <= 288), Wf [H, F], Wo [F, H].
//
// A block owns 64 tokens. Their x rows are split once into AP bf16 piece
// planes in shared memory. The block then walks F in chunks of FC (32;
// 16 for float32 weights, whose tiles are twice as large). Phase 1 forms
// the [64, FC] chunk of h = x @ Wf[:, chunk] on the tensor cores: each
// warp pair owns 16 rows and splits the 18 K steps between its warps, so
// each x fragment is read from shared memory once per chunk; the pair
// swaps partial sums through shared memory, and each warp applies the
// column scale, bias and ReLU in float32 to its half of the columns and
// stores them split into HP bf16 piece planes. Phase 2 adds h_chunk @
// Wo[chunk, :] into a [64, 288] float32 accumulator that stays in
// registers across the whole F loop (each warp 32 rows x 72 columns: 2 x
// 9 MMA tiles, 72 accumulators a thread). Named barriers order the pair
// swap and the four warps that share 32 rows of h. The weight chunks
// stream through a ring of 3 stages by cp.async (2 for float32 weights);
// int8 chunks are loaded into registers a chunk ahead, widened to bf16
// once per block and stored to a 2-stage ring. So h never leaves the
// chip: the unfused pair of GEMMs wrote and read it back as float32
// [M, F], 1.68 GB per block at M = 102,400. It is bound by operations
// (ffn.cu); what holds it back is that mma.sync takes every operand
// through registers (ldmatrix) with one 8-warp block an SM, where wgmma
// would read B from shared memory (PERF.md).
// ------------------------------------------------------------------------
template <typename TA, int AP, typename TB, int BP, int HP>
struct FfnTile {
  static constexpr int kBM = 64, kHMax = 288, kThreads = 256;
  static constexpr int kFC = sizeof(TB) == 4 ? 16 : 32;
  // int8 chunks are widened to bf16 once per block (every value is read
  // by four warps) and the ring then holds bf16 tiles.
  static constexpr bool kStaged = sizeof(TB) == 1;
  using TS = typename std::conditional<kStaged, bf16, TB>::type;
  static constexpr int kStages = sizeof(TB) == 2 ? 3 : 2;
  static constexpr int kXLd = kHMax + 8;  // 592-byte bf16 rows
  static constexpr int kHLd = kFC + 8;    // 48- / 80-byte bf16 rows
  static constexpr int kWfLd = b_ld<TS>(kFC);
  static constexpr int kWoLd = b_ld<TS>(kHMax);
  static constexpr int kXPlane = kBM * kXLd;
  static constexpr int kHPlane = kBM * kHLd;
  static constexpr int kXBytes = AP * kXPlane * 2;
  static constexpr int kHBytes = HP * kHPlane * 2;
  static constexpr int kWfBytes = kHMax * kWfLd * sizeof(TS);
  static constexpr int kWoBytes = kFC * kWoLd * sizeof(TS);
  static constexpr int kStageBytes = kWfBytes + kWoBytes;
  // Phase 1's partial sums swapped within each warp pair.
  static constexpr int kSwapBytes = 8 * (kFC / 16) * 4 * 32 * 4;
  static constexpr int kSmem =
      kXBytes + kHBytes + kStages * kStageBytes + kSwapBytes;
  static_assert(kSmem <= 232448, "one block's shared memory");
  static_assert(kXBytes % 16 == 0 && kHBytes % 16 == 0 &&
                kWfBytes % 16 == 0 && kStageBytes % 16 == 0,
                "tile alignment");
};

// One chunk of int8 FFN weights in registers: the [288, FC] filter tile
// (rows past H zero) and the [FC, 288] output tile (columns past H zero)
// as 8-byte pieces, kPer a thread, loaded a chunk ahead of its use.
template <int kFC, int kHMax, int kThreads>
struct Int8Chunk {
  static constexpr int kWfItems = kHMax * (kFC / 8);
  static constexpr int kItems = kWfItems + kFC * (kHMax / 8);
  static constexpr int kPer = (kItems + kThreads - 1) / kThreads;
  uint2 v[kPer];

  __device__ __forceinline__ void load(const int8_t* wf, const int8_t* wo,
                                       int H, int F, int c0, int tid) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      v[j] = make_uint2(0u, 0u);
      if (i < kWfItems) {
        const int r = i / (kFC / 8);
        const int c = (i - r * (kFC / 8)) * 8;
        if (r < H) {
          v[j] = __ldg(reinterpret_cast<const uint2*>(
              wf + static_cast<int64_t>(r) * F + c0 + c));
        }
      } else if (i < kItems) {
        const int r = (i - kWfItems) / (kHMax / 8);
        const int c = (i - kWfItems - r * (kHMax / 8)) * 8;
        if (c < H) {
          v[j] = __ldg(reinterpret_cast<const uint2*>(
              wo + static_cast<int64_t>(c0 + r) * H + c));
        }
      }
    }
  }

  __device__ __forceinline__ void store(bf16* wf_s, int wf_ld, bf16* wo_s,
                                        int wo_ld, int tid) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      bf16* dst;
      if (i < kWfItems) {
        const int r = i / (kFC / 8);
        dst = wf_s + r * wf_ld + (i - r * (kFC / 8)) * 8;
      } else if (i < kItems) {
        const int r = (i - kWfItems) / (kHMax / 8);
        dst = wo_s + r * wo_ld + (i - kWfItems - r * (kHMax / 8)) * 8;
      } else {
        continue;
      }
      *reinterpret_cast<uint4*>(dst) = widen_int8x8(v[j]);
    }
  }
};

template <typename TA, int AP, typename TB, int BP, int HP>
__global__ void __launch_bounds__(256, 1)
    ffn_kernel(const TA* __restrict__ x, const TB* __restrict__ wf,
               const TB* __restrict__ wo, int M, int H, int F,
               const float* __restrict__ f_scale,
               const float* __restrict__ b_filter, Epilogue ep) {
  using T = FfnTile<TA, AP, TB, BP, HP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + T::kXBytes);
  unsigned char* ring = smem + T::kXBytes + T::kHBytes;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // phase 1: the warp's 16 rows of the 64
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * T::kBM;
  const int chunks = F / T::kFC;

  using TS = typename T::TS;
  auto wf_stage = [&](int s) {
    return reinterpret_cast<TS*>(ring + s * T::kStageBytes);
  };
  auto wo_stage = [&](int s) {
    return reinterpret_cast<TS*>(ring + s * T::kStageBytes + T::kWfBytes);
  };
  Int8Chunk<T::kFC, T::kHMax, T::kThreads> staged;
  auto load = [&](int s, int c) {
    if constexpr (T::kStaged) {
      staged.load(wf, wo, H, F, c * T::kFC, tid);
    } else {
      load_tile<TB, T::kHMax, T::kFC, 16, T::kThreads>(
          wf_stage(s), T::kWfLd, wf, F, H, F, 0, c * T::kFC, tid);
      load_tile<TB, T::kFC, T::kHMax, 16, T::kThreads>(
          wo_stage(s), T::kWoLd, wo, H, F, H, c * T::kFC, 0, tid);
    }
  };
  if constexpr (T::kStaged) {
    load(0, 0);
    staged.store(wf_stage(0), T::kWfLd, wo_stage(0), T::kWoLd, tid);
  } else {
#pragma unroll
    for (int s = 0; s < T::kStages - 1; ++s) {
      if (s < chunks) load(s, s);
      cp_async_commit();
    }
  }

  // x's rows as AP bf16 piece planes, zero past M and H (H % 8 == 0).
  for (int i = tid; i < T::kBM * (T::kHMax / 4); i += T::kThreads) {
    const int r = i / (T::kHMax / 4);
    const int c = (i - r * (T::kHMax / 4)) * 4;
    const int m = m0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (m < M && c < H) {
      const TA* src = x + static_cast<int64_t>(m) * H + c;
      if constexpr (sizeof(TA) == 4) {
        const float4 q = *reinterpret_cast<const float4*>(src);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
        const uint2 q = *reinterpret_cast<const uint2*>(src);
        v[0] = __uint_as_float(q.x << 16);
        v[1] = __uint_as_float(q.x & 0xffff0000u);
        v[2] = __uint_as_float(q.y << 16);
        v[3] = __uint_as_float(q.y & 0xffff0000u);
      }
    }
    uint32_t lo[AP], hi[AP];
    split_pair<AP>(v[0], v[1], lo, 1);
    split_pair<AP>(v[2], v[3], hi, 1);
#pragma unroll
    for (int p = 0; p < AP; ++p) {
      *reinterpret_cast<uint2*>(xs + p * T::kXPlane + r * T::kXLd + c) =
          make_uint2(lo[p], hi[p]);
    }
  }

  // Phase 1: warp (wm, wk) forms h[wm * 16 + 0..15, all FC columns] over
  // half of the K steps (wk); the pair then swaps the partial sums of the
  // column half each finishes. Phase 2: warp (wm2, wn2) adds into
  // out[wm2 * 32 + 0..31, wn2 * 72 + 0..71] (2 x 9 MMA tiles).
  const int wk = warp & 1;
  const int wm2 = warp >> 2;
  const int wn2 = warp & 3;
  constexpr int kNT1 = T::kFC / 8;        // phase-1 MMA tiles per warp
  constexpr int kHalf = kNT1 / 2;         // the tiles a warp finishes
  constexpr int kKSteps = T::kHMax / 32;  // 9: half of the 18 K steps
  constexpr int kNT2 = T::kHMax / 32;     // 9 phase-2 tiles per row tile
  float* swap = reinterpret_cast<float*>(smem + T::kXBytes + T::kHBytes +
                                         T::kStages * T::kStageBytes);
  float acc[2][kNT2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    if constexpr (T::kStaged) {
      __syncthreads();  // chunk c stored; chunk c - 1's stage and h free
      if (c + 1 < chunks) load(0, c + 1);  // into registers
    } else {
      cp_async_wait<T::kStages - 2>();
      __syncthreads();  // chunk c landed; chunk c - 1's stage and h free
      const int next = c + T::kStages - 1;
      if (next < chunks) load(next % T::kStages, next);
      cp_async_commit();
    }
    const TS* wfs = wf_stage(c % T::kStages);
    const TS* wos = wo_stage(c % T::kStages);

    float hacc[1][kNT1][4];
#pragma unroll
    for (int j = 0; j < kNT1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[0][j][e] = 0.f;
#pragma unroll 3
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int k0 = (wk * kKSteps + ks) * 16;
      uint32_t af[1][AP][4];
      load_a_planes<AP>(xs, T::kXPlane, T::kXLd, wm * 16, k0, lane, af[0]);
      mma_tiles<BP>(hacc, af, wfs, T::kWfLd, k0, 0, lane);
    }
    // Swap halves: this warp finishes columns wk * FC / 2 + 0..FC / 2 - 1
    // and hands the partner its sums of the other half.
    float* mine = swap + warp * (kHalf * 4 * 32);
    const float* theirs = swap + (warp ^ 1) * (kHalf * 4 * 32);
#pragma unroll
    for (int j = 0; j < kHalf; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(j * 4 + e) * 32 + lane] =
            wk ? hacc[0][j][e] : hacc[0][kHalf + j][e];
      }
    named_barrier(1 + wm, 64);
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int col = wk * (T::kFC / 2) + j * 8 + 2 * t;
      const int f = c * T::kFC + col;
      const float s0 = f_scale ? f_scale[f] : 1.f;
      const float s1 = f_scale ? f_scale[f + 1] : 1.f;
      const float b0 = b_filter[f];
      const float b1 = b_filter[f + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // Constant indices only (a runtime one would put hacc in local
        // memory).
        float v0 = wk ? hacc[0][kHalf + j][2 * half] : hacc[0][j][2 * half];
        float v1 =
            wk ? hacc[0][kHalf + j][2 * half + 1] : hacc[0][j][2 * half + 1];
        v0 += theirs[(j * 4 + 2 * half) * 32 + lane];
        v1 += theirs[(j * 4 + 2 * half + 1) * 32 + lane];
        if (f_scale) {
          v0 *= s0;
          v1 *= s1;
        }
        v0 = fmaxf(v0 + b0, 0.f);
        v1 = fmaxf(v1 + b1, 0.f);
        uint32_t pieces[HP];
        split_pair<HP>(v0, v1, pieces, 1);
        const int row = wm * 16 + g + half * 8;
#pragma unroll
        for (int p = 0; p < HP; ++p) {
          *reinterpret_cast<uint32_t*>(hs + p * T::kHPlane + row * T::kHLd +
                                       col) = pieces[p];
        }
      }
    }
    named_barrier(5 + wm2, 128);  // h's 32 rows of this warp quad stored

#pragma unroll
    for (int k0 = 0; k0 < T::kFC; k0 += 16) {
      uint32_t hf[2][HP][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        load_a_planes<HP>(hs, T::kHPlane, T::kHLd, wm2 * 32 + i * 16, k0,
                          lane, hf[i]);
      }
      mma_tiles<BP>(acc, hf, wos, T::kWoLd, k0, wn2 * 72, lane);
    }
    if constexpr (T::kStaged) {  // chunk c + 1, widened, to the free stage
      if (c + 1 < chunks) {
        staged.store(wf_stage((c + 1) % T::kStages), T::kWfLd,
                     wo_stage((c + 1) % T::kStages), T::kWoLd, tid);
      }
    }
  }

  const float alpha = *ep.alpha;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm2 * 32 + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kNT2; ++j) {
        const int n = wn2 * 72 + j * 8 + 2 * t;
        if (n < H) {
          epilogue_store2(ep, m, n, H, acc[i][j][2 * half],
                          acc[i][j][2 * half + 1], alpha, -1);
        }
      }
    }
  }
}

template <typename TA, int AP, typename TB, int BP, int HP>
inline cudaError_t launch_ffn(const TA* x, const TB* wf, const TB* wo, int M,
                              int H, int F, const float* f_scale,
                              const float* b_filter, const Epilogue& ep,
                              cudaStream_t stream) {
  using T = FfnTile<TA, AP, TB, BP, HP>;
  if (H > T::kHMax || H % 8 || F % T::kFC) return cudaErrorInvalidValue;
  auto kernel = ffn_kernel<TA, AP, TB, BP, HP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + T::kBM - 1) / T::kBM, T::kThreads, T::kSmem, stream>>>(
      x, wf, wo, M, H, F, f_scale, b_filter, ep);
  return cudaGetLastError();
}

}  // namespace mma
}  // namespace dc
