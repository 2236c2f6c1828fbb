// K1 and K4, part 1: masked embedding gather + condenser + position add,
// on the tensor cores.
//
// Replaces the embed/condense half of the TPU kernels
// deepconsensus_tpu/ops/fused_window_attention.py::_kernel
// (_embed_condense + the pos add) and
// deepconsensus_tpu/ops/ragged_window_attention.py::_kernel
// (_embed_condense + _pos_contribution). The TPU kernel builds a one-hot
// block in VMEM and multiplies it by each family's table, because the
// MXU does products well and gathers badly. Here the gather builds the
// product's A operand in shared memory and the product runs on bf16
// mma.sync (mma_gemm.cuh's fragments, cp.async ring and padded strides):
//   x[m, :] = sum_k table(k)[id(m, row(k)), elem(k)] * w_cond[k, :] + pos
// with table values scaled by sqrt(width) at the compute dtype, id 0
// embedding to zero, ids truncated to int32, shifted and clipped per
// family (prepare_ids). For ragged slots (K4) the epilogue adds
// pos[p - start(p)] inside a window and nothing elsewhere.
//
// Bound: at M = 102,400 tokens, K = 560, N = 280 (288 with the padding)
// the product is 33 GFLOP, 0.033 ms at the bf16 peak, and the bytes are
// ~35 MB of pileup rows in and x out as float32 (115 MB) and, in bf16
// runs, bfloat16 (57 MB): ~0.06 ms at 3.35 TB/s, so a bfloat16 run is
// bound by its bytes. In float32 runs both operands take 3 bf16 pieces
// and the 6 piece products above 2^-24 are kept
// (ops/_kernels.py::split_pieces), 6x the MMAs.
//
// Design (one persistent block per SM slot, 256 threads = 8 warps):
// * Once per block: every table is read in its own dtype, rounded to the
//   compute dtype, times sqrt(width) (rounded to the compute dtype, as
//   scaled_tables does), and stored in shared memory as AP bf16 piece
//   planes, after a zero region that id 0 points at. The column map
//   (pileup row and element of each of the K columns) comes along.
// * Per 64-token tile: the ids of the 64 tokens x R pileup rows are
//   decoded once (truncate, shift, clip, id 0 -> the zero region) into
//   int16 offsets into the planes, with the rows read coalesced along
//   the window (a tile may straddle windows: b = m / L is taken here and
//   nowhere else). The block owns all N columns, so each token's gather
//   happens once, and the [64, 288] float32 accumulator stays in
//   registers (each warp 32 rows x 72 columns: 2 x 9 MMA tiles).
// * Main loop over K in chunks of 32 (the tail zero): the A chunk
//   [64, 32] is built in shared memory from the offsets and the planes
//   (eight columns of one pileup row are one 16-byte read when the
//   family's width is a multiple of 8), double-buffered so the next
//   chunk's gather overlaps this chunk's MMAs; w_cond's [32, 288] chunk
//   comes through a 3-stage cp.async ring, split in registers into BP
//   pieces as gemm.cu does. One __syncthreads per chunk.
// * Epilogue (gemm_epilogue.cuh's Epilogue and epilogue_value): + pos,
//   x stored as float32 and, in bfloat16 runs, the compute-dtype x_base
//   the residual adds to. The accumulators pass through shared memory
//   (the ring, A chunks and ids, idle by then), so x leaves in whole
//   16-byte pieces of rows and each warp's store covers full lines (the
//   fragments' own 8-byte stores cover 32 bytes of each of 8 rows).
#include "mma_gemm.cuh"

using dc::bf16;
using dc::Epilogue;
using dc::epilogue_value;
using dc::pos_row;

namespace {

using namespace dc::mma;

constexpr int kMaxTables = 8;
// Pileup rows a thread decodes per tile (4 threads a token): R <= 128.
constexpr int kRowsPerThread = 32;
constexpr int kMaxRows = 4 * kRowsPerThread;

// The tables as the kernel reads them: the pointer, its dtype, the
// scale sqrt(width) already rounded to the compute dtype, and where its
// entries start in the staged planes (table t's entry j at base[t] + j).
struct Tables {
  const void* ptr[kMaxTables];
  float scale[kMaxTables];
  int base[kMaxTables];
  int count[kMaxTables];
  int is_bf16[kMaxTables];
  int n;
  int entries;  // staged entries per plane, a multiple of 8
};

struct Geometry {
  const float* rows;  // [B, R, L] raw pileup values
  int R, L, M, N, K;
  // meta (int32): [R x 4] per pileup row (shift, largest id, table
  // base, width; width 0 = no family), [K] per column (row | elem << 16),
  // [K / 8] per group of eight columns (row | elem0 << 16 | 1 << 31 when
  // the eight are one row's elements elem0 .. elem0 + 7 at a 16-byte
  // aligned offset, else 0).
  const int* meta;
};

template <int AP, typename TB>
struct CondenseTile {
  static constexpr int kBM = 64, kBN = 288, kBK = 32, kStages = 3;
  static constexpr int kThreads = 256;
  static constexpr int kALd = kBK + 8;  // 80-byte bf16 rows
  static constexpr int kAPlane = kBM * kALd;
  static constexpr int kABytes = 2 * AP * kAPlane * 2;  // double-buffered
  static constexpr int kBLd = b_ld<TB>(kBN);
  static constexpr int kStageBytes = kBK * kBLd * sizeof(TB);
  static constexpr int kRingBytes = kStages * kStageBytes;
  // The epilogue's [64, 288] float32 stage: rows of 296 floats (8
  // banks apart), so the accumulators' 8-byte stores of a half-warp hit
  // distinct banks.
  static constexpr int kOutLd = kBN + 8;
  static constexpr int kOutBytes = kBM * kOutLd * 4;
  static_assert(kStageBytes % 16 == 0 && kABytes % 16 == 0,
                "16-byte aligned regions");

  // The per-tile region: the ring, the A chunks and the ids in the main
  // loop, the epilogue's stage after it (whichever is larger).
  __host__ __device__ static int tile_bytes(int R) {
    const int loop = kRingBytes + kABytes + R * kBM * 2;
    return loop > kOutBytes ? loop : kOutBytes;
  }

  // Dynamic shared memory: the per-tile region, table planes, meta.
  static int smem_bytes(int entries, int R, int K) {
    return tile_bytes(R) + AP * entries * 2 +
           ((4 * R + K + K / 8) * 4 + 15) / 16 * 16;
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int AP, typename TB, int BP>
__global__ void __launch_bounds__(256, AP == 1 && sizeof(TB) == 2 ? 2 : 1)
    condense_kernel(Geometry geo, Tables tabs, const TB* __restrict__ w,
                    Epilogue ep) {
  using T = CondenseTile<AP, TB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = geo.R, K = geo.K;
  const int E = tabs.entries;
  unsigned char* ring = smem;
  bf16* abuf = reinterpret_cast<bf16*>(smem + T::kRingBytes);
  int16_t* ids = reinterpret_cast<int16_t*>(smem + T::kRingBytes + T::kABytes);
  bf16* planes = reinterpret_cast<bf16*>(smem + T::tile_bytes(R));
  int* meta = reinterpret_cast<int*>(smem + T::tile_bytes(R) + AP * E * 2);
  const int* row_meta = meta;
  const int* col_meta = meta + 4 * R;
  const int* group_meta = meta + 4 * R + K;

  // Once per block: the column map and the scaled table planes.
  for (int i = tid; i < 4 * R + K + K / 8; i += T::kThreads) {
    meta[i] = __ldg(geo.meta + i);
  }
  for (int i = tid; i < E; i += T::kThreads) {
#pragma unroll
    for (int p = 0; p < AP; ++p) planes[p * E + i] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();  // the zero region and gaps before the tables
  for (int t = 0; t < tabs.n; ++t) {
    const float scale = tabs.scale[t];
    const int base = tabs.base[t];
#pragma unroll 4
    for (int j = tid; j < tabs.count[t]; j += T::kThreads) {
      float v = tabs.is_bf16[t]
                    ? __bfloat162float(
                          __ldg(static_cast<const bf16*>(tabs.ptr[t]) + j))
                    : __ldg(static_cast<const float*>(tabs.ptr[t]) + j);
      if constexpr (AP == 1) {  // bf16 compute: round, scale, round
        v = round_bf16(__fmul_rn(round_bf16(v), scale));
      } else {
        v = __fmul_rn(v, scale);
      }
      float rest = v;
#pragma unroll
      for (int p = 0; p < AP; ++p) {
        const bf16 piece = __float2bfloat16_rn(rest);
        planes[p * E + base + j] = piece;
        rest -= __bfloat162float(piece);
      }
    }
  }

  const int wm = warp >> 2;  // the warp's 32 rows of the 64
  const int wn = warp & 3;   // and its 72 columns of the 288
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int chunks = (K + T::kBK - 1) / T::kBK;
  const int tiles = (geo.M + T::kBM - 1) / T::kBM;

  auto stage_b = [&](int s) {
    return reinterpret_cast<TB*>(ring + s * T::kStageBytes);
  };
  auto load_b = [&](int s, int c) {
    load_tile<TB, T::kBK, T::kBN, 16, T::kThreads>(
        stage_b(s), T::kBLd, w, geo.N, K, geo.N, c * T::kBK, 0, tid);
  };
  // The A chunk c into buffer `buf`: thread (row am, group aq) writes the
  // eight columns c * 32 + 8 aq .. + 7 of token row am, in AP planes.
  const int am = tid & (T::kBM - 1);
  const int aq = tid >> 6;
  auto build_a = [&](int buf, int c) {
    bf16* dst = abuf + buf * AP * T::kAPlane + am * T::kALd + 8 * aq;
    const int k0 = c * T::kBK + 8 * aq;
    uint4 v[AP];
    if (k0 >= K) {
#pragma unroll
      for (int p = 0; p < AP; ++p) v[p] = make_uint4(0u, 0u, 0u, 0u);
    } else {
      const int grp = group_meta[k0 >> 3];
      if (grp < 0) {  // one row's eight elements: 16-byte reads
        const int off = ids[(grp & 0xffff) * T::kBM + am] +
                        ((grp >> 16) & 0x7fff);
#pragma unroll
        for (int p = 0; p < AP; ++p) {
          v[p] = *reinterpret_cast<const uint4*>(planes + p * E + off);
        }
      } else {
        uint32_t w32[AP][4];
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const int c0 = col_meta[k0 + j];
          const int c1 = col_meta[k0 + j + 1];
          const int o0 = ids[(c0 & 0xffff) * T::kBM + am] + (c0 >> 16);
          const int o1 = ids[(c1 & 0xffff) * T::kBM + am] + (c1 >> 16);
#pragma unroll
          for (int p = 0; p < AP; ++p) {
            const uint32_t lo = reinterpret_cast<const uint16_t*>(planes)[p * E + o0];
            const uint32_t hi = reinterpret_cast<const uint16_t*>(planes)[p * E + o1];
            w32[p][j / 2] = lo | (hi << 16);
          }
        }
#pragma unroll
        for (int p = 0; p < AP; ++p) {
          v[p] = make_uint4(w32[p][0], w32[p][1], w32[p][2], w32[p][3]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < AP; ++p) {
      *reinterpret_cast<uint4*>(dst + p * T::kAPlane) = v[p];
    }
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * T::kBM;
    __syncthreads();  // the last tile is out of the stage
#pragma unroll
    for (int s = 0; s < T::kStages - 1; ++s) {
      if (s < chunks) load_b(s, s);
      cp_async_commit();
    }
    // The tile's ids: token am (coalesced along the window), rows aq,
    // aq + 4, ...; offsets into the planes, 0 for id 0. All of a
    // thread's loads are issued before the first is used, so the tile
    // waits for device memory about once, not once per row.
    {
      const int m = m0 + am;
      const bool ok = m < geo.M;
      const int b = ok ? m / geo.L : 0;
      const int l = ok ? m - b * geo.L : 0;
      const float* src = geo.rows + static_cast<int64_t>(b) * R * geo.L + l;
      float raw[kRowsPerThread];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = aq + 4 * j;
        raw[j] = ok && r < R ? __ldg(src + static_cast<int64_t>(r) * geo.L)
                             : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = aq + 4 * j;
        if (r < R) {
          const int width = row_meta[4 * r + 3];
          // truncation, as astype(int32); then the family's shift and clip
          int id = static_cast<int>(raw[j]) + row_meta[4 * r];
          id = min(max(id, 0), row_meta[4 * r + 1]);
          const int off = id && width ? row_meta[4 * r + 2] + id * width : 0;
          ids[r * T::kBM + am] = static_cast<int16_t>(off);
        }
      }
    }
    __syncthreads();  // ids stored
    build_a(0, 0);

    float acc[2][9][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 9; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<T::kStages - 2>();
      __syncthreads();  // B chunk c landed, A chunk c built; c - 1's free
      const int next = c + T::kStages - 1;
      if (next < chunks) load_b(next % T::kStages, next);
      cp_async_commit();
      if (c + 1 < chunks) build_a((c + 1) & 1, c + 1);
      const bf16* as = abuf + (c & 1) * AP * T::kAPlane;
      const TB* bs = stage_b(c % T::kStages);
#pragma unroll
      for (int k0 = 0; k0 < T::kBK; k0 += 16) {
        uint32_t af[2][AP][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          load_a_planes<AP>(as, T::kAPlane, T::kALd, wm * 32 + i * 16, k0,
                            lane, af[i]);
        }
        mma_tiles<BP>(acc, af, bs, T::kBLd, k0, wn * 72, lane);
      }
    }

    // Epilogue through shared memory: every warp stores its
    // accumulators to the stage (over the ring, A chunks and ids, idle
    // now), then every thread writes whole 16-byte pieces of rows
    // (+ pos), so each warp's stores cover full lines of x.
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring, A and ids
    float* stage = reinterpret_cast<float*>(smem);
    {
      float* mine = stage + (wm * 32 + g) * T::kOutLd + wn * 72 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < 9; ++j) {
            *reinterpret_cast<float2*>(
                mine + (i * 16 + half * 8) * T::kOutLd + j * 8) =
                make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
          }
    }
    __syncthreads();  // the tile staged
    const int quads = geo.N / 4;
    for (int e = tid; e < T::kBM * quads; e += T::kThreads) {
      const int row = e / quads;
      const int n = (e - row * quads) * 4;
      const int m = m0 + row;
      if (m >= geo.M) break;  // rows past M come last
      const int prow = ep.pos ? pos_row(ep, m) : -1;
      float4 v =
          *reinterpret_cast<const float4*>(stage + row * T::kOutLd + n);
      v.x = epilogue_value(ep, m, n, geo.N, v.x, 0.f, prow);
      v.y = epilogue_value(ep, m, n + 1, geo.N, v.y, 0.f, prow);
      v.z = epilogue_value(ep, m, n + 2, geo.N, v.z, 0.f, prow);
      v.w = epilogue_value(ep, m, n + 3, geo.N, v.w, 0.f, prow);
      const int64_t idx = static_cast<int64_t>(m) * geo.N + n;
      *reinterpret_cast<float4*>(static_cast<float*>(ep.out) + idx) = v;
      if (ep.out2) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
        *reinterpret_cast<uint2*>(ep.out2 + idx) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  }
}

template <int AP, typename TB, int BP>
cudaError_t launch(const Geometry& geo, const Tables& tabs, const TB* w,
                   const Epilogue& ep, cudaStream_t stream) {
  using T = CondenseTile<AP, TB>;
  const int smem = T::smem_bytes(tabs.entries, geo.R, geo.K);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = condense_kernel<AP, TB, BP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, T::kThreads, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (geo.M + T::kBM - 1) / T::kBM;
  const int blocks = tiles < sms * per_sm ? tiles : sms * per_sm;
  if (blocks == 0) return cudaSuccess;
  kernel<<<blocks, T::kThreads, smem, stream>>>(geo, tabs, w, ep);
  return cudaGetLastError();
}

// compute_bf16: 1 piece of each operand, w_cond bfloat16; else float32
// w_cond and 3 pieces of each, the 6 products above 2^-24 kept.
cudaError_t dispatch(int compute_bf16, const Geometry& geo,
                     const Tables& tabs, const void* w, const Epilogue& ep,
                     cudaStream_t stream) {
  if (compute_bf16) {
    return launch<1, bf16, 1>(geo, tabs, static_cast<const bf16*>(w), ep,
                              stream);
  }
  return launch<3, float, 3>(geo, tabs, static_cast<const float*>(w), ep,
                             stream);
}

Tables make_tables(int n, const void* const* ptrs, const int* is_bf16,
                   const float* scales, const int* bases, const int* counts,
                   int entries) {
  Tables t{};
  t.n = n;
  t.entries = entries;
  for (int i = 0; i < n && i < kMaxTables; ++i) {
    t.ptr[i] = ptrs[i];
    t.is_bf16[i] = is_bf16[i];
    t.scale[i] = scales[i];
    t.base[i] = bases[i];
    t.count[i] = counts[i];
  }
  return t;
}

}  // namespace

// Dynamic shared memory the condenser asks for (bytes).
extern "C" int dc_embed_condense_smem_bytes(int compute_bf16, int entries,
                                            int R, int K) {
  return compute_bf16 ? CondenseTile<1, bf16>::smem_bytes(entries, R, K)
                      : CondenseTile<3, float>::smem_bytes(entries, R, K);
}

// rows [B, R, L] float32 with M = B * L tokens; meta as Geometry says;
// n_tables (<= 8) tables, each float32 or bfloat16, with their scales
// and staged bases and entry counts (host arrays); w_cond [K, N] in the
// compute dtype, K and N multiples of 8, N <= 288; pos [L, N] in the
// compute dtype or null; x_f32 [M, N]; x_base_bf16 [M, N] or null;
// lengths null (K1) or [M / L, wps] int32 ragged window widths (K4).
extern "C" int dc_embed_condense(
    const float* rows, int R, int L, const int* meta, int n_tables,
    const void* const* table_ptrs, const int* table_bf16,
    const float* table_scales, const int* table_bases,
    const int* table_counts, int entries, const void* w_cond,
    int compute_bf16, const void* pos, int M, int N, int K, float* x_f32,
    void* x_base_bf16, const int* lengths, int wps, void* stream_ptr) {
  if (n_tables < 1 || n_tables > kMaxTables || K % 8 || N % 8 || N > 288 ||
      entries % 8 || entries > 32768 || R < 1 || R > kMaxRows || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Epilogue ep{1.f, 0, nullptr, pos, compute_bf16, L, 0, nullptr, 0, nullptr,
              x_f32, 0, static_cast<bf16*>(x_base_bf16), lengths, wps};
  const Geometry geo{rows, R, L, M, N, K, meta};
  const Tables tabs = make_tables(n_tables, table_ptrs, table_bf16,
                                  table_scales, table_bases, table_counts,
                                  entries);
  return static_cast<int>(
      dispatch(compute_bf16, geo, tabs, w_cond, ep, stream));
}
