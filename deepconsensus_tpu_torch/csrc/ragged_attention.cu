// Banded multi-head attention core over fixed windows or ragged slots:
// K1 (layer 0), K2 (layers 1+) and K4 (ragged layer 0) all run it.
//
// Replaces the per-head score/softmax/weighted-sum loop of the TPU
// kernels deepconsensus_tpu/ops/fused_window_attention.py::_attention,
// deepconsensus_tpu/ops/fused_encoder_block.py::_attention (with and
// without its ragged mask) and
// deepconsensus_tpu/ops/ragged_window_attention.py::_ragged_attention.
// The TPU kernels compute the full [L, L] score block per head and fill
// the masked logits with -1e9 before a float32 softmax; exp(-1e9 - m) is
// exactly 0.0 in float32 whenever a row keeps one unmasked logit, so
// only the unmasked logits carry weight. This kernel computes just
// those: exact, not an approximation. Query i of a window starting at
// `start` with width `width` attends to keys
// [max(start, i - win), min(start + width - 1, i + win)].
//
// Ragged slots: with a lengths row [wps] per slot (window widths packed
// back to back from position 0; 0 = unused), each query finds its own
// window from that row, as the TPU kernel derives it (slot_geometry).
// A position past every window has no unmasked key; the TPU kernel's
// softmax is uniform there, but those positions are never delivered,
// so this kernel writes a defined 0. Without lengths every row is one
// window of the full length L.
//
// Input: qkv [B*L, 3H] float32 from the fused q/k/v projection (q
// already scaled by head_dim^-1/2); output o [B*L, H] float32, heads
// concatenated like the reference. One block per (slot, query tile of
// 32, head) stages only the K/V rows that tile can reach (the tile plus
// win rows each side: 56 rows at win 12, ~63 KB) in dynamic shared
// memory, so any slot length fits the 227 KB block limit; rows are
// padded to head_dim+1 floats so lane-per-key dot products hit distinct
// banks. Each warp takes one query at a time: one lane per key for the
// logits, warp shuffles for max and sum (no atomics, so the result is
// the same from run to run), then one lane per output feature for the
// weighted sum.
//
// Bound: ~4*L*(2*win+1)*H flop per window against 4*4*L*H bytes moved:
// memory-bound. Each K/V element is read (32 + 2*win)/32 times, once
// per query tile whose halo covers it.
#include <math.h>
#include <stdint.h>

#include "attention_util.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueryTile = 32;

using dc::warp_max;
using dc::warp_sum;

// Rows of K/V a query tile reaches, and keys one query reaches.
__host__ __device__ inline int span_rows(int L, int win) {
  return L < kQueryTile + 2 * win ? L : kQueryTile + 2 * win;
}
__host__ __device__ inline int band_keys(int L, int win) {
  return L < 2 * win + 1 ? L : 2 * win + 1;
}

size_t smem_bytes(int L, int head_dim, int win) {
  return sizeof(float) * (2 * static_cast<size_t>(span_rows(L, win)) *
                              (head_dim + 1) +
                          kWarps * head_dim + kWarps * band_keys(L, win));
}

__global__ void __launch_bounds__(kThreads)
    attention_kernel(const float* __restrict__ qkv,
                     const int* __restrict__ lengths, int wps,
                     float* __restrict__ out, int L, int H, int head_dim,
                     int win, int n_tiles) {
  extern __shared__ float smem[];
  const int hdp = head_dim + 1;
  const int span = span_rows(L, win);
  float* ks = smem;                        // [span, hdp]
  float* vs = ks + span * hdp;             // [span, hdp]
  float* qbuf = vs + span * hdp;           // [kWarps, head_dim]
  float* wbuf = qbuf + kWarps * head_dim;  // [kWarps, band_keys]

  const int b = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x - b * n_tiles) * kQueryTile;
  const int q1 = min(L, q0 + kQueryTile);
  const int h = blockIdx.y;
  const int lo = max(0, q0 - win);
  const int hi = min(L, q1 + win);
  const int ld = 3 * H;
  const float* base = qkv + static_cast<int64_t>(b) * L * ld;
  const int* lens = lengths ? lengths + static_cast<int64_t>(b) * wps : nullptr;
  for (int idx = threadIdx.x; idx < (hi - lo) * head_dim; idx += kThreads) {
    const int r = idx / head_dim;
    const int d = idx - r * head_dim;
    const float* row =
        base + static_cast<int64_t>(lo + r) * ld + h * head_dim + d;
    ks[r * hdp + d] = row[H];
    vs[r * hdp + d] = row[2 * H];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* qb = qbuf + warp * head_dim;
  float* wb = wbuf + warp * band_keys(L, win);
  for (int i = q0 + warp; i < q1; i += kWarps) {
    float* orow = out + (static_cast<int64_t>(b) * L + i) * H + h * head_dim;
    // The window that owns position i (warp-uniform).
    int start = 0, width = L;
    if (lens) {
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
    if (width == 0) {
      for (int d = lane; d < head_dim; d += 32) orow[d] = 0.f;
      continue;
    }
    const float* qrow = base + static_cast<int64_t>(i) * ld + h * head_dim;
    for (int d = lane; d < head_dim; d += 32) qb[d] = qrow[d];
    __syncwarp();
    const int j0 = max(start, i - win);
    const int j1 = min(min(start + width, L) - 1, i + win);
    const int nj = j1 - j0 + 1;
    float m = -INFINITY;
    for (int jj = lane; jj < nj; jj += 32) {
      const float* krow = ks + (j0 - lo + jj) * hdp;
      float s = 0.f;
      for (int d = 0; d < head_dim; ++d) s = fmaf(qb[d], krow[d], s);
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
    __syncwarp();
    for (int d = lane; d < head_dim; d += 32) {
      float acc = 0.f;
      for (int jj = 0; jj < nj; ++jj) {
        acc = fmaf(wb[jj] / sum, vs[(j0 - lo + jj) * hdp + d], acc);
      }
      orow[d] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int dc_attention_smem_bytes(int L, int H, int num_heads,
                                       int win) {
  return static_cast<int>(smem_bytes(L, H / num_heads, win));
}

// lengths: [B, wps] int32 window widths per slot, or null (one window
// of length L per row).
extern "C" int dc_attention(const float* qkv, const int* lengths, int wps,
                            float* out, int B, int L, int H, int num_heads,
                            int win, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int head_dim = H / num_heads;
  const size_t smem = smem_bytes(L, head_dim, win);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (L + kQueryTile - 1) / kQueryTile;
  dim3 grid(B * n_tiles, num_heads);
  attention_kernel<<<grid, kThreads, smem, stream>>>(
      qkv, lengths, wps, out, L, H, head_dim, win, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
