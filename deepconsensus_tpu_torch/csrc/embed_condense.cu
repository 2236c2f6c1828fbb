// K1 and K4, part 1: masked embedding gather + condenser + position add.
//
// Replaces the embed/condense half of the TPU kernels
// deepconsensus_tpu/ops/fused_window_attention.py::_kernel
// (_embed_condense + the pos add) and
// deepconsensus_tpu/ops/ragged_window_attention.py::_kernel
// (_embed_condense + _pos_contribution). For ragged slots (K4) the
// epilogue reads the slot's lengths row and adds pos[p - start(p)] on
// positions inside a window and nothing elsewhere, as the TPU kernel's
// one-hot position product does. The TPU kernel builds a one-hot block
// in VMEM and multiplies it by each family's table, because the MXU
// does products well and gathers badly. On Hopper a gather is cheap, so
// this is a gather, not a one-hot product: the GEMM's A loader reads the
// token's id from the pileup rows, truncates it to int32, applies the
// family's shift and clip, masks id 0 to zero, and fetches one element
// of the (sqrt(width)-scaled) table row. That 560-wide embedded row is
// contracted against w_cond in the tiled GEMM's own loop and never
// exists in device memory; the epilogue adds pos[l] and writes x both in
// float32 (for the layer-0 attention) and, for bfloat16 runs, the
// compute-dtype x_base the caller's residual adds to.
//
// Bound: 2*M*560*280 flop against ~M*85*4 bytes of ids: compute-bound
// (see tiled_gemm.cuh for the GEMM design). The id reads are gathers
// with neighbouring threads on neighbouring positions (kMFast), so they
// coalesce along the window.
#include "tiled_gemm.cuh"

using dc::bf16;
using dc::Epilogue;
using dc::launch_tiled_gemm;
using dc::to_f32;

namespace {

// meta is [5, K] int32: pileup row, table offset (table base + element
// within the embedding width), largest valid id, id shift, width.
template <typename TT>
struct GatherA {
  static constexpr bool kMFast = true;
  const float* rows;  // [B, R, L]
  int R;
  int L;
  int K;
  const int* meta;
  const TT* tables;
  __device__ __forceinline__ float operator()(int m, int k) const {
    const int b = m / L;
    const int l = m - b * L;
    const int r = __ldg(meta + k);
    const int off = __ldg(meta + K + k);
    const int vmax = __ldg(meta + 2 * K + k);
    const int shift = __ldg(meta + 3 * K + k);
    const int width = __ldg(meta + 4 * K + k);
    const float raw = rows[(static_cast<int64_t>(b) * R + r) * L + l];
    int id = static_cast<int>(raw) + shift;  // truncation, as astype(int32)
    id = min(max(id, 0), vmax);
    if (id == 0) return 0.f;
    return to_f32(tables[off + id * width]);
  }
};

}  // namespace

// lengths: null (K1: windows of length L), or [M / L, wps] int32 window
// widths per ragged slot of L positions (K4).
extern "C" int dc_embed_condense(const float* rows, int R, int L,
                                 const int* meta, const void* tables,
                                 const void* w_cond, const void* pos,
                                 int is_bf16, int M, int N, int K,
                                 float* x_f32, void* x_base_bf16,
                                 const int* lengths, int wps,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Epilogue ep{1.f, 0, nullptr, pos, is_bf16, L, 0, nullptr, 0, nullptr,
              x_f32, 0, static_cast<bf16*>(x_base_bf16), lengths, wps};
  if (is_bf16) {
    GatherA<bf16> al{rows, R, L, K, meta, static_cast<const bf16*>(tables)};
    launch_tiled_gemm(al, static_cast<const bf16*>(w_cond), M, N, K, ep,
                      stream);
  } else {
    GatherA<float> al{rows, R, L, K, meta, static_cast<const float*>(tables)};
    launch_tiled_gemm(al, static_cast<const float*>(w_cond), M, N, K, ep,
                      stream);
  }
  return static_cast<int>(cudaGetLastError());
}
