// Dense projection / FFN GEMM with the fused epilogue of tiled_gemm.cuh.
//
// Replaces the per-tile [tile*L, K] x [K, N] matmuls (dot_general) that
// the TPU kernels deepconsensus_tpu/ops/fused_window_attention.py
// (_attention, the q/k/v/o projections) and
// deepconsensus_tpu/ops/fused_encoder_block.py (_attention, _ffn)
// compute in their own bodies. On the TPU those run inside one VMEM
// pass; here each product is one launch over all windows of the pack
// (M = windows x positions), with the q scale, bias, ReLU and the ReZero
// residual folded into the epilogue so no extra elementwise pass reads
// the product back. Bound and design: see tiled_gemm.cuh.
//
// K2's int8-weight variant (the same pallas_call with QuantizedWeight
// inputs, _dequant_matmul) is b_type 2: B is read as int8 and col_scale
// holds the per-output-channel float32 scale, applied first in the
// epilogue, (x @ q) * scale, as the reference orders it. The products
// stay float32 x float32 on the CUDA cores: the reference multiplies
// float32 activations by int8 weights in float32, which an int8 x int8
// tensor-core product (dp4a, int8 mma) would not compute.
#include "tiled_gemm.cuh"

using dc::bf16;
using dc::DenseA;
using dc::Epilogue;
using dc::launch_tiled_gemm;

namespace {

// B's element type: 0 float32, 1 bfloat16, 2 int8.
template <class ALoad>
void launch_any_b(const ALoad& al, const void* b, int b_type, int M, int N,
                  int K, const Epilogue& ep, cudaStream_t stream) {
  if (b_type == 2) {
    launch_tiled_gemm(al, static_cast<const int8_t*>(b), M, N, K, ep, stream);
  } else if (b_type == 1) {
    launch_tiled_gemm(al, static_cast<const bf16*>(b), M, N, K, ep, stream);
  } else {
    launch_tiled_gemm(al, static_cast<const float*>(b), M, N, K, ep, stream);
  }
}

}  // namespace

extern "C" int dc_gemm(const void* a, int a_bf16, const void* b, int b_type,
                       int M, int N, int K, float scale, int scale_cols,
                       const float* col_scale, const float* bias, int relu,
                       const void* res, int res_bf16, const float* alpha,
                       void* out, int out_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Epilogue ep{scale, scale_cols, bias, nullptr, 0, 1, relu, res, res_bf16,
              alpha, out, out_bf16, nullptr};
  ep.col_scale = col_scale;
  if (a_bf16) {
    launch_any_b(DenseA<bf16>{static_cast<const bf16*>(a), K}, b, b_type, M,
                 N, K, ep, stream);
  } else {
    launch_any_b(DenseA<float>{static_cast<const float*>(a), K}, b, b_type,
                 M, N, K, ep, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
