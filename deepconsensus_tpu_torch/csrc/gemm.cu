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
#include "tiled_gemm.cuh"

using dc::bf16;
using dc::DenseA;
using dc::Epilogue;
using dc::launch_tiled_gemm;

extern "C" int dc_gemm(const void* a, int a_bf16, const void* b, int b_bf16,
                       int M, int N, int K, float scale, int scale_cols,
                       const float* bias, int relu, const void* res,
                       int res_bf16, const float* alpha, void* out,
                       int out_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Epilogue ep{scale, scale_cols, bias, nullptr, 0, 1, relu, res, res_bf16,
              alpha, out, out_bf16, nullptr};
  if (a_bf16) {
    DenseA<bf16> al{static_cast<const bf16*>(a), K};
    if (b_bf16) {
      launch_tiled_gemm(al, static_cast<const bf16*>(b), M, N, K, ep, stream);
    } else {
      launch_tiled_gemm(al, static_cast<const float*>(b), M, N, K, ep, stream);
    }
  } else {
    DenseA<float> al{static_cast<const float*>(a), K};
    if (b_bf16) {
      launch_tiled_gemm(al, static_cast<const bf16*>(b), M, N, K, ep, stream);
    } else {
      launch_tiled_gemm(al, static_cast<const float*>(b), M, N, K, ep, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
