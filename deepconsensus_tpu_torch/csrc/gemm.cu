// Dense projection GEMM with the fused epilogue of gemm_epilogue.cuh, on
// the tensor cores (mma_gemm.cuh).
//
// Replaces the per-tile [tile*L, K] x [K, N] matmuls (dot_general) that
// the TPU kernels deepconsensus_tpu/ops/fused_window_attention.py
// (_attention, the q/k/v/o projections), ragged_window_attention.py
// (the same) and fused_encoder_block.py (_attention) compute in their
// own bodies. On the TPU those run inside one VMEM pass; here each
// product is one launch over all windows of the pack (M = windows x
// positions), with the q scale, bias, ReLU and the ReZero residual
// folded into the epilogue so no extra elementwise pass reads the
// product back.
//
// Bound: bytes. At M = 102,400 tokens the q/k/v product (K = 280,
// N = 840) does 48 GFLOP, 0.05 ms at the bf16 tensor-core peak, against
// 0.46 GB of float32 activations in and out, 0.14 ms at 3.35 TB/s; the
// output projection (N = 280) is further below the ridge. So the design
// keeps 16-byte cp.async loads in flight through a 3-stage ring, orders
// the grid so the few column tiles of one row tile run together (A
// comes from device memory about once), and splits operands into bf16
// pieces in registers (mma_gemm.cuh), whose extra MMAs fit under the
// byte time: a_pieces of A and b_pieces of B, as
// ops/_kernels.py::split_pieces chooses them from the operand types and
// the compute dtype.
//
// K2's int8-weight variant (the same pallas_call with QuantizedWeight
// inputs, _dequant_matmul) is b_type 2: B is read as int8, widened to
// bf16 in registers (exact), and col_scale holds the per-output-channel
// float32 scale, applied first in the epilogue, (x @ q) * scale, as the
// reference orders it. An int8 x int8 product (int8 mma) would compute
// something else: the reference multiplies float32 activations.
#include "mma_gemm.cuh"

using dc::bf16;
using dc::Epilogue;
using dc::mma::launch_mma_gemm;

namespace {

// B's element type: 0 float32 (3 pieces), 1 bfloat16, 2 int8 (1 piece).
template <typename TA, int AP>
cudaError_t launch_any_b(const TA* a, const void* b, int b_type,
                         int b_pieces, int M, int N, int K,
                         const Epilogue& ep, cudaStream_t stream) {
  if (b_type == 0 && b_pieces == 3) {
    return launch_mma_gemm<TA, AP, float, 3>(
        a, static_cast<const float*>(b), M, N, K, ep, stream);
  }
  if (b_type == 1 && b_pieces == 1) {
    return launch_mma_gemm<TA, AP, bf16, 1>(
        a, static_cast<const bf16*>(b), M, N, K, ep, stream);
  }
  if (b_type == 2 && b_pieces == 1) {
    return launch_mma_gemm<TA, AP, int8_t, 1>(
        a, static_cast<const int8_t*>(b), M, N, K, ep, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// K and N must be multiples of 8 (16-byte rows of bf16, 8-byte of int8).
extern "C" int dc_gemm(const void* a, int a_bf16, int a_pieces,
                       const void* b, int b_type, int b_pieces, int M, int N,
                       int K, float scale, int scale_cols,
                       const float* col_scale, const float* bias, int relu,
                       const void* res, int res_bf16, const float* alpha,
                       void* out, int out_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (K % 8 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
  Epilogue ep{scale, scale_cols, bias, nullptr, 0, 1, relu, res, res_bf16,
              alpha, out, out_bf16, nullptr};
  ep.col_scale = col_scale;
  cudaError_t err = cudaErrorInvalidValue;
  if (a_bf16 && a_pieces == 1) {
    err = launch_any_b<bf16, 1>(static_cast<const bf16*>(a), b, b_type,
                                b_pieces, M, N, K, ep, stream);
  } else if (!a_bf16 && a_pieces == 2) {
    err = launch_any_b<float, 2>(static_cast<const float*>(a), b, b_type,
                                 b_pieces, M, N, K, ep, stream);
  } else if (!a_bf16 && a_pieces == 3) {
    err = launch_any_b<float, 3>(static_cast<const float*>(a), b, b_type,
                                 b_pieces, M, N, K, ep, stream);
  }
  return static_cast<int>(err);
}
