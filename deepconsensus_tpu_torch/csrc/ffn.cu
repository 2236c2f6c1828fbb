// K2's FFN half in one launch: filter GEMM -> column scale, bias, ReLU
// -> output GEMM -> column scale, bias, ReZero residual.
//
// Replaces _ffn inside the TPU kernel
// deepconsensus_tpu/ops/fused_encoder_block.py::_block_call (both
// _dequant_matmul products, for float and int8 QuantizedWeights). The TPU
// kernel keeps the [tokens, filter] ReLU intermediate in VMEM; so does
// this one, in shared memory, one [64, 32] chunk at a time ([64, 16] for
// float32 weights), while the
// [64, H] output accumulates in registers (mma_gemm.cuh::ffn_kernel).
//
// Bound: operations. At M = 102,400 tokens, H = 280, F = 2,048 the two
// products are 235 GFLOP (0.24 ms at the bf16 tensor-core peak) against
// ~0.23 GB of activations in and out plus 2.3 MB of weights; split into
// bf16 pieces (2 for float32 activations in a bf16 run, 3 in a float32
// run) the MMAs are 2-3x that. Writing h through device memory, as two
// GEMMs must, would add 1.68 GB (0.50 ms at 3.35 TB/s) per block.
#include "mma_gemm.cuh"

using dc::bf16;
using dc::Epilogue;
using dc::mma::launch_ffn;

namespace {

// (A type, A pieces, B type, B pieces, h pieces): the operand types and
// the compute dtype the model runs (ops/_kernels.py::split_pieces), with
// h split as a float32 A of the same compute dtype.
template <typename TB, int BP, int HP>
cudaError_t launch_any_a(const void* x, int x_bf16, int a_pieces,
                         const void* wf, const void* wo, int M, int H, int F,
                         const float* f_scale, const float* b_filter,
                         const Epilogue& ep, cudaStream_t stream) {
  const TB* f = static_cast<const TB*>(wf);
  const TB* o = static_cast<const TB*>(wo);
  if constexpr (HP == 2) {  // a bf16 x is a bf16 run's
    if (x_bf16 && a_pieces == 1) {
      return launch_ffn<bf16, 1, TB, BP, HP>(static_cast<const bf16*>(x), f,
                                             o, M, H, F, f_scale, b_filter,
                                             ep, stream);
    }
  }
  if (!x_bf16 && a_pieces == HP) {
    return launch_ffn<float, HP, TB, BP, HP>(static_cast<const float*>(x), f,
                                             o, M, H, F, f_scale, b_filter,
                                             ep, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// out[M, H] = x + alpha * ((relu((x @ wf) * f_scale + b_filter) @ wo)
// * o_scale + b_out); x is also the residual. b_type: 0 float32, 1
// bfloat16, 2 int8 (f_scale and o_scale set, else null). H <= 288 and a
// multiple of 8; F a multiple of 32 (16 for float32 weights).
extern "C" int dc_ffn(const void* x, int x_bf16, int a_pieces,
                      const void* wf, const void* wo, int b_type,
                      int b_pieces, int h_pieces, int M, int H, int F,
                      const float* f_scale, const float* b_filter,
                      const float* o_scale, const float* b_out,
                      const float* alpha, void* out, int out_bf16,
                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Epilogue ep{1.f, 0, b_out, nullptr, 0, 1, 0, x, x_bf16, alpha, out,
              out_bf16, nullptr};
  ep.col_scale = o_scale;
  cudaError_t err = cudaErrorInvalidValue;
  if (b_type == 0 && b_pieces == 3 && h_pieces == 3) {
    err = launch_any_a<float, 3, 3>(x, x_bf16, a_pieces, wf, wo, M, H, F,
                                    f_scale, b_filter, ep, stream);
  } else if (b_type == 1 && b_pieces == 1 && h_pieces == 2) {
    err = launch_any_a<bf16, 1, 2>(x, x_bf16, a_pieces, wf, wo, M, H, F,
                                   f_scale, b_filter, ep, stream);
  } else if (b_type == 2 && b_pieces == 1 && h_pieces == 2) {
    err = launch_any_a<int8_t, 1, 2>(x, x_bf16, a_pieces, wf, wo, M, H, F,
                                     f_scale, b_filter, ep, stream);
  } else if (b_type == 2 && b_pieces == 1 && h_pieces == 3) {
    err = launch_any_a<int8_t, 1, 3>(x, x_bf16, a_pieces, wf, wo, M, H, F,
                                     f_scale, b_filter, ep, stream);
  }
  return static_cast<int>(err);
}
