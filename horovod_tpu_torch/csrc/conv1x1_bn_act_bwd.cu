// Kernel 2: the train-mode backward of relu(BN(x . w)) for a 1x1 conv,
// with the ReLU mask, the BN backward and both products fused.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/conv_block.py
// conv1x1_bn_act_bwd_fused -> _bwd_kernel. Inputs dz, y [M][C] bf16,
// x [M][Cin] bf16, w [Cin][C] bf16 and seven per-channel f32 rows
// (g, mean, inv, a, b, scale, bias); outputs dx [M][Cin] bf16 and
// dW [Cin][C] f32. relu=False sites pass scale = 0, bias = 1, which makes
// the mask all-true, as the TPU kernel does.
//
// On the H100 it is bound by bytes at most sites (it reads dz and y
// twice, once per product, and x once; it does 2*Cin*C/(2*Cin+2*C)
// operations per byte or fewer). dy, which the unfused backward writes
// and reads twice, is formed in the loaders of both products from dz, y
// and the per-channel rows, rounded to bf16 and never stored. The mask is
// recomputed there in f32 with separately rounded multiplies and adds,
// so it equals the forward's z > 0. The TPU grid was sequential and kept
// dW in one resident accumulator; here dx and dW are two launches over
// parallel blocks: dx accumulates over all of C in registers and rounds
// once; dW is split over M into f32 partials that a fixed-order pass adds.
#include "conv1x1_gemm.cuh"

extern "C" int hvd_conv1x1_bn_act_bwd(
    const void* dz, const void* y, const void* x, const void* w,
    const void* g, const void* mean, const void* inv, const void* a,
    const void* b, const void* scale, const void* bias, void* dx, void* ws,
    void* dw, int M, int Cin, int C, int splits, int chunk, void* stream) {
  using namespace hvd;
  Dy<true> dy{static_cast<const bf16*>(dz), static_cast<const bf16*>(y),
              M, C,
              static_cast<const float*>(g), static_cast<const float*>(mean),
              static_cast<const float*>(inv), static_cast<const float*>(a),
              static_cast<const float*>(b), static_cast<const float*>(scale),
              static_cast<const float*>(bias)};
  return launch_bwd<true>(dy, static_cast<const bf16*>(x),
                          static_cast<const bf16*>(w), static_cast<bf16*>(dx),
                          static_cast<float*>(ws), static_cast<float*>(dw), M,
                          Cin, C, splits, chunk,
                          reinterpret_cast<cudaStream_t>(stream));
}
