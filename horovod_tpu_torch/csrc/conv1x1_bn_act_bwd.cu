// Kernel 2: the train-mode backward of relu(BN(x . w)) for a 1x1 conv,
// with the ReLU mask, the BN backward and both products fused.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/conv_block.py
// conv1x1_bn_act_bwd_fused -> _bwd_kernel. Inputs dz, y [M][C],
// x [M][Cin], w [Cin][C], all bf16 or all f32 (tf32 products), and seven
// per-channel f32 rows (g, mean, inv, a, b, scale, bias); outputs dx
// [M][Cin] in the input type and dW [Cin][C] f32. relu=False sites pass
// scale = 0, bias = 1, which makes the mask all-true, as the TPU kernel
// does.
//
// On the H100 it is bound by bytes at most sites (it reads dz and y
// twice, once per product, and x once; it does 2*Cin*C/(2*Cin+2*C)
// operations per byte or fewer). dy, which the unfused backward writes
// and reads twice, is formed in the loaders of both products from dz, y
// and the per-channel rows, rounded to the input type (a no-op in f32)
// and never stored. The mask is recomputed there in f32 with separately rounded multiplies and adds,
// so it equals the forward's z > 0. The TPU grid was sequential and kept
// dW in one resident accumulator; here dx and dW are two launches over
// parallel blocks: dx accumulates over all of C in registers and rounds
// once; dW is split over M into f32 partials that a fixed-order pass adds.
#include "conv1x1_gemm.cuh"

namespace hvd {
template <class T>
int launch_bn_act_bwd(const void* dz, const void* y, const void* x,
                      const void* w, const void* g, const void* mean,
                      const void* inv, const void* a, const void* b,
                      const void* scale, const void* bias, void* dx,
                      void* ws, void* dw, int M, int Cin, int C, int splits,
                      int chunk, void* stream) {
  Dy<true, T> dy{static_cast<const T*>(dz), static_cast<const T*>(y), M, C,
                 static_cast<const float*>(g),
                 static_cast<const float*>(mean),
                 static_cast<const float*>(inv), static_cast<const float*>(a),
                 static_cast<const float*>(b),
                 static_cast<const float*>(scale),
                 static_cast<const float*>(bias)};
  return launch_bwd<true, T>(dy, static_cast<const T*>(x),
                             static_cast<const T*>(w), static_cast<T*>(dx),
                             static_cast<float*>(ws), static_cast<float*>(dw),
                             M, Cin, C, splits, chunk,
                             reinterpret_cast<cudaStream_t>(stream));
}
}  // namespace hvd

#define HVD_BN_ACT_BWD(SUFFIX, T)                                            \
  extern "C" int hvd_conv1x1_bn_act_bwd_##SUFFIX(                            \
      const void* dz, const void* y, const void* x, const void* w,           \
      const void* g, const void* mean, const void* inv, const void* a,       \
      const void* b, const void* scale, const void* bias, void* dx,          \
      void* ws, void* dw, int M, int Cin, int C, int splits, int chunk,      \
      void* stream) {                                                        \
    return hvd::launch_bn_act_bwd<T>(dz, y, x, w, g, mean, inv, a, b, scale, \
                                     bias, dx, ws, dw, M, Cin, C, splits,    \
                                     chunk, stream);                         \
  }
HVD_BN_ACT_BWD(bf16, hvd::bf16)
HVD_BN_ACT_BWD(f32, float)
