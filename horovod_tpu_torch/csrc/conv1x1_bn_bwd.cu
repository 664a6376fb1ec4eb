// Kernel 3: the train-mode backward of BN(x . w) for a 1x1 conv, with the
// BN backward and both products fused (no ReLU mask).
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/conv_bn_backward.py
// conv1x1_bn_bwd_fused -> _bwd_kernel. Inputs dz, y [M][C], x [M][Cin],
// w [Cin][C], all bf16 or all f32 (tf32 products), and five per-channel
// f32 rows (g, mean, inv, a, b); outputs dx [M][Cin] in the input type
// and dW [Cin][C] f32.
//
// Bound and design as kernel 2 (conv1x1_bn_act_bwd.cu): bytes-bound at
// most sites; dy = (g*dz - a) - b*xhat is formed in the loaders of both
// products, rounded to the input type and never stored; dx accumulates
// over C in registers; dW is split over M into f32 partials added in a
// fixed order.
#include "conv1x1_gemm.cuh"

namespace hvd {
template <class T>
int launch_bn_bwd(const void* dz, const void* y, const void* x,
                  const void* w, const void* g, const void* mean,
                  const void* inv, const void* a, const void* b, void* dx,
                  void* ws, void* dw, int M, int Cin, int C, int splits,
                  int chunk, void* stream) {
  Dy<false, T> dy{static_cast<const T*>(dz), static_cast<const T*>(y), M, C,
                  static_cast<const float*>(g),
                  static_cast<const float*>(mean),
                  static_cast<const float*>(inv),
                  static_cast<const float*>(a), static_cast<const float*>(b),
                  nullptr, nullptr};
  return launch_bwd<false, T>(dy, static_cast<const T*>(x),
                              static_cast<const T*>(w), static_cast<T*>(dx),
                              static_cast<float*>(ws),
                              static_cast<float*>(dw), M, Cin, C, splits,
                              chunk, reinterpret_cast<cudaStream_t>(stream));
}
}  // namespace hvd

#define HVD_BN_BWD(SUFFIX, T)                                               \
  extern "C" int hvd_conv1x1_bn_bwd_##SUFFIX(                               \
      const void* dz, const void* y, const void* x, const void* w,          \
      const void* g, const void* mean, const void* inv, const void* a,      \
      const void* b, void* dx, void* ws, void* dw, int M, int Cin, int C,   \
      int splits, int chunk, void* stream) {                                \
    return hvd::launch_bn_bwd<T>(dz, y, x, w, g, mean, inv, a, b, dx, ws,   \
                                 dw, M, Cin, C, splits, chunk, stream);     \
  }
HVD_BN_BWD(bf16, hvd::bf16)
HVD_BN_BWD(f32, float)
