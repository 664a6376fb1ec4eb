// Kernel 3: the train-mode backward of BN(x . w) for a 1x1 conv, with the
// BN backward and both products fused (no ReLU mask).
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/conv_bn_backward.py
// conv1x1_bn_bwd_fused -> _bwd_kernel. Inputs dz, y [M][C], x [M][Cin],
// w [Cin][C], all bf16 or all f32 (tf32 products), and five per-channel
// f32 rows (g, mean, inv, a, b); outputs dx [M][Cin] in the input type
// and dW [Cin][C] f32.
//
// Bound, design and instances as kernel 2 (conv1x1_bn_act_bwd.cu), of
// which it is the MASK = false instance: bytes-bound at most sites;
// dy = (g*dz - a) - b*xhat formed on chip, rounded to the input type
// and never stored; hvd_conv1x1_bn_bwd_hopper for bf16 at Cin, C
// multiples of 8 in [64, 1024] (conv1x1_bwd_hopper.cuh),
// hvd_conv1x1_bn_bwd_hopper_tf32 for f32 at Cin, C multiples of 4 in
// [64, 1024] (conv1x1_bwd_hopper_f32.cuh), the simple mma.sync code
// (conv1x1_gemm.cuh) for every other shape.
#include "conv1x1_bwd_hopper_f32.cuh"

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

extern "C" int hvd_conv1x1_bn_bwd_hopper(
    const void* dz, const void* y, const void* x, const void* w,
    const void* g, const void* mean, const void* inv, const void* a,
    const void* b, void* dx, void* ws, void* dw, int M, int Cin, int C,
    int nb, int ct, int nt, int clusters, int chunk, void* stream) {
  using hvd::bf16;
  hvd::cbh::Rows rows{static_cast<const float*>(g),
                      static_cast<const float*>(mean),
                      static_cast<const float*>(inv),
                      static_cast<const float*>(a),
                      static_cast<const float*>(b), nullptr, nullptr};
  return hvd::cbh::launch_bwd_hopper<false>(
      static_cast<const bf16*>(dz), static_cast<const bf16*>(y),
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), rows,
      static_cast<bf16*>(dx), static_cast<float*>(ws),
      static_cast<float*>(dw), M, Cin, C, nb, ct, nt, clusters, chunk,
      reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int hvd_conv1x1_bn_bwd_hopper_tf32(
    const void* dz, const void* y, const void* x, const void* w,
    const void* g, const void* mean, const void* inv, const void* a,
    const void* b, void* dx, void* ws, void* dw, int M, int Cin,
    int C, int nb, int ct, int nt, int clusters, int chunk, void* stream) {
  hvd::cbh::Rows rows{static_cast<const float*>(g),
                      static_cast<const float*>(mean),
                      static_cast<const float*>(inv),
                      static_cast<const float*>(a),
                      static_cast<const float*>(b),
                      nullptr, nullptr};
  return hvd::cbh32::launch_bwd_tf32<false>(
      static_cast<const float*>(dz), static_cast<const float*>(y),
      static_cast<const float*>(x), static_cast<const float*>(w), rows,
      static_cast<float*>(dx), static_cast<float*>(ws),
      static_cast<float*>(dw), M, Cin, C, nb, ct, nt, clusters, chunk,
      reinterpret_cast<cudaStream_t>(stream));
}

HVD_FOLD_ROWS_ENTRY(hvd_conv1x1_bn_fold_rows)
