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
// once per product and x once; it does 2*Cin*C/(2*Cin+2*C) operations
// per byte or fewer). dy, which the unfused backward writes and reads
// twice, is formed on chip from dz, y and the per-channel rows, rounded
// to the input type (a no-op in f32) and never stored. The mask is
// recomputed in f32 with separately rounded multiplies and adds
// (dy_value, built with -fmad=false), so it equals the forward's z > 0.
// The TPU grid was sequential and kept dW in one resident accumulator;
// here dx and dW are two launches over parallel blocks, dW split over M
// and summed in a fixed order.
//
// Three instances, chosen by the wrapper from shape and dtype alone
// (ops/conv_bn_backward.py bwd_instance):
//   hvd_conv1x1_bn_act_bwd_hopper: bf16 with Cin, C multiples of 8 in
//     [64, 1024] (every ResNet-50 site): wgmma, TMA rings, dy formed once
//     per product per block, dW split-K summed through thread-block
//     clusters (conv1x1_bwd_hopper.cuh, whose note gives the design);
//   hvd_conv1x1_bn_act_bwd_hopper_tf32: f32 with Cin, C multiples of 4 in
//     [64, 1024] (every ResNet-50 site): the same design on tf32 wgmma,
//     dW's x^T from registers and dy^T written K-major
//     (conv1x1_bwd_hopper_f32.cuh);
//   hvd_conv1x1_bn_act_bwd_{bf16,f32}: every other shape: the simple
//     mma.sync GEMM of conv1x1_gemm.cuh, dy formed in its loaders.
#include "conv1x1_bwd_hopper_f32.cuh"

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

extern "C" int hvd_conv1x1_bn_act_bwd_hopper(
    const void* dz, const void* y, const void* x, const void* w,
    const void* g, const void* mean, const void* inv, const void* a,
    const void* b, const void* scale, const void* bias, void* dx, void* ws,
    void* dw, int M, int Cin, int C, int nb, int ct, int nt, int clusters,
    int chunk, void* stream) {
  using hvd::bf16;
  hvd::cbh::Rows rows{static_cast<const float*>(g),
                      static_cast<const float*>(mean),
                      static_cast<const float*>(inv),
                      static_cast<const float*>(a),
                      static_cast<const float*>(b),
                      static_cast<const float*>(scale),
                      static_cast<const float*>(bias)};
  return hvd::cbh::launch_bwd_hopper<true>(
      static_cast<const bf16*>(dz), static_cast<const bf16*>(y),
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), rows,
      static_cast<bf16*>(dx), static_cast<float*>(ws),
      static_cast<float*>(dw), M, Cin, C, nb, ct, nt, clusters, chunk,
      reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int hvd_conv1x1_bn_act_bwd_hopper_tf32(
    const void* dz, const void* y, const void* x, const void* w,
    const void* g, const void* mean, const void* inv, const void* a,
    const void* b, const void* scale, const void* bias, void* dx, void* ws,
    void* dw, int M, int Cin, int C, int nb, int ct, int nt, int clusters,
    int chunk, void* stream) {
  hvd::cbh::Rows rows{static_cast<const float*>(g),
                      static_cast<const float*>(mean),
                      static_cast<const float*>(inv),
                      static_cast<const float*>(a),
                      static_cast<const float*>(b),
                      static_cast<const float*>(scale),
                      static_cast<const float*>(bias)};
  return hvd::cbh32::launch_bwd_tf32<true>(
      static_cast<const float*>(dz), static_cast<const float*>(y),
      static_cast<const float*>(x), static_cast<const float*>(w), rows,
      static_cast<float*>(dx), static_cast<float*>(ws),
      static_cast<float*>(dw), M, Cin, C, nb, ct, nt, clusters, chunk,
      reinterpret_cast<cudaStream_t>(stream));
}

// Clusters of `cl` blocks of the f32 dW kernel at tile (ct, nt) that the
// current card holds at once, or -1 (what chose the split plan's cluster
// size, and its check; kernel 3's dW blocks take the same resources).
extern "C" int hvd_conv1x1_bn_act_bwd_tf32_max_clusters(int ct, int nt,
                                                        int cl) {
  return hvd::cbh32::dw_max_clusters<true>(ct, nt, cl);
}

HVD_FOLD_ROWS_ENTRY(hvd_conv1x1_bn_act_fold_rows)
