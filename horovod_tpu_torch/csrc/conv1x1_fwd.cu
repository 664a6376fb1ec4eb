// Kernel 1: y = x . w with the BatchNorm stat sums fused into the pass.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/conv_block.py
// conv1x1_fwd_fused -> _fwd_kernel. Inputs x [M][Cin] and w [Cin][C],
// both bf16 or both f32 (tf32 products). Outputs y [M][C] in the input
// type and the per-channel f32 sum and sum of squares of the STORED y.
//
// On the H100 the kernel is bound by bytes at most ResNet-50 sites: it
// does Cin*C/(Cin+C) operations per byte moved (51 at Cin=64, C=256; 341
// at Cin=1024, C=512), against the ~295 at which bf16 tensor cores become
// the limit. So it reads x and w and writes y once, and the stat sums
// never re-read y from device memory. The TPU kernel carried the sums in
// one resident accumulator across a sequential grid; here blocks run in
// parallel, so each block writes its partial sums to an f32 workspace and
// a second, fixed-order pass adds them up: no float atomics, the same
// result on every run.
//
// Two instances, chosen by ops/conv_block.py `fwd_instance` from shape
// and dtype alone:
//   hvd_conv1x1_fwd_hopper: bf16 with Cin, C multiples of 8 in [64,
//     1024] (every ResNet-50 site): TMA rings, wgmma with w read in
//     place, y staged in shared memory and written by TMA stores, one
//     column-sum launch (conv1x1_fwd_hopper.cuh, whose note gives the
//     design);
//   hvd_conv1x1_fwd_bf16 / _f32: `fwd_kernel` below, the simple version
//     (mma.sync through conv1x1_gemm.cuh's register-staged loads, a 128
//     x 128 tile, y stored element by element, two column-sum launches)
//     on w^T [C][Cin], which the wrapper transposes so both operands load
//     along K. f32 stays here: tf32 wgmma takes K-major operands only.
#include "conv1x1_fwd_hopper.cuh"
#include "conv1x1_gemm.cuh"

namespace hvd {

template <class T>
__global__ void __launch_bounds__(THREADS, 2)
    fwd_kernel(const T* __restrict__ x, const T* __restrict__ wt,
               T* __restrict__ y, float* __restrict__ ws_sum,
               float* __restrict__ ws_sq, int M, int K, int C) {
  __shared__ __align__(16) T sa[tile_elems<T>()];
  __shared__ __align__(16) T sb[tile_elems<T>()];
  __shared__ float red[2][2][BN];  // [warp row][sum, sumsq][column]
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  float acc[4][4][4];
  gemm_tile<false, false>(Plain<T>{x, M, K}, Plain<T>{wt, C, K}, row0, col0, 0,
                          K, acc, sa, sb);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4, g = lane >> 2, t = lane & 3;
  float ps[4][2], pq[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) ps[ni][e] = pq[ni][e] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = row0 + wm * 64 + mi * 16 + g + (e >= 2 ? 8 : 0);
        int c = col0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (r < M && c < C) {
          T v = Elt<T>::from_f32(acc[mi][ni][e]);
          y[(size_t)r * C + c] = v;
          float f = Elt<T>::to_f32(v);  // sums of the stored value
          ps[ni][e & 1] = __fadd_rn(ps[ni][e & 1], f);
          pq[ni][e & 1] = __fadd_rn(pq[ni][e & 1], __fmul_rn(f, f));
        }
      }
  // Sum over the 8 lanes that share a column (lane bits 2..4), in a fixed
  // butterfly order.
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ps[ni][e] = __fadd_rn(ps[ni][e],
                              __shfl_xor_sync(0xffffffffu, ps[ni][e], off));
        pq[ni][e] = __fadd_rn(pq[ni][e],
                              __shfl_xor_sync(0xffffffffu, pq[ni][e], off));
      }
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int c = wn * 32 + ni * 8 + 2 * t + e;
        red[wm][0][c] = ps[ni][e];
        red[wm][1][c] = pq[ni][e];
      }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < BN; c += THREADS) {
    if (col0 + c < C) {
      size_t o = (size_t)blockIdx.x * C + col0 + c;
      ws_sum[o] = __fadd_rn(red[0][0][c], red[1][0][c]);
      ws_sq[o] = __fadd_rn(red[0][1][c], red[1][1][c]);
    }
  }
}

template <class T>
int launch_fwd(const void* x, const void* wt, void* y, void* ws, void* sum,
               void* sumsq, int M, int Cin, int C, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int nmb = (M + BM - 1) / BM;
  float* ws_sum = static_cast<float*>(ws);
  float* ws_sq = ws_sum + (size_t)nmb * C;
  dim3 grid(nmb, (C + BN - 1) / BN);
  fwd_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt),
      static_cast<T*>(y), ws_sum, ws_sq, M, Cin, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  colsum(ws_sum, static_cast<float*>(sum), nmb, C, st);
  colsum(ws_sq, static_cast<float*>(sumsq), nmb, C, st);
  return (int)cudaGetLastError();
}

}  // namespace hvd

// ws holds 2 * ceil(M / 128) * C floats. Returns cudaGetLastError().
#define HVD_FWD(SUFFIX, T)                                                  \
  extern "C" int hvd_conv1x1_fwd_##SUFFIX(                                  \
      const void* x, const void* wt, void* y, void* ws, void* sum,          \
      void* sumsq, int M, int Cin, int C, void* stream) {                   \
    return hvd::launch_fwd<T>(x, wt, y, ws, sum, sumsq, M, Cin, C, stream); \
  }
HVD_FWD(bf16, hvd::bf16)
HVD_FWD(f32, float)

// x [M][Cin], w [Cin][C] bf16; stats [2][C] f32 (sum, then sumsq); ws
// holds ceil(M / 128) * 2 * C floats; bn is the job width `fwd_tile`
// chose (64, 128 or 256). Returns cudaGetLastError().
extern "C" int hvd_conv1x1_fwd_hopper(const void* x, const void* w, void* y,
                                      void* ws, void* stats, int M, int Cin,
                                      int C, int bn, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const hvd::bf16* xb = static_cast<const hvd::bf16*>(x);
  const hvd::bf16* wb = static_cast<const hvd::bf16*>(w);
  hvd::bf16* yb = static_cast<hvd::bf16*>(y);
  float* wsf = static_cast<float*>(ws);
  float* sf = static_cast<float*>(stats);
  if (bn == 64)
    return hvd::cfh::launch_fwd_hopper<64>(xb, wb, yb, wsf, sf, M, Cin, C, st);
  if (bn == 128)
    return hvd::cfh::launch_fwd_hopper<128>(xb, wb, yb, wsf, sf, M, Cin, C,
                                            st);
  if (bn == 256)
    return hvd::cfh::launch_fwd_hopper<256>(xb, wb, yb, wsf, sf, M, Cin, C,
                                            st);
  return (int)cudaErrorInvalidValue;
}
