// Shared pieces of the fused 1x1-conv + BatchNorm kernels for Hopper
// (sm_90a): a shared-memory-tiled GEMM on mma.sync with f32 accumulation,
// operand sources that form their values while the tile is loaded (the
// BN-backward dy never reaches device memory), and a fixed-order
// column-sum pass for cross-block reductions.
//
// Element types: bf16 operands run mma.sync.m16n8k16 (bf16 x bf16);
// float32 operands run mma.sync.m16n8k8 on tf32, each operand rounded to
// tf32 (cvt.rna) as it enters shared memory. Both accumulate in f32 and
// leave the accumulator in the same per-thread layout (mma.cuh), so every
// epilogue is shared.
//
// Tiling: a block of 256 threads (8 warps as 2 x 4) computes a 128 x 128
// output tile; each warp owns 64 x 32 (4 x 4 mma tiles, 64 f32
// accumulators per thread). K advances 32 at a time through one tile of
// each operand in shared memory; the next tile's global loads are in
// flight in registers while the current one is multiplied. An operand
// tile is kept in one of two layouts, chosen by which of its source
// dimensions is contiguous:
//   KC  [128 rows][32 k + pad]    when the source is contiguous along k;
//   RC  [32 k][128 rows + 8 pad]  when it is contiguous along the rows.
// Both are written with 16-byte stores and read as mma fragments without
// bank conflicts. Any M, K and N are taken: loads outside the source are
// zero and stores outside the output are skipped.
#pragma once

#include "mma.cuh"

namespace hvd {

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;

// What differs between the element types: the KC row stride, the mma
// depth, where a thread's k values sit in a fragment, and conversions.
template <class T>
struct Elt;

template <>
struct Elt<bf16> {
  static constexpr int LDK = BK + 8;   // KC row stride (elements)
  static constexpr int KSTEP = 16;     // m16n8k16
  static __device__ __forceinline__ int kpos(int t) { return 2 * t; }
  static __device__ __forceinline__ bf16 zero() {
    return __ushort_as_bfloat16(0);
  }
  static __device__ __forceinline__ float to_f32(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 from_f32(float f) {
    return __float2bfloat16_rn(f);
  }
  // The value as the tensor cores take it.
  static __device__ __forceinline__ bf16 operand(bf16 v) { return v; }
};

template <>
struct Elt<float> {
  static constexpr int LDK = BK + 4;
  static constexpr int KSTEP = 8;      // m16n8k8 tf32
  static __device__ __forceinline__ int kpos(int t) { return t; }
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float f) { return f; }
  static __device__ __forceinline__ float operand(float v) {
    return tf32_round(v);
  }
};

constexpr int LDR = BM + 8;  // RC row stride (elements), both types

template <class T>
__host__ __device__ constexpr int tile_elems() {
  return BM * Elt<T>::LDK > BK * LDR ? BM * Elt<T>::LDK : BK * LDR;
}

// Eight consecutive values of one row, 16 or 32 bytes.
template <class T>
struct __align__(16) Vec8 {
  T v[8];
};

template <class T>
struct Raw {
  Vec8<T> a, b;
};

template <class T>
__device__ __forceinline__ void copy16(const T* src, T* dst) {
#pragma unroll
  for (int i = 0; i < (int)(8 * sizeof(T) / 16); ++i)
    reinterpret_cast<uint4*>(dst)[i] =
        reinterpret_cast<const uint4*>(src)[i];
}

// Operand sources. A source is read 8 values at a time, at (r, c .. c+7)
// of its logical row-major matrix, in two steps: fetch() issues the
// global loads into registers (zero outside the matrix), emit() turns
// them into the 8 operand values of the tile. gemm_tile fetches the next
// K tile before it multiplies the current one, so the loads' latency
// hides behind the tensor-core work.
template <class T>
__device__ __forceinline__ void fetch8(const T* p, int rows, int cols, int r,
                                       int c, Vec8<T>& u) {
  const T* q = p + (size_t)r * cols + c;
  if (r < rows && c + 8 <= cols && ((uintptr_t)q & 15) == 0) {
    copy16(q, u.v);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      u.v[j] = (r < rows && c + j < cols) ? q[j] : Elt<T>::zero();
  }
}

// A row-major matrix [rows][cols].
template <class T>
struct Plain {
  typedef T elem;
  const T* p;
  int rows, cols;
  __device__ __forceinline__ void fetch(int r, int c, Raw<T>& raw) const {
    fetch8(p, rows, cols, r, c, raw.a);
  }
  __device__ __forceinline__ Vec8<T> emit(const Raw<T>& raw, int,
                                          int) const {
    Vec8<T> o;
#pragma unroll
    for (int j = 0; j < 8; ++j) o.v[j] = Elt<T>::operand(raw.a.v[j]);
    return o;
  }
};

// One element of the BN-backward input gradient, before its rounding to
// the element type, from dz and y (as f32) and its channel's rows:
//   xhat = (y - mean) * inv
//   MASK: dz = (xhat * s + bias > 0) ? dz : 0   (the forward's ReLU)
//   dy = (g * dz - a) - b * xhat.
// Every float op is a separately rounded intrinsic, in the order of the
// plain PyTorch version, so dy and the mask match it bit for bit. Both
// the simple loaders (Dy below) and the Hopper kernels
// (conv1x1_bwd_hopper.cuh) form dy here.
template <bool MASK>
__device__ __forceinline__ float dy_value(float dz, float y, float g,
                                          float mean, float inv, float a,
                                          float b, float s, float bias) {
  const float xhat = __fmul_rn(__fsub_rn(y, mean), inv);
  if (MASK) {
    const float zpre = __fadd_rn(__fmul_rn(xhat, s), bias);
    dz = zpre > 0.f ? dz : 0.f;
  }
  return __fsub_rn(__fsub_rn(__fmul_rn(g, dz), a), __fmul_rn(b, xhat));
}

// The BN-backward input gradient dy [M][C] as an operand source of the
// simple GEMM: formed by dy_value from dz and y as the tile is loaded,
// rounded to T (a no-op in f32).
template <bool MASK, class T>
struct Dy {
  typedef T elem;
  const T *dz, *y;
  int rows, cols;
  const float *g, *mean, *inv, *a, *b, *s, *bias;
  __device__ __forceinline__ void fetch(int r, int c, Raw<T>& raw) const {
    fetch8(dz, rows, cols, r, c, raw.a);
    fetch8(y, rows, cols, r, c, raw.b);
  }
  __device__ __forceinline__ Vec8<T> emit(const Raw<T>& raw, int r,
                                          int c) const {
    Vec8<T> o;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int cc = c + j;
      if (r < rows && cc < cols) {
        float t = dy_value<MASK>(
            Elt<T>::to_f32(raw.a.v[j]), Elt<T>::to_f32(raw.b.v[j]), g[cc],
            mean[cc], inv[cc], a[cc], b[cc], MASK ? s[cc] : 0.f,
            MASK ? bias[cc] : 0.f);
        o.v[j] = Elt<T>::operand(Elt<T>::from_f32(t));
      } else {
        o.v[j] = Elt<T>::zero();
      }
    }
    return o;
  }
};

// One operand tile's share of this thread: PER vectors of 8 values. KC:
// src is logical [row][k]; RC: src is logical [k][row].
template <bool RC, class Src>
struct TileLoader {
  typedef typename Src::elem T;
  static constexpr int PER = BM * BK / 8 / THREADS;
  Raw<T> raw[PER];

  __device__ __forceinline__ static void at(int i, int row0, int k0,
                                            int& r, int& c, int& off) {
    int v = threadIdx.x + i * THREADS;
    if (!RC) {
      int rr = v / (BK / 8), kk = (v % (BK / 8)) * 8;
      r = row0 + rr, c = k0 + kk, off = rr * Elt<T>::LDK + kk;
    } else {
      int kk = v / (BM / 8), rr = (v % (BM / 8)) * 8;
      r = k0 + kk, c = row0 + rr, off = kk * LDR + rr;
    }
  }
  __device__ __forceinline__ void fetch(const Src& src, int row0, int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int r, c, off;
      at(i, row0, k0, r, c, off);
      src.fetch(r, c, raw[i]);
    }
  }
  __device__ __forceinline__ void store(const Src& src, T* S, int row0,
                                        int k0) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int r, c, off;
      at(i, row0, k0, r, c, off);
      Vec8<T> o = src.emit(raw[i], r, c);
      copy16(o.v, S + off);
    }
  }
};

// The 32-bit fragment register holding (row, k) and, for bf16,
// (row, k + 1).
template <bool RC>
__device__ __forceinline__ uint32_t frag(const bf16* S, int row, int k) {
  if (!RC)
    return *reinterpret_cast<const uint32_t*>(S + row * Elt<bf16>::LDK + k);
  uint32_t lo = __bfloat16_as_ushort(S[k * LDR + row]);
  uint32_t hi = __bfloat16_as_ushort(S[(k + 1) * LDR + row]);
  return lo | (hi << 16);
}

template <bool RC>
__device__ __forceinline__ uint32_t frag(const float* S, int row, int k) {
  return __float_as_uint(RC ? S[k * LDR + row]
                            : S[row * Elt<float>::LDK + k]);
}

// acc[mi][ni][e] = sum over k in [k_begin, k_end) of A[row][k] * B[k][col]
// for the block's 128 x 128 tile at (row0, col0). The element acc[mi][ni][e]
// sits at row  row0 + wm*64 + mi*16 + (lane>>2) + (e>=2 ? 8 : 0)
//        col   col0 + wn*32 + ni*8 + 2*(lane&3) + (e&1).
// (k_end - k_begin) must be a multiple of BK unless k_end is the end of K.
template <bool A_RC, bool B_RC, class SrcA, class SrcB, class T>
__device__ __forceinline__ void gemm_tile(const SrcA& A, const SrcB& B,
                                          int row0, int col0, int k_begin,
                                          int k_end, float (*acc)[4][4],
                                          T* sa, T* sb) {
  constexpr int HALF = Elt<T>::KSTEP / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4, g = lane >> 2;
  const int kt = Elt<T>::kpos(lane & 3);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  TileLoader<A_RC, SrcA> la;
  TileLoader<B_RC, SrcB> lb;
  if (k_begin < k_end) {
    la.fetch(A, row0, k_begin);
    lb.fetch(B, col0, k_begin);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    la.store(A, sa, row0, k0);
    lb.store(B, sb, col0, k0);
    __syncthreads();
    if (k0 + BK < k_end) {  // next tile's loads fly during this tile's mma
      la.fetch(A, row0, k0 + BK);
      lb.fetch(B, col0, k0 + BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += Elt<T>::KSTEP) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        int r = wm * 64 + mi * 16 + g;
        af[mi][0] = frag<A_RC>(sa, r, kk + kt);
        af[mi][1] = frag<A_RC>(sa, r + 8, kk + kt);
        af[mi][2] = frag<A_RC>(sa, r, kk + kt + HALF);
        af[mi][3] = frag<A_RC>(sa, r + 8, kk + kt + HALF);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        int n = wn * 32 + ni * 8 + g;
        bfr[ni][0] = frag<B_RC>(sb, n, kk + kt);
        bfr[ni][1] = frag<B_RC>(sb, n, kk + kt + HALF);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(acc[mi][ni], af[mi], bfr[ni], T());
    }
    __syncthreads();
  }
}

// out[i] = sum over b = 0 .. nb-1 of ws[b * n + i], in that order: the
// deterministic second pass of every cross-block reduction. Stores, never
// accumulates into, `out`.
__global__ void colsum_kernel(const float* __restrict__ ws,
                              float* __restrict__ out, int nb, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < nb; ++b) s = __fadd_rn(s, ws[(size_t)b * n + i]);
  out[i] = s;
}

inline void colsum(const float* ws, float* out, int nb, int n,
                   cudaStream_t st) {
  colsum_kernel<<<(n + 255) / 256, 256, 0, st>>>(ws, out, nb, n);
}

// The per-channel rows of kernels 2 and 3 from the wrapper's inputs, in
// the order and rounding of the plain version's fold_rows, one launch in
// place of a handful of small PyTorch ones:
//   g = scale * inv
//   a = g * dbeta * minv  (- dmean * minv)
//   b = g * dgamma * minv (- 2 * dvar * minv / inv)
// and the mask's rows: s = scale and bias (relu), or 0 and 1 (which
// makes the mask all-true). scale and bias are P (bf16 or f32); dmean,
// dvar and bias may be null. out[5][C] = g, a, b, s, bias.
template <class P>
__global__ void fold_kernel(const P* __restrict__ scale,
                            const P* __restrict__ bias,
                            const float* __restrict__ inv,
                            const float* __restrict__ dbeta,
                            const float* __restrict__ dgamma,
                            const float* __restrict__ dmean,
                            const float* __restrict__ dvar, float minv,
                            int relu, float* __restrict__ out, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const float s = Elt<P>::to_f32(scale[i]), iv = inv[i];
  const float g = __fmul_rn(s, iv);
  float a = __fmul_rn(__fmul_rn(g, dbeta[i]), minv);
  float b = __fmul_rn(__fmul_rn(g, dgamma[i]), minv);
  if (dmean) a = __fsub_rn(a, __fmul_rn(dmean[i], minv));
  if (dvar)
    b = __fsub_rn(b, __fdiv_rn(__fmul_rn(__fmul_rn(2.f, dvar[i]), minv), iv));
  out[i] = g;
  out[C + i] = a;
  out[2 * C + i] = b;
  out[3 * C + i] = relu ? s : 0.f;
  out[4 * C + i] = relu ? Elt<P>::to_f32(bias[i]) : 1.f;
}

}  // namespace hvd

// The C entry point of fold_kernel, defined by each backward source.
#define HVD_FOLD_ROWS_ENTRY(NAME)                                           \
  extern "C" int NAME(const void* scale, const void* bias, const void* inv, \
                      const void* dbeta, const void* dgamma,                \
                      const void* dmean, const void* dvar, void* out, int C,\
                      float minv, int relu, int param_bf16, void* stream) { \
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);               \
    const int nb = (C + 255) / 256;                                         \
    const float *iv = static_cast<const float*>(inv),                       \
                *db = static_cast<const float*>(dbeta),                     \
                *dg = static_cast<const float*>(dgamma),                    \
                *dm = static_cast<const float*>(dmean),                     \
                *dv = static_cast<const float*>(dvar);                      \
    if (param_bf16)                                                         \
      hvd::fold_kernel<hvd::bf16><<<nb, 256, 0, st>>>(                      \
          static_cast<const hvd::bf16*>(scale),                             \
          static_cast<const hvd::bf16*>(bias), iv, db, dg, dm, dv, minv,    \
          relu, static_cast<float*>(out), C);                               \
    else                                                                    \
      hvd::fold_kernel<float><<<nb, 256, 0, st>>>(                          \
          static_cast<const float*>(scale), static_cast<const float*>(bias),\
          iv, db, dg, dm, dv, minv, relu, static_cast<float*>(out), C);     \
    return (int)cudaGetLastError();                                         \
  }

namespace hvd {

// ---------------------------------------------------------------------
// Backward: dx = dy . w^T and dW = x^T . dy, dy formed in the loaders.
// ---------------------------------------------------------------------

// dx tile: rows m, cols cin, K = C. A = dy [m][c] (KC), B = w [cin][c] (KC).
// The f32 accumulator covers all of C in registers; dx rounds once.
template <bool MASK, class T>
__global__ void __launch_bounds__(THREADS, 2)
    dx_kernel(Dy<MASK, T> dy, const T* __restrict__ w, T* __restrict__ dx,
              int M, int Cin, int C) {
  __shared__ __align__(16) T sa[tile_elems<T>()];
  __shared__ __align__(16) T sb[tile_elems<T>()];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  float acc[4][4][4];
  gemm_tile<false, false>(dy, Plain<T>{w, Cin, C}, row0, col0, 0, C, acc,
                          sa, sb);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = row0 + wm * 64 + mi * 16 + g + (e >= 2 ? 8 : 0);
        int c = col0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (r < M && c < Cin)
          dx[(size_t)r * Cin + c] = Elt<T>::from_f32(acc[mi][ni][e]);
      }
}

// dW partial tile: rows cin, cols c, K = this split's rows m.
// A = x [m][cin] (RC), B = dy [m][c] (RC). Stored to ws[split][cin][c].
template <bool MASK, class T>
__global__ void __launch_bounds__(THREADS, 2)
    dw_kernel(Dy<MASK, T> dy, const T* __restrict__ x, float* __restrict__ ws,
              int M, int Cin, int C, int chunk) {
  __shared__ __align__(16) T sa[tile_elems<T>()];
  __shared__ __align__(16) T sb[tile_elems<T>()];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(M, k_begin + chunk);
  float acc[4][4][4];
  gemm_tile<true, true>(Plain<T>{x, M, Cin}, dy, row0, col0, k_begin, k_end,
                        acc, sa, sb);
  float* out = ws + (size_t)blockIdx.z * Cin * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = row0 + wm * 64 + mi * 16 + g + (e >= 2 ? 8 : 0);
        int c = col0 + wn * 32 + ni * 8 + 2 * t + (e & 1);
        if (r < Cin && c < C) out[(size_t)r * C + c] = acc[mi][ni][e];
      }
}

// Both backward launches plus the split reduction. `chunk` is a multiple
// of BK; splits * chunk >= M; ws holds splits * Cin * C floats.
template <bool MASK, class T>
int launch_bwd(Dy<MASK, T> dy, const T* x, const T* w, T* dx, float* ws,
               float* dw, int M, int Cin, int C, int splits, int chunk,
               cudaStream_t st) {
  dim3 gdx((M + BM - 1) / BM, (Cin + BN - 1) / BN);
  dx_kernel<MASK, T><<<gdx, THREADS, 0, st>>>(dy, w, dx, M, Cin, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gdw((Cin + BM - 1) / BM, (C + BN - 1) / BN, splits);
  dw_kernel<MASK, T><<<gdw, THREADS, 0, st>>>(dy, x, ws, M, Cin, C, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  colsum(ws, dw, splits, Cin * C, st);
  return (int)cudaGetLastError();
}

}  // namespace hvd
