// Shared pieces of the fused 1x1-conv + BatchNorm kernels for Hopper
// (sm_90a): a shared-memory-tiled bf16 GEMM on mma.sync.m16n8k16 with
// f32 accumulation, operand sources that form their values while the
// tile is loaded (the BN-backward dy never reaches device memory), and a
// fixed-order column-sum pass for cross-block reductions.
//
// Tiling: a block of 256 threads (8 warps as 2 x 4) computes a 128 x 128
// output tile; each warp owns 64 x 32 (4 x 4 mma tiles, 64 f32
// accumulators per thread). K advances 32 at a time through one tile of
// each operand in shared memory; the next tile's global loads are in
// flight in registers while the current one is multiplied. An operand tile is kept in one of two
// layouts, chosen by which of its source dimensions is contiguous:
//   KC  [128 rows][32 k + 8 pad]  when the source is contiguous along k;
//   RC  [32 k][128 rows + 8 pad]  when it is contiguous along the rows.
// Both are written with 16-byte stores and read as mma fragments without
// bank conflicts. Any M, K and N are taken: loads outside the source are
// zero and stores outside the output are skipped.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvd {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int LDK = BK + 8;    // KC row stride (elements)
constexpr int LDR = BM + 8;    // RC row stride (elements)
constexpr int TILE_ELEMS = BM * LDK;  // >= BK * LDR

__device__ __forceinline__ bf16 bzero() { return __ushort_as_bfloat16(0); }

// Operand sources. A source is read 8 values at a time, at (r, c .. c+7)
// of its logical row-major matrix, in two steps: fetch() issues the
// global loads into registers (zero outside the matrix), emit() turns
// them into the 8 bf16 values of the tile. gemm_tile fetches the next
// K tile before it multiplies the current one, so the loads' latency
// hides behind the tensor-core work.
struct Raw {
  uint4 a, b;
};

__device__ __forceinline__ void fetch8(const bf16* p, int rows, int cols,
                                       int r, int c, uint4& u) {
  const bf16* q = p + (size_t)r * cols + c;
  if (r < rows && c + 8 <= cols && ((uintptr_t)q & 15) == 0) {
    u = *reinterpret_cast<const uint4*>(q);
  } else {
    __align__(16) bf16 t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      t[j] = (r < rows && c + j < cols) ? q[j] : bzero();
    u = *reinterpret_cast<const uint4*>(t);
  }
}

// A row-major bf16 matrix [rows][cols].
struct Plain {
  const bf16* p;
  int rows, cols;
  __device__ __forceinline__ void fetch(int r, int c, Raw& raw) const {
    fetch8(p, rows, cols, r, c, raw.a);
  }
  __device__ __forceinline__ uint4 emit(const Raw& raw, int, int) const {
    return raw.a;
  }
};

// The BN-backward input gradient dy [M][C], formed from dz and y as it is
// loaded:  xhat = (y - mean) * inv
//          MASK: dz = (xhat * s + bias > 0) ? dz : 0   (the forward's ReLU)
//          dy = (g * dz - a) - b * xhat, rounded to bf16.
// Every float op is a separately rounded intrinsic, in the order of the
// plain PyTorch version, so dy and the mask match it bit for bit.
template <bool MASK>
struct Dy {
  const bf16 *dz, *y;
  int rows, cols;
  const float *g, *mean, *inv, *a, *b, *s, *bias;
  __device__ __forceinline__ void fetch(int r, int c, Raw& raw) const {
    fetch8(dz, rows, cols, r, c, raw.a);
    fetch8(y, rows, cols, r, c, raw.b);
  }
  __device__ __forceinline__ uint4 emit(const Raw& raw, int r, int c) const {
    const bf16* dzv = reinterpret_cast<const bf16*>(&raw.a);
    const bf16* yv = reinterpret_cast<const bf16*>(&raw.b);
    __align__(16) bf16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int cc = c + j;
      if (r < rows && cc < cols) {
        float xhat = __fmul_rn(__fsub_rn(__bfloat162float(yv[j]), mean[cc]),
                               inv[cc]);
        float d = __bfloat162float(dzv[j]);
        if (MASK) {
          float zpre = __fadd_rn(__fmul_rn(xhat, s[cc]), bias[cc]);
          d = zpre > 0.f ? d : 0.f;
        }
        float t = __fsub_rn(__fsub_rn(__fmul_rn(g[cc], d), a[cc]),
                            __fmul_rn(b[cc], xhat));
        v[j] = __float2bfloat16_rn(t);
      } else {
        v[j] = bzero();
      }
    }
    return *reinterpret_cast<const uint4*>(v);
  }
};

// One operand tile's share of this thread: PER vectors of 8 values. KC:
// src is logical [row][k]; RC: src is logical [k][row].
template <bool RC, class Src>
struct TileLoader {
  static constexpr int PER = BM * BK / 8 / THREADS;
  Raw raw[PER];

  __device__ __forceinline__ static void at(int i, int row0, int k0,
                                            int& r, int& c, int& off) {
    int v = threadIdx.x + i * THREADS;
    if (!RC) {
      int rr = v / (BK / 8), kk = (v % (BK / 8)) * 8;
      r = row0 + rr, c = k0 + kk, off = rr * LDK + kk;
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
  __device__ __forceinline__ void store(const Src& src, bf16* S, int row0,
                                        int k0) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      int r, c, off;
      at(i, row0, k0, r, c, off);
      *reinterpret_cast<uint4*>(S + off) = src.emit(raw[i], r, c);
    }
  }
};

// The 32-bit fragment register holding (row, k) and (row, k + 1).
template <bool RC>
__device__ __forceinline__ uint32_t frag(const bf16* S, int row, int k) {
  if (!RC) return *reinterpret_cast<const uint32_t*>(S + row * LDK + k);
  uint32_t lo = __bfloat16_as_ushort(S[k * LDR + row]);
  uint32_t hi = __bfloat16_as_ushort(S[(k + 1) * LDR + row]);
  return lo | (hi << 16);
}

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mi][ni][e] = sum over k in [k_begin, k_end) of A[row][k] * B[k][col]
// for the block's 128 x 128 tile at (row0, col0). The element acc[mi][ni][e]
// sits at row  row0 + wm*64 + mi*16 + (lane>>2) + (e>=2 ? 8 : 0)
//        col   col0 + wn*32 + ni*8 + 2*(lane&3) + (e&1).
// (k_end - k_begin) must be a multiple of BK unless k_end is the end of K.
template <bool A_RC, bool B_RC, class SrcA, class SrcB>
__device__ __forceinline__ void gemm_tile(const SrcA& A, const SrcB& B,
                                          int row0, int col0, int k_begin,
                                          int k_end, float (*acc)[4][4],
                                          bf16* sa, bf16* sb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4, g = lane >> 2, t = lane & 3;
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
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        int r = wm * 64 + mi * 16 + g;
        af[mi][0] = frag<A_RC>(sa, r, kk + 2 * t);
        af[mi][1] = frag<A_RC>(sa, r + 8, kk + 2 * t);
        af[mi][2] = frag<A_RC>(sa, r, kk + 2 * t + 8);
        af[mi][3] = frag<A_RC>(sa, r + 8, kk + 2 * t + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        int n = wn * 32 + ni * 8 + g;
        bfr[ni][0] = frag<B_RC>(sb, n, kk + 2 * t);
        bfr[ni][1] = frag<B_RC>(sb, n, kk + 2 * t + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], af[mi], bfr[ni]);
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

// ---------------------------------------------------------------------
// Backward: dx = dy . w^T and dW = x^T . dy, dy formed in the loaders.
// ---------------------------------------------------------------------

// dx tile: rows m, cols cin, K = C. A = dy [m][c] (KC), B = w [cin][c] (KC).
// The f32 accumulator covers all of C in registers; dx rounds once.
template <bool MASK>
__global__ void __launch_bounds__(THREADS, 2)
    dx_kernel(Dy<MASK> dy, const bf16* __restrict__ w, bf16* __restrict__ dx,
              int M, int Cin, int C) {
  __shared__ __align__(16) bf16 sa[TILE_ELEMS];
  __shared__ __align__(16) bf16 sb[TILE_ELEMS];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  float acc[4][4][4];
  gemm_tile<false, false>(dy, Plain{w, Cin, C}, row0, col0, 0, C, acc, sa, sb);
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
          dx[(size_t)r * Cin + c] = __float2bfloat16_rn(acc[mi][ni][e]);
      }
}

// dW partial tile: rows cin, cols c, K = this split's rows m.
// A = x [m][cin] (RC), B = dy [m][c] (RC). Stored to ws[split][cin][c].
template <bool MASK>
__global__ void __launch_bounds__(THREADS, 2)
    dw_kernel(Dy<MASK> dy, const bf16* __restrict__ x, float* __restrict__ ws,
              int M, int Cin, int C, int chunk) {
  __shared__ __align__(16) bf16 sa[TILE_ELEMS];
  __shared__ __align__(16) bf16 sb[TILE_ELEMS];
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(M, k_begin + chunk);
  float acc[4][4][4];
  gemm_tile<true, true>(Plain{x, M, Cin}, dy, row0, col0, k_begin, k_end,
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
template <bool MASK>
int launch_bwd(Dy<MASK> dy, const bf16* x, const bf16* w, bf16* dx,
               float* ws, float* dw, int M, int Cin, int C, int splits,
               int chunk, cudaStream_t st) {
  dim3 gdx((M + BM - 1) / BM, (Cin + BN - 1) / BN);
  dx_kernel<MASK><<<gdx, THREADS, 0, st>>>(dy, w, dx, M, Cin, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gdw((Cin + BM - 1) / BM, (C + BN - 1) / BN, splits);
  dw_kernel<MASK><<<gdw, THREADS, 0, st>>>(dy, x, ws, M, Cin, C, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  colsum(ws, dw, splits, Cin * C, st);
  return (int)cudaGetLastError();
}

}  // namespace hvd
