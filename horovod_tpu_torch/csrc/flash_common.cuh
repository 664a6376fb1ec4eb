// Shared pieces of the flash-attention kernels for Hopper (sm_90a):
// tile loads into shared memory, warp-level products on mma.sync, and the
// instantiation over element type and head dim.
//
// Layout: q, o, do, dq [BH][Sq][D] and k, v, dk, dv [BH][Sk][D],
// row-major and 16-byte aligned; lse, delta, dlse [BH][Sq] f32. Element
// types: bf16 (mma m16n8k16) or f32 (mma m16n8k8 on tf32; every operand
// is rounded to tf32 as its fragment is loaded). D in {32, 64, 128, 256}.
//
// The wide path (head dims above 256, zero-padded by the wrapper to a
// multiple of 256): the simple kernels' D 256 instances take a runtime
// `width`, the head dim in device memory, of which D 256 is the case
// width == 256. The score products (q.k^T, do.v^T) run over all of it,
// streamed through shared memory 256 columns at a time, so no tile is
// wider than the D 256 instance's; the outputs (o, dq, dk, dv) are cut
// into 256-wide windows of columns on grid axis z, and the block of
// window z recomputes the scores it needs and writes that window. lse
// (kernel 4) is written by window 0; every window computes the same
// values in the same order.
//
// A block has 4 warps and works on one 64-row tile of its own (queries
// for the forward and dQ, keys for dK/dV); each warp owns 16 of those
// rows. It walks the other sequence 64 rows at a time through shared
// memory. Score-shaped tiles (16 x 64 per warp) live in registers as mma
// accumulators; a probability or dS tile that feeds a second product is
// written to the warp's own slice of shared memory and read back as the
// A operand. Every row tile is owned by one block: no atomics, and the
// results repeat bit for bit.
#pragma once

#include "mma.cuh"

namespace hvd {
namespace flash {

constexpr int TILE = 64;          // rows of a q or kv tile
constexpr int WARPS = 4, NT = 128;
constexpr float NEG_INF = -1e30f;  // the JAX kernel's mask value
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
// The Hopper kernels (bf16, D <= 128) have two consumer warpgroups. The
// forward adds a producer warpgroup: it launches at 168 registers a
// thread (384 x 168 fit the SM's 65,536), the producer drops to 24 and
// the consumers rise to 240 (setmaxnreg). The dK/dV kernel has no
// producer warpgroup: under setmaxnreg ptxas held its consumers near 190
// registers and spilled the accumulators, while 256 threads may use 255.
constexpr int CONSUMER_WARPS = 8, HOP_NT = CONSUMER_WARPS * 32 + 128;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

template <class T>
struct Ty;

template <>
struct Ty<bf16> {
  static constexpr int PAD = 8, KSTEP = 16;
  static __device__ __forceinline__ int kpos(int t) { return 2 * t; }
  static __device__ __forceinline__ float to_f32(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 from_f32(float f) {
    return __float2bfloat16_rn(f);
  }
  // (r, k) and (r, k + 1) of a row-major tile, one register.
  static __device__ __forceinline__ uint32_t ld_row(const bf16* S, int ld,
                                                    int r, int k) {
    return *reinterpret_cast<const uint32_t*>(S + r * ld + k);
  }
  // (k, n) and (k + 1, n) of a tile stored [k][n], one register.
  static __device__ __forceinline__ uint32_t ld_col(const bf16* S, int ld,
                                                    int k, int n) {
    uint32_t lo = __bfloat16_as_ushort(S[k * ld + n]);
    uint32_t hi = __bfloat16_as_ushort(S[(k + 1) * ld + n]);
    return lo | (hi << 16);
  }
};

template <>
struct Ty<float> {
  static constexpr int PAD = 4, KSTEP = 8;
  static __device__ __forceinline__ int kpos(int t) { return t; }
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float f) { return f; }
  static __device__ __forceinline__ uint32_t ld_row(const float* S, int ld,
                                                    int r, int k) {
    return __float_as_uint(tf32_round(S[r * ld + k]));
  }
  static __device__ __forceinline__ uint32_t ld_col(const float* S, int ld,
                                                    int k, int n) {
    return __float_as_uint(tf32_round(S[k * ld + n]));
  }
};

// Row strides in shared memory: a D-wide tile and a KT-wide score tile,
// where KT is the row count of the tile streamed through the loop. The
// pads put the 8 rows a fragment load touches in distinct banks.
template <class T, int D, int KT = TILE>
struct Ld {
  static constexpr int TILE_LD = D + Ty<T>::PAD;
  static constexpr int P_LD = KT + Ty<T>::PAD;
  static constexpr int TILE_ELEMS = TILE * TILE_LD;
  static constexpr int KT_ELEMS = KT * TILE_LD;  // one streamed tile
  static constexpr int P_ELEMS = 16 * P_LD;  // one warp's score slice
};

// Rows of the streamed tile in the backward kernels: 32 for f32 at D
// 256, where four 64-row tiles would pass the 227 KB of shared memory a
// block may use; else 64.
template <class T, int D>
__host__ __device__ constexpr int stream_rows() {
  return sizeof(T) == 4 && D == 256 ? 32 : TILE;
}

// sm[0 .. ROWS) rows <- D columns of g rows [r0, r0 + ROWS) of a
// [rows][ld] matrix (g points at the first column); rows at or past
// `rows` are zero. 16-byte loads and stores.
template <class T, int D, int ROWS = TILE>
__device__ __forceinline__ void load_tile(T* sm, const T* g, int r0,
                                          int rows, int ld = D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NT) {
    int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows)
      v = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(sm + r * Ld<T, D>::TILE_LD + c) = v;
  }
}

// acc (16 x 8*NJ) += A (rows ra .. ra+15 of a row-major tile, K wide)
// times B, where B(k, n) = Bs[n][k] (a tile stored row per n).
template <class T, int NJ, int K>
__device__ __forceinline__ void mma_nt(float (*acc)[4], const T* A, int lda,
                                       int ra, const T* Bs, int ldb) {
  constexpr int H = Ty<T>::KSTEP / 2;
  const int lane = threadIdx.x % 32, g = lane >> 2;
  const int kp = Ty<T>::kpos(lane & 3);
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += Ty<T>::KSTEP) {
    uint32_t a[4] = {Ty<T>::ld_row(A, lda, ra + g, k0 + kp),
                     Ty<T>::ld_row(A, lda, ra + g + 8, k0 + kp),
                     Ty<T>::ld_row(A, lda, ra + g, k0 + kp + H),
                     Ty<T>::ld_row(A, lda, ra + g + 8, k0 + kp + H)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t b[2] = {Ty<T>::ld_row(Bs, ldb, 8 * j + g, k0 + kp),
                       Ty<T>::ld_row(Bs, ldb, 8 * j + g, k0 + kp + H)};
      mma(acc[j], a, b, T());
    }
  }
}

// acc (16 x 8*NJ) += A (rows 0 .. 15 of a row-major tile, K wide) times
// B, where B(k, n) = Bs[k][n] (a tile stored row per k).
template <class T, int NJ, int K>
__device__ __forceinline__ void mma_nn(float (*acc)[4], const T* A, int lda,
                                       const T* Bs, int ldb) {
  constexpr int H = Ty<T>::KSTEP / 2;
  const int lane = threadIdx.x % 32, g = lane >> 2;
  const int kp = Ty<T>::kpos(lane & 3);
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += Ty<T>::KSTEP) {
    uint32_t a[4] = {Ty<T>::ld_row(A, lda, g, k0 + kp),
                     Ty<T>::ld_row(A, lda, g + 8, k0 + kp),
                     Ty<T>::ld_row(A, lda, g, k0 + kp + H),
                     Ty<T>::ld_row(A, lda, g + 8, k0 + kp + H)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t b[2] = {Ty<T>::ld_col(Bs, ldb, k0 + kp, 8 * j + g),
                       Ty<T>::ld_col(Bs, ldb, k0 + kp + H, 8 * j + g)};
      mma(acc[j], a, b, T());
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// Row (within the warp's 16) and column (within 8*NJ) of acc[j][e].
__device__ __forceinline__ int acc_row(int e) {
  return ((threadIdx.x % 32) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x % 4) + (e & 1);
}

// Stores a warp's 16 x D accumulator, divided by div0 (rows 0..7) or
// div1 (rows 8..15), as D columns of rows r0 + 0..15 of a [rows][ld]
// matrix (out points at the first column); rows at or past `rows` are
// skipped.
template <class T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (*acc)[4],
                                           int r0, int rows, float div0,
                                           float div1, int ld = D) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int r = r0 + acc_row(e);
      if (r < rows)
        out[(size_t)r * ld + acc_col(j, e)] =
            Ty<T>::from_f32(acc[j][e] / (e >> 1 ? div1 : div0));
    }
}

// The Hopper kernels' block order over a 1-d grid of n_tiles * BH
// blocks: heads in groups of GROUP_HEADS, and inside a group tile 0 (the
// heaviest under causal masking) of every head, then tile 1, and so on.
// The blocks in flight then share a few heads, whose k, v (or q, do)
// stay in the 50 MB L2 instead of 132 heads' worth streaming from HBM.
constexpr int GROUP_HEADS = 16;
__device__ __forceinline__ void group_order(int n_tiles, int BH, int& bh,
                                            int& tile) {
  const int L = blockIdx.x;
  const int g0 = L / (n_tiles * GROUP_HEADS) * GROUP_HEADS;
  const int heads = min(GROUP_HEADS, BH - g0);
  const int r = L - g0 * n_tiles;
  tile = r / heads;
  bh = g0 + r % heads;
}

// Dynamic shared memory above 48 KB must be allowed per kernel.
template <class K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

}  // namespace flash
}  // namespace hvd

// One extern "C" entry point per source dispatches on (is_f32, D) to the
// instance LAUNCH<T, inst>(D, args...): inst is D for D in {32, 64, 128,
// 256}, and 256 (the wide path, width D) for any larger multiple of 256;
// any other D returns cudaErrorInvalidValue (the Python wrapper pads dh
// up to one of these first).
#define HVD_FLASH_DISPATCH(LAUNCH, is_f32, D, ...)                      \
  do {                                                                  \
    if (is_f32) {                                                       \
      if (D == 32) return LAUNCH<float, 32>(D, __VA_ARGS__);            \
      if (D == 64) return LAUNCH<float, 64>(D, __VA_ARGS__);            \
      if (D == 128) return LAUNCH<float, 128>(D, __VA_ARGS__);          \
      if (D >= 256 && D % 256 == 0)                                     \
        return LAUNCH<float, 256>(D, __VA_ARGS__);                      \
    } else {                                                            \
      if (D == 32) return LAUNCH<hvd::bf16, 32>(D, __VA_ARGS__);        \
      if (D == 64) return LAUNCH<hvd::bf16, 64>(D, __VA_ARGS__);        \
      if (D == 128) return LAUNCH<hvd::bf16, 128>(D, __VA_ARGS__);      \
      if (D >= 256 && D % 256 == 0)                                     \
        return LAUNCH<hvd::bf16, 256>(D, __VA_ARGS__);                  \
    }                                                                   \
    return (int)cudaErrorInvalidValue;                                  \
  } while (0)
