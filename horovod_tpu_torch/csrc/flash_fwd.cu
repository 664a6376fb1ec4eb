// Kernel 4: the flash-attention forward, FlashAttention-2 style.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/flash_attention.py
// _fwd -> _fwd_kernel. Inputs q [BH][Sq][D], k, v [BH][Sk][D], bf16 or
// f32; outputs o [BH][Sq][D] in the input type and lse [BH][Sq] f32, the
// log-sum-exp of each row of scaled scores, which the backward kernels
// and chunk merges read.
//
// One block per (bh, 64-query tile); a loop over 64-key tiles takes the
// place of the TPU's sequential grid axis. s = q.k^T and o += p.v run on
// mma.sync with f32 accumulation; the online softmax (row max m, row sum
// l) stays in registers, with the JAX kernel's -1e30 mask value and its
// l > 0 guard at the end. Under causal masking a key tile past the
// query tile's last row is never loaded (the block skip of the JAX
// kernel, ik*bk <= iq*bq + bq - 1); keys past Sk are masked to -inf, so
// any S is taken, not only multiples of the tile.
//
// On the H100 the forward at the LM's shape (S 1024, D 128, bf16,
// causal) is bound by bytes: it does about S/2 multiply-adds per q, k
// or v element loaded, below the ~295 operations per byte at which the
// bf16 tensor cores become the limit. The design reads q once into
// shared memory and streams each needed k, v tile once per query tile,
// and never writes the S x S scores. It is the simple version: loads are
// synchronous (no cp.async/TMA pipeline) and the products are mma.sync,
// not wgmma.
#include "flash_common.cuh"

namespace hvd {
namespace flash {

template <class T, int D>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, float scale,
               int causal) {
  typedef Ld<T, D> L;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + L::TILE_ELEMS;
  T* sV = sK + L::TILE_ELEMS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* sP = sV + L::TILE_ELEMS + warp * L::P_ELEMS;
  const int bh = blockIdx.x;
  // Heaviest causal tiles (the last queries) are scheduled first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;
  const int r_lo = q0 + warp * 16 + (lane >> 2);  // this thread's rows:
                                                   // r_lo and r_lo + 8
  load_tile<T, D>(sQ, qb, q0, Sq);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero<D / 8>(acc);
  const int k_end = causal ? min(Sk, q0 + TILE) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tiles' readers are done
    load_tile<T, D>(sK, kb, k0, Sk);
    load_tile<T, D>(sV, vb, k0, Sk);
    __syncthreads();
    float s[TILE / 8][4];
    zero<TILE / 8>(s);
    mma_nt<T, TILE / 8, D>(s, sQ, L::TILE_LD, warp * 16, sK, L::TILE_LD);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = r_lo + (e >> 1) * 8, c = k0 + acc_col(j, e);
        float x = s[j][e] * scale;
        if (c >= Sk)
          x = -INFINITY;  // no such key: weight exactly 0
        else if (causal && c > r)
          x = NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float sum[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the 4 threads of a quad share a row
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = expf(m[h] - mx[h]);
    }
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += p;
        sP[acc_row(e) * L::P_LD + acc_col(j, e)] = Ty<T>::from_f32(p);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = alpha[h] * l[h] + sum[h];
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    __syncwarp();
    mma_nn<T, D / 8, TILE>(acc, sP, L::P_LD, sV, L::TILE_LD);
  }
  float safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) safe[h] = l[h] > 0.f ? l[h] : 1.f;
  store_rows<T, D>(o + (size_t)bh * Sq * D, acc, q0 + warp * 16, Sq,
                   safe[0], safe[1]);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = r_lo + h * 8;
      if (r < Sq) lse[(size_t)bh * Sq + r] = m[h] + logf(safe[h]);
    }
  }
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int BH, int Sq, int Sk, float scale, int causal, void* stream) {
  typedef Ld<T, D> L;
  const int smem =
      (3 * L::TILE_ELEMS + WARPS * L::P_ELEMS) * (int)sizeof(T);
  cudaError_t e = allow_smem(fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (Sq + TILE - 1) / TILE);
  fwd_kernel<T, D><<<grid, NT, smem, reinterpret_cast<cudaStream_t>(
                                         stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace hvd

// Returns cudaGetLastError() after the launch.
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int BH, int Sq, int Sk,
                             int D, float scale, int causal, int is_f32,
                             void* stream) {
  HVD_FLASH_DISPATCH(hvd::flash::launch, is_f32, D, q, k, v, o, lse, BH, Sq,
                     Sk, scale, causal, stream);
}
