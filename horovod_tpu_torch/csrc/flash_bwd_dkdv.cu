// Kernel 5: the flash-attention backward for dK and dV.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/flash_attention.py
// _bwd -> _bwd_dkdv_kernel. Inputs q, o, do [BH][Sq][D], k, v
// [BH][Sk][D] (bf16 or f32), lse [BH][Sq] f32 and, in the variant with
// an lse cotangent, dlse [BH][Sq] f32; outputs dk, dv [BH][Sk][D] in the
// input type, and delta [BH][Sq] f32, which kernel 6 reads.
//
// delta is computed once, by a small pre-pass launched from the same
// entry point: delta = rowsum(do * o) in f32, minus dlse when there is
// one, so that every later use reads (dp - delta) for the JAX kernel's
// (dp - delta + dlse). The variant without dlse reads no dlse buffer.
//
// Then one block per (bh, 64-key tile), looping over the query tiles
// from the diagonal (causal) or from 0. Per query tile each warp
// recomputes, for its 16 keys, s^T = k.q^T and p^T = exp(s^T*scale -
// lse), then dp^T = v.do^T and ds^T = p^T * (dp^T - delta) * scale, and
// accumulates dv += p^T.do and dk += ds^T.q in f32 registers. Each block
// owns its dk, dv rows: no atomics.
//
// At the LM's shape (S 1024, D 128, bf16, causal) this kernel does four
// S x S x D products over half the pairs, about 103 GFLOP for BH 192,
// and moves about 250 MB: operations and bytes bound it about equally.
// The design keeps k, v and the dk, dv accumulators on chip for the whole
// query loop, so each is read or written once; q, do, lse and delta are
// read once per key tile. Loads are synchronous and the products are
// mma.sync (no TMA, no wgmma): the simple first version.
#include "flash_common.cuh"

namespace hvd {
namespace flash {

// delta[row] = sum over d of do[row][d] * o[row][d] (minus dlse[row]),
// one warp per row.
template <class T, int D, bool HAS_DLSE>
__global__ void __launch_bounds__(NT)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 const float* __restrict__ dlse, float* __restrict__ delta,
                 int rows) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    s += Ty<T>::to_f32(dout[(size_t)row * D + d]) *
         Ty<T>::to_f32(o[(size_t)row * D + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = HAS_DLSE ? s - dlse[row] : s;
}

template <class T, int D>
__global__ void __launch_bounds__(NT)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Sq, int Sk, float scale,
                int causal) {
  typedef Ld<T, D> L;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + L::TILE_ELEMS;
  T* sQ = sV + L::TILE_ELEMS;
  T* sO = sQ + L::TILE_ELEMS;  // the do tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* sP = sO + L::TILE_ELEMS + warp * 2 * L::P_ELEMS;
  T* sS = sP + L::P_ELEMS;  // ds^T
  float* sL = reinterpret_cast<float*>(sO + L::TILE_ELEMS +
                                       WARPS * 2 * L::P_ELEMS);
  float* sD = sL + TILE;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * TILE;  // heaviest causal tiles first
  const T* qb = q + (size_t)bh * Sq * D;
  const T* ob = dout + (size_t)bh * Sq * D;
  const float* lb = lse + (size_t)bh * Sq;
  const float* db = delta + (size_t)bh * Sq;
  const int key_lo = k0 + warp * 16 + (lane >> 2);  // and key_lo + 8
  load_tile<T, D>(sK, k + (size_t)bh * Sk * D, k0, Sk);
  load_tile<T, D>(sV, v + (size_t)bh * Sk * D, k0, Sk);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero<D / 8>(dk_acc);
  zero<D / 8>(dv_acc);
  for (int q0 = causal ? k0 : 0; q0 < Sq; q0 += TILE) {
    __syncthreads();
    load_tile<T, D>(sQ, qb, q0, Sq);
    load_tile<T, D>(sO, ob, q0, Sq);
    if (threadIdx.x < TILE) {
      int r = q0 + threadIdx.x;
      sL[threadIdx.x] = r < Sq ? lb[r] : INFINITY;  // no such query: p = 0
      sD[threadIdx.x] = r < Sq ? db[r] : 0.f;
    }
    __syncthreads();
    float st[TILE / 8][4], dpt[TILE / 8][4];
    zero<TILE / 8>(st);
    zero<TILE / 8>(dpt);
    mma_nt<T, TILE / 8, D>(st, sK, L::TILE_LD, warp * 16, sQ, L::TILE_LD);
    mma_nt<T, TILE / 8, D>(dpt, sV, L::TILE_LD, warp * 16, sO, L::TILE_LD);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int key = key_lo + (e >> 1) * 8, c = acc_col(j, e);
        float x = st[j][e] * scale;
        if (causal && key > q0 + c) x = NEG_INF;
        float p = key < Sk ? expf(x - sL[c]) : 0.f;
        float ds = p * (dpt[j][e] - sD[c]) * scale;
        sP[acc_row(e) * L::P_LD + c] = Ty<T>::from_f32(p);
        sS[acc_row(e) * L::P_LD + c] = Ty<T>::from_f32(ds);
      }
    __syncwarp();
    mma_nn<T, D / 8, TILE>(dv_acc, sP, L::P_LD, sO, L::TILE_LD);
    mma_nn<T, D / 8, TILE>(dk_acc, sS, L::P_LD, sQ, L::TILE_LD);
  }
  const int r0 = k0 + warp * 16;
  store_rows<T, D>(dk + (size_t)bh * Sk * D, dk_acc, r0, Sk, 1.f, 1.f);
  store_rows<T, D>(dv + (size_t)bh * Sk * D, dv_acc, r0, Sk, 1.f, 1.f);
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* dlse, void* delta,
           void* dk, void* dv, int BH, int Sq, int Sk, float scale,
           int causal, void* stream) {
  typedef Ld<T, D> L;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = BH * Sq, nb = (rows + WARPS - 1) / WARPS;
  if (dlse)
    delta_kernel<T, D, true><<<nb, NT, 0, st>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout),
        static_cast<const float*>(dlse), static_cast<float*>(delta), rows);
  else
    delta_kernel<T, D, false><<<nb, NT, 0, st>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), nullptr,
        static_cast<float*>(delta), rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = (4 * L::TILE_ELEMS + 2 * WARPS * L::P_ELEMS) *
                       (int)sizeof(T) +
                   2 * TILE * (int)sizeof(float);
  e = allow_smem(dkdv_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (Sk + TILE - 1) / TILE);
  dkdv_kernel<T, D><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace hvd

// dlse may be null (the variant without an lse cotangent). Returns
// cudaGetLastError() after the launches.
extern "C" int hvd_flash_bwd_dkdv(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  const void* dlse, void* delta, void* dk,
                                  void* dv, int BH, int Sq, int Sk, int D,
                                  float scale, int causal, int is_f32,
                                  void* stream) {
  HVD_FLASH_DISPATCH(hvd::flash::launch, is_f32, D, q, k, v, o, dout, lse,
                     dlse, delta, dk, dv, BH, Sq, Sk, scale, causal, stream);
}
