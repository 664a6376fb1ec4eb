// Kernel 6: the flash-attention backward for dQ.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/flash_attention.py _bwd
// -> _bwd_dq_kernel. Inputs q, do [BH][Sq][D], k, v [BH][Sk][D] (bf16 or
// f32; D 32, 64, 128 or 256), lse [BH][Sq] f32 and delta [BH][Sq] f32,
// the row sums that kernel 5's pre-pass wrote (with dlse already folded
// in, so this kernel has one variant); output dq [BH][Sq][D] in the
// input type.
//
// One block per (bh, 64-query tile), looping over the key tiles (64
// rows; 32 for f32 at D 256, to stay inside shared memory) up to the
// diagonal (causal) or to Sk. Per key tile each warp recomputes, for
// its 16 queries, s = q.k^T, p = exp(s*scale - lse), dp = do.v^T and
// ds = p * (dp - delta) * scale, and accumulates dq += ds.k in f32
// registers. Each block owns its dq rows: no atomics.
//
// At the LM's shape (S 1024, D 128, bf16, causal) this kernel does three
// S x S x D products over half the pairs, about 77 GFLOP for BH 192, and
// moves about 250 MB: bytes and operations bound it about equally. q, do,
// lse, delta and the dq accumulator stay on chip for the whole key loop;
// k and v are read once per query tile. Synchronous loads and mma.sync:
// the simple first version.
#include "flash_common.cuh"

namespace hvd {
namespace flash {

template <class T, int D>
__global__ void __launch_bounds__(NT)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Sk, float scale, int causal) {
  constexpr int KT = stream_rows<T, D>();  // rows of a k, v tile
  typedef Ld<T, D, KT> L;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + L::TILE_ELEMS;  // the do tile
  T* sK = sO + L::TILE_ELEMS;
  T* sV = sK + L::KT_ELEMS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* sS = sV + L::KT_ELEMS + warp * L::P_ELEMS;
  const int bh = blockIdx.x;
  // Heaviest causal tiles (the last queries) are scheduled first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;
  const int r_lo = q0 + warp * 16 + (lane >> 2);  // and r_lo + 8
  load_tile<T, D>(sQ, q + (size_t)bh * Sq * D, q0, Sq);
  load_tile<T, D>(sO, dout + (size_t)bh * Sq * D, q0, Sq);
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int r = r_lo + h * 8;
    lr[h] = r < Sq ? lse[(size_t)bh * Sq + r] : INFINITY;
    dr[h] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
  }

  float acc[D / 8][4];
  zero<D / 8>(acc);
  const int k_end = causal ? min(Sk, q0 + TILE) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += KT) {
    __syncthreads();
    load_tile<T, D, KT>(sK, kb, k0, Sk);
    load_tile<T, D, KT>(sV, vb, k0, Sk);
    __syncthreads();
    float s[KT / 8][4], dp[KT / 8][4];
    zero<KT / 8>(s);
    zero<KT / 8>(dp);
    mma_nt<T, KT / 8, D>(s, sQ, L::TILE_LD, warp * 16, sK, L::TILE_LD);
    mma_nt<T, KT / 8, D>(dp, sO, L::TILE_LD, warp * 16, sV, L::TILE_LD);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int h = e >> 1, r = r_lo + h * 8, c = k0 + acc_col(j, e);
        float x = s[j][e] * scale;
        if (causal && c > r) x = NEG_INF;
        float p = c < Sk ? expf(x - lr[h]) : 0.f;
        float ds = p * (dp[j][e] - dr[h]) * scale;
        sS[acc_row(e) * L::P_LD + acc_col(j, e)] = Ty<T>::from_f32(ds);
      }
    __syncwarp();
    mma_nn<T, D / 8, KT>(acc, sS, L::P_LD, sK, L::TILE_LD);
  }
  store_rows<T, D>(dq + (size_t)bh * Sq * D, acc, q0 + warp * 16, Sq, 1.f,
                   1.f);
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int BH, int Sq,
           int Sk, float scale, int causal, void* stream) {
  typedef Ld<T, D, stream_rows<T, D>()> L;
  const int smem =
      (2 * L::TILE_ELEMS + 2 * L::KT_ELEMS + WARPS * L::P_ELEMS) *
      (int)sizeof(T);
  cudaError_t e = allow_smem(dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (Sq + TILE - 1) / TILE);
  dq_kernel<T, D><<<grid, NT, smem, reinterpret_cast<cudaStream_t>(
                                        stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace hvd

// Returns cudaGetLastError() after the launch.
extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int BH, int Sq,
                                int Sk, int D, float scale, int causal,
                                int is_f32, void* stream) {
  HVD_FLASH_DISPATCH(hvd::flash::launch, is_f32, D, q, k, v, dout, lse,
                     delta, dq, BH, Sq, Sk, scale, causal, stream);
}
