// Kernel 6: the flash-attention backward for dQ.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/flash_attention.py _bwd
// -> _bwd_dq_kernel. Inputs q, do [BH][Sq][D], k, v [BH][Sk][D] (bf16 or
// f32; D 32, 64, 128, 256 or a larger multiple of 256), lse [BH][Sq]
// f32 and delta [BH][Sq] f32,
// the row sums that kernel 5's pre-pass wrote (with dlse already folded
// in, so this kernel has one variant); output dq [BH][Sq][D] in the
// input type:
//   dq = sum_j ds_ij k_j,  ds = p (dp - delta) scale,
//   p = exp(q.k^T scale - lse),  dp = do.v^T.
//
// At the LM's shape (S 1024, D 128, bf16, causal) this kernel does three
// S x S x D products over half the pairs, about 77 GFLOP for BH 192, and
// moves about 250 MB: the operations bound it (~0.078 ms at 989 TFLOP/s
// against ~0.075 ms of bytes at 3.35 TB/s). Both versions below keep q,
// do, lse, delta and the dq accumulator on chip for the whole key loop
// and read k and v once per query tile. Each block owns its dq rows: no
// atomics, and the result repeats bit for bit.
//
// bf16 at D 32, 64 and 128 (the main path): `dq_hopper`. What held the
// simple version back was the product chain, not bytes: synchronous
// tile loads between two barriers, mma.sync fed from shared memory by 4
// warps, and ds written to shared memory and read back for dq += ds.k.
// A block is two warpgroups (256 threads, so ptxas may give each thread
// 255 registers), each owning 64 of the block's 128 queries. Thread 0
// issues every TMA load: the q and do tiles once, then 64-key tiles of k
// and v through a 4-stage ring gated by full and empty mbarriers,
// refilling a stage as soon as all 8 warps are done with it, so the next
// tiles are in flight while the products run. Per key tile each
// warpgroup runs s = q.k^T and dp = do.v^T on wgmma with both operands
// in shared memory (K-major: k and v are [key][D]), in two commit groups
// so that the exp of p runs while dp is computed; p = exp2(s * scale *
// log2(e) - lse * log2(e)) and ds = p * (dp - delta) * scale in the
// accumulator registers, packed there into the bf16 A fragments of dq +=
// ds.k on wgmma with k read through the descriptor's transpose bit: ds
// never goes to shared memory. dq stays an f32 accumulator in registers
// (D/2 floats a thread) and is written once. Blocks run the last
// (heaviest causal) query tiles first, heads grouped so that the blocks
// in flight share k and v in L2.
//
// f32 (tf32) at every D, and bf16 at D 256: `dq_kernel`, the simple
// version: one block per (bh, 64-query tile), looping over the key tiles
// (64 rows; 32 for f32 at D 256, to stay inside shared memory) up to the
// diagonal (causal) or to Sk; per key tile each warp recomputes s, p, dp
// and ds for its 16 queries on mma.sync with synchronous tile loads, and
// ds passes through its slice of shared memory. tf32 wgmma takes only
// K-major operands, so ds.k would need a transposed copy of k, and
// neither case is on the main path. Its D 256 instance is also the wide
// path for head dims above 256 (flash_common.cuh): s and dp over every
// 256-column chunk, q, do, k, v streamed chunk by chunk, and dq's window
// blockIdx.z from k's window; right, not fast.
#include <type_traits>

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace hvd {
namespace flash {

template <class T, int D>
__global__ void __launch_bounds__(NT)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Sk, float scale, int causal,
              int width) {
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
  // The wide path: scores over n_ch chunks of D columns, dq's window win.
  // Below D 256 the width is D at compile time, so those instances
  // compile as if the wide path were not there.
  const int W = D < 256 ? D : width;
  const int n_ch = W / D, win = blockIdx.z * D;
  const T* qb = q + (size_t)bh * Sq * W;
  const T* ob = dout + (size_t)bh * Sq * W;
  const T* kb = k + (size_t)bh * Sk * W;
  const T* vb = v + (size_t)bh * Sk * W;
  const int r_lo = q0 + warp * 16 + (lane >> 2);  // and r_lo + 8
  if (n_ch == 1) {
    load_tile<T, D>(sQ, qb, q0, Sq);
    load_tile<T, D>(sO, ob, q0, Sq);
  }
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
    float s[KT / 8][4], dp[KT / 8][4];
    zero<KT / 8>(s);
    zero<KT / 8>(dp);
    for (int ch = 0; ch < n_ch; ++ch) {
      __syncthreads();
      if (n_ch > 1) {
        load_tile<T, D>(sQ, qb + ch * D, q0, Sq, W);
        load_tile<T, D>(sO, ob + ch * D, q0, Sq, W);
      }
      load_tile<T, D, KT>(sK, kb + ch * D, k0, Sk, W);
      load_tile<T, D, KT>(sV, vb + ch * D, k0, Sk, W);
      __syncthreads();
      mma_nt<T, KT / 8, D>(s, sQ, L::TILE_LD, warp * 16, sK, L::TILE_LD);
      mma_nt<T, KT / 8, D>(dp, sO, L::TILE_LD, warp * 16, sV, L::TILE_LD);
    }
    if (n_ch > 1) {  // k's window for dq += ds.k
      __syncthreads();
      load_tile<T, D, KT>(sK, kb + win, k0, Sk, W);
      __syncthreads();
    }
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
  store_rows<T, D>(dq + (size_t)bh * Sq * W + win, acc, q0 + warp * 16,
                   Sq, 1.f, 1.f, W);
}

template <class T, int D>
int launch_simple(int width, const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int BH, int Sq, int Sk, float scale, int causal,
                  cudaStream_t st) {
  typedef Ld<T, D, stream_rows<T, D>()> L;
  const int smem =
      (2 * L::TILE_ELEMS + 2 * L::KT_ELEMS + WARPS * L::P_ELEMS) *
      (int)sizeof(T);
  cudaError_t e = allow_smem(dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (Sq + TILE - 1) / TILE, width / D);
  dq_kernel<T, D><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Sq, Sk, scale, causal, width);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16, Hopper

template <int D>
struct DqHop {
  static constexpr int BQ = 128, BK = 64, ST = 4;  // rows, ring stages
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int OFF_DO = Q_BYTES, OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + ST * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + ST * KV_BYTES;
  // barriers: q and do full, then full and empty per stage; 1024 bytes
  // of slack to align the tiles.
  static constexpr int SMEM = OFF_BAR + (1 + 2 * ST) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(CONSUMER_WARPS * 32, 1)
    dq_hopper(const __grid_constant__ CUtensorMap mq,
              const __grid_constant__ CUtensorMap mk,
              const __grid_constant__ CUtensorMap mv,
              const __grid_constant__ CUtensorMap mdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int BH, int Sq, int Sk, float scale,
              int causal) {
  typedef DqHop<D> C;
  typedef hop::Swz<D> S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::ST;
  // Heaviest causal tiles (the last queries) first.
  const int n_qt = (Sq + C::BQ - 1) / C::BQ;
  int bh, tile;
  group_order(n_qt, BH, bh, tile);
  const int q0 = (n_qt - 1 - tile) * C::BQ;
  const int k_end = causal ? min(Sk, q0 + C::BQ) : Sk;
  const int n_tiles = (k_end + C::BK - 1) / C::BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Key tile it (k, v) into stage it % ST, by TMA; rows past Sk are zero.
  auto load = [&](int it) {
    const int st = it % C::ST, k0 = it * C::BK;
    hop::bar_expect(full + st, 2 * C::KV_BYTES);
    for (int cb = 0; cb < S::NCB; ++cb) {
      const int off = st * C::KV_BYTES + cb * C::BK * S::SWB;
      hop::tma_3d(sm + C::OFF_K + off, &mk, full + st, cb * S::CB, k0, bh);
      hop::tma_3d(sm + C::OFF_V + off, &mv, full + st, cb * S::CB, k0, bh);
    }
  };
  if (threadIdx.x == 0) {
    hop::bar_init(q_full, 1);
    for (int s = 0; s < C::ST; ++s) {
      hop::bar_init(full + s, 1);
      hop::bar_init(empty + s, CONSUMER_WARPS);
    }
    hop::bar_init_fence();
    hop::bar_expect(q_full, 2 * C::Q_BYTES);
    for (int cb = 0; cb < S::NCB; ++cb) {
      hop::tma_3d(sm + cb * C::BQ * S::SWB, &mq, q_full, cb * S::CB, q0, bh);
      hop::tma_3d(sm + C::OFF_DO + cb * C::BQ * S::SWB, &mdo, q_full,
                  cb * S::CB, q0, bh);
    }
    for (int it = 0; it < min(C::ST, n_tiles); ++it) load(it);
  }
  __syncthreads();

  // Warpgroup wg owns queries q0 + 64wg .. + 63; this thread holds rows
  // r_lo and r_lo + 8 of them (rows of s); columns are keys. A row past
  // Sq has lse +inf (p = 0) and is not stored.
  const int wg = warp / 4, t = lane & 3;
  const int r_lo = q0 + 64 * wg + 16 * (warp % 4) + (lane >> 2);
  const int r_min = r_lo - (lane >> 2);  // the warp's first row
  const float sl2 = scale * LOG2E;
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    l2[h] = r < Sq ? lse[(size_t)bh * Sq + r] * LOG2E : INFINITY;
    dl[h] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
  }
  const uint32_t sQ = hop::smem_u32(sm), sO = sQ + C::OFF_DO;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  hop::bar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    // Thread 0 refills the stage of tile it - 1, once every warp is done
    // with it, with tile it - 1 + ST.
    if (threadIdx.x == 0 && it > 0 && it - 1 + C::ST < n_tiles) {
      hop::bar_wait(empty + (it - 1) % C::ST, ((it - 1) / C::ST) & 1);
      load(it - 1 + C::ST);
    }
    const int st = it % C::ST, k0 = it * C::BK;
    const uint32_t sK = sQ + C::OFF_K + st * C::KV_BYTES;
    const uint32_t sV = sQ + C::OFF_V + st * C::KV_BYTES;
    float s[C::BK / 2], dp[C::BK / 2];
    uint32_t da[C::BK / 16][4];
    hop::bar_wait(full + st, (it / C::ST) & 1);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // s = q.k^T
      hop::Wgmma<C::BK>::template ss<0, 0>(
          s, hop::desc_k<D, C::BQ>(sQ, 64 * wg, kk),
          hop::desc_k<D, C::BK>(sK, 0, kk), kk > 0);
    hop::wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dp = do.v^T
      hop::Wgmma<C::BK>::template ss<0, 0>(
          dp, hop::desc_k<D, C::BQ>(sO, 64 * wg, kk),
          hop::desc_k<D, C::BK>(sV, 0, kk), kk > 0);
    hop::wg_commit();
    hop::wg_wait<1>();
    hop::fence_regs(s);

    // p in place of s while dp is computed. Masks only tiles that cross
    // the diagonal of this warp's rows or the Sk edge.
    const bool edge = k0 + C::BK > Sk || (causal && k0 + C::BK - 1 > r_min);
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) {
      const int c = k0 + 8 * (i / 4) + 2 * t + (i & 1);  // key
      float p = hop::exp2_approx(s[i] * sl2 - l2[(i >> 1) & 1]);
      if (edge && (c >= Sk || (causal && c > r_lo + ((i >> 1) & 1) * 8)))
        p = 0.f;
      s[i] = p;
    }
    hop::wg_wait<0>();
    hop::fence_regs(dp);

    // ds = p * (dp - delta) * scale, packed for dq += ds.k: the pairs
    // d[8kk .. 8kk + 7] in order are the A fragment of keys 16kk ..
    // 16kk + 15.
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, h = r & 1;
        da[kk][r] = hop::pack_bf16(s[i] * (dp[i] - dl[h]) * scale,
                                   s[i + 1] * (dp[i + 1] - dl[h]) * scale);
      }
    hop::fence_regs(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)  // dq += ds.k
      hop::Wgmma<D>::template rs<1>(acc, da[kk],
                                    hop::desc_mn<D, C::BK>(sK, kk), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + st);  // this warp is done
  }

  bf16* out = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + 8 * h;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (size_t)r * D + 8 * j + 2 * t) =
          hop::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <int D>
int launch_hopper(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int BH, int Sq, int Sk, float scale, int causal,
                  cudaStream_t st) {
  typedef DqHop<D> C;
  CUtensorMap mq, mk, mv, mdo;
  if (!hop::map_3d<D>(&mq, q, Sq, BH, C::BQ) ||
      !hop::map_3d<D>(&mdo, dout, Sq, BH, C::BQ) ||
      !hop::map_3d<D>(&mk, k, Sk, BH, C::BK) ||
      !hop::map_3d<D>(&mv, v, Sk, BH, C::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(dq_hopper<D>, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = BH * ((Sq + C::BQ - 1) / C::BQ);
  dq_hopper<D><<<grid, CONSUMER_WARPS * 32, C::SMEM, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), BH, Sq, Sk,
      scale, causal);
  return (int)cudaGetLastError();
}

// width: the head dim in device memory (D, or a multiple of 256 above
// it for the wide path of the D 256 instance). bf16 at D <= 128 takes
// dq_hopper, everything else dq_kernel (ops/flash_attention.py
// `flash_instance` names the same choice).
template <class T, int D>
int launch(int width, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, void* dq,
           int BH, int Sq, int Sk, float scale, int causal, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, bf16>::value && D <= 128)
    return launch_hopper<D>(q, k, v, dout, lse, delta, dq, BH, Sq, Sk, scale,
                            causal, st);
  else
    return launch_simple<T, D>(width, q, k, v, dout, lse, delta, dq, BH, Sq,
                               Sk, scale, causal, st);
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
