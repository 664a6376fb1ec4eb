// Kernel 5: the flash-attention backward for dK and dV.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/flash_attention.py _bwd
// -> _bwd_dkdv_kernel. Inputs q, o, do [BH][Sq][D], k, v [BH][Sk][D]
// (bf16 or f32; D 32, 64, 128 or 256), lse [BH][Sq] f32 and, in the
// variant with an lse cotangent, dlse [BH][Sq] f32; outputs dk, dv
// [BH][Sk][D] in the input type, and delta [BH][Sq] f32, which kernel 6
// reads.
//
// delta is computed once, by a small pre-pass launched from the same
// entry point: delta = rowsum(do * o) in f32, minus dlse when there is
// one, so that every later use reads (dp - delta) for the JAX kernel's
// (dp - delta + dlse). The variant without dlse reads no dlse buffer.
//
// At the LM's shape (S 1024, D 128, bf16, causal) this kernel does four
// S x S x D products over half the pairs, about 103 GFLOP for BH 192,
// and moves about 250 MB: operations and bytes bound it about equally.
// Both versions below keep k, v and the dk, dv accumulators on chip for
// the whole query loop, so each is read or written once; q, do, lse and
// delta are read once per key tile. Each block owns its dk, dv rows: no
// atomics, and the results repeat bit for bit.
//
// bf16 at D 32, 64 and 128 (the main path): `dkdv_hopper`. A block is
// two warpgroups, each owning 64 of the block's 128 keys. The k and v
// tiles are loaded once by TMA and stay; 64-query tiles of q and do,
// with their lse and delta, stream through a 3-stage TMA ring gated by
// full and empty mbarriers; thread 0 issues the loads between its own
// products, refilling a stage as soon as every warp is done with it.
// Per query tile each warpgroup runs four wgmma products in the
// transposed orientation: s^T = k.q^T and dp^T = v.do^T with both
// operands in shared memory; p^T = exp2(s^T * scale * log2(e) - lse *
// log2(e)) and ds^T = p^T * (dp^T - delta) * scale in the accumulator
// registers, packed to bf16 A fragments there; then dv += p^T.do and
// dk += ds^T.q with do and q read through the descriptor's transpose
// bit. Neither p^T nor ds^T goes to shared memory. Three commit groups a
// tile let the exp of p^T run while dp^T is computed, and ds^T while dv
// is. dk and dv stay f32 accumulators in registers (D/2 + D/2 floats a
// thread); with the score tiles and fragments that needs ~250 registers
// at D 128, which a 256-thread block has (ptxas: 255, no spills).
//
// f32 (tf32) at every D, and bf16 at D 256: `dkdv_kernel`, the simple
// version: one block per (bh, 64-key tile), looping over the query tiles
// from the diagonal (causal) or from 0 (64 rows; 32 for f32 at D 256,
// to stay inside shared memory); each warp recomputes s^T, p^T, dp^T
// and ds^T for its 16 keys on mma.sync with synchronous tile loads, and
// p^T, ds^T pass through its slice of shared memory. tf32 wgmma takes
// only K-major operands, and neither case is on the main path.
#include <type_traits>

#include "flash_common.cuh"
#include "wgmma.cuh"

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
  constexpr int KT = stream_rows<T, D>();  // rows of a q, do tile
  typedef Ld<T, D, KT> L;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + L::TILE_ELEMS;
  T* sQ = sV + L::TILE_ELEMS;
  T* sO = sQ + L::KT_ELEMS;  // the do tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* sP = sO + L::KT_ELEMS + warp * 2 * L::P_ELEMS;
  T* sS = sP + L::P_ELEMS;  // ds^T
  float* sL = reinterpret_cast<float*>(sO + L::KT_ELEMS +
                                       WARPS * 2 * L::P_ELEMS);
  float* sD = sL + KT;
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
  for (int q0 = causal ? k0 : 0; q0 < Sq; q0 += KT) {
    __syncthreads();
    load_tile<T, D, KT>(sQ, qb, q0, Sq);
    load_tile<T, D, KT>(sO, ob, q0, Sq);
    if (threadIdx.x < KT) {
      int r = q0 + threadIdx.x;
      sL[threadIdx.x] = r < Sq ? lb[r] : INFINITY;  // no such query: p = 0
      sD[threadIdx.x] = r < Sq ? db[r] : 0.f;
    }
    __syncthreads();
    float st[KT / 8][4], dpt[KT / 8][4];
    zero<KT / 8>(st);
    zero<KT / 8>(dpt);
    mma_nt<T, KT / 8, D>(st, sK, L::TILE_LD, warp * 16, sQ, L::TILE_LD);
    mma_nt<T, KT / 8, D>(dpt, sV, L::TILE_LD, warp * 16, sO, L::TILE_LD);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
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
    mma_nn<T, D / 8, KT>(dv_acc, sP, L::P_LD, sO, L::TILE_LD);
    mma_nn<T, D / 8, KT>(dk_acc, sS, L::P_LD, sQ, L::TILE_LD);
  }
  const int r0 = k0 + warp * 16;
  store_rows<T, D>(dk + (size_t)bh * Sk * D, dk_acc, r0, Sk, 1.f, 1.f);
  store_rows<T, D>(dv + (size_t)bh * Sk * D, dv_acc, r0, Sk, 1.f, 1.f);
}

template <class T, int D>
int launch_simple(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int BH, int Sq, int Sk, float scale,
                  int causal, cudaStream_t st) {
  typedef Ld<T, D, stream_rows<T, D>()> L;
  const int smem = (2 * L::TILE_ELEMS + 2 * L::KT_ELEMS +
                    2 * WARPS * L::P_ELEMS) *
                       (int)sizeof(T) +
                   2 * stream_rows<T, D>() * (int)sizeof(float);
  cudaError_t e = allow_smem(dkdv_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (Sk + TILE - 1) / TILE);
  dkdv_kernel<T, D><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16, Hopper

template <int D>
struct BwdHop {
  static constexpr int BKEY = 128, BQ = 64, ST = 3;  // rows, ring stages
  static constexpr int KV_BYTES = BKEY * D * 2, Q_BYTES = BQ * D * 2;
  static constexpr int ROW_BYTES = BQ * 4;  // lse or delta of a q tile
  static constexpr int OFF_V = KV_BYTES, OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + ST * Q_BYTES;
  static constexpr int OFF_L = OFF_DO + ST * Q_BYTES;
  static constexpr int OFF_DL = OFF_L + ST * ROW_BYTES;
  static constexpr int OFF_BAR = OFF_DL + ST * ROW_BYTES;
  static constexpr int STAGE_TX = 2 * Q_BYTES + 2 * ROW_BYTES;
  // barriers: k and v full, then full and empty per stage; 1024 bytes
  // of slack to align the tiles.
  static constexpr int SMEM = OFF_BAR + (1 + 2 * ST) * 8 + 1024;
};

// Two consumer warpgroups and no producer warpgroup: thread 0 issues the
// loads between its own products. A block of 256 threads may use 255
// registers a thread, which the two f32 accumulators of D/2 floats, the
// score tiles and the bf16 fragments need at D 128.
template <int D>
__global__ void __launch_bounds__(CONSUMER_WARPS * 32, 1)
    dkdv_hopper(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mdo,
                const __grid_constant__ CUtensorMap ml,
                const __grid_constant__ CUtensorMap md,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int Sq,
                int Sk, float scale, int causal) {
  typedef BwdHop<D> C;
  typedef hop::Swz<D> S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::ST;
  int bh, tile;  // heaviest causal tiles (the first keys) first
  group_order((Sk + C::BKEY - 1) / C::BKEY, BH, bh, tile);
  const int k0 = tile * C::BKEY;
  const int q_start = causal ? k0 / C::BQ * C::BQ : 0;
  const int n_tiles = q_start < Sq ? (Sq - q_start + C::BQ - 1) / C::BQ : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Query tile it (q, do, lse, delta) into stage it % ST, by TMA.
  auto load = [&](int it) {
    const int st = it % C::ST, q0 = q_start + it * C::BQ;
    hop::bar_expect(full + st, C::STAGE_TX);
    for (int cb = 0; cb < S::NCB; ++cb) {
      const int off = st * C::Q_BYTES + cb * C::BQ * S::SWB;
      hop::tma_3d(sm + C::OFF_Q + off, &mq, full + st, cb * S::CB, q0, bh);
      hop::tma_3d(sm + C::OFF_DO + off, &mdo, full + st, cb * S::CB, q0,
                  bh);
    }
    // lse and delta rows of [BH * Sq]; rows past Sq are masked below.
    hop::tma_1d(sm + C::OFF_L + st * C::ROW_BYTES, &ml, full + st,
                bh * Sq + q0);
    hop::tma_1d(sm + C::OFF_DL + st * C::ROW_BYTES, &md, full + st,
                bh * Sq + q0);
  };
  if (threadIdx.x == 0) {
    hop::bar_init(kv_full, 1);
    for (int s = 0; s < C::ST; ++s) {
      hop::bar_init(full + s, 1);
      hop::bar_init(empty + s, CONSUMER_WARPS);
    }
    hop::bar_init_fence();
    hop::bar_expect(kv_full, 2 * C::KV_BYTES);
    for (int cb = 0; cb < S::NCB; ++cb) {
      hop::tma_3d(sm + cb * C::BKEY * S::SWB, &mk, kv_full, cb * S::CB, k0,
                  bh);
      hop::tma_3d(sm + C::OFF_V + cb * C::BKEY * S::SWB, &mv, kv_full,
                  cb * S::CB, k0, bh);
    }
    for (int it = 0; it < min(C::ST, n_tiles); ++it) load(it);
  }
  __syncthreads();

  // Warpgroup wg owns keys k0 + 64wg .. + 63; this thread holds keys
  // key_lo and key_lo + 8 (rows of s^T); columns are queries. Four
  // products a query tile, in three commit groups so that the exp runs
  // while dp^T is computed, and ds^T while dv is.
  const int wg = warp / 4, t = lane & 3;
  const int key_lo = k0 + 64 * wg + 16 * (warp % 4) + (lane >> 2);
  const int key_max = key_lo - (lane >> 2) + 15;  // the warp's last key
  const float sl2 = scale * LOG2E;
  const uint32_t sK = hop::smem_u32(sm), sV = sK + C::OFF_V;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  hop::bar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    // Thread 0 refills the stage of tile it - 1, once every warp is done
    // with it, with tile it - 1 + ST.
    if (threadIdx.x == 0 && it > 0 && it - 1 + C::ST < n_tiles) {
      hop::bar_wait(empty + (it - 1) % C::ST, ((it - 1) / C::ST) & 1);
      load(it - 1 + C::ST);
    }
    const int st = it % C::ST, q0 = q_start + it * C::BQ;
    const uint32_t sQ = sK + C::OFF_Q + st * C::Q_BYTES;
    const uint32_t sO = sK + C::OFF_DO + st * C::Q_BYTES;  // the do tile
    const float* sL =
        reinterpret_cast<const float*>(sm + C::OFF_L + st * C::ROW_BYTES);
    const float* sD =
        reinterpret_cast<const float*>(sm + C::OFF_DL + st * C::ROW_BYTES);
    float s[C::BQ / 2], dp[C::BQ / 2];
    uint32_t pa[C::BQ / 16][4], da[C::BQ / 16][4];
    hop::bar_wait(full + st, (it / C::ST) & 1);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // s^T = k.q^T
      hop::Wgmma<C::BQ>::template ss<0, 0>(
          s, hop::desc_k<D, C::BKEY>(sK, 64 * wg, kk),
          hop::desc_k<D, C::BQ>(sQ, 0, kk), kk > 0);
    hop::wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dp^T = v.do^T
      hop::Wgmma<C::BQ>::template ss<0, 0>(
          dp, hop::desc_k<D, C::BKEY>(sV, 64 * wg, kk),
          hop::desc_k<D, C::BQ>(sO, 0, kk), kk > 0);
    hop::wg_commit();
    hop::wg_wait<1>();
    hop::fence_regs(s);

    // p^T = exp2(s^T * scale * log2(e) - lse * log2(e)), in place and
    // packed into the A fragments of dv += p^T.do. Masks only tiles that
    // cross the diagonal of this warp's keys or the Sq edge.
    const bool edge = q0 + C::BQ > Sq || (causal && key_max > q0);
#pragma unroll
    for (int i = 0; i < C::BQ / 2; ++i) {
      const int c = 8 * (i / 4) + 2 * t + (i & 1);  // query in the tile
      float p = hop::exp2_approx(s[i] * sl2 - sL[c] * LOG2E);
      if (edge && (q0 + c >= Sq ||
                   (causal && key_lo + ((i >> 1) & 1) * 8 > q0 + c)))
        p = 0.f;
      s[i] = p;
    }
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = hop::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    hop::fence_regs(dva);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk)  // dv += p^T.do
      hop::Wgmma<D>::template rs<1>(dva, pa[kk],
                                    hop::desc_mn<D, C::BQ>(sO, kk), 1);
    hop::wg_commit();
    hop::wg_wait<1>();  // dp^T is in; dv may still run
    hop::fence_regs(dp);

    // ds^T = p^T * (dp^T - delta) * scale, packed for dk += ds^T.q.
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const int c = 8 * (i / 4) + 2 * t;
        da[kk][r] = hop::pack_bf16(s[i] * (dp[i] - sD[c]) * scale,
                                   s[i + 1] * (dp[i + 1] - sD[c + 1]) * scale);
      }
    hop::fence_regs(dka);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BQ / 16; ++kk)  // dk += ds^T.q
      hop::Wgmma<D>::template rs<1>(dka, da[kk],
                                    hop::desc_mn<D, C::BQ>(sQ, kk), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(dva);
    hop::fence_regs(dka);
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + st);  // this warp is done
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_lo + 8 * h;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = ((size_t)bh * Sk + key) * D + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + at) =
          hop::pack_bf16(dka[4 * j + 2 * h], dka[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          hop::pack_bf16(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
    }
  }
}

template <int D>
int launch_hopper(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int BH, int Sq, int Sk, float scale,
                  int causal, cudaStream_t st) {
  typedef BwdHop<D> C;
  CUtensorMap mq, mk, mv, mdo, ml, md;
  if (!hop::map_3d<D>(&mq, q, Sq, BH, C::BQ) ||
      !hop::map_3d<D>(&mdo, dout, Sq, BH, C::BQ) ||
      !hop::map_3d<D>(&mk, k, Sk, BH, C::BKEY) ||
      !hop::map_3d<D>(&mv, v, Sk, BH, C::BKEY) ||
      !hop::map_1d(&ml, lse, (long long)BH * Sq, C::BQ) ||
      !hop::map_1d(&md, delta, (long long)BH * Sq, C::BQ))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(dkdv_hopper<D>, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = BH * ((Sk + C::BKEY - 1) / C::BKEY);
  dkdv_hopper<D><<<grid, CONSUMER_WARPS * 32, C::SMEM, st>>>(
      mq, mk, mv, mdo, ml, md, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      BH, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

template <class T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, const void* dlse, void* delta,
           void* dk, void* dv, int BH, int Sq, int Sk, float scale,
           int causal, void* stream) {
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
  if constexpr (std::is_same<T, bf16>::value && D <= 128)
    return launch_hopper<D>(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Sk,
                            scale, causal, st);
  else
    return launch_simple<T, D>(q, k, v, dout, lse, delta, dk, dv, BH, Sq,
                               Sk, scale, causal, st);
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
