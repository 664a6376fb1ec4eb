// Kernel 4: the flash-attention forward, FlashAttention style.
//
// Replaces the Pallas TPU kernel horovod_tpu/ops/flash_attention.py _fwd
// -> _fwd_kernel. Inputs q [BH][Sq][D], k, v [BH][Sk][D], bf16 or f32, D
// 32, 64, 128, 256 or a larger multiple of 256; outputs o [BH][Sq][D] in the input type and lse
// [BH][Sq] f32, the log-sum-exp of each row of scaled scores, which the
// backward kernels and chunk merges read. Causal masking uses the JAX
// kernel's -1e30; keys past Sk are -inf, so any S is taken; rows with l
// = 0 divide by 1.
//
// On the H100 the forward at the LM's shape (S 1024, D 128, bf16,
// causal) is bound by bytes: it does about S/2 multiply-adds per q, k
// or v element loaded, below the ~295 operations per byte at which the
// bf16 tensor cores become the limit. Both versions below read q once
// into shared memory, stream each needed k, v tile once per query tile
// and never write the S x S scores; they differ in how close they come.
//
// bf16 at D 32, 64 and 128 (the main path): `fwd_hopper`. A block is
// two consumer warpgroups, each owning 64 of the block's 128 query rows,
// and one producer warpgroup, whose registers go to the consumers
// (setmaxnreg). One producer thread loads the q tile once and streams
// 128-key k and v tiles through a 2-stage ring in shared memory, all by
// TMA (cp.async.bulk.tensor, swizzled for the wgmma descriptors), gated
// by full and empty mbarriers (k and v slots freed apart, k as soon as
// s is computed), so the next tiles are in flight while the consumers
// compute. s = q.k^T is wgmma with both operands in shared memory; the
// online softmax runs on the accumulator registers with exp2 and
// scale*log2(e) folded into one multiply, and masks only the tiles that
// cross the diagonal or the Sk edge. The two warpgroups take turns to
// issue their products, so that one's softmax overlaps the other's
// products on the tensor cores. p is packed to bf16 in registers and is
// the register A operand of o += p.v (v read through the descriptor's
// transpose bit). No score or probability tile goes to shared memory.
//
// f32 (tf32) at every D, and bf16 at D 256: `fwd_kernel`, the simple
// version on mma.sync with synchronous 64-row tile loads and p through
// the warp's slice of shared memory. tf32 wgmma takes only K-major
// operands, so p.v would need a transposed copy of v, and neither case
// is on the main path. Its D 256 instance is also the wide path for
// head dims above 256 (flash_common.cuh): q.k^T over every 256-column
// chunk of q and k, both streamed through the 256-wide tiles, and o's
// window blockIdx.z; right, not fast.
#include <type_traits>

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace hvd {
namespace flash {

template <class T, int D>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, float scale,
               int causal, int width) {
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
  // The wide path: scores over n_ch chunks of D columns, o's window win.
  // Below D 256 the width is D at compile time, so those instances
  // compile as if the wide path were not there.
  const int W = D < 256 ? D : width;
  const int n_ch = W / D, win = blockIdx.z * D;
  const T* qb = q + (size_t)bh * Sq * W;
  const T* kb = k + (size_t)bh * Sk * W;
  const T* vb = v + (size_t)bh * Sk * W;
  const int r_lo = q0 + warp * 16 + (lane >> 2);  // this thread's rows:
                                                   // r_lo and r_lo + 8
  if (n_ch == 1) load_tile<T, D>(sQ, qb, q0, Sq);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero<D / 8>(acc);
  const int k_end = causal ? min(Sk, q0 + TILE) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    float s[TILE / 8][4];
    zero<TILE / 8>(s);
    for (int ch = 0; ch < n_ch; ++ch) {
      __syncthreads();  // the previous tiles' readers are done
      if (n_ch > 1) load_tile<T, D>(sQ, qb + ch * D, q0, Sq, W);
      load_tile<T, D>(sK, kb + ch * D, k0, Sk, W);
      if (ch == n_ch - 1) load_tile<T, D>(sV, vb + win, k0, Sk, W);
      __syncthreads();
      mma_nt<T, TILE / 8, D>(s, sQ, L::TILE_LD, warp * 16, sK, L::TILE_LD);
    }
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
  store_rows<T, D>(o + (size_t)bh * Sq * W + win, acc, q0 + warp * 16,
                   Sq, safe[0], safe[1], W);
  if ((lane & 3) == 0 && blockIdx.z == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = r_lo + h * 8;
      if (r < Sq) lse[(size_t)bh * Sq + r] = m[h] + logf(safe[h]);
    }
  }
}

template <class T, int D>
int launch_simple(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int Sq, int Sk, float scale, int causal,
                  int width, void* stream) {
  typedef Ld<T, D> L;
  const int smem =
      (3 * L::TILE_ELEMS + WARPS * L::P_ELEMS) * (int)sizeof(T);
  cudaError_t e = allow_smem(fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(BH, (Sq + TILE - 1) / TILE, width / D);
  fwd_kernel<T, D><<<grid, NT, smem, reinterpret_cast<cudaStream_t>(
                                         stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Sk, scale, causal, width);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16, Hopper

template <int D>
struct FwdHop {
  static constexpr int BQ = 128, BK = 128, ST = 2;  // rows, ring stages
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int OFF_K = Q_BYTES, OFF_V = OFF_K + ST * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + ST * KV_BYTES;
  // barriers: q full, then k full, v full, k empty, v empty per stage;
  // 1024 bytes of slack to align the tiles.
  static constexpr int SMEM = OFF_BAR + (1 + 4 * ST) * 8 + 1024;
};

// Scores of one 128-key tile (in s, f32) to probabilities in place:
// scaled to log2 units, masked where `edge` says the tile crosses the
// Sk edge or the diagonal, the running row max m moved and alpha =
// 2^(m_old - m_new) returned for the rows' earlier sums; l takes alpha
// and this tile's sum (this thread's part of each row).
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], bool edge,
                                               int k0, int r_lo, int Sk,
                                               int causal, float sl2) {
  const int t = threadIdx.x & 3;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = s[i] * sl2;
    if (edge) {
      const int c = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      if (c >= Sk)
        x = -INFINITY;  // no such key: weight exactly 0
      else if (causal && c > r_lo + ((i >> 1) & 1) * 8)
        x = NEG_INF * LOG2E;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the 4 threads of a quad share a row
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = hop::exp2_approx(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = hop::exp2_approx(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
}

// p (f32 accumulator layout) packed into the bf16 A fragments of p.v:
// the pairs d[8kk .. 8kk + 7] in order are the fragment of keys
// 16kk .. 16kk + 15.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = hop::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int D>
__global__ void __launch_bounds__(HOP_NT, 1)
    fwd_hopper(const __grid_constant__ CUtensorMap mq,
               const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
               float* __restrict__ lse, int BH, int Sq, int Sk, float scale,
               int causal) {
  typedef FwdHop<D> C;
  typedef hop::Swz<D> S;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::ST;
  uint64_t* k_empty = v_full + C::ST;  // a k slot is free again
  uint64_t* v_empty = k_empty + C::ST;
  // Heaviest causal tiles (the last queries) are scheduled first.
  const int n_qt = (Sq + C::BQ - 1) / C::BQ;
  int bh, tile;
  group_order(n_qt, BH, bh, tile);
  const int q0 = (n_qt - 1 - tile) * C::BQ;
  const int k_end = causal ? min(Sk, q0 + C::BQ) : Sk;
  const int n_tiles = (k_end + C::BK - 1) / C::BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    hop::bar_init(q_full, 1);
    for (int s = 0; s < C::ST; ++s) {
      hop::bar_init(k_full + s, 1);
      hop::bar_init(v_full + s, 1);
      hop::bar_init(k_empty + s, CONSUMER_WARPS);
      hop::bar_init(v_empty + s, CONSUMER_WARPS);
    }
    hop::bar_init_fence();
  }
  __syncthreads();

  const int wg = hop::warpgroup();
  if (wg == CONSUMER_WARPS / 4) {
    // The producer warpgroup gives its registers to the consumers; one
    // thread issues every TMA load.
    hop::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMER_WARPS * 32) {
      hop::bar_expect(q_full, C::Q_BYTES);
      for (int cb = 0; cb < S::NCB; ++cb)
        hop::tma_3d(sm + cb * C::BQ * S::SWB, &mq, q_full, cb * S::CB, q0,
                    bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % C::ST;
        const uint32_t par = (it / C::ST - 1) & 1;
        unsigned char* kt = sm + C::OFF_K + st * C::KV_BYTES;
        unsigned char* vt = sm + C::OFF_V + st * C::KV_BYTES;
        if (it >= C::ST) hop::bar_wait(k_empty + st, par);
        hop::bar_expect(k_full + st, C::KV_BYTES);
        for (int cb = 0; cb < S::NCB; ++cb)
          hop::tma_3d(kt + cb * C::BK * S::SWB, &mk, k_full + st,
                      cb * S::CB, it * C::BK, bh);
        if (it >= C::ST) hop::bar_wait(v_empty + st, par);
        hop::bar_expect(v_full + st, C::KV_BYTES);
        for (int cb = 0; cb < S::NCB; ++cb)
          hop::tma_3d(vt + cb * C::BK * S::SWB, &mv, v_full + st,
                      cb * S::CB, it * C::BK, bh);
      }
    }
  } else {
    // The consumers: warpgroup wg owns query rows q0 + 64wg .. + 63; this
    // thread holds rows r_lo and r_lo + 8 of them. The two warpgroups
    // take turns to issue their products (named barriers 1 and 2), so
    // that one's softmax runs while the other's products use the tensor
    // cores.
    hop::reg_alloc<CONSUMER_REGS>();
    const int t = lane & 3;
    const int r_lo = q0 + 64 * wg + 16 * (warp % 4) + (lane >> 2);
    const int r_min = r_lo - (lane >> 2);  // the warp's first row
    const float sl2 = scale * LOG2E;
    const uint32_t sQ = hop::smem_u32(sm);
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    float acc[D / 2], alpha[2];
    uint32_t pa[C::BK / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF * LOG2E, NEG_INF * LOG2E}, l[2] = {0.f, 0.f};
    if (wg == 1) hop::named_arrive(their_turn, 2 * 128);  // wg 0 first
    hop::bar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % C::ST, k0 = it * C::BK;
      const uint32_t par = (it / C::ST) & 1;
      float s[C::BK / 2];
      hop::bar_wait(k_full + st, par);
      hop::named_sync(my_turn, 2 * 128);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // s = q.k^T
        hop::Wgmma<C::BK>::template ss<0, 0>(
            s, hop::desc_k<D, C::BQ>(sQ, 64 * wg, kk),
            hop::desc_k<D, C::BK>(sQ + C::OFF_K + st * C::KV_BYTES, 0, kk),
            kk > 0);
      hop::wg_commit();
      hop::named_arrive(their_turn, 2 * 128);
      hop::wg_wait<0>();
      hop::fence_regs(s);
      __syncwarp();
      if (lane == 0) hop::bar_arrive(k_empty + st);  // k read by this warp

      const bool edge = k0 + C::BK > Sk || (causal && k0 + C::BK - 1 > r_min);
      online_softmax<C::BK>(s, m, l, alpha, edge, k0, r_lo, Sk, causal, sl2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_p<C::BK>(s, pa);

      hop::bar_wait(v_full + st, par);
      hop::named_sync(my_turn, 2 * 128);
      hop::fence_regs(acc);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)  // o += p.v
        hop::Wgmma<D>::template rs<1>(
            acc, pa[kk],
            hop::desc_mn<D, C::BK>(sQ + C::OFF_V + st * C::KV_BYTES, kk), 1);
      hop::wg_commit();
      // wg 1's last turn has no one left to hand over to.
      if (wg == 0 || it + 1 < n_tiles) hop::named_arrive(their_turn, 2 * 128);
      hop::wg_wait<0>();
      hop::fence_regs(acc);
      __syncwarp();
      if (lane == 0) hop::bar_arrive(v_empty + st);
    }

    float safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      safe[h] = l[h] > 0.f ? l[h] : 1.f;
    }
    bf16* ob = o + (size_t)bh * Sq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      if (r >= Sq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r * D + 8 * j + 2 * t) =
            hop::pack_bf16(acc[4 * j + 2 * h] / safe[h],
                           acc[4 * j + 2 * h + 1] / safe[h]);
      if (t == 0) lse[(size_t)bh * Sq + r] = (m[h] + log2f(safe[h])) * LN2;
    }
  }
}

template <int D>
int launch_hopper(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int Sq, int Sk, float scale, int causal,
                  void* stream) {
  typedef FwdHop<D> C;
  CUtensorMap mq, mk, mv;
  if (!hop::map_3d<D>(&mq, q, Sq, BH, C::BQ) ||
      !hop::map_3d<D>(&mk, k, Sk, BH, C::BK) ||
      !hop::map_3d<D>(&mv, v, Sk, BH, C::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fwd_hopper<D>, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int grid = BH * ((Sq + C::BQ - 1) / C::BQ);
  fwd_hopper<D><<<grid, HOP_NT, C::SMEM,
                  reinterpret_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), BH, Sq,
      Sk, scale, causal);
  return (int)cudaGetLastError();
}

// width: the head dim in device memory (D, or a multiple of 256 above
// it for the wide path of the D 256 instance).
template <class T, int D>
int launch(int width, const void* q, const void* k, const void* v, void* o,
           void* lse, int BH, int Sq, int Sk, float scale, int causal,
           void* stream) {
  if constexpr (std::is_same<T, bf16>::value && D <= 128)
    return launch_hopper<D>(q, k, v, o, lse, BH, Sq, Sk, scale, causal,
                            stream);
  else
    return launch_simple<T, D>(q, k, v, o, lse, BH, Sq, Sk, scale, causal,
                               width, stream);
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
