// The Hopper design of the fused 1x1-conv + BN backward kernels 2 and 3
// for float32 (tf32 products, sm_90a): dy = (g * dz - a) - b * xhat
// (kernel 2 also masks dz with the forward's ReLU), dx = dy . w^T in f32
// and dW = x^T . dy in f32, dy never written to device memory. The f32
// sibling of conv1x1_bwd_hopper.cuh (bf16), whose note gives the design
// this one follows; `bwd_instance` (ops/conv_bn_backward.py) sends f32
// here for Cin and C multiples of 4 (TMA's 16-byte stride) in [64, 1024]
// (every ResNet-50 site), and the simple mma.sync code of
// conv1x1_gemm.cuh keeps every other f32 shape.
//
// What the H100 bounds, and what differs from the bf16 design:
//
// * Bytes. At every ResNet-50 site the products are bound by memory
//   (each input read once, each output written once: 1.143 ms a step at
//   batch 32 against 0.40 ms of tf32 operations at 495 TFLOP/s). The
//   simple code held one K step of 32 in flight per block, staged
//   through registers; here thread 0 keeps a TMA ring of 3 or 4 stages
//   of 24-64 KB full, and dz, y and x are read through L2 by the blocks
//   that share them at the same time (persistent dx grid, one wave of
//   dW blocks). Measured on an H100, a block's TMA loads of 128-byte
//   rows run at a near-fixed rate, with a cost per load besides: the
//   kernels' time follows the bytes each block loads (L2 re-reads
//   included) and its loads, over the blocks in flight. So dW loads x,
//   dz and y with one 3-d TMA load each a step (all its 32-column
//   blocks at once, map_3d_f32_blocks) where C and Cin are multiples of
//   32, and runs a block on every SM.
// * tf32 wgmma reads shared-memory operands K-major only, and a 128-byte
//   swizzled row holds 32 f32 values: a ring step is 32 channels (dx) or
//   32 rows (dW), where bf16 takes 64.
// * dx = dy . w^T (`dx_tf32`): both operands are K-major, so the bf16
//   plan carries over: TMA brings [128 rows][32 ch] tiles of dz and y and
//   an [NB cin][32 ch] tile of w; each consumer forms dy in the tf32 A
//   fragment (wgmma.cuh) from its rows of dz and y, rounds it (cvt.rna)
//   and issues wgmma RS m64nNBk8 with w as B.
// * dW = x^T . dy (`dw_tf32`): both operands are MN-major along M, which
//   tf32 wgmma cannot read from shared memory, and no staging copy is
//   made: A = x^T comes from registers, each thread gathering its
//   fragment (rows cin, columns m) from the swizzled x tile and rounding
//   it; B = dy, which the threads form anyway, is written transposed
//   ([NT c][32 m], K-major along M, rounded) into one of two buffers in
//   the swizzled layout and fenced for the async proxy. A stage is free
//   once its dz, y (read into dy^T one step ahead) and x (gathered at its
//   own step) are read, before its products run.
// * dy is formed once per product per block, as in bf16: in dx from the
//   per-channel rows staged once in shared memory, here interleaved
//   ([channel][8]: g, mean, inv, a, b, s, bias, 0) so that a channel's
//   rows are two 16-byte loads; in dW from a fixed group of 4 channels a
//   thread, whose rows it reads once into registers.
// * Split-K over M as the bf16 instance does it: the blocks of a cluster
//   add their partial tiles through distributed shared memory in a fixed
//   order, and a workspace (added by the fixed-order colsum pass) only
//   when a tile has more than one cluster. A dW block takes more than
//   half an SM's shared memory, and an H100 holds 15 clusters of 8 such
//   blocks at once but 66 of 2: the wrapper launches clusters of 2
//   (`hopper_tf32_dw_plan`), a block on every SM in one wave, where 16
//   clusters of 8 would run a second wave. The cluster size is a launch
//   attribute (cudaLaunchKernelEx). dx and dW repeat bit for bit.
// * Shared memory: at most 232,448 bytes a block. The ring holds 3 or 4
//   stages at every shape this instance takes (`hopper_tf32_smem` in the
//   wrapper mirrors the arithmetic of `launch_dx_tf32` and `dw_smem`
//   below): dx at NB 256 and C 1024 is 3 x 64 KB + 32 KB of rows; dW at
//   CT 256, NT 128 is 3 x 64 KB + 32 KB of dy^T buffers. dW tiles run
//   to 256 x 128 (two m64 tiles a warpgroup), so that dz and y are read
//   once a step at Cin 256.
// * Rounding. Operands that the threads hand to the tensor cores are
//   rounded to tf32 as the simple code rounds them (cvt.rna): dy in both
//   products, x in dW. w in dx goes from TMA straight to the tensor
//   cores, which read the upper 19 bits of each value: w is truncated.
#pragma once

#include <cooperative_groups.h>

#include "conv1x1_bwd_hopper.cuh"

namespace hvd {
namespace cbh32 {

using cbh::NT_BLOCK;
using cbh::Rows;
using cbh::SMEM_MAX;
using cbh::WARPS;
using hop::sm_count;
using hop::swz;

constexpr int KB = 32;          // channels (dx) or rows (dW) a ring step
constexpr int DX_ROWS = 128;    // rows of a dx tile
constexpr int BOX = 32 * 128;   // bytes of a [32 rows][32 f32] TMA box
constexpr int RW = 8;           // staged floats a channel
constexpr int MIN_STAGES = 3;
constexpr int MAX_STAGES = 4;
constexpr int TF32_CLUSTER = 2;  // dW blocks a cluster (see the note)

// sr[i * RW + k] = row k at channel c0 + i, for i < n: g, mean, inv, a,
// b, s, bias (s and bias null without the mask), then 0; zero past C (a
// zero row makes dy 0 there, whatever TMA's zero fill put in dz and y).
__device__ __forceinline__ void stage_rows8(float* sr, const Rows& r, int c0,
                                            int n, int C) {
  const float* src[7] = {r.g, r.mean, r.inv, r.a, r.b, r.s, r.bias};
  for (int idx = threadIdx.x; idx < n * RW; idx += NT_BLOCK) {
    const int i = idx / RW, k = idx % RW;
    sr[idx] = k < 7 && src[k] && c0 + i < C ? src[k][c0 + i] : 0.f;
  }
}

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return __float_as_uint(tf32_round(v));
}

// Ring depth that fits beside `fixed` bytes, at most MAX_STAGES; 0 when
// MIN_STAGES do not.
inline int stages(int stage_bytes, int fixed) {
  const int st = (SMEM_MAX - 1024 - fixed) / stage_bytes;
  return st < MIN_STAGES ? 0 : (st > MAX_STAGES ? MAX_STAGES : st);
}

// ------------------------------------------------------------------ dx

template <int NB>
struct DxCfg {
  static constexpr int ZY = DX_ROWS * 128;  // dz or y: [128 rows][32 ch]
  static constexpr int WB = NB * 128;       // w: [NB cin][32 ch]
  static constexpr int STAGE = 2 * ZY + WB;
};

template <bool MASK, int NB>
__global__ void __launch_bounds__(NT_BLOCK, 1)
    dx_tf32(const __grid_constant__ CUtensorMap mdz,
            const __grid_constant__ CUtensorMap my,
            const __grid_constant__ CUtensorMap mw, Rows rows,
            float* __restrict__ dx, int M, int Cin, int C, int ST) {
  typedef DxCfg<NB> G;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const int KC = (C + KB - 1) / KB;   // ring steps a tile
  const int CP = KC * KB;              // staged channels
  float* sr = reinterpret_cast<float*>(sm + ST * G::STAGE);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sm + ST * G::STAGE + RW * CP * 4);
  uint64_t* empty = full + ST;
  const int n_ct = (Cin + NB - 1) / NB;
  const int n_jobs = ((M + DX_ROWS - 1) / DX_ROWS) * n_ct;
  const int my_jobs =
      blockIdx.x < n_jobs ? (n_jobs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_items = my_jobs * KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Item it: ring step kc of the block's job it / KC (row tile major,
  // Cin tile minor, so blocks in flight share rows of dz and y).
  auto load = [&](int it) {
    const int st = it % ST, job = blockIdx.x + (it / KC) * gridDim.x;
    const int kc = it % KC;
    const int m0 = job / n_ct * DX_ROWS, n0 = job % n_ct * NB;
    unsigned char* base = sm + st * G::STAGE;
    hop::bar_expect(full + st, G::STAGE);
    hop::tma_2d(base, &mdz, full + st, kc * KB, m0);
    hop::tma_2d(base + G::ZY, &my, full + st, kc * KB, m0);
    hop::tma_2d(base + 2 * G::ZY, &mw, full + st, kc * KB, n0);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hop::bar_init(full + s, 1);
      hop::bar_init(empty + s, WARPS);
    }
    hop::bar_init_fence();
    for (int it = 0; it < min(ST, n_items); ++it) load(it);
  }
  stage_rows8(sr, rows, 0, CP, C);
  __syncthreads();

  // Warpgroup wg owns rows 64wg .. 64wg + 63 of the tile; this thread
  // holds rows rl and rl + 8 of them and, in each 8-channel k-step,
  // channels t and t + 4 (the tf32 A fragment's layout).
  const int wg = warp / 4, g = lane >> 2, t = lane & 3;
  const int rl = 64 * wg + 16 * (warp % 4) + g;  // rl & 7 == g
  // dy of item it, formed from its dz and y tiles into A fragments.
  auto form = [&](int it, uint32_t (&pa)[KB / 8][4]) {
    const int st = it % ST, kc = it % KC;
    const unsigned char* zt = sm + st * G::STAGE;
    const unsigned char* yt = zt + G::ZY;
    hop::bar_wait(full + st, (it / ST) & 1);
#pragma unroll
    for (int kk = 0; kk < KB / 8; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // channel t (h 0) or t + 4 (h 1)
        const int ch = kc * KB + 8 * kk + 4 * h + t;
        const float4 p = *reinterpret_cast<const float4*>(sr + ch * RW);
        const float4 q = *reinterpret_cast<const float4*>(sr + ch * RW + 4);
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // rows rl (e 0), rl + 8 (e 1)
          const int off = swz(rl + 8 * e, 2 * kk + h) + 4 * t;
          const float z = *reinterpret_cast<const float*>(zt + off);
          const float yv = *reinterpret_cast<const float*>(yt + off);
          pa[kk][2 * h + e] = tf32_bits(dy_value<MASK>(
              z, yv, p.x, p.y, p.z, p.w, q.x, q.y, q.z));
        }
      }
  };
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  // Item it: its products on the fragments `cur` (formed one step
  // earlier), and while they run, the next item's fragments into `nxt`.
  auto step = [&](int it, uint32_t (&cur)[KB / 8][4],
                  uint32_t (&nxt)[KB / 8][4]) {
    if (threadIdx.x == 0 && it > 0 && it - 1 + ST < n_items) {
      hop::bar_wait(empty + (it - 1) % ST, ((it - 1) / ST) & 1);
      load(it - 1 + ST);
    }
    const int st = it % ST, kc = it % KC;
    const uint32_t wt = hop::smem_u32(sm + st * G::STAGE + 2 * G::ZY);
    hop::fence_regs(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 8; ++kk)  // acc += dy . w^T, K-major w
      hop::WgmmaTf32<NB>::rs(acc, cur[kk], hop::desc_k32(wt, 0, kk), 1);
    hop::wg_commit();
    if (it + 1 < n_items) form(it + 1, nxt);
    hop::wg_wait<0>();
    hop::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + st);

    if (kc == KC - 1) {  // the tile is done
      const int job = blockIdx.x + (it / KC) * gridDim.x;
      const int m0 = job / n_ct * DX_ROWS, n0 = job % n_ct * NB;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = m0 + rl + 8 * e;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const int c = n0 + 8 * j + 2 * t;  // even; Cin a multiple of 4
          if (c < Cin)
            *reinterpret_cast<float2*>(dx + (size_t)r * Cin + c) =
                make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
    }
  };
  uint32_t pa0[KB / 8][4], pa1[KB / 8][4];
  if (n_items > 0) form(0, pa0);
  for (int it = 0; it < n_items; it += 2) {
    step(it, pa0, pa1);
    if (it + 1 < n_items) step(it + 1, pa1, pa0);
  }
}

// ------------------------------------------------------------------ dW

template <int CT, int NT>
struct DwCfg {
  static constexpr int XB = CT * 128;   // x: CT / 32 boxes [32 m][32 cin]
  static constexpr int ZB = NT * 128;   // dz; and y
  static constexpr int STAGE = XB + 2 * ZB;
  static constexpr int DYT = NT * 128;  // a dy^T buffer: [NT c][32 m]
  static constexpr int LDT = NT + 8;    // f32 partial tile row stride
  static constexpr int TILE_BYTES = CT * LDT * 4;
  // A warpgroup's share: MT m64 tiles of cin, every k-step (CT 128 and
  // 256), or, at CT 64, both warpgroups on the one m64 tile and half of
  // the k-steps each (their partials added in a fixed order at the end).
  static constexpr int MT = CT == 256 ? 2 : 1;
  static constexpr bool SPLIT_K = CT == 64;
  static constexpr int KSTEPS = SPLIT_K ? 2 : KB / 8;
  static_assert(CT == 64 || CT == 128 || CT == 256, "CT 64, 128 or 256");
  static_assert(NT == 64 || NT == 128, "NT 64 or 128");
};

template <bool MASK, int CT, int NT>
__global__ void __launch_bounds__(NT_BLOCK, 1)
    dw_tf32(const __grid_constant__ CUtensorMap mx,
            const __grid_constant__ CUtensorMap mdz,
            const __grid_constant__ CUtensorMap my, Rows rows,
            float* __restrict__ out, int M, int Cin, int C, int chunk,
            int ST, int x3, int z3) {
  // Launched in clusters of `cl` blocks along x (launch_dw_tf32). out is
  // dW, or the workspace when a tile has more than one cluster: cluster k
  // then writes slice k. x3 (z3): mx (mdz, my) is a 3-d map of column
  // blocks (map_3d_f32_blocks), one load a step, else a 2-d one, a load
  // for each 32 columns; the tiles land alike.
  typedef DwCfg<CT, NT> G;
  namespace cg = cooperative_groups;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dyt = sm + ST * G::STAGE;  // two buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(dyt + 2 * G::DYT);
  uint64_t* empty = full + ST;
  const int n_ctile = (C + NT - 1) / NT;
  const int cin0 = blockIdx.y / n_ctile * CT, c0 = blockIdx.y % n_ctile * NT;
  const int m_begin = blockIdx.x * chunk;
  const int m_end = min(M, m_begin + chunk);
  const int n_items = m_begin < m_end ? (m_end - m_begin + KB - 1) / KB : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  auto load = [&](int it) {
    const int st = it % ST, m0 = m_begin + it * KB;
    unsigned char* base = sm + st * G::STAGE;
    hop::bar_expect(full + st, G::STAGE);
    if (x3)
      hop::tma_3d(base, &mx, full + st, 0, m0, cin0 / 32);
    else
      for (int b = 0; b < CT / 32; ++b)
        hop::tma_2d(base + b * BOX, &mx, full + st, cin0 + 32 * b, m0);
    if (z3) {
      hop::tma_3d(base + G::XB, &mdz, full + st, 0, m0, c0 / 32);
      hop::tma_3d(base + G::XB + G::ZB, &my, full + st, 0, m0, c0 / 32);
    } else {
      for (int b = 0; b < NT / 32; ++b) {
        hop::tma_2d(base + G::XB + b * BOX, &mdz, full + st, c0 + 32 * b,
                    m0);
        hop::tma_2d(base + G::XB + G::ZB + b * BOX, &my, full + st,
                    c0 + 32 * b, m0);
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hop::bar_init(full + s, 1);
      hop::bar_init(empty + s, WARPS);
    }
    hop::bar_init_fence();
    for (int it = 0; it < min(ST, n_items); ++it) load(it);
  }
  __syncthreads();

  // dy^T of item it into buffer it & 1. This thread forms the 4 channels
  // of group cg4 (a fixed group, so its per-channel rows are read once,
  // from device memory into registers: zero past C) in rows r0, r0 +
  // TPG, ... of the step; a warp's stores to dy^T then fall in 16 or 32
  // banks. Rows past M are zero.
  constexpr int TPG = NT_BLOCK / (NT / 4);  // threads a channel group
  const int cg4 = threadIdx.x / TPG, r0 = threadIdx.x % TPG;
  float cr[4][7];
  {
    const float* src[7] = {rows.g, rows.mean, rows.inv, rows.a,
                           rows.b, rows.s, rows.bias};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const int c = c0 + 4 * cg4 + j;
        cr[j][k] = src[k] && c < C ? src[k][c] : 0.f;
      }
  }
  auto form = [&](int it) {
    const unsigned char* zt = sm + (it % ST) * G::STAGE + G::XB;
    const unsigned char* yt = zt + G::ZB;
    unsigned char* d = dyt + (it & 1) * G::DYT;
    const int m0 = m_begin + it * KB;
#pragma unroll
    for (int i = 0; i < KB / TPG; ++i) {
      const int m = r0 + TPG * i;
      const int off = (cg4 / 8) * BOX + swz(m, cg4 % 8);
      const float4 z = *reinterpret_cast<const float4*>(zt + off);
      const float4 yv = *reinterpret_cast<const float4*>(yt + off);
      const float zs[4] = {z.x, z.y, z.z, z.w};
      const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
      const bool valid = m0 + m < M;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * cg4 + j;
        const float v =
            valid ? tf32_round(dy_value<MASK>(zs[j], ys[j], cr[j][0],
                                              cr[j][1], cr[j][2], cr[j][3],
                                              cr[j][4], cr[j][5], cr[j][6]))
                  : 0.f;
        *reinterpret_cast<float*>(d + swz(c, m >> 2) + 4 * (m & 3)) = v;
      }
    }
    hop::fence_proxy_async();
  };

  // The A fragments of item it (x^T: rows cin, columns m), gathered from
  // its x tile and rounded: warpgroup wg's m64 tiles are cin rows
  // [64(MT wg + j), +64) for j < MT (CT 128, 256), or [0, 64) at CT 64
  // (k-steps 2wg, 2wg + 1).
  const int wg = warp / 4, g = lane >> 2, t = lane & 3;
  const int rw = 16 * (warp % 4) + g;
  uint32_t a[G::MT][G::KSTEPS][4];
  auto gather = [&](int it) {
    const unsigned char* xt = sm + (it % ST) * G::STAGE;
#pragma unroll
    for (int j = 0; j < G::MT; ++j)
#pragma unroll
      for (int i = 0; i < G::KSTEPS; ++i) {
        const int kk = G::SPLIT_K ? 2 * wg + i : i;
        const int crow = (G::SPLIT_K ? 0 : 64 * (G::MT * wg + j)) + rw;
#pragma unroll
        for (int h = 0; h < 2; ++h)  // column (row m) t (h 0), t + 4 (h 1)
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // row (cin) crow, crow + 8
            const int m = 8 * kk + 4 * h + t, cin = crow + 8 * e;
            a[j][i][2 * h + e] = tf32_bits(*reinterpret_cast<const float*>(
                xt + (cin / 32) * BOX + swz(m, (cin % 32) / 4) +
                4 * (cin % 4)));
          }
      }
  };

  float acc[G::MT][NT / 2];
#pragma unroll
  for (int j = 0; j < G::MT; ++j)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[j][i] = 0.f;
  if (n_items > 0) {
    hop::bar_wait(full, 0);
    form(0);
  }
  hop::named_sync(1, NT_BLOCK);
  const uint32_t dyt_u = hop::smem_u32(dyt);
  for (int it = 0; it < n_items; ++it) {
    const int st = it % ST;
    // every thread waited for this stage when it formed its dy^T
    gather(it);
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + st);  // dz, y and x all read
    if (threadIdx.x == 0 && it + ST < n_items) {  // refill it at once
      hop::bar_wait(empty + st, (it / ST) & 1);
      load(it + ST);
    }
#pragma unroll
    for (int j = 0; j < G::MT; ++j) hop::fence_regs(acc[j]);
    hop::wg_fence();
    const uint32_t bt = dyt_u + (it & 1) * G::DYT;
#pragma unroll
    for (int i = 0; i < G::KSTEPS; ++i)  // acc += x^T . dy
#pragma unroll
      for (int j = 0; j < G::MT; ++j)
        hop::WgmmaTf32<NT>::rs(
            acc[j], a[j][i],
            hop::desc_k32(bt, 0, G::SPLIT_K ? 2 * wg + i : i), 1);
    hop::wg_commit();
    if (it + 1 < n_items) {  // the next dy^T while these products run
      hop::bar_wait(full + (it + 1) % ST, ((it + 1) / ST) & 1);
      form(it + 1);
    }
    hop::wg_wait<0>();
#pragma unroll
    for (int j = 0; j < G::MT; ++j) hop::fence_regs(acc[j]);
    hop::named_sync(1, NT_BLOCK);
  }

  // The partial tile into shared memory (the ring is free: every load
  // was consumed and every product has completed), [CT][LDT] f32.
  __syncthreads();
  float* tile = reinterpret_cast<float*>(sm);
  auto put = [&](bool add) {
#pragma unroll
    for (int j = 0; j < G::MT; ++j) {
      const int rb = G::SPLIT_K ? 0 : 64 * (G::MT * wg + j);
#pragma unroll
      for (int q = 0; q < NT / 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float2* p = reinterpret_cast<float2*>(
              tile + (rb + rw + 8 * e) * G::LDT + 8 * q + 2 * t);
          float2 v = make_float2(acc[j][4 * q + 2 * e],
                                 acc[j][4 * q + 2 * e + 1]);
          if (add)
            v = make_float2(__fadd_rn(p->x, v.x), __fadd_rn(p->y, v.y));
          *p = v;
        }
    }
  };
  if (!G::SPLIT_K || wg == 0) put(false);
  if (G::SPLIT_K) {
    __syncthreads();
    if (wg == 1) put(true);  // warpgroup 0's k-steps, then 1's
  }

  // Cluster reduction: block r of the cl blocks adds rows [r * CT / cl,
  // (r + 1) * CT / cl) of the cl partial tiles in the order 0 .. cl - 1
  // and writes them once.
  cg::cluster_group clu = cg::this_cluster();
  clu.sync();
  const int rank = (int)clu.block_rank(), cl = (int)clu.num_blocks();
  constexpr int V = NT / 4;
  const int row0 = rank * CT / cl, rows_n = (rank + 1) * CT / cl - row0;
  const size_t slice =
      gridDim.x > (unsigned)cl ? (size_t)(blockIdx.x / cl) * Cin * C : 0;
  for (int i = threadIdx.x; i < rows_n * V; i += NT_BLOCK) {
    const int row = row0 + i / V, col = 4 * (i % V);
    const int off = row * G::LDT + col;
    float4 s = *reinterpret_cast<const float4*>(clu.map_shared_rank(tile, 0)
                                                + off);
    for (int q = 1; q < cl; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(clu.map_shared_rank(tile, q) + off);
      s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y),
                      __fadd_rn(s.z, v.z), __fadd_rn(s.w, v.w));
    }
    if (cin0 + row < Cin && c0 + col < C)
      *reinterpret_cast<float4*>(out + slice + (size_t)(cin0 + row) * C +
                                 c0 + col) = s;
  }
  clu.sync();  // no block leaves while another reads its shared memory
}

// ------------------------------------------------------------------ launch

template <bool MASK, int NB>
int launch_dx_tf32(const CUtensorMap& mdz, const CUtensorMap& my,
              const CUtensorMap& mw, const Rows& rows, float* dx, int M,
              int Cin, int C, cudaStream_t st) {
  typedef DxCfg<NB> G;
  const int CP = (C + KB - 1) / KB * KB;
  const int fixed = RW * CP * 4 + 2 * MAX_STAGES * 8;
  const int ST = stages(G::STAGE, fixed);
  if (!ST) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + ST * G::STAGE + fixed;
  cudaError_t e = cudaFuncSetAttribute(
      dx_tf32<MASK, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_jobs = (M + DX_ROWS - 1) / DX_ROWS * ((Cin + NB - 1) / NB);
  const int grid = n_jobs < sm_count() ? n_jobs : sm_count();
  dx_tf32<MASK, NB><<<grid, NT_BLOCK, smem, st>>>(mdz, my, mw, rows, dx, M,
                                                  Cin, C, ST);
  return (int)cudaGetLastError();
}

template <int CT, int NT>
int dw_smem(int* stages_out) {
  typedef DwCfg<CT, NT> G;
  const int fixed = 2 * G::DYT + 2 * MAX_STAGES * 8;
  const int ST = stages(G::STAGE, fixed);
  *stages_out = ST;
  return ST && ST * G::STAGE >= G::TILE_BYTES ? 1024 + ST * G::STAGE + fixed
                                              : 0;
}

template <bool MASK, int CT, int NT>
cudaLaunchConfig_t dw_config(dim3 grid, int smem, int cl, cudaStream_t st,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT_BLOCK, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The dW pass in clusters of TF32_CLUSTER blocks: `clusters` clusters a
// tile, each block `chunk` rows.
template <bool MASK, int CT, int NT>
int launch_dw_tf32(const float* x, const float* dz, const float* y,
                   const Rows& rows, float* out, int M, int Cin, int C,
                   int clusters, int chunk, cudaStream_t st) {
  constexpr int cl = TF32_CLUSTER;
  // x, dz and y by one 3-d load each a step where their columns come in
  // whole 32-column blocks (every ResNet-50 site), else by 2-d loads
  CUtensorMap mx, mdz, my;
  const int x3 = hop::map_3d_f32_blocks(&mx, x, M, Cin, KB, CT / 32);
  const int z3 = hop::map_3d_f32_blocks(&mdz, dz, M, C, KB, NT / 32) &&
                 hop::map_3d_f32_blocks(&my, y, M, C, KB, NT / 32);
  if ((!x3 && !hop::map_2d_f32(&mx, x, M, Cin, KB)) ||
      (!z3 && (!hop::map_2d_f32(&mdz, dz, M, C, KB) ||
               !hop::map_2d_f32(&my, y, M, C, KB))))
    return (int)cudaErrorInvalidValue;
  int ST;
  const int smem = dw_smem<CT, NT>(&ST);
  if (!smem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dw_tf32<MASK, CT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = dw_config<MASK, CT, NT>(
      dim3(cl * clusters, ((Cin + CT - 1) / CT) * ((C + NT - 1) / NT)), smem,
      cl, st, attr);
  e = cudaLaunchKernelEx(&cfg, dw_tf32<MASK, CT, NT>, mx, mdz, my, rows, out,
                         M, Cin, C, chunk, ST, x3, z3);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `cl` dW blocks of tile (ct, nt) the current card
// holds at once (cudaOccupancyMaxActiveClusters), or -1: what chose
// TF32_CLUSTER, and the check that a plan fits in one wave.
template <bool MASK>
int dw_max_clusters(int ct, int nt, int cl) {
  int ST, smem, n = -1;
  cudaLaunchAttribute attr[1];
#define HVD_OCC(CT_, NT_)                                                  \
  if (ct == CT_ && nt == NT_) {                                            \
    smem = dw_smem<CT_, NT_>(&ST);                                         \
    if (!smem || cudaFuncSetAttribute(                                     \
                     dw_tf32<MASK, CT_, NT_>,                              \
                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem))   \
      return -1;                                                           \
    cudaLaunchConfig_t cfg = dw_config<MASK, CT_, NT_>(                    \
        dim3(cl * 16, 1, 1), smem, cl, 0, attr);                           \
    if (cudaOccupancyMaxActiveClusters(&n, dw_tf32<MASK, CT_, NT_>, &cfg)) \
      return -1;                                                           \
    return n;                                                              \
  }
  HVD_OCC(64, 64) HVD_OCC(64, 128) HVD_OCC(128, 64) HVD_OCC(128, 128)
  HVD_OCC(256, 64) HVD_OCC(256, 128)
#undef HVD_OCC
  return n;
}

// dx = dy . w^T and dW = x^T . dy on the tf32 Hopper kernels. nb, ct, nt
// are the tile widths `hopper_tf32_tiles` chose; the dW split is
// `clusters` clusters of TF32_CLUSTER blocks of `chunk` rows (a multiple
// of 32). With one cluster a tile, dW is written directly; else each
// cluster writes its sum to ws[cluster] and colsum adds them in order.
template <bool MASK>
int launch_bwd_tf32(const float* dz, const float* y, const float* x,
                    const float* w, const Rows& rows, float* dx, float* ws,
                    float* dw, int M, int Cin, int C, int nb, int ct, int nt,
                    int clusters, int chunk, cudaStream_t st) {
  CUtensorMap mdz_r, my_r, mw;
  if (nb > 256 || !hop::map_2d_f32(&mdz_r, dz, M, C, DX_ROWS) ||
      !hop::map_2d_f32(&my_r, y, M, C, DX_ROWS) ||
      !hop::map_2d_f32(&mw, w, Cin, C, nb))
    return (int)cudaErrorInvalidValue;
  int e;
  if (nb == 64)
    e = launch_dx_tf32<MASK, 64>(mdz_r, my_r, mw, rows, dx, M, Cin, C,
                                 st);
  else if (nb == 128)
    e = launch_dx_tf32<MASK, 128>(mdz_r, my_r, mw, rows, dx, M, Cin, C,
                                  st);
  else if (nb == 256)
    e = launch_dx_tf32<MASK, 256>(mdz_r, my_r, mw, rows, dx, M, Cin, C,
                                  st);
  else
    return (int)cudaErrorInvalidValue;
  if (e) return e;
  float* out = clusters > 1 ? ws : dw;
#define HVD_DW32(CT_, NT_)                                                \
  if (ct == CT_ && nt == NT_)                                             \
    e = launch_dw_tf32<MASK, CT_, NT_>(x, dz, y, rows, out, M, Cin, C,    \
                                       clusters, chunk, st);              \
  else
  HVD_DW32(64, 64) HVD_DW32(64, 128) HVD_DW32(128, 64) HVD_DW32(128, 128)
  HVD_DW32(256, 64) HVD_DW32(256, 128) return (int)cudaErrorInvalidValue;
#undef HVD_DW32
  if (e) return e;
  if (clusters > 1) {
    colsum(ws, dw, clusters, Cin * C, st);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace cbh32
}  // namespace hvd
