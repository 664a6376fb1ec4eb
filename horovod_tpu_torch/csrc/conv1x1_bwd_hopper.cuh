// The Hopper design of the fused 1x1-conv + BN backward kernels 2 and 3
// (bf16, sm_90a): dy = (g * dz - a) - b * xhat (kernel 2 also masks dz
// with the forward's ReLU), dx = dy . w^T in bf16 and dW = x^T . dy in
// f32, dy never written to device memory. Kernels 2 and 3 are its two
// instances (MASK true, false); f32 runs the tf32 sibling of this
// design (conv1x1_bwd_hopper_f32.cuh), and the shapes that
// `bwd_instance` (ops/conv_bn_backward.py) sends elsewhere keep the
// simple mma.sync code of conv1x1_gemm.cuh.
//
// What the H100 bounds, and what each part of the design does about it:
//
// * dy is formed once per product per block, from rows in shared memory.
//   Each block stages its channels' per-channel rows (g, mean, inv, a, b
//   and, with the mask, scale and bias: at most 28 KB at C 1024) in
//   shared memory once, and forms every dy element it needs once with
//   dy_value, the same separately rounded ops as the simple loaders, so
//   the mask keeps the forward's sign decisions bit for bit. Over a
//   launch each dy element is formed ceil(Cin / NB) times for dx (NB =
//   256 from Cin 256 up, 128 where 256-wide tiles would not fill two
//   waves) and ceil(Cin / CT) times for dW (CT = 256 from Cin 256 up): 8
//   to 12 times at Cin 1024, 2 or 3 at Cin 256, twice below; the simple
//   code forms it 2 * ceil(Cin / 128) times, 16 at Cin 1024, each with 7
//   row loads from device memory.
// * dx on wgmma with dy in registers (`dx_hopper`). A block of two
//   warpgroups owns 128 rows by NB (64, 128 or 256) columns of Cin at a
//   time, on a persistent grid (one block an SM walks its row tiles,
//   all Cin tiles of a row tile in turn, so that the blocks in flight
//   share dz and y in L2, and w stays there). K is C: thread 0 issues TMA
//   loads of 64-channel tiles of dz and y (128 rows) and of w (NB rows,
//   K-major: w is [Cin][C]), all 128-byte swizzled, into an mbarrier ring
//   that runs across the block's tiles. Each consumer reads its rows of
//   dz and y in the wgmma A-fragment layout (wgmma.cuh), forms dy there,
//   packs it to bf16 and issues wgmma RS (m64nNBk16). dy stays out of
//   shared memory; dx rounds once from the f32 accumulator.
// * dW on wgmma with dy in shared memory (`dw_hopper`). A block owns a
//   CT (cin) x NT (c) tile of dW (CT 64, 128, 256; NT 64, 128) over a
//   chunk of M. Per 64-row step TMA brings x (MN-major, read with the
//   transpose bit) and dz, y; the 256 threads form the step's dy tile in
//   place of dz, in the same swizzled layout (each thread one 16-byte
//   piece: 8 channels of one row), fence it for the async proxy, and each
//   warpgroup issues wgmma SS with dy as B (MN-major, desc_mn). The next
//   step's dy is formed while this step's products run. With CT 256 each
//   dy tile feeds 256 x NT x 64 multiply-adds, so a block forms dy for
//   1/256 of its products; the blocks of one M chunk (all tiles of dW)
//   run together and read that chunk of dz, y and x from HBM about once.
// * Split-K without float atomics and with little workspace. dW has few
//   tiles (1 to 16 at the ResNet-50 sites), so M is split over blocks.
//   The splits of a tile form thread-block clusters of 8 along M: each
//   block leaves its f32 partial tile in its own shared memory, and
//   block r of the cluster adds slice r of the 8 partials, read through
//   distributed shared memory in the order 0..7, and writes it once.
//   Only when a tile has more than one cluster does a cluster write its
//   sum to a workspace that the fixed-order colsum pass adds: the
//   planner (`hopper_dw_plan`) keeps tiles x clusters <= 16, so the
//   workspace is at most 16 tiles (2 MiB), written once and read once,
//   against 35.7 MB of partials at (6272, 256, 1024) with 17 plain
//   splits. Clusters rather than fewer, longer splits: fewer splits
//   would leave SMs idle at the sites with 1-4 tiles, while the cluster
//   keeps 128 blocks busy and moves the partials SM to SM. A block's rows
//   are one contiguous chunk (interleaving the 64-row steps over the
//   blocks measured 2% slower on an H100). Every sum runs in a fixed
//   order: dx and dW repeat bit for bit.
// * Registers: 256 threads a block, no producer warpgroup and no
//   setmaxnreg (thread 0 issues the TMA loads between its own products),
//   which gives ptxas 255 registers a thread: the dx accumulator of 64 x
//   256 f32 per warpgroup is 128 of them.
#pragma once

#include <cooperative_groups.h>

#include "conv1x1_gemm.cuh"
#include "wgmma.cuh"

namespace hvd {
namespace cbh {

constexpr int NT_BLOCK = 256;  // threads: two warpgroups
constexpr int WARPS = NT_BLOCK / 32;
constexpr int KB = 64;          // channels (dx) or rows (dW) a ring step
constexpr int DX_ROWS = 128;    // rows of a dx tile
constexpr int CLUSTER = 8;      // blocks that add their dW partials
constexpr int BOX = 64 * 128;   // bytes of a [64 rows][64 bf16] TMA box
constexpr int SMEM_MAX = 232448;
constexpr int MAX_STAGES = 4;

// The per-channel rows, as pointers into device memory.
struct Rows {
  const float *g, *mean, *inv, *a, *b, *s, *bias;
};

// sr[k * n + i] = row k at channel c0 + i, for i < n; zero past C (a
// zero row makes dy 0 there, whatever TMA's zero fill put in dz and y).
template <bool MASK>
__device__ __forceinline__ void stage_rows(float* sr, const Rows& r, int c0,
                                           int n, int C) {
  const float* src[7] = {r.g, r.mean, r.inv, r.a, r.b, r.s, r.bias};
  constexpr int NR = MASK ? 7 : 5;
#pragma unroll
  for (int k = 0; k < NR; ++k)
    for (int i = threadIdx.x; i < n; i += NT_BLOCK)
      sr[k * n + i] = c0 + i < C ? src[k][c0 + i] : 0.f;
}

// dy for channel i of the staged rows (stride n) from a bf16 pair.
template <bool MASK>
__device__ __forceinline__ float dy_at(const float* sr, int n, int i,
                                       float dz, float y) {
  return dy_value<MASK>(dz, y, sr[i], sr[n + i], sr[2 * n + i],
                        sr[3 * n + i], sr[4 * n + i],
                        MASK ? sr[5 * n + i] : 0.f,
                        MASK ? sr[6 * n + i] : 0.f);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

using hop::sm_count;
using hop::swz;

// Ring depth that fits beside `fixed` bytes; 0 when two stages do not.
inline int stages(int stage_bytes, int fixed) {
  const int st = (SMEM_MAX - 1024 - fixed) / stage_bytes;
  return st < 2 ? 0 : (st > MAX_STAGES ? MAX_STAGES : st);
}

// ------------------------------------------------------------------ dx

template <int NB>
struct DxCfg {
  static constexpr int ZY = DX_ROWS * 128;  // dz or y: [128 rows][64 ch]
  static constexpr int WB = NB * 128;       // w: [NB cin][64 ch]
  static constexpr int STAGE = 2 * ZY + WB;
};

template <bool MASK, int NB>
__global__ void __launch_bounds__(NT_BLOCK, 1)
    dx_hopper(const __grid_constant__ CUtensorMap mdz,
              const __grid_constant__ CUtensorMap my,
              const __grid_constant__ CUtensorMap mw, Rows rows,
              bf16* __restrict__ dx, int M, int Cin, int C, int ST) {
  typedef DxCfg<NB> G;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const int KC = (C + KB - 1) / KB;   // ring steps a tile
  const int CP = KC * KB;              // staged channels
  float* sr = reinterpret_cast<float*>(sm + ST * G::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      sm + ST * G::STAGE + (MASK ? 7 : 5) * CP * 4);
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
    for (int r = 0; r < NB; r += 256)  // a box has at most 256 rows
      hop::tma_2d(base + 2 * G::ZY + r * 128, &mw, full + st, kc * KB,
                  n0 + r);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hop::bar_init(full + s, 1);
      hop::bar_init(empty + s, WARPS);
    }
    hop::bar_init_fence();
    for (int it = 0; it < min(ST, n_items); ++it) load(it);
  }
  stage_rows<MASK>(sr, rows, 0, CP, C);
  __syncthreads();

  // Warpgroup wg owns rows 64wg .. 64wg + 63 of the tile; this thread
  // holds rows rl and rl + 8 of them and, in each 16-channel k-step,
  // channels 2t, 2t + 1, 2t + 8, 2t + 9 (the A fragment's layout).
  const int wg = warp / 4, g = lane >> 2, t = lane & 3;
  const int rl = 64 * wg + 16 * (warp % 4) + g;  // rl & 7 == g
  // dy of item it, formed from its dz and y tiles into A fragments.
  auto form = [&](int it, uint32_t (&pa)[KB / 16][4]) {
    const int st = it % ST, kc = it % KC;
    const unsigned char* zt = sm + st * G::STAGE;
    const unsigned char* yt = zt + G::ZY;
    hop::bar_wait(full + st, (it / ST) & 1);
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // columns 2t (h 0) or 2t + 8 (h 1)
        const int ch = kc * KB + 16 * kk + 8 * h + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // rows rl (e 0), rl + 8 (e 1)
          const int off = swz(rl + 8 * e, 2 * kk + h) + 4 * t;
          const float2 z =
              unpack(*reinterpret_cast<const uint32_t*>(zt + off));
          const float2 yv =
              unpack(*reinterpret_cast<const uint32_t*>(yt + off));
          pa[kk][2 * h + e] =
              hop::pack_bf16(dy_at<MASK>(sr, CP, ch, z.x, yv.x),
                             dy_at<MASK>(sr, CP, ch + 1, z.y, yv.y));
        }
      }
  };
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  // Item it: its products on the fragments `cur` (formed one step
  // earlier), and while they run, the next item's fragments into `nxt`.
  auto step = [&](int it, uint32_t (&cur)[KB / 16][4],
                  uint32_t (&nxt)[KB / 16][4]) {
    if (threadIdx.x == 0 && it > 0 && it - 1 + ST < n_items) {
      hop::bar_wait(empty + (it - 1) % ST, ((it - 1) / ST) & 1);
      load(it - 1 + ST);
    }
    const int st = it % ST, kc = it % KC;
    const uint32_t wt = hop::smem_u32(sm + st * G::STAGE + 2 * G::ZY);
    hop::fence_regs(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)  // acc += dy . w^T, K-major w
      hop::Wgmma<NB>::template rs<0>(acc, cur[kk],
                                     hop::desc_k<64, NB>(wt, 0, kk), 1);
    hop::wg_commit();
    if (it + 1 < n_items) form(it + 1, nxt);
    hop::wg_wait<0>();
    hop::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + st);

    if (kc == KC - 1) {  // the tile is done: dx rounds once
      const int job = blockIdx.x + (it / KC) * gridDim.x;
      const int m0 = job / n_ct * DX_ROWS, n0 = job % n_ct * NB;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = m0 + rl + 8 * e;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const int c = n0 + 8 * j + 2 * t;
          if (c < Cin)
            *reinterpret_cast<uint32_t*>(dx + (size_t)r * Cin + c) =
                hop::pack_bf16(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
    }
  };
  uint32_t pa0[KB / 16][4], pa1[KB / 16][4];
  if (n_items > 0) form(0, pa0);
  for (int it = 0; it < n_items; it += 2) {
    step(it, pa0, pa1);
    if (it + 1 < n_items) step(it + 1, pa1, pa0);
  }
}

// ------------------------------------------------------------------ dW

template <int CT, int NT>
struct DwCfg {
  static constexpr int XB = CT * 128;  // x: CT / 64 boxes of [64 m][64 cin]
  static constexpr int ZB = NT * 128;  // dz, then dy; and y
  static constexpr int STAGE = XB + 2 * ZB;
  static constexpr int LDT = NT + 8;   // f32 partial tile row stride
  static constexpr int TILE_BYTES = CT * LDT * 4;
  // A warpgroup's share: MT m64 tiles of cin, every k-step (CT >= 128),
  // or, at CT 64, both warpgroups on the one m64 tile and half of the
  // k-steps each (their partials added in a fixed order at the end).
  static constexpr int MT = CT == 256 ? 2 : 1;
  static constexpr bool SPLIT_K = CT == 64;
};

template <bool MASK, int CT, int NT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT_BLOCK, 1)
    dw_hopper(const __grid_constant__ CUtensorMap mx,
              const __grid_constant__ CUtensorMap mdz,
              const __grid_constant__ CUtensorMap my, Rows rows,
              float* __restrict__ out, int M, int Cin, int C, int chunk,
              int ST) {
  // out is dW, or the workspace when a tile has more than one cluster:
  // cluster k then writes slice k.
  typedef DwCfg<CT, NT> G;
  namespace cg = cooperative_groups;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  float* sr = reinterpret_cast<float*>(sm + ST * G::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      sm + ST * G::STAGE + (MASK ? 7 : 5) * NT * 4);
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
    for (int b = 0; b < CT / 64; ++b)
      hop::tma_2d(base + b * BOX, &mx, full + st, cin0 + 64 * b, m0);
    for (int b = 0; b < NT / 64; ++b) {
      hop::tma_2d(base + G::XB + b * BOX, &mdz, full + st, c0 + 64 * b, m0);
      hop::tma_2d(base + G::XB + G::ZB + b * BOX, &my, full + st,
                  c0 + 64 * b, m0);
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
  stage_rows<MASK>(sr, rows, c0, NT, C);
  __syncthreads();

  // The dy tile of item it, in place of its dz: this thread's pieces are
  // 8 channels (cg8) of rows r0, r0 + R, ...: a fixed channel group, so
  // its per-channel rows are read once, into registers. Rows past M are
  // zero.
  constexpr int GROUPS = NT / 8, R = NT_BLOCK / GROUPS, NR = MASK ? 7 : 5;
  const int cg8 = threadIdx.x % GROUPS, r0 = threadIdx.x / GROUPS;
  float cr[7][8];
#pragma unroll
  for (int k = 0; k < 7; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) cr[k][j] = k < NR ? sr[k * NT + 8 * cg8 + j] : 0.f;
  auto form = [&](int it) {
    unsigned char* zt = sm + (it % ST) * G::STAGE + G::XB;
    const unsigned char* yt = zt + G::ZB;
    const int m0 = m_begin + it * KB;
#pragma unroll
    for (int i = 0; i < KB / R; ++i) {
      const int row = r0 + i * R;
      const int off = (cg8 / 8) * BOX + swz(row, cg8 % 8);
      uint4 z = *reinterpret_cast<const uint4*>(zt + off);
      const uint4 yv = *reinterpret_cast<const uint4*>(yt + off);
      const uint32_t* zp = &z.x;
      const uint32_t* yp = &yv.x;
      uint4 d;
      uint32_t* dp = &d.x;
      float v[8];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float2 zf = unpack(zp[p]), yf = unpack(yp[p]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * p + h;
          v[j] = dy_value<MASK>(h ? zf.y : zf.x, h ? yf.y : yf.x, cr[0][j],
                                cr[1][j], cr[2][j], cr[3][j], cr[4][j],
                                cr[5][j], cr[6][j]);
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
        dp[p] = m0 + row < M ? hop::pack_bf16(v[2 * p], v[2 * p + 1]) : 0u;
      *reinterpret_cast<uint4*>(zt + off) = d;
    }
    hop::fence_proxy_async();
  };

  const int wg = warp / 4;
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
  for (int it = 0; it < n_items; ++it) {
    const int st = it % ST;
    const uint32_t xt = hop::smem_u32(sm + st * G::STAGE);
    const uint32_t dyt = xt + G::XB;
#pragma unroll
    for (int j = 0; j < G::MT; ++j) hop::fence_regs(acc[j]);
    hop::wg_fence();
    // acc += x^T . dy; at CT 64 warpgroup wg takes k-steps 2wg, 2wg + 1
    // (the same count for both, so no branch on wg around a wgmma).
#pragma unroll
    for (int i = 0; i < (G::SPLIT_K ? 2 : KB / 16); ++i) {
      const int kk = G::SPLIT_K ? 2 * wg + i : i;
#pragma unroll
      for (int j = 0; j < G::MT; ++j) {
        const int xb = G::SPLIT_K ? 0 : G::MT * wg + j;  // cin box
        hop::Wgmma<NT>::template ss<1, 1>(
            acc[j], hop::desc_mn<64, KB>(xt + xb * BOX, kk),
            hop::desc_mn<NT, KB>(dyt, kk), 1);
      }
    }
    hop::wg_commit();
    if (it + 1 < n_items) {  // the next dy while these products run
      hop::bar_wait(full + (it + 1) % ST, ((it + 1) / ST) & 1);
      form(it + 1);
    }
    hop::wg_wait<0>();
#pragma unroll
    for (int j = 0; j < G::MT; ++j) hop::fence_regs(acc[j]);
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + st);
    if (threadIdx.x == 0 && it + ST < n_items) {
      hop::bar_wait(empty + st, (it / ST) & 1);
      load(it + ST);
    }
    hop::named_sync(1, NT_BLOCK);
  }

  // The partial tile into shared memory (the ring is free: every load
  // was consumed and every product has completed), [CT][LDT] f32.
  __syncthreads();
  float* tile = reinterpret_cast<float*>(sm);
  const int t = lane & 3, rw = 16 * (warp % 4) + (lane >> 2);
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
          if (add) v = make_float2(__fadd_rn(p->x, v.x), __fadd_rn(p->y, v.y));
          *p = v;
        }
    }
  };
  if (!G::SPLIT_K || wg == 0) put(false);
  if (G::SPLIT_K) {
    __syncthreads();
    if (wg == 1) put(true);  // warpgroup 0's k-steps, then 1's
  }

  // Cluster reduction: block r adds rows [r * CT / 8, (r + 1) * CT / 8)
  // of the 8 partial tiles in the order 0..7 and writes them once.
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int rank = (int)cl.block_rank();
  constexpr int ROWS = CT / CLUSTER, V = NT / 4;
  const size_t slice = gridDim.x > CLUSTER
                           ? (size_t)(blockIdx.x / CLUSTER) * Cin * C
                           : 0;
  const float* part[CLUSTER];
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) part[q] = cl.map_shared_rank(tile, q);
  for (int i = threadIdx.x; i < ROWS * V; i += NT_BLOCK) {
    const int row = rank * ROWS + i / V, col = 4 * (i % V);
    const int off = row * G::LDT + col;
    float4 s = *reinterpret_cast<const float4*>(part[0] + off);
#pragma unroll
    for (int q = 1; q < CLUSTER; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(part[q] + off);
      s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y),
                      __fadd_rn(s.z, v.z), __fadd_rn(s.w, v.w));
    }
    if (cin0 + row < Cin && c0 + col < C)
      *reinterpret_cast<float4*>(out + slice + (size_t)(cin0 + row) * C +
                                 c0 + col) = s;
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

// ------------------------------------------------------------------ launch

template <bool MASK, int NB>
int launch_dx(const CUtensorMap& mdz, const CUtensorMap& my,
              const CUtensorMap& mw, const Rows& rows, bf16* dx, int M,
              int Cin, int C, cudaStream_t st) {
  typedef DxCfg<NB> G;
  const int CP = (C + KB - 1) / KB * KB;
  const int fixed = (MASK ? 7 : 5) * CP * 4 + 2 * MAX_STAGES * 8;
  const int ST = stages(G::STAGE, fixed);
  if (!ST) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + ST * G::STAGE + fixed;
  cudaError_t e = cudaFuncSetAttribute(
      dx_hopper<MASK, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_jobs = (M + DX_ROWS - 1) / DX_ROWS * ((Cin + NB - 1) / NB);
  const int grid = n_jobs < sm_count() ? n_jobs : sm_count();
  dx_hopper<MASK, NB><<<grid, NT_BLOCK, smem, st>>>(mdz, my, mw, rows, dx, M,
                                                    Cin, C, ST);
  return (int)cudaGetLastError();
}

template <bool MASK, int CT, int NT>
int launch_dw(const CUtensorMap& mx, const CUtensorMap& mdz,
              const CUtensorMap& my, const Rows& rows, float* out, int M,
              int Cin, int C, int clusters, int chunk, cudaStream_t st) {
  typedef DwCfg<CT, NT> G;
  const int fixed = (MASK ? 7 : 5) * NT * 4 + 2 * MAX_STAGES * 8;
  int ST = stages(G::STAGE, fixed);
  if (ST && ST * G::STAGE < G::TILE_BYTES)
    ST = (G::TILE_BYTES + G::STAGE - 1) / G::STAGE;  // room for the tile
  if (!ST || 1024 + ST * G::STAGE + fixed > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int smem = 1024 + ST * G::STAGE + fixed;
  cudaError_t e = cudaFuncSetAttribute(
      dw_hopper<MASK, CT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(CLUSTER * clusters, ((Cin + CT - 1) / CT) * ((C + NT - 1) / NT));
  dw_hopper<MASK, CT, NT><<<grid, NT_BLOCK, smem, st>>>(
      mx, mdz, my, rows, out, M, Cin, C, chunk, ST);
  return (int)cudaGetLastError();
}

// dx = dy . w^T and dW = x^T . dy on the Hopper kernels. nb, ct, nt are
// the tile widths `hopper_tiles` chose; the dW split is `clusters`
// clusters of CLUSTER blocks of `chunk` rows (a multiple of 64). With
// one cluster a tile, dW is written directly; else each cluster writes
// its sum to ws[cluster] and colsum adds them in order.
template <bool MASK>
int launch_bwd_hopper(const bf16* dz, const bf16* y, const bf16* x,
                      const bf16* w, const Rows& rows, bf16* dx, float* ws,
                      float* dw, int M, int Cin, int C, int nb, int ct,
                      int nt, int clusters, int chunk, cudaStream_t st) {
  CUtensorMap mdz_r, my_r, mw, mx, mdz, my;
  if (!hop::map_2d(&mdz_r, dz, M, C, DX_ROWS) ||
      !hop::map_2d(&my_r, y, M, C, DX_ROWS) ||
      !hop::map_2d(&mw, w, Cin, C, nb > 256 ? 256 : nb) ||
      !hop::map_2d(&mx, x, M, Cin, KB) || !hop::map_2d(&mdz, dz, M, C, KB) ||
      !hop::map_2d(&my, y, M, C, KB))
    return (int)cudaErrorInvalidValue;
  int e;
  if (nb == 64)
    e = launch_dx<MASK, 64>(mdz_r, my_r, mw, rows, dx, M, Cin, C, st);
  else if (nb == 128)
    e = launch_dx<MASK, 128>(mdz_r, my_r, mw, rows, dx, M, Cin, C, st);
  else if (nb == 256)
    e = launch_dx<MASK, 256>(mdz_r, my_r, mw, rows, dx, M, Cin, C, st);
  else
    return (int)cudaErrorInvalidValue;
  if (e) return e;
  float* out = clusters > 1 ? ws : dw;
#define HVD_DW(CT_, NT_)                                                  \
  if (ct == CT_ && nt == NT_)                                             \
    e = launch_dw<MASK, CT_, NT_>(mx, mdz, my, rows, out, M, Cin, C,      \
                                  clusters, chunk, st);                   \
  else
  HVD_DW(64, 64) HVD_DW(64, 128) HVD_DW(128, 64) HVD_DW(128, 128)
  HVD_DW(256, 64) HVD_DW(256, 128) return (int)cudaErrorInvalidValue;
#undef HVD_DW
  if (e) return e;
  if (clusters > 1) {
    colsum(ws, dw, clusters, Cin * C, st);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace cbh
}  // namespace hvd
