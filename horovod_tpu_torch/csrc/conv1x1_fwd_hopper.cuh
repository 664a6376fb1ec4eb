// The Hopper design of kernel 1, the 1x1-conv forward with the BatchNorm
// stat sums (bf16, sm_90a): y = x . w stored in bf16, and the per-channel
// f32 sum and sum of squares of the STORED (rounded) y over the real M
// rows. f32 and the shapes that `fwd_instance` (ops/conv_block.py) sends
// elsewhere keep the simple mma.sync fwd_kernel of conv1x1_fwd.cu.
//
// What the H100 bounds, and what each part of the design does about it:
//
// * Bytes, at every ResNet-50 site but the Cin-1024 ones: a site does
//   Cin * C / (Cin + C) multiply-adds per element moved (32 to 341), near
//   or below the ~295 operations a byte at which the bf16 tensor cores
//   become the limit, and y is the largest array at the M 100352 sites.
//   So x and w are read and y written once, and the HBM is kept busy: a
//   persistent grid (one block an SM) walks its jobs, 128-row x BN-column
//   tiles of y (the column tiles of one row tile next to each other in
//   launch order, so that x comes from L2 when C > 256), and thread 0
//   keeps the TMA loads of 64-channel steps of x ([128 rows][64 cin]) and
//   w ([64 cin][BN c]) ST stages ahead in a ring that runs across job
//   boundaries: the next job's operands arrive during this job's
//   epilogue.
// * wgmma on every product: two warpgroups, each owning 64 rows x BN
//   columns (BN 64, 128 or 256: the smallest that holds C up to 256,
//   narrower where that leaves fewer jobs than SMs, `fwd_tile`), f32
//   accumulators in registers (BN / 2 a thread), both operands in shared
//   memory. w is read straight from its [Cin][C] layout as an MN-major B
//   operand (the descriptor's transpose bit), so no transposed copy of w
//   is made.
// * The epilogue writes y once, in 16-KB TMA stores: the accumulator is
//   rounded to bf16 into a staging tile in shared memory (128-byte
//   swizzle, conflict-free 4-byte stores), which thread 0 hands to one
//   asynchronous TMA store a 64-column box (clipped at M and C) while the
//   block goes on. The stat sums read the same staged, rounded values:
//   each thread sums one column pair over a slice of the rows with
//   __fadd_rn / __fmul_rn, the slices are added in order, and the job's
//   partial (sum, sumsq) row goes to a workspace [row tile][2][C]; one
//   fixed-order column-sum launch (`colsum_split`) adds the row tiles for
//   both rows at once. No float atomics: y and the sums repeat bit for
//   bit. TMA zero-fills rows past M and channels past Cin or C, which add
//   zero to both sums, as the JAX wrapper's zero padding does.
// * Registers: 256 threads a block and no producer warpgroup (thread 0
//   issues the loads between its own products), so ptxas may give each
//   thread 255 registers; the accumulator is 128 of them at BN 256.
#pragma once

#include "conv1x1_gemm.cuh"
#include "wgmma.cuh"

namespace hvd {
namespace cfh {

constexpr int NT_BLOCK = 256;  // threads: two warpgroups
constexpr int WARPS = NT_BLOCK / 32;
constexpr int BM = 128;        // rows of a job
constexpr int KB = 64;         // input channels a ring step
constexpr int BOX = 64 * 128;  // bytes of a [64 rows][64 bf16] TMA box
constexpr int SMEM_MAX = 232448;
constexpr int MAX_STAGES = 4;

template <int BN>
struct FwdCfg {
  static constexpr int XB = BM * 128;          // x: [128 rows][64 cin]
  static constexpr int STAGE = XB + (BN / 64) * BOX;  // + w: [64 cin][BN]
  static constexpr int YBOX = BM * 128;        // staged y: [128 rows][64 c]
  static constexpr int YB = (BN / 64) * YBOX;
  static constexpr int PAIRS = BN / 2;         // column pairs of a job
  static constexpr int SLICES = NT_BLOCK / PAIRS;  // row slices of the sums
  static constexpr int SLICE_ROWS = BM / SLICES;
  static constexpr int RED = SLICES * 2 * BN * 4;  // [slice][sum, sq][BN]
};

template <int BN>
__global__ void __launch_bounds__(NT_BLOCK, 1)
    fwd_hopper(const __grid_constant__ CUtensorMap mx,
               const __grid_constant__ CUtensorMap mw,
               const __grid_constant__ CUtensorMap my,
               float* __restrict__ ws, int M, int Cin, int C, int ST) {
  typedef FwdCfg<BN> G;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ys = sm + ST * G::STAGE;  // the staged y tile
  float* red = reinterpret_cast<float*>(ys + G::YB);
  uint64_t* full = reinterpret_cast<uint64_t*>(ys + G::YB + G::RED);
  uint64_t* empty = full + ST;
  const int KC = (Cin + KB - 1) / KB;  // ring steps a job
  const int n_ct = (C + BN - 1) / BN;
  const int n_jobs = (M + BM - 1) / BM * n_ct;
  const int my_jobs =
      blockIdx.x < n_jobs ? (n_jobs - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_items = my_jobs * KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Item it: ring step it % KC of the block's job it / KC (row tile
  // major, column tile minor).
  auto load = [&](int it) {
    const int st = it % ST, job = blockIdx.x + (it / KC) * gridDim.x;
    const int k0 = (it % KC) * KB;
    const int m0 = job / n_ct * BM, n0 = job % n_ct * BN;
    unsigned char* base = sm + st * G::STAGE;
    hop::bar_expect(full + st, G::STAGE);
    hop::tma_2d(base, &mx, full + st, k0, m0);
    for (int b = 0; b < BN / 64; ++b)
      hop::tma_2d(base + G::XB + b * BOX, &mw, full + st, n0 + 64 * b, k0);
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

  // Warpgroup wg owns rows 64wg .. 64wg + 63 of a job; this thread holds
  // rows rl and rl + 8 of them, columns 8j + 2t and 8j + 2t + 1.
  const int wg = warp / 4, t = lane & 3;
  const int rl = 64 * wg + 16 * (warp % 4) + (lane >> 2);
  // In the sums, this thread takes columns 2pr, 2pr + 1 of rows
  // [sl * SLICE_ROWS, (sl + 1) * SLICE_ROWS).
  const int pr = threadIdx.x % G::PAIRS, sl = threadIdx.x / G::PAIRS;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_items; ++it) {
    // Thread 0 refills the stage of item it - 1, once every warp is done
    // with it, with item it - 1 + ST.
    if (threadIdx.x == 0 && it > 0 && it - 1 + ST < n_items) {
      hop::bar_wait(empty + (it - 1) % ST, ((it - 1) / ST) & 1);
      load(it - 1 + ST);
    }
    const int st = it % ST, kc = it % KC;
    const uint32_t xt = hop::smem_u32(sm + st * G::STAGE);
    const uint32_t wt = xt + G::XB;
    hop::bar_wait(full + st, (it / ST) & 1);
    hop::fence_regs(acc);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)  // acc (=)+= x . w, w MN-major
      hop::Wgmma<BN>::template ss<0, 1>(
          acc, hop::desc_k<64, BM>(xt, 64 * wg, kk),
          hop::desc_mn<BN, KB>(wt, kk), kc > 0 || kk > 0);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + st);
    if (kc < KC - 1) continue;

    // The job is done: y rounds once, into the staging tile, once the
    // previous job's store has read it.
    const int job = blockIdx.x + (it / KC) * gridDim.x;
    const int m0 = job / n_ct * BM, n0 = job % n_ct * BN;
    if (threadIdx.x == 0) hop::bulk_wait_read<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<uint32_t*>(ys + (j / 8) * G::YBOX +
                                     hop::swz(rl + 8 * e, j % 8) + 4 * t) =
            hop::pack_bf16(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    hop::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int b = 0; b < BN / 64; ++b)
        hop::tma_store_2d(&my, ys + b * G::YBOX, n0 + 64 * b, m0);
      hop::bulk_commit();
    }

    // The stat sums of the staged values, while the store runs: a warp
    // reads one 128-byte row of a box at a time (no bank conflicts).
    const unsigned char* col = ys + (pr / 32) * G::YBOX + 4 * (pr % 4);
    const int chunk = (pr % 32) / 4;
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
    for (int r = sl * G::SLICE_ROWS; r < (sl + 1) * G::SLICE_ROWS; ++r) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(col + hop::swz(r, chunk)));
      s0 = __fadd_rn(s0, v.x);
      s1 = __fadd_rn(s1, v.y);
      q0 = __fadd_rn(q0, __fmul_rn(v.x, v.x));
      q1 = __fadd_rn(q1, __fmul_rn(v.y, v.y));
    }
    float* rs = red + sl * 2 * BN;
    rs[2 * pr] = s0;
    rs[2 * pr + 1] = s1;
    rs[BN + 2 * pr] = q0;
    rs[BN + 2 * pr + 1] = q1;
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * BN; i += NT_BLOCK) {
      const int which = i / BN, c = i % BN;  // which: 0 sum, 1 sumsq
      if (n0 + c >= C) continue;
      float s = red[which * BN + c];
      for (int q = 1; q < G::SLICES; ++q)
        s = __fadd_rn(s, red[(2 * q + which) * BN + c]);
      ws[((size_t)(m0 / BM) * 2 + which) * C + n0 + c] = s;
    }
  }
  if (threadIdx.x == 0) hop::bulk_wait<0>();  // y is written
}

// out[i] = sum over b < nb of ws[b * n + i], in a fixed order, for every
// i < n in one launch: warp w of a block sums rows w, w + 32, ... in
// turn, then warp 0 adds the 32 warps' partials in the order of w.
// Stores, never accumulates into, `out`.
__global__ void __launch_bounds__(1024)
    colsum_split(const float* __restrict__ ws, float* __restrict__ out,
                 int nb, int n) {
  __shared__ float part[32][33];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < n)
    for (int b = w; b < nb; b += 32) s = __fadd_rn(s, ws[(size_t)b * n + i]);
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && i < n) {
    float total = part[0][lane];
#pragma unroll
    for (int q = 1; q < 32; ++q) total = __fadd_rn(total, part[q][lane]);
    out[i] = total;
  }
}

// y = x . w and stats = (sum, sumsq) of the stored y, [2][C]. ws holds
// ceil(M / 128) * 2 * C floats.
template <int BN>
int launch_fwd_hopper(const bf16* x, const bf16* w, bf16* y, float* ws,
                      float* stats, int M, int Cin, int C, cudaStream_t st) {
  typedef FwdCfg<BN> G;
  CUtensorMap mx, mw, my;
  if (!hop::map_2d(&mx, x, M, Cin, BM) || !hop::map_2d(&mw, w, Cin, C, KB) ||
      !hop::map_2d(&my, y, M, C, BM))
    return (int)cudaErrorInvalidValue;
  const int fixed = G::YB + G::RED + 2 * MAX_STAGES * 8;
  int ST = (SMEM_MAX - 1024 - fixed) / G::STAGE;
  if (ST > MAX_STAGES) ST = MAX_STAGES;
  if (ST < 2) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + ST * G::STAGE + fixed;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_hopper<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int nmb = (M + BM - 1) / BM;
  const int n_jobs = nmb * ((C + BN - 1) / BN);
  const int grid = n_jobs < hop::sm_count() ? n_jobs : hop::sm_count();
  fwd_hopper<BN><<<grid, NT_BLOCK, smem, st>>>(mx, mw, my, ws, M, Cin, C,
                                               ST);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  colsum_split<<<(2 * C + 31) / 32, 1024, 0, st>>>(ws, stats, nmb, 2 * C);
  return (int)cudaGetLastError();
}

}  // namespace cfh
}  // namespace hvd
