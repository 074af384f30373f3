// Dataflow-configurable fp32 GEMM  C = A @ B  for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/tt_gemm.py (the
// pallas_call in tt_gemm(), :178): _os_kernel (:39, K2), _ws_kernel (:56,
// K3) and _is_kernel (:78, K4).  The plan's dataflow picks what stays
// resident while the rest streams; the host picks each grid for the card
// (kernels/tt_gemm.py: os_grid, ws_grid, is_grid) and the kernels walk a
// block's work the way the grid's block_work / block_steps do:
//
//   OS  (m-tile x n-tile) blocks.  Each block's output tile stays in
//       registers (up to 4 rows x 4 columns a thread) while the k-block
//       tiles of A and B stream past it; the k-fold runs in registers and
//       every output is stored once.
//   WS  (n-band x m-range x k-group) blocks.  In each block the k-blocks
//       of its group loop outside; each k-block's (block_k x block_n) B
//       tile is staged once and stays resident while the block streams the
//       A tiles of its m-range.  When K is split over k-groups every
//       partial p_kb goes to a workspace and a second, small kernel folds
//       them into C; otherwise partial C folds in registers (one m-tile in
//       the range) or round-trips through C once per k-fold.
//   IS  (m-band x n-group) blocks.  Each block stages its band of A once,
//       across all of K where it fits shared memory, and keeps it resident
//       while the B tiles of its group of n-tiles stream past it; each
//       n-tile's k-fold runs in registers and is stored once.  Where the
//       band does not fit, A stages one k-block at a time (k-blocks
//       outside, n-tiles inside, as the reference's grid runs) and, when
//       the group has more than one n-tile, the partials round-trip
//       through C, the reference's o_ref = o_ref + part.
//
// At every decode shape of the plans IS runs OS's schedule under its own
// name.  Those calls give fewer tiles than SMs, so is_grid gives each
// block one n-tile (more blocks fill the card better than a band reused
// across n-tiles), and the tiles fit shared memory whole, so both stage
// the block's rows of A across all of K once, with its B rows, in one
// pass.  The band reuse IS names, and the fold through C, take effect
// only past that: more tiles than SMs, or K too deep for one pass.
//
// Why IS keeps A and not C.  On the TPU the grid runs in order on one
// core, so IS revisits its output block across the k axis and carries the
// sum in it.  A GPU block owns its outputs and folds them in registers, so
// C needs no revisit wherever a block's outputs fit its register tile.
// What IS names is the input band: read from device memory once per block
// while the weight tiles stream past it.  A kernel that kept C resident
// and streamed A and B would be OS.
//
// Numerics.  Every dataflow computes, for each output element, the same
// sequence (the tile loop of gemm_tile.cuh, shared with fused_path.cu):
// p_kb = sum over the k-block in ascending k (fp32 FMA from 0), then C =
// p_0, C = C + p_1, ... in ascending k-block order.  That is the
// reference's contract (acc += dot(block) in OS; o = o + part in WS/IS),
// so the three dataflows agree bit for bit at one block_k, and an output
// element never depends on M, N, block_m or block_n, on a grid, or on the
// other rows of the launch (the serve engine's continuous == oneshot
// contract).  The WS split over K keeps it: the workspace holds each p_kb
// separately (no per-group sums, no atomics, no tree) and the fold adds
// them in ascending kb order.  Ragged edges are masked (zero-filled tiles,
// stores skipped) instead of padding the operands in device memory.  No
// TF32: the model is fp32 and parity is held at 1e-5.
//
// What bounds it on this card.  The TT path GEMMs are small and thin (one
// dim is often 4-16), so the work is bound by memory traffic and by launch
// and latency cost, not by the 67 TFLOP/s fp32 FMA rate.  At the decode
// shapes (OS 64,128,16: 45 KB and 0.26 MFLOP, 0.013 us for its bytes) the
// floor is one launch, one round trip to memory and one short FMA chain.
// The first OS and IS kernels were 4-6x off one torch.matmul there: one
// block for the whole call, staging by dependent scalar loads (~40 a
// thread at 64,128,16), one 128-deep FMA chain at a time per thread, IS
// folding every partial through C, and a cudaFuncSetAttribute per launch.
// WS was slow for the same reason at the train plans' weight gradients
// (M,K,N = 2048,2048,16: 0.0051 ms for its bytes): one block per n-band.
//
// What the design does about it.  A decode GEMM's block has one busy
// warp, so every latency it waits on shows in full: runtime integer
// divisions, constant loads, and a shared-memory load waited on at every
// k step (PERF.md has the timings that led here).
//   * Grids that fill the card: the host cuts the output tile (OS, IS)
//     or the m-tile and K (WS) until the call gives about one block per SM
//     (two for WS), down to 4 rows a tile, and for OS and IS then halves
//     the n-tile (down to 8 columns) while a block would stage more than
//     2 KB of B; 64,128,16 runs as 32 blocks of 4 x 8.  OS and IS take a
//     2-D grid (m-band, n-group) and the host passes the counts, so a
//     block divides nothing but its thread index.
//   * Staging with cp.async: 16-byte copies where rows are aligned,
//     4-byte zero-filling copies at ragged edges, each thread walking one
//     column of copy units down the rows.  Where every tile of a block
//     fits shared memory (BandGrid.one_pass: all the plans' decode
//     shapes), the band of A and each n-tile's B rows across all of K go
//     out in one pass before one wait.  Otherwise the tiles stream through
//     a two-stage ring: tile t + 1's copies are issued before tile t's
//     FMAs (cp.async.commit_group / wait_group 1).
//   * Register tiles: up to 4 rows x 4 columns a thread, the rows a
//     template argument (OS, IS, WS), so no branch sits in the loop.
//     Every kernel runs gemm_tile::kblocks_fold: A read as a float4 per
//     row and 4 k steps, the next 4 steps' operands loaded before this
//     step's FMAs (ptxas does not hoist them), one loop across all of a
//     pass's K folding at each k-block edge.  A k-block stages rounded up
//     to a multiple of 4 k, zero-filled.  Staged rows are padded to a
//     multiple of 4 plus 4 floats, so the rows one warp reads at one k
//     fall into distinct banks.
//   * At least 4 warps a block (more where the tile needs them), and the
//     dynamic-shared-memory attribute raised once per kernel, device and
//     size, not on every launch.
// No mma (fp32 has no tensor-core mode), no TMA or clusters: at these
// shapes latency and round trips, not bytes or FMAs, are the limit.

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

#include "gemm_tile.cuh"

namespace {

constexpr int kThreads = 256;
// the fewest threads an OS or IS block launches with
constexpr int kMinThreads = 128;

using gemm_tile::cp_async;
using gemm_tile::cp_async_commit;
using gemm_tile::cp_async_wait_all;
using gemm_tile::cp_async_wait_prior;
using gemm_tile::kfold;
using gemm_tile::kpad;
using gemm_tile::kTileRows;

// Row stride of a staged A tile `cols` wide: cols rounded up to 4, plus 4,
// so rows stay 16-byte aligned for cp.async and the rows that one warp
// reads at one k fall into distinct banks.
__host__ __device__ __forceinline__ int pad_ld(int cols) {
  return kpad(cols) + 4;
}

// Raises a kernel's dynamic-shared-memory cap on the current device the
// first time a launch needs more than the cap already set, so a launch
// at or under it makes no call.  Below 48 KB no attribute is needed.
class SmemCap {
 public:
  template <class Kernel>
  cudaError_t allow(Kernel* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const bool cached = dev >= 0 && dev < kDevices;
    if (cached && cap_[dev].load() >= bytes) return cudaSuccess;
    std::lock_guard<std::mutex> lock(mu_);
    if (cached && cap_[dev].load() >= bytes) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && cached) cap_[dev].store(bytes);
    return err;
  }

 private:
  static constexpr int kDevices = 16;
  std::mutex mu_;
  std::atomic<size_t> cap_[kDevices]{};
};

// How one thread walks a (rows x units) copy: units u0, u0 + ustep, ...
// of rows r0, r0 + rstep, ...  Where a row has at most blockDim.x units,
// each thread keeps one unit column and strides the rows; otherwise the
// block strides each row.  The divisions happen once per launch.
struct Walk {
  int u0, ustep, r0, rstep;
};

__device__ __forceinline__ Walk walk_of(int units) {
  const int n = blockDim.x, t = threadIdx.x;
  if (units > n) return Walk{t, n, 0, 1};
  const int q = t / units;
  // threads past the last whole row group get no rows
  return Walk{t - q * units, units, q < n / units ? q : 1 << 30, n / units};
}

// Stage a (rows x units) tile, `Bytes` (4 or 16) a unit: unit (r, u) goes
// to dst + r * ld_dst + u * Bytes / 4 from src + r * ld_src + u * Bytes / 4
// when r < rmax and u * Bytes / 4 < cmax, else it is zero-filled.
template <int Bytes>
__device__ __forceinline__ void stage_tile(float* dst, int ld_dst,
                                           const float* src, long long ld_src,
                                           int rows, int units, int rmax,
                                           int cmax, const Walk& w) {
  constexpr int f = Bytes / 4;
  for (int r = w.r0; r < rows; r += w.rstep)
    for (int u = w.u0; u < units; u += w.ustep) {
      const bool v = r < rmax && u * f < cmax;
      cp_async<Bytes>(dst + r * ld_dst + u * f, v ? src + r * ld_src + u * f : src,
                      v);
    }
}

// One OS or IS launch over the grid kernels/tt_gemm.py::os_grid / is_grid
// chose.  Block (blockIdx.x, blockIdx.y) owns the band of TR * ty_n rows
// blockIdx.x and the group of up to nt_group n-tiles of tn columns
// blockIdx.y.
struct BandArgs {
  const float* A;
  const float* B;
  float* C;
  int M, K, N;
  int bk;        // block_k: fixes the bits
  int tn;        // columns of one n-tile
  int ty_n;      // row groups; the register tile's rows (TR) are the
                 // kernel's template argument, strided by ty_n
  int nt_group;  // n-tiles per block (OS: 1)
  int a_whole;   // the band of A across all of K is staged once (IS)
  int n_kb;      // k-blocks of K
  int n_nt;      // n-tiles of N
  int vec_a, vec_b, vec_c;  // 16-byte copies of A, of B; float4 stores
};

// OnePass (the host's BandGrid.one_pass: every tile of the block fits and
// each n-tile folds in registers, as at every decode shape of the plans):
// the band of A and each n-tile's B rows across all of K stage in one pass
// before one wait, and gemm_tile::kblocks_fold runs each n-tile's whole K
// as one loop.  Otherwise the block's tiles t = 0 .. T-1, each one n-tile
// j and one k-block kb, stream through a two-stage ring (B tile t in slot
// t % 2, issued before tile t - 1's FMAs).  With the A band whole, or one
// n-tile, they run n-tile by n-tile (kb inside) and each n-tile's k-fold
// stays in registers; otherwise k-block by k-block (n-tiles inside), the
// k-block's slice of A staged with its first tile into slot kb % 2 and
// kept while the B tiles of the group stream past it, and the partials
// fold through C.  A staged k-block is kpad(bk) deep, zero past bk.  TR
// (the register tile's rows) is a template argument, so the tile loops
// have no branch between their loads and FMAs; tiles are walked by
// counters, with no division in the loop.  A block of one busy warp, as
// the decode shapes give, otherwise pays every runtime division and every
// load's latency in full.
template <int TR, bool OnePass>
__device__ __forceinline__ void band_gemm(const BandArgs& p) {
  extern __shared__ __align__(16) float band_smem[];
  const int n_tx = (p.tn + 3) / 4;
  const int ldb = 4 * n_tx;
  const int tm = TR * p.ty_n;
  const int n_kb = p.n_kb;
  const int bkp = kpad(p.bk);
  const int m0 = blockIdx.x * tm;
  const int j0 = blockIdx.y * p.nt_group;
  const int n_j = min(p.nt_group, p.n_nt - j0);
  const bool reg_fold = p.a_whole || n_j == 1;
  // the band across all of K (bk a multiple of 4 here), or two slices
  const bool band = p.a_whole || OnePass;
  const int lda = band ? pad_ld(n_kb * p.bk) : pad_ld(p.bk);
  float* As = band_smem;
  float* Bs = band_smem + (band ? 1 : 2) * tm * lda;
  const int a_units = p.vec_a ? (band ? n_kb * p.bk : bkp) / 4
                              : (band ? n_kb * p.bk : bkp);
  const int b_units = p.vec_b ? ldb / 4 : ldb;
  const Walk wa = walk_of(a_units), wb = walk_of(b_units);
  const int tx = threadIdx.x % n_tx, ty = threadIdx.x / n_tx;
  const bool active = ty < p.ty_n;

  auto store = [&](int i, int j, const float (&v)[4]) {
    const int m = m0 + ty + i * p.ty_n;
    const int c0 = 4 * tx, n0 = (j0 + j) * p.tn + c0;
    if (m >= p.M) return;
    float* crow = p.C + (long long)m * p.N;
    if (p.vec_c && c0 + 3 < p.tn && n0 + 3 < p.N) {
      *reinterpret_cast<float4*>(crow + n0) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + q < p.tn && n0 + q < p.N) crow[n0 + q] = v[q];
    }
  };
  // A rows [m0, m0 + tm) x K columns [k0, k0 + cols) into dst, zero past
  // k0 + kmax (and past M, K)
  auto stage_a = [&](float* dst, int k0, int kmax) {
    const float* src = p.A + (long long)m0 * p.K + k0;
    const int cmax = min(kmax, p.K - k0);
    if (p.vec_a)
      stage_tile<16>(dst, lda, src, p.K, tm, a_units, p.M - m0, cmax, wa);
    else
      stage_tile<4>(dst, lda, src, p.K, tm, a_units, p.M - m0, cmax, wa);
  };
  // B rows [k0, k0 + rows) of n-tile j into dst, zero past k0 + kmax
  auto stage_b = [&](float* dst, int j, int k0, int rows, int kmax) {
    const int n0 = (j0 + j) * p.tn;
    const float* src = p.B + (long long)k0 * p.N + n0;
    const int rmax = min(kmax, p.K - k0), cmax = min(p.tn, p.N - n0);
    if (p.vec_b)
      stage_tile<16>(dst, ldb, src, p.N, rows, b_units, rmax, cmax, wb);
    else
      stage_tile<4>(dst, ldb, src, p.N, rows, b_units, rmax, cmax, wb);
  };
  float tot[kTileRows][4];
  if (band) stage_a(As, 0, p.K);  // joins the first group
  if constexpr (OnePass) {
    const int rows = n_kb * p.bk;
    for (int j = 0; j < n_j; ++j)
      stage_b(Bs + j * rows * ldb, j, 0, rows, p.K);
    cp_async_wait_all();
    __syncthreads();
    if (!active) return;
    for (int j = 0; j < n_j; ++j) {
      gemm_tile::kblocks_fold<TR>(As, lda, ty, p.ty_n, Bs + j * rows * ldb,
                                  ldb, 4 * tx, p.bk, n_kb, 0, tot);
#pragma unroll
      for (int i = 0; i < TR; ++i) store(i, j, tot[i]);
    }
    return;
  }
  // the next tile to stage and the tile to compute: n-tile j, k-block kb
  struct Cursor {
    int j = 0, kb = 0;
  };
  auto advance = [&](Cursor& c) {
    if (reg_fold) {
      if (++c.kb == n_kb) c.kb = 0, ++c.j;
    } else if (++c.j == n_j) {
      c.j = 0, ++c.kb;
    }
  };
  auto stage = [&](const Cursor& c, int slot) {
    const int k0 = c.kb * p.bk;
    if (!band && (reg_fold || c.j == 0))  // a new k-block's slice of A
      stage_a(As + (c.kb & 1) * tm * lda, k0, p.bk);
    stage_b(Bs + slot * bkp * ldb, c.j, k0, bkp, p.bk);
  };
  const int T = n_j * n_kb;
  Cursor st, ct;
  stage(st, 0);
  advance(st);
  cp_async_commit();
  float s[kTileRows][4];
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      stage(st, (t + 1) & 1);
      advance(st);
    }
    cp_async_commit();
    cp_async_wait_prior();  // tile t's group has landed
    __syncthreads();
    if (active) {
      const int kb = ct.kb;
      const float* a = band ? As + kb * p.bk : As + (kb & 1) * tm * lda;
      const float* b = Bs + (t & 1) * bkp * ldb;
      if (reg_fold) {
        gemm_tile::kblocks_fold<TR>(a, lda, ty, p.ty_n, b, ldb, 4 * tx, bkp, 1,
                                    kb, tot);
        if (kb == n_kb - 1) {
#pragma unroll
          for (int i = 0; i < TR; ++i) store(i, ct.j, tot[i]);
        }
      } else {
        gemm_tile::kblocks_fold<TR>(a, lda, ty, p.ty_n, b, ldb, 4 * tx, bkp, 1,
                                    0, s);
        const int c0 = 4 * tx, n0 = (j0 + ct.j) * p.tn + c0;
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int m = m0 + ty + i * p.ty_n;
          if (m >= p.M) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c0 + q < p.tn && n0 + q < p.N)
              kfold(p.C + (long long)m * p.N + n0 + q, s[i][q], kb);
        }
      }
    }
    advance(ct);
    __syncthreads();  // slot t % 2 is free for tile t + 2
  }
}

template <int TR, bool OnePass>
__global__ void __launch_bounds__(kThreads) os_kernel(const BandArgs p) {
  band_gemm<TR, OnePass>(p);
}

template <int TR, bool OnePass>
__global__ void __launch_bounds__(kThreads) is_kernel(const BandArgs p) {
  band_gemm<TR, OnePass>(p);
}

// WS: block (n-band, m-range, k-group), decoded as the host's
// kernels/tt_gemm.py::WSGrid.block_work does.  For each k-block of its
// group the block stages the (bk x bn) B tile once and keeps it resident
// while it streams the A tiles of its m-range past it.  Each thread holds
// a register tile of TR rows (strided by `ty_n`) x 4 columns; every
// output is its own ascending fmaf chain per k-block (kblocks_fold over
// the k-block, kpad(bk) deep and zero past bk).  The partial p_kb then
// goes
//   * to the workspace W[kb][m][n] when K is split over k-groups (the
//     fold kernel below sums them into C in ascending kb order);
//   * else to a register fold when the range is one m-tile;
//   * else to C, read-add-written once per k-fold (the reference's WS).
//
// Batched (the experts' weight gradients): blockIdx.y is the batch index,
// and each batch item reads and writes its own A, B, C and W at the
// strides of one (M, K, N) problem, over the grid an unbatched launch
// takes, so its outputs are that launch's bits.
template <int TR>
__global__ void __launch_bounds__(kThreads)
ws_kernel(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ C, float* __restrict__ W, int M, int K, int N,
          int bk, int bn, int ty_n, int mt_per_range, int kg, int vec) {
  extern __shared__ __align__(16) float ws_smem[];
  {
    const long long e = blockIdx.y;
    const int n_kb_all = (K + bk - 1) / bk;
    A += e * M * K;
    B += e * K * N;
    C += e * M * N;
    if (W != nullptr) W += e * n_kb_all * M * N;
  }
  const int n_tx = (bn + 3) / 4;
  const int ldb = 4 * n_tx;
  const int bkp = kpad(bk);
  const int lda = pad_ld(bk);
  const int tm = TR * ty_n;
  float* Bs = ws_smem;              // resident weight tile, bkp x ldb
  float* As = ws_smem + bkp * ldb;  // streamed input tile, tm x lda
  const int n_kb = (K + bk - 1) / bk;
  const int n_nb = (N + bn - 1) / bn;
  const int n_mt = (M + tm - 1) / tm;
  const int n_mr = (n_mt + mt_per_range - 1) / mt_per_range;
  const int nb = blockIdx.x % n_nb;
  const int mr = (blockIdx.x / n_nb) % n_mr;
  const int kgi = blockIdx.x / (n_nb * n_mr);
  const int n0 = nb * bn;
  const int kb0 = kgi * kg, kb1 = min(kb0 + kg, n_kb);
  const int mt0 = mr * mt_per_range, mt1 = min(mt0 + mt_per_range, n_mt);
  const bool split = kg < n_kb;
  const bool reg_fold = !split && mt1 - mt0 == 1;
  const int tx = threadIdx.x % n_tx, ty = threadIdx.x / n_tx;
  const bool active = ty < ty_n;
  float tot[kTileRows][4];
  float s[kTileRows][4];
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * bk;
    __syncthreads();  // the previous k-block is done with Bs and As
    for (int idx = threadIdx.x; idx < bkp * ldb; idx += blockDim.x) {
      const int k = idx / ldb, c = idx - k * ldb;
      const bool ok = k < bk && k0 + k < K && c < bn && n0 + c < N;
      cp_async<4>(Bs + idx, ok ? B + (long long)(k0 + k) * N + n0 + c : B, ok);
    }
    for (int mt = mt0; mt < mt1; ++mt) {
      const int m0 = mt * tm;
      if (mt > mt0) __syncthreads();  // the previous m-tile is done with As
      if (vec) {
        const int q = bk / 4;
        for (int idx = threadIdx.x; idx < tm * q; idx += blockDim.x) {
          const int r = idx / q, c = 4 * (idx - r * q);
          const bool ok = m0 + r < M && k0 + c < K;
          cp_async<16>(As + r * lda + c,
                       ok ? A + (long long)(m0 + r) * K + k0 + c : A, ok);
        }
      } else {
        for (int idx = threadIdx.x; idx < tm * bkp; idx += blockDim.x) {
          const int r = idx / bkp, c = idx - r * bkp;
          const bool ok = c < bk && m0 + r < M && k0 + c < K;
          cp_async<4>(As + r * lda + c,
                      ok ? A + (long long)(m0 + r) * K + k0 + c : A, ok);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (!active) continue;
      gemm_tile::kblocks_fold<TR>(As, lda, ty, ty_n, Bs, ldb, 4 * tx, bkp, 1,
                                  0, s);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int m = m0 + ty + i * ty_n;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * tx + j, n = n0 + c;
          if (m >= M || c >= bn || n >= N) continue;
          if (split)
            W[((long long)kb * M + m) * N + n] = s[i][j];
          else if (reg_fold)
            kfold(&tot[i][j], s[i][j], kb);
          else
            kfold(C + (long long)m * N + n, s[i][j], kb);
        }
      }
    }
  }
  if (!reg_fold || !active) return;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int m = mt0 * tm + ty + i * ty_n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tx + j, n = n0 + c;
      if (m < M && c < bn && n < N) C[(long long)m * N + n] = tot[i][j];
    }
  }
}

// The split-K fold: C = W[0], then C = C + W[kb] for kb = 1, 2, ... in
// ascending order, the same sequence kfold applies (4 outputs a thread).
__global__ void __launch_bounds__(kThreads)
ws_fold_kernel(const float* __restrict__ W, float* __restrict__ C,
               long long mn, int n_kb) {
  // batch item blockIdx.y: its own workspace and C
  W += (long long)blockIdx.y * n_kb * mn;
  C += (long long)blockIdx.y * mn;
  const long long i0 =
      4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i0 >= mn) return;
  if (i0 + 4 <= mn && (mn & 3) == 0) {
    float4 acc = *reinterpret_cast<const float4*>(W + i0);
    for (int kb = 1; kb < n_kb; ++kb) {
      const float4 p = *reinterpret_cast<const float4*>(W + kb * mn + i0);
      acc.x = acc.x + p.x;
      acc.y = acc.y + p.y;
      acc.z = acc.z + p.z;
      acc.w = acc.w + p.w;
    }
    *reinterpret_cast<float4*>(C + i0) = acc;
    return;
  }
  for (long long i = i0; i < i0 + 4 && i < mn; ++i) {
    float acc = W[i];
    for (int kb = 1; kb < n_kb; ++kb) acc = acc + W[kb * mn + i];
    C[i] = acc;
  }
}

}  // namespace

// OS (dataflow 0) or IS (dataflow 2) over the grid that
// kernels/tt_gemm.py::os_grid / is_grid chose: `tr` rows a thread, `ty_n`
// row groups (band tr * ty_n rows), n-tiles of `tn` columns, `nt_group`
// n-tiles a block, `a_whole` (IS) to stage the band across all of K once,
// `one_pass` to stage every tile of a block before one wait (both need a
// block_k that is a multiple of 4).  Returns the cudaError_t of the
// launch.
extern "C" int tt_gemm_launch(int dataflow, const float* A, const float* B,
                              float* C, int M, int K, int N, int bk, int tn,
                              int tr, int ty_n, int nt_group, int a_whole,
                              int one_pass, void* stream) {
  const int n_tx = (tn + 3) / 4;
  if ((dataflow != 0 && dataflow != 2) || bk < 1 || tn < 1 || tr < 1 ||
      tr > kTileRows || ty_n < 1 || n_tx * ty_n > kThreads || nt_group < 1 ||
      ((a_whole || one_pass) && bk % 4 != 0) ||
      (one_pass && !a_whole && nt_group != 1) ||
      (dataflow == 0 && (nt_group != 1 || a_whole)))
    return (int)cudaErrorInvalidValue;
  const int tm = tr * ty_n;
  const int n_kb = (K + bk - 1) / bk;
  const int n_nt = (N + tn - 1) / tn;
  const int n_mb = (M + tm - 1) / tm;
  const int n_ng = (n_nt + nt_group - 1) / nt_group;
  if (M < 1 || K < 1 || N < 1 || n_ng > 65535)
    return (int)cudaErrorInvalidValue;
  const bool band = a_whole || one_pass;
  const size_t a_floats =
      band ? (size_t)tm * pad_ld(n_kb * bk) : 2 * (size_t)tm * pad_ld(bk);
  const size_t b_floats = one_pass ? (size_t)nt_group * n_kb * bk * 4 * n_tx
                                   : 2 * (size_t)kpad(bk) * 4 * n_tx;
  const size_t smem = (a_floats + b_floats) * sizeof(float);
  const auto aligned = [](const void* q) {
    return reinterpret_cast<unsigned long long>(q) % 16 == 0;
  };
  BandArgs p{A, B, C, M, K, N, bk, tn, ty_n, nt_group, a_whole, n_kb, n_nt,
             K % 4 == 0 && bk % 4 == 0 && aligned(A),
             N % 4 == 0 && tn % 4 == 0 && aligned(B),
             N % 4 == 0 && tn % 4 == 0 && aligned(C)};
  using Kernel = void(const BandArgs);
  static Kernel* const kernels[2][2][kTileRows] = {
      {{os_kernel<1, false>, os_kernel<2, false>, os_kernel<3, false>,
        os_kernel<4, false>},
       {os_kernel<1, true>, os_kernel<2, true>, os_kernel<3, true>,
        os_kernel<4, true>}},
      {{is_kernel<1, false>, is_kernel<2, false>, is_kernel<3, false>,
        is_kernel<4, false>},
       {is_kernel<1, true>, is_kernel<2, true>, is_kernel<3, true>,
        is_kernel<4, true>}}};
  static SmemCap caps[2][2][kTileRows];
  const int d = dataflow == 0 ? 0 : 1;
  const int op = one_pass ? 1 : 0;
  Kernel* kernel = kernels[d][op][tr - 1];
  cudaError_t err = caps[d][op][tr - 1].allow(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // at least 4 warps, so the staging copies issue from 4 warps at once
  const int tile_threads = (n_tx * ty_n + 31) / 32 * 32;
  const int threads = tile_threads > kMinThreads ? tile_threads : kMinThreads;
  kernel<<<dim3(n_mb, n_ng), threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// WS over the grid kernels/tt_gemm.py::ws_grid chose: `tr` rows a thread,
// `ty_n` row groups (m-tile tr * ty_n rows), `mt_per_range` m-tiles per
// m-range, `kg` k-blocks per k-group.  With more than one k-group, W
// (n_kb * M * N floats a batch item, allocated by the caller) takes the
// partials and a second launch folds them into C.  `batch` problems of
// one shape, each stored whole after the previous one (A: M * K floats
// each, B: K * N, C: M * N), run as one launch (the grid's y axis).
// Returns the first failing launch's cudaError_t, or 0.
extern "C" int tt_gemm_ws_launch(const float* A, const float* B, float* C,
                                 float* W, int M, int K, int N, int bk,
                                 int bn, int tr, int ty_n, int mt_per_range,
                                 int kg, int batch, void* stream) {
  const int n_tx = (bn + 3) / 4;
  if (tr < 1 || tr > kTileRows || ty_n < 1 || n_tx * ty_n > kThreads ||
      mt_per_range < 1 || kg < 1 || bk < 1 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_kb = (K + bk - 1) / bk;
  const long long n_mt = (M + (long long)tr * ty_n - 1) / (tr * ty_n);
  const long long blocks = (long long)((N + bn - 1) / bn) *
                           ((n_mt + mt_per_range - 1) / mt_per_range) *
                           ((n_kb + kg - 1) / kg);
  const bool split = kg < n_kb;
  if (blocks > 0x7fffffffLL || (split && W == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(tr * ty_n * pad_ld(bk) + kpad(bk) * 4 * n_tx) * sizeof(float);
  const int vec = bk % 4 == 0 && K % 4 == 0 &&
                  reinterpret_cast<unsigned long long>(A) % 16 == 0;
  using Kernel = void(const float*, const float*, float*, float*, int, int,
                      int, int, int, int, int, int, int);
  static Kernel* const kernels[kTileRows] = {ws_kernel<1>, ws_kernel<2>,
                                             ws_kernel<3>, ws_kernel<4>};
  static SmemCap caps[kTileRows];
  Kernel* kernel = kernels[tr - 1];
  cudaError_t err = caps[tr - 1].allow(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)blocks, batch), kThreads, smem, (cudaStream_t)stream>>>(
      A, B, C, W, M, K, N, bk, bn, ty_n, mt_per_range, kg, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  const long long mn = (long long)M * N;
  const long long fold_blocks = ((mn + 3) / 4 + kThreads - 1) / kThreads;
  ws_fold_kernel<<<dim3((unsigned)fold_blocks, batch), kThreads, 0,
                   (cudaStream_t)stream>>>(W, C, mn, n_kb);
  return (int)cudaGetLastError();
}

extern "C" const char* tt_gemm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
