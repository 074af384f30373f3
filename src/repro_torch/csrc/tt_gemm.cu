// Dataflow-configurable fp32 GEMM  C = A @ B  for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/tt_gemm.py (the
// pallas_call in tt_gemm(), :178): _os_kernel (:39, K2), _ws_kernel (:56,
// K3) and _is_kernel (:78, K4).  The plan's dataflow picks which operand
// tile stays resident in shared memory while the others stream:
//
//   OS  one block per (block_m x block_n) output tile; the k-blocks loop
//       inside it and the fp32 accumulator stays in registers until one
//       final store.
//   WS  a grid of (n-band x m-range x k-group) blocks that the host picks
//       for the card (kernels/tt_gemm.py::ws_grid).  In each block the
//       k-blocks of its group loop outside; each k-block's (block_k x
//       block_n) B tile is staged once and stays resident while the block
//       streams the A tiles of its m-range.  When K is split over k-groups
//       every partial p_kb goes to a workspace and a second, small kernel
//       folds them into C; otherwise partial C folds in registers (one
//       m-tile in the range) or round-trips through C once per k-fold.
//   IS  one block per m-band, symmetric: the (block_m x block_k) A tile
//       stays resident while B streams across the n-tiles.
//
// Numerics.  Every dataflow computes, for each output element, the same
// sequence (the tile loop of gemm_tile.cuh, shared with fused_path.cu):
// p_kb = sum over the k-block in ascending k (fp32 FMA from 0), then C =
// p_0, C = C + p_1, ... in ascending k-block order.  That is the
// reference's contract (acc += dot(block) in OS; o = o + part in WS/IS),
// so the three dataflows agree bit for bit at one block_k, and an output
// element never depends on M, N, block_m or block_n, on the WS grid, or
// on the other rows of the launch (the serve engine's continuous ==
// oneshot contract).  The WS split over K keeps it: the workspace holds
// each p_kb separately (no per-group sums, no atomics, no tree) and the
// fold adds them in ascending kb order.  Ragged edges are masked
// (zero-filled tiles, stores skipped) instead of padding the operands in
// device memory.  No TF32: the model is fp32 and parity is held at 1e-5.
//
// What bounds it on this card.  The TT path GEMMs are small and thin (one
// dim is often 8-16), so the work is bound by memory traffic and by launch
// and latency cost, not by the 67 TFLOP/s fp32 FMA rate: the weight
// gradient M,K,N = 2048,2048,16 needs 0.0051 ms for its bytes (A read
// once) but 0.002 ms for its FMAs.  What made WS slow was the grid: one
// block per n-band, and every train-plan weight gradient has N = block_n
// = 16, so one block on one of 132 SMs ran the whole 2048-deep product as
// dependent FMA chains out of shared memory.
//
// What the WS design does about it.  The host splits M into m-ranges
// (down to 4 rows) and then K into k-groups until the call gives about
// 2 x 132 blocks where the shape allows (2048,2048,16: 18 m-ranges of
// 120 rows x 16 k-groups of one k-block = 288 blocks; the rule and its
// numbers are in ws_grid).  The split costs one workspace pass of n_kb x M
// x N fp32 values (2 MiB there, against 16 MiB of A) and one more launch.
// Inside a block, A and B stage with cp.async (16-byte copies of A where
// rows are aligned, 4-byte zero-filling copies at the ragged rest), and
// each thread keeps a register tile of up to 4 rows x 4 columns, so one
// float4 of B and 4 scalars of A from shared memory feed 16 FMAs.  The
// staged A row stride is block_k + 4 floats, so a warp's rows sit in
// distinct banks.  No mma (fp32 has no tensor-core mode), no TMA: at
// these shapes the bytes, not the FMA rate, are the limit.  OS and IS
// keep their first, simple version.

#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace {

constexpr int kThreads = 256;
// block_m * block_n <= kThreads * kMaxPerThread (checked by the wrapper)
constexpr int kMaxPerThread = 64;

using gemm_tile::cp_async;
using gemm_tile::cp_async_wait_all;
using gemm_tile::kblock_dot;
using gemm_tile::kfold;
using gemm_tile::load_tile;
using gemm_tile::RowMajor;

// Row stride of the WS kernel's staged A tile: block_k rounded up to 4,
// plus 4, so rows stay 16-byte aligned for cp.async and the rows that one
// warp reads at one k fall into distinct banks.
__host__ __device__ __forceinline__ int ws_lda(int bk) {
  return ((bk + 3) & ~3) + 4;
}

__global__ void __launch_bounds__(kThreads)
os_kernel(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ C, int M, int K, int N, int bm, int bk, int bn) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + bm * bk;
  const int n_tiles_n = (N + bn - 1) / bn;
  const int m0 = (blockIdx.x / n_tiles_n) * bm;
  const int n0 = (blockIdx.x % n_tiles_n) * bn;
  const int n_kb = (K + bk - 1) / bk;
  float acc[kMaxPerThread];
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    load_tile(As, RowMajor{A, K}, M, K, m0, kb * bk, bm, bk);
    load_tile(Bs, RowMajor{B, N}, K, N, kb * bk, n0, bk, bn);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      int o = threadIdx.x + i * kThreads;
      if (o < bm * bn) {
        float s = kblock_dot(As, Bs, o / bn, o % bn, bk, bn);
        kfold(&acc[i], s, kb);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    int o = threadIdx.x + i * kThreads;
    if (o < bm * bn) {
      int m = m0 + o / bn, n = n0 + o % bn;
      if (m < M && n < N) C[(long long)m * N + n] = acc[i];
    }
  }
}

// WS: block (n-band, m-range, k-group), decoded as the host's
// kernels/tt_gemm.py::WSGrid.block_work does.  For each k-block of its
// group the block stages the (bk x bn) B tile once and keeps it resident
// while it streams the A tiles of its m-range past it.  Each thread holds
// a register tile of `tr` rows (strided by `ty_n`) x 4 columns; every
// output is its own ascending fmaf chain per k-block (kblock_tile).  The
// partial p_kb then goes
//   * to the workspace W[kb][m][n] when K is split over k-groups (the
//     fold kernel below sums them into C in ascending kb order);
//   * else to a register fold when the range is one m-tile;
//   * else to C, read-add-written once per k-fold (the reference's WS).
__global__ void __launch_bounds__(kThreads)
ws_kernel(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ C, float* __restrict__ W, int M, int K, int N,
          int bk, int bn, int tr, int ty_n, int mt_per_range, int kg,
          int vec) {
  extern __shared__ __align__(16) float ws_smem[];
  const int n_tx = (bn + 3) / 4;
  const int ldb = 4 * n_tx;
  const int lda = ws_lda(bk);
  const int tm = tr * ty_n;
  float* Bs = ws_smem;             // resident weight tile, bk x ldb
  float* As = ws_smem + bk * ldb;  // streamed input tile, tm x lda
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
  float tot[gemm_tile::kTileRows][4];
  float s[gemm_tile::kTileRows][4];
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k0 = kb * bk;
    __syncthreads();  // the previous k-block is done with Bs and As
    for (int idx = threadIdx.x; idx < bk * ldb; idx += blockDim.x) {
      const int k = idx / ldb, c = idx - k * ldb;
      const bool ok = k0 + k < K && c < bn && n0 + c < N;
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
        for (int idx = threadIdx.x; idx < tm * bk; idx += blockDim.x) {
          const int r = idx / bk, c = idx - r * bk;
          const bool ok = m0 + r < M && k0 + c < K;
          cp_async<4>(As + r * lda + c,
                      ok ? A + (long long)(m0 + r) * K + k0 + c : A, ok);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (!active) continue;
      gemm_tile::kblock_tile(As, lda, ty, ty_n, tr, Bs, ldb, 4 * tx, bk, s);
#pragma unroll
      for (int i = 0; i < gemm_tile::kTileRows; ++i) {
        const int m = m0 + ty + i * ty_n;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * tx + j, n = n0 + c;
          if (i >= tr || m >= M || c >= bn || n >= N) continue;
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
  for (int i = 0; i < gemm_tile::kTileRows; ++i) {
    const int m = mt0 * tm + ty + i * ty_n;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tx + j, n = n0 + c;
      if (i < tr && m < M && c < bn && n < N)
        C[(long long)m * N + n] = tot[i][j];
    }
  }
}

// The split-K fold: C = W[0], then C = C + W[kb] for kb = 1, 2, ... in
// ascending order, the same sequence kfold applies (4 outputs a thread).
__global__ void __launch_bounds__(kThreads)
ws_fold_kernel(const float* __restrict__ W, float* __restrict__ C,
               long long mn, int n_kb) {
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

__global__ void __launch_bounds__(kThreads)
is_kernel(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ C, int M, int K, int N, int bm, int bk, int bn) {
  extern __shared__ float smem[];
  float* As = smem;              // resident input tile
  float* Bs = smem + bm * bk;    // streamed weight tile
  const int m0 = blockIdx.x * bm;
  const int n_kb = (K + bk - 1) / bk;
  const int n_nb = (N + bn - 1) / bn;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    load_tile(As, RowMajor{A, K}, M, K, m0, kb * bk, bm, bk);
    for (int nb = 0; nb < n_nb; ++nb) {
      __syncthreads();
      load_tile(Bs, RowMajor{B, N}, K, N, kb * bk, nb * bn, bk, bn);
      __syncthreads();
      for (int o = threadIdx.x; o < bm * bn; o += blockDim.x) {
        int m = m0 + o / bn, n = nb * bn + o % bn;
        if (m < M && n < N) {
          float s = kblock_dot(As, Bs, o / bn, o % bn, bk, bn);
          kfold(C + (long long)m * N + n, s, kb);
        }
      }
    }
  }
}

}  // namespace

// dataflow: 0 = OS, 2 = IS (WS has its own launcher below).  Returns the
// cudaError_t of the launch.
extern "C" int tt_gemm_launch(int dataflow, const float* A, const float* B,
                              float* C, int M, int K, int N, int bm, int bk,
                              int bn, void* stream) {
  void (*kernel)(const float*, const float*, float*, int, int, int, int, int,
                 int);
  long long blocks;
  if (dataflow == 0) {
    kernel = os_kernel;
    blocks = (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  } else if (dataflow == 2) {
    kernel = is_kernel;
    blocks = (M + bm - 1) / bm;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (bm * bn > kThreads * kMaxPerThread || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)(bm * bk + bk * bn) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      A, B, C, M, K, N, bm, bk, bn);
  return (int)cudaGetLastError();
}

// WS over the grid kernels/tt_gemm.py::ws_grid chose: `tr` rows a thread,
// `ty_n` row groups (m-tile tr * ty_n rows), `mt_per_range` m-tiles per
// m-range, `kg` k-blocks per k-group.  With more than one k-group, W
// (n_kb * M * N floats, allocated by the caller) takes the partials and
// a second launch folds them into C.  Returns the first failing launch's
// cudaError_t, or 0.
extern "C" int tt_gemm_ws_launch(const float* A, const float* B, float* C,
                                 float* W, int M, int K, int N, int bk,
                                 int bn, int tr, int ty_n, int mt_per_range,
                                 int kg, void* stream) {
  const int n_tx = (bn + 3) / 4;
  if (tr < 1 || tr > gemm_tile::kTileRows || ty_n < 1 ||
      n_tx * ty_n > kThreads || mt_per_range < 1 || kg < 1 || bk < 1)
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
      (size_t)(tr * ty_n * ws_lda(bk) + bk * 4 * n_tx) * sizeof(float);
  const int vec = bk % 4 == 0 && K % 4 == 0 &&
                  reinterpret_cast<unsigned long long>(A) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      ws_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ws_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      A, B, C, W, M, K, N, bk, bn, tr, ty_n, mt_per_range, kg, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  const long long mn = (long long)M * N;
  const long long fold_blocks = ((mn + 3) / 4 + kThreads - 1) / kThreads;
  ws_fold_kernel<<<(unsigned)fold_blocks, kThreads, 0,
                   (cudaStream_t)stream>>>(W, C, mn, n_kb);
  return (int)cudaGetLastError();
}

extern "C" const char* tt_gemm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
