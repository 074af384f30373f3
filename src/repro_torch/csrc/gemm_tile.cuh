// The fp32 tile loop shared by the dataflow GEMM (tt_gemm.cu, K2-K4) and
// the fused-segment kernel (fused_path.cu, K5).
//
// Every kernel computes every output element the same way: for each
// k-block of block_k (ascending), a partial sum  s = fmaf(a_k, b_k, s)
// from 0 over the staged tile in ascending k (zero-filled past the matrix
// edge), then the fold  acc = s  for the first k-block and  acc = acc + s
// after it.  kblocks_fold computes a register tile of those partials and
// folds them with kfold; every kernel runs it.  The value of an output
// therefore depends on its row of A, its column of B and block_k only,
// never on block_m, block_n, the tile walk, the grid or the other rows of
// the launch.  Keeping this code in one place is what keeps the dataflows
// and the fused route bit-identical.
#pragma once

#include <cuda_runtime.h>

namespace gemm_tile {

// The ascending k-fold into `acc` (a register or an fp32 output in device
// memory): the first k-block stores its sum, later ones add to it.
__device__ __forceinline__ void kfold(float* acc, float s, int kb) {
  *acc = kb == 0 ? s : *acc + s;
}

// A thread's register tile: up to kTileRows rows x 4 columns.
constexpr int kTileRows = 4;

// A k-block as staged: block_k rounded up to a multiple of 4, the rows of B
// and columns of A past block_k zero-filled.  The chain then ends in up to
// 3 fmaf(0, 0, s) = s, which change no value (a partial of -0 becomes +0).
__host__ __device__ __forceinline__ int kpad(int bk) { return (bk + 3) & ~3; }

// The register tile of Rows x 4 outputs over n_kb staged k-blocks of bk
// (a multiple of 4; kpad) that lie back to back in shared memory (A rows
// k = 0 .. n_kb * bk - 1 from As + row * lda, B rows from Bs + k * ldb):
// for each k-block the fmaf chain from 0 in ascending k of
// As[(row0 + i * row_step) * lda + k] * Bs[k * ldb + col0 + j], folded into
// tot[i][j] with kfold as k-block kb0, kb0 + 1, ...  Rows of A and B are
// 16-byte aligned (lda, ldb, col0 multiples of 4): A is read as one float4
// per row and 4 k steps, B as one float4 per k, and the next 4 steps'
// operands are loaded before this step's FMAs (ptxas issues a
// shared-memory load just before its use, which a block of one busy warp,
// as the decode GEMMs give, pays at every step).  One loop runs across the
// k-block edges, so a short k-block does not pay the pipeline's start
// again.
template <int Rows>
__device__ __forceinline__ void kblocks_fold(const float* As, int lda,
                                             int row0, int row_step,
                                             const float* Bs, int ldb,
                                             int col0, int bk, int n_kb,
                                             int kb0,
                                             float (&tot)[kTileRows][4]) {
  static_assert(Rows >= 1 && Rows <= kTileRows, "Rows: 1 to 4");
  float s[Rows][4];
#pragma unroll
  for (int i = 0; i < Rows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  float4 a[Rows], b[4];
  auto load = [&](int k, float4(&ra)[Rows], float4(&rb)[4]) {
#pragma unroll
    for (int i = 0; i < Rows; ++i)
      ra[i] = *reinterpret_cast<const float4*>(
          As + (row0 + i * row_step) * lda + k);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      rb[q] = *reinterpret_cast<const float4*>(Bs + (k + q) * ldb + col0);
  };
  const int k_end = n_kb * bk;
  int kb = kb0, left = bk;
  load(0, a, b);
#pragma unroll 4
  for (int k = 0; k < k_end; k += 4) {
    float4 an[Rows], bn[4];
    load(k + 4 < k_end ? k + 4 : k, an, bn);  // the last round reloads
#pragma unroll
    for (int i = 0; i < Rows; ++i) {
      const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[i][0] = fmaf(av[q], b[q].x, s[i][0]);
        s[i][1] = fmaf(av[q], b[q].y, s[i][1]);
        s[i][2] = fmaf(av[q], b[q].z, s[i][2]);
        s[i][3] = fmaf(av[q], b[q].w, s[i][3]);
      }
    }
    if ((left -= 4) == 0) {  // the k-block is done: fold it, start the next
#pragma unroll
      for (int i = 0; i < Rows; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kfold(&tot[i][j], s[i][j], kb);
          s[i][j] = 0.f;
        }
      ++kb;
      left = bk;
    }
#pragma unroll
    for (int i = 0; i < Rows; ++i) a[i] = an[i];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = bn[q];
  }
}

// Asynchronous copies into shared memory (sm_80+): `bytes` of 4 or 16,
// zero-filled when `valid` is false (the source is then not read, but
// must still be a valid address).  cp_async_commit() closes this thread's
// current group of copies; cp_async_wait_prior() waits until at most one
// of its groups is still in flight (a two-stage ring), cp_async_wait_all()
// for every copy it issued.  A __syncthreads() then publishes them to the
// block.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  static_assert(Bytes == 4 || Bytes == 16, "cp.async takes 4 or 16 bytes");
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? Bytes : 0;
  if constexpr (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

}  // namespace gemm_tile
