// The fp32 tile loops shared by the dataflow GEMM (tt_gemm.cu, K2-K4) and
// the fused-segment kernel (fused_path.cu, K5).
//
// Every kernel computes every output element the same way: for each
// k-block of block_k (ascending), a partial sum  s = fmaf(a_k, b_k, s)
// from 0 over the staged tile in ascending k (zero-filled past the matrix
// edge), then the fold  acc = s  for the first k-block and  acc = acc + s
// after it.  kblock_dot (OS, IS) computes one output's partial,
// kblock_tile (WS, K5) a register tile of them, each with that same
// sequence.  The value of an output therefore depends on its row of A, its
// column of B and block_k only, never on block_m, block_n, the tile walk,
// the grid or the other rows of the launch.  Keeping this code in one
// place is what keeps the dataflows and the fused route bit-identical.
#pragma once

#include <cuda_runtime.h>

namespace gemm_tile {

// A row-major (R x C) matrix in device memory.
struct RowMajor {
  const float* __restrict__ p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return p[(long long)r * ld + c];
  }
};

// Stage the (rows x cols) tile at (r0, c0) of an (R x C) operand into
// shared memory, zero outside the operand.  `src(r, c)` reads one element.
template <class Src>
__device__ __forceinline__ void load_tile(float* dst, const Src& src, int R,
                                          int C, int r0, int c0, int rows,
                                          int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    int r = idx / cols, c = idx - r * cols;
    int gr = r0 + r, gc = c0 + c;
    dst[idx] = (gr < R && gc < C) ? src(gr, gc) : 0.f;
  }
}

// One output's partial sum over a staged k-block, ascending k.
__device__ __forceinline__ float kblock_dot(const float* As, const float* Bs,
                                            int m, int n, int bk, int bn) {
  float s = 0.f;
  for (int k = 0; k < bk; ++k) s = fmaf(As[m * bk + k], Bs[k * bn + n], s);
  return s;
}

// The ascending k-fold into `acc` (a register or an fp32 output in device
// memory): the first k-block stores its sum, later ones add to it.
__device__ __forceinline__ void kfold(float* acc, float s, int kb) {
  *acc = kb == 0 ? s : *acc + s;
}

// A register tile of up to kTileRows x 4 outputs over one staged k-block:
// s[i][j] is the fmaf chain from 0 over k ascending of
// As[(row0 + i * row_step) * lda + k] * Bs[k * ldb + col0 + j], the same
// sequence kblock_dot computes for each of them; only the first `rows`
// rows are computed.  Bs rows are 16-byte aligned (ldb and col0 multiples
// of 4), so one float4 load feeds 4 * rows FMAs.  KUnroll is how many k
// steps the compiler unrolls; it changes the schedule, not the sequence
// (K5 takes 8; PERF.md has its times at 4 and 8 on an H100).
constexpr int kTileRows = 4;

template <int KUnroll = 4>
__device__ __forceinline__ void kblock_tile(const float* As, int lda, int row0,
                                            int row_step, int rows,
                                            const float* Bs, int ldb, int col0,
                                            int bk,
                                            float (&s)[kTileRows][4]) {
#pragma unroll
  for (int i = 0; i < kTileRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll KUnroll
  for (int k = 0; k < bk; ++k) {
    const float4 b = *reinterpret_cast<const float4*>(Bs + k * ldb + col0);
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      if (i < rows) {
        const float a = As[(row0 + i * row_step) * lda + k];
        s[i][0] = fmaf(a, b.x, s[i][0]);
        s[i][1] = fmaf(a, b.y, s[i][1]);
        s[i][2] = fmaf(a, b.z, s[i][2]);
        s[i][3] = fmaf(a, b.w, s[i][3]);
      }
    }
  }
}

// Asynchronous copies into shared memory (sm_80+): `bytes` of 4 or 16,
// zero-filled when `valid` is false (the source is then not read, but
// must still be a valid address).  cp_async_wait_all() waits for every
// copy this thread issued; a __syncthreads() then publishes them.
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

}  // namespace gemm_tile
