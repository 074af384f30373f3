// The fp32 tile loop shared by the dataflow GEMM (tt_gemm.cu, K2-K4) and
// the fused-segment kernel (fused_path.cu, K5).
//
// Both kernels compute every output element the same way: for each k-block
// of block_k (ascending), a partial sum  s = fmaf(a_k, b_k, s)  from 0 over
// the staged tile in ascending k (zero-filled past the matrix edge), then
// the fold  acc = s  for the first k-block and  acc = acc + s  after it.
// The value of an output therefore depends on its row of A, its column of
// B and block_k only, never on block_m, block_n, the tile walk or the
// other rows of the launch.  Keeping this code in one place is what keeps
// the fused route bit-identical to the per-step route.
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

}  // namespace gemm_tile
