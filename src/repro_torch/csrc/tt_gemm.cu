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
//   WS  one block per n-band.  k-blocks loop outside; each k-block's
//       (block_k x block_n) B tile is loaded once and stays in shared
//       memory while the block sweeps every m-tile, streaming A.  Partial
//       C round-trips through the fp32 output in device memory once per
//       k-fold (read, add, write).
//   IS  one block per m-band, symmetric: the (block_m x block_k) A tile
//       stays resident while B streams across the n-tiles.
//
// Numerics.  Every dataflow computes, for each output element, the same
// sequence: p_kb = sum over the k-block in ascending k (fp32 FMA from 0),
// then C = p_0, C = C + p_1, ... in ascending k-block order.  That is the
// reference's contract (acc += dot(block) in OS; o = o + part in WS/IS),
// so the three dataflows agree bit for bit at one block_k, and an output
// element never depends on M, N, block_m or block_n, or on the other rows
// of the launch (the serve engine's continuous == oneshot contract).  No
// atomics, no split-K.  Ragged edges are masked (zero-filled tiles, stores
// skipped) instead of padding the operands in device memory.
//
// What bounds it on this card.  The TT path GEMMs are small and thin (one
// dim is often 8-16), so the work is bound by memory traffic and by launch
// and latency cost, not by the 67 TFLOP/s fp32 FMA rate.  This first
// version is plain FFMA from shared memory (no mma, no TF32 since the model
// is fp32, no TMA or pipelining); the tile loads are coalesced along the
// row.  WS and IS deliberately keep their re-reads of C per k-fold, the
// traffic the paper's simulator charges them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// block_m * block_n <= kThreads * kMaxPerThread (checked by the wrapper)
constexpr int kMaxPerThread = 64;

// Stage the (rows x cols) tile at (r0, c0) of a row-major (R x C) matrix
// into shared memory, zero outside the matrix.
__device__ void load_tile(float* dst, const float* __restrict__ src, int R,
                          int C, int r0, int c0, int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    int r = idx / cols, c = idx - r * cols;
    int gr = r0 + r, gc = c0 + c;
    dst[idx] = (gr < R && gc < C) ? src[(long long)gr * C + gc] : 0.f;
  }
}

// One output's partial sum over a staged k-block, ascending k.
__device__ __forceinline__ float kblock_dot(const float* As, const float* Bs,
                                            int m, int n, int bk, int bn) {
  float s = 0.f;
  for (int k = 0; k < bk; ++k) s = fmaf(As[m * bk + k], Bs[k * bn + n], s);
  return s;
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
    load_tile(As, A, M, K, m0, kb * bk, bm, bk);
    load_tile(Bs, B, K, N, kb * bk, n0, bk, bn);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      int o = threadIdx.x + i * kThreads;
      if (o < bm * bn) {
        float s = kblock_dot(As, Bs, o / bn, o % bn, bk, bn);
        acc[i] = kb == 0 ? s : acc[i] + s;
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

__global__ void __launch_bounds__(kThreads)
ws_kernel(const float* __restrict__ A, const float* __restrict__ B,
          float* __restrict__ C, int M, int K, int N, int bm, int bk, int bn) {
  extern __shared__ float smem[];
  float* Bs = smem;              // resident weight tile
  float* As = smem + bk * bn;    // streamed input tile
  const int n0 = blockIdx.x * bn;
  const int n_kb = (K + bk - 1) / bk;
  const int n_mb = (M + bm - 1) / bm;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    load_tile(Bs, B, K, N, kb * bk, n0, bk, bn);
    for (int mb = 0; mb < n_mb; ++mb) {
      __syncthreads();
      load_tile(As, A, M, K, mb * bm, kb * bk, bm, bk);
      __syncthreads();
      for (int o = threadIdx.x; o < bm * bn; o += blockDim.x) {
        int m = mb * bm + o / bn, n = n0 + o % bn;
        if (m < M && n < N) {
          float s = kblock_dot(As, Bs, o / bn, o % bn, bk, bn);
          float* c = C + (long long)m * N + n;
          *c = kb == 0 ? s : *c + s;
        }
      }
    }
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
    load_tile(As, A, M, K, m0, kb * bk, bm, bk);
    for (int nb = 0; nb < n_nb; ++nb) {
      __syncthreads();
      load_tile(Bs, B, K, N, kb * bk, nb * bn, bk, bn);
      __syncthreads();
      for (int o = threadIdx.x; o < bm * bn; o += blockDim.x) {
        int m = m0 + o / bn, n = nb * bn + o % bn;
        if (m < M && n < N) {
          float s = kblock_dot(As, Bs, o / bn, o % bn, bk, bn);
          float* c = C + (long long)m * N + n;
          *c = kb == 0 ? s : *c + s;
        }
      }
    }
  }
}

}  // namespace

// dataflow: 0 = OS, 1 = WS, 2 = IS.  Returns the cudaError_t of the launch.
extern "C" int tt_gemm_launch(int dataflow, const float* A, const float* B,
                              float* C, int M, int K, int N, int bm, int bk,
                              int bn, void* stream) {
  void (*kernel)(const float*, const float*, float*, int, int, int, int, int,
                 int);
  long long blocks;
  if (dataflow == 0) {
    kernel = os_kernel;
    blocks = (long long)((M + bm - 1) / bm) * ((N + bn - 1) / bn);
  } else if (dataflow == 1) {
    kernel = ws_kernel;
    blocks = (N + bn - 1) / bn;
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

extern "C" const char* tt_gemm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
