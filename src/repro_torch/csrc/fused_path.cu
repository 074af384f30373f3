// Fused path segment: a chain of >= 2 contraction steps of a TT path in ONE
// launch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/fused_path.py (_kernel,
// :177, with _chain_step, :127; launched by the pallas_call in
// fused_segment_contract, :286; K5).  The TPU kernel streams the
// batch-carrying operand through the grid in token blocks, pins the
// batch-free operands whole in VMEM and keeps each interior intermediate
// in an fp32 VMEM scratch buffer, so the chain pays one launch and no HBM
// bytes for its interior tensors.
//
// What bounds it on this card.  The chains the plans fuse are thin: at full
// width (2048 tokens) the first step is (tokens x 768|2048) @ (.. x 16) and
// the second (d_out x 16) @ (16 x tokens).  The arithmetic is 0.1-0.2
// GFLOP; the work is bound by bytes (X in, Y out, in HBM), far from the
// fp32 FMA rate.  The streamed X block alone (256 tokens x 768 x 4 B =
// 768 KiB at the plan's block) is larger than the 227 KB of shared memory
// of a block, and so is mlp.wd's 16 x 2048 core merge, so nothing is
// "pinned whole" here.
//
// What the design does about it.
//   * One CUDA block per token block; the host picks the token block for
//     the card (kernels/fused_path.py::choose_block_tokens) so that a
//     2048-token call fills the SMs.  Rows are independent and no block
//     size changes a bit.
//   * Every operand is staged tile by tile into shared memory with the
//     same load_tile / kblock_dot / kfold loop as the per-step GEMM
//     (gemm_tile.cuh); only the interior intermediates (token-blocked,
//     fp32, e.g. 8 x 16 floats) stay resident across steps.  X is read
//     once from HBM, Y written once, the interior never leaves the chip.
//   * Operands are addressed through host-built offset tables (row and
//     column offsets, as K1 does), so the permutes of the per-step route
//     cost no copies in device memory, and the last step writes its result
//     straight into the segment's output layout with the batch axis
//     wherever it falls.
//   * Ragged token counts are masked in the kernel (loads of tokens past
//     the end read 0, their outputs are not stored), not padded.
//
// Numerics.  Each chained step uses block_k clamped against the step's FULL
// (not token-blocked) K, exactly as the per-step route clamps it, and the
// shared tile loop makes each output the same FMA sequence as tt_gemm.cu
// computes for it.  So fused == per-step route, bit for bit.

#include <cuda_runtime.h>

#include "gemm_tile.cuh"

// The parameter structs cross the C interface (fused_path_launch), so they
// have external linkage; the kernel stays file-local.
constexpr int kThreads = 256;
constexpr int kMaxSteps = 8;
// tile_m * tile_n <= kThreads * kMaxPerThread (checked by the host)
constexpr int kMaxPerThread = 16;

// One GEMM operand, element (r, c) at  base[row[r] + col[c]].
struct Operand {
  const float* base;     // device memory; unused for an interior operand
  int mid;               // interior buffer in shared memory, or -1
  const int* row;
  const int* col;
  const int* row_tok;    // token (within the block) of each row, or null
  const int* col_tok;    // token of each column, or null
  long long tok_stride;  // elements per token of the streamed input, else 0
};

struct ChainStep {
  Operand a, b;
  int M, K, N;           // token-blocked GEMM dims
  int bk;                // block_k clamped against the step's full K
  int tile_m, tile_n;    // outputs of one pass
  int out_mid;           // interior buffer for the result, -1 = Y
  const int* c_row;      // last step: Y offsets of the result rows/columns
  const int* c_col;
  const int* c_row_tok;  // last step: token of each result row / column
  const int* c_col_tok;
};

struct FusedParams {
  float* y;
  long long tokens;
  long long y_tok_stride;
  int block_tokens;
  int n_steps;
  int tile_offset;             // floats: the staging tiles in shared memory
  int mid_offset[kMaxSteps];   // floats: the interior buffers
  ChainStep steps[kMaxSteps];
};

namespace {

using gemm_tile::kblock_dot;
using gemm_tile::kfold;
using gemm_tile::load_tile;

// An operand as load_tile reads it; tokens at or past `valid` read 0.
struct Gathered {
  const float* p;
  const int* row;
  const int* col;
  const int* row_tok;
  const int* col_tok;
  int valid;
  __device__ __forceinline__ float operator()(int r, int c) const {
    if (row_tok != nullptr && __ldg(row_tok + r) >= valid) return 0.f;
    if (col_tok != nullptr && __ldg(col_tok + c) >= valid) return 0.f;
    return p[__ldg(row + r) + __ldg(col + c)];
  }
};

__device__ __forceinline__ Gathered gathered(const FusedParams& p,
                                             const Operand& op, float* smem,
                                             long long t0, int valid) {
  const float* base =
      op.mid >= 0 ? smem + p.mid_offset[op.mid] : op.base + t0 * op.tok_stride;
  return Gathered{base, op.row, op.col, op.row_tok, op.col_tok, valid};
}

// __grid_constant__: the step table is read in place from parameter space.
__global__ void __launch_bounds__(kThreads)
fused_kernel(const __grid_constant__ FusedParams p) {
  extern __shared__ float smem[];
  const long long t0 = (long long)blockIdx.x * p.block_tokens;
  const long long rem = p.tokens - t0;
  const int valid = rem < p.block_tokens ? (int)rem : p.block_tokens;
  float* tiles = smem + p.tile_offset;

  for (int s = 0; s < p.n_steps; ++s) {
    const ChainStep& st = p.steps[s];
    const Gathered A = gathered(p, st.a, smem, t0, valid);
    const Gathered B = gathered(p, st.b, smem, t0, valid);
    const int tm = st.tile_m, tn = st.tile_n, bk = st.bk;
    float* As = tiles;
    float* Bs = tiles + tm * bk;
    const int n_tn = (st.N + tn - 1) / tn;
    const int n_tiles = ((st.M + tm - 1) / tm) * n_tn;
    const int n_kb = (st.K + bk - 1) / bk;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int m0 = (tile / n_tn) * tm, n0 = (tile % n_tn) * tn;
      float acc[kMaxPerThread];
      for (int kb = 0; kb < n_kb; ++kb) {
        __syncthreads();
        load_tile(As, A, st.M, st.K, m0, kb * bk, tm, bk);
        load_tile(Bs, B, st.K, st.N, kb * bk, n0, bk, tn);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kMaxPerThread; ++i) {
          const int o = threadIdx.x + i * kThreads;
          if (o < tm * tn)
            kfold(&acc[i], kblock_dot(As, Bs, o / tn, o % tn, bk, tn), kb);
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxPerThread; ++i) {
        const int o = threadIdx.x + i * kThreads;
        const int m = m0 + o / tn, n = n0 + o % tn;
        if (o >= tm * tn || m >= st.M || n >= st.N) continue;
        if (st.out_mid >= 0) {
          smem[p.mid_offset[st.out_mid] + m * st.N + n] = acc[i];
        } else {
          const int tok = st.c_row_tok != nullptr ? __ldg(st.c_row_tok + m)
                                                  : __ldg(st.c_col_tok + n);
          if (tok < valid)
            p.y[t0 * p.y_tok_stride + __ldg(st.c_row + m) +
                __ldg(st.c_col + n)] = acc[i];
        }
      }
    }
    __syncthreads();  // the next step reads this step's interior result
  }
}

}  // namespace

// One launch: `n_blocks` token blocks of `params->block_tokens` tokens.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_path_launch(const FusedParams* params, int n_blocks,
                                 int smem_bytes, void* stream) {
  if (params->n_steps < 2 || params->n_steps > kMaxSteps || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < params->n_steps; ++s) {
    const ChainStep& st = params->steps[s];
    if (st.tile_m * st.tile_n > kThreads * kMaxPerThread || st.bk < 1)
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fused_kernel<<<n_blocks, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      *params);
  return (int)cudaGetLastError();
}

extern "C" int fused_path_max_steps() { return kMaxSteps; }

extern "C" int fused_path_max_tile() { return kThreads * kMaxPerThread; }

extern "C" const char* fused_path_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
