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
// GFLOP; the work is bound by bytes (X in, Y out, in HBM: 0.0069 ms at
// mlp.wg), far from the fp32 FMA rate.  What made the first version slow
// was not HBM but how the operands reached the SMs: one block per 8-token
// block, each gathering the batch-free operands whole, element by element
// through offset tables (two table loads per element; at mlp.wg the 16 x
// 2048 output-side merge is 128 KiB a block, ~33 MB of scalar gathers a
// call), in 48 staged k-blocks with two barriers each.
//
// What this design does about it.
//   * pack_kernel, once per call, copies each batch-free operand of the
//     chain (the token-free core merges; they change every optimizer
//     step) through its offset tables into a dense row-major buffer in
//     its GEMM role: (M x K) as operand A, (K x N) as operand B.  The
//     wrapper allocates the buffer.  The main kernel reads packed
//     operands with 16-byte cp.async copies and no tables.
//   * Grid: one block per token block.  The host halves the token block
//     from the plan's (at most 64) down to 8 while the call has fewer
//     token blocks than SMs (kernels/fused_path.py::choose_block_tokens):
//     256 blocks at 2048 tokens.  Larger token blocks with the last step's
//     weight-side columns split over a second grid axis were built and
//     measured, and lost on an H100 at 2048 tokens (32 tokens x 3 splits:
//     0.064 ms at mlp.wg against 0.053 ms for 8 tokens, one block each;
//     PERF.md): a split re-reads the streamed input and recomputes the
//     first step, and an 8-token block stages a 768-deep first step in
//     one round.
//   * Each round stages as many k-blocks as fit ~96 KB of shared memory,
//     so the 768-2048-deep first step takes 1-3 rounds and barriers
//     instead of 48.  The streamed input stages with 16-byte copies where
//     its rows are aligned and its columns contiguous, through its tables
//     (masked per token) otherwise.
//   * Each thread keeps a register tile of up to 4 rows x 4 columns
//     (gemm_tile.cuh's kblocks_fold, shared with the tt_gemm kernels) and
//     runs a round's k-blocks as one loop, folding at each k-block edge.
//     block_k must be a multiple of 4 (plans clamp it to a power of two of
//     at least 8); the wrapper and the launcher refuse any other.
//   * The fp32 interior stays in shared memory across steps; the last step
//     writes straight into the segment's output layout through its
//     tables, the batch axis wherever it falls (float4 stores where Y's
//     columns are the block's contiguous tokens); ragged token counts are
//     masked, not padded.
//
// Numerics.  Each chained step uses block_k clamped against the step's FULL
// (not token-blocked) K, exactly as the per-step route clamps it, and the
// register tile computes each output's k-block partial as the same fmaf
// chain from 0 in ascending k as tt_gemm.cu, folded in ascending k-block
// order.  Neither the token block nor how many k-blocks a round stages
// changes a bit, so fused == per-step route, bit for bit, and a row never
// depends on the other rows of the call.  No atomics and no TF32 (fp32 has
// no tensor-core mode; parity is held at 1e-5): plain fp32 FMAs, which at
// these shapes are not the limit (mlp.wg needs 0.0069 ms for its bytes,
// ~0.003 ms for its 0.2 GFLOP at 67 TFLOP/s).

#include <cuda_runtime.h>

#include "gemm_tile.cuh"

// The parameter structs cross the C interface (fused_path_launch), so they
// have external linkage; the kernels stay file-local.
constexpr int kThreads = 256;
constexpr int kMaxSteps = 8;

// The token-side operand of a step: the streamed input (device memory) or
// the previous step's interior result (shared memory); element (r, c) at
// base[row[r] + col[c]].
struct Operand {
  const float* base;     // streamed input; unused for an interior operand
  int mid;               // interior buffer in shared memory, or -1
  const int* row;
  const int* col;
  const int* row_tok;    // token (within the block) of each row, or null
  const int* col_tok;    // token of each column, or null
  long long tok_stride;  // elements per token of the streamed input, else 0
  int vec;               // row offsets % 4 == 0, columns contiguous, tokens
                         // on rows: 16-byte copies
};

struct ChainStep {
  Operand t;             // the token-side operand
  int w_is_a;            // the packed batch-free operand is A (M x K), else B
  int w_offset;          // floats into the packed buffer
  int M, K, N;           // token-blocked GEMM dims
  int bk;                // block_k clamped against the step's full K
  int kc;                // k staged per round, a multiple of bk
  int tile_m, tile_n;    // outputs of one pass
  int tr;                // rows a thread: tile_m = tr * (tile_m / tr)
  int out_mid;           // interior buffer for the result, -1 = Y
  int y_vec;             // last step: Y's columns are the tokens,
                         // contiguous, rows 16-byte aligned: float4 stores
  const int* c_row;      // last step: Y offsets of the result rows/columns
  const int* c_col;
  const int* c_row_tok;  // last step: token of each result row / column
  const int* c_col_tok;
};

struct FusedParams {
  float* y;
  const float* packed;
  long long tokens;
  long long y_tok_stride;
  int block_tokens;
  int n_steps;
  int tile_offset;             // floats: the staging tiles in shared memory
  int mid_offset[kMaxSteps];   // floats: the interior buffers
  ChainStep steps[kMaxSteps];
};

// One batch-free operand to pack: dst[r * cols + c] = src[row[r] + col[c]].
struct PackOp {
  const float* src;
  const int* row;
  const int* col;
  int rows, cols;
  int offset;  // floats into the packed buffer
};

struct PackParams {
  float* packed;
  int n_ops;
  PackOp ops[kMaxSteps];
};

namespace {

using gemm_tile::cp_async;
using gemm_tile::cp_async_wait_all;
using gemm_tile::kTileRows;

__global__ void __launch_bounds__(kThreads)
pack_kernel(const __grid_constant__ PackParams p) {
  const PackOp& op = p.ops[blockIdx.y];
  const long long n = (long long)op.rows * op.cols;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / op.cols), c = (int)(i - (long long)r * op.cols);
    p.packed[op.offset + i] = op.src[__ldg(op.row + r) + __ldg(op.col + c)];
  }
}

// Stage rows [r0, r0 + rows) x cols [c0, c0 + cols) of a dense row-major
// (R x C) matrix (ld C) into dst (row stride ld_dst), zero outside
// [0, r_hi) x [0, C).
__device__ __forceinline__ void stage_dense(float* dst, int ld_dst,
                                            const float* src, int C, int r0,
                                            int r_hi, int c0, int rows,
                                            int cols) {
  if (C % 4 == 0 && cols % 4 == 0) {
    const int q = cols / 4;
    for (int idx = threadIdx.x; idx < rows * q; idx += blockDim.x) {
      const int r = idx / q, c = 4 * (idx - r * q);
      const bool ok = r0 + r < r_hi && c0 + c < C;
      cp_async<16>(dst + r * ld_dst + c,
                   ok ? src + (long long)(r0 + r) * C + c0 + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
      const int r = idx / cols, c = idx - r * cols;
      const bool ok = r0 + r < r_hi && c0 + c < C;
      cp_async<4>(dst + r * ld_dst + c,
                  ok ? src + (long long)(r0 + r) * C + c0 + c : src, ok);
    }
  }
}

// Stage rows [r0, r0 + rows) x cols [c0, c0 + cols) of the token-side
// operand, zero outside [0, r_hi) x [0, c_hi) and at tokens >= valid.
__device__ __forceinline__ void stage_token(float* dst, int ld_dst,
                                            const Operand& op,
                                            const float* base, bool in_smem,
                                            int r0, int r_hi, int c0,
                                            int c_hi, int rows, int cols,
                                            int valid) {
  if (op.vec && !in_smem && cols % 4 == 0) {
    const int q = cols / 4;
    for (int idx = threadIdx.x; idx < rows * q; idx += blockDim.x) {
      const int r = idx / q, c = 4 * (idx - r * q);
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < r_hi && gc < c_hi &&
                      (op.row_tok == nullptr || __ldg(op.row_tok + gr) < valid);
      cp_async<16>(dst + r * ld_dst + c, ok ? base + __ldg(op.row + gr) + gc
                                            : base, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int r = idx / cols, c = idx - r * cols;
    const int gr = r0 + r, gc = c0 + c;
    bool ok = gr < r_hi && gc < c_hi;
    if (ok && op.row_tok != nullptr) ok = __ldg(op.row_tok + gr) < valid;
    if (ok && op.col_tok != nullptr) ok = __ldg(op.col_tok + gc) < valid;
    if (in_smem) {
      dst[r * ld_dst + c] = ok ? base[op.row[gr] + op.col[gc]] : 0.f;
    } else {
      cp_async<4>(dst + r * ld_dst + c,
                  ok ? base + __ldg(op.row + gr) + __ldg(op.col + gc) : base,
                  ok);
    }
  }
}

// gemm_tile::kblocks_fold with the register tile's rows a runtime count
// (1 to kTileRows): the host sizes each step's tile.
__device__ __forceinline__ void kblocks_fold_rows(
    int rows, const float* As, int lda, int row0, int row_step,
    const float* Bs, int ldb, int col0, int bk, int n_kb, int kb0,
    float (&tot)[kTileRows][4]) {
  switch (rows) {
    case 1:
      gemm_tile::kblocks_fold<1>(As, lda, row0, row_step, Bs, ldb, col0, bk,
                                 n_kb, kb0, tot);
      break;
    case 2:
      gemm_tile::kblocks_fold<2>(As, lda, row0, row_step, Bs, ldb, col0, bk,
                                 n_kb, kb0, tot);
      break;
    case 3:
      gemm_tile::kblocks_fold<3>(As, lda, row0, row_step, Bs, ldb, col0, bk,
                                 n_kb, kb0, tot);
      break;
    default:
      gemm_tile::kblocks_fold<4>(As, lda, row0, row_step, Bs, ldb, col0, bk,
                                 n_kb, kb0, tot);
  }
}

// __grid_constant__: the step table is read in place from parameter space.
__global__ void __launch_bounds__(kThreads)
fused_kernel(const __grid_constant__ FusedParams p) {
  extern __shared__ __align__(16) float smem[];
  const long long t0 = (long long)blockIdx.x * p.block_tokens;
  const long long rem = p.tokens - t0;
  const int valid = rem < p.block_tokens ? (int)rem : p.block_tokens;
  float* stage = smem + p.tile_offset;

  for (int s = 0; s < p.n_steps; ++s) {
    const ChainStep& st = p.steps[s];
    const int M = st.M, K = st.K, N = st.N;
    const int tm = st.tile_m, tn = st.tile_n, kc = st.kc, bk = st.bk;
    const int n_tx = (tn + 3) / 4, ldb = 4 * n_tx, lda = kc + 4;
    const int n_ty = tm / st.tr;
    float* As = stage;
    float* Bs = stage + tm * lda;
    const int tx = threadIdx.x % n_tx, ty = threadIdx.x / n_tx;
    const bool active = ty < n_ty;
    const bool t_smem = st.t.mid >= 0;
    const float* tbase = t_smem ? smem + p.mid_offset[st.t.mid]
                                : st.t.base + t0 * st.t.tok_stride;
    const float* wbase = p.packed + st.w_offset;
    const int n_kb = (K + bk - 1) / bk;
    for (int m0 = 0; m0 < M; m0 += tm) {
      for (int n0 = 0; n0 < N; n0 += tn) {
        float acc[kTileRows][4];
        for (int k0 = 0; k0 < K; k0 += kc) {
          // one round: rows [m0, m0 + tm) of A and columns [n0, n0 + ldb)
          // of B at k0
          __syncthreads();  // the previous round is done with the tiles
          if (st.w_is_a) {
            stage_dense(As, lda, wbase, K, m0, M, k0, tm, kc);
            stage_token(Bs, ldb, st.t, tbase, t_smem, k0, K, n0, N, kc,
                        ldb, valid);
          } else {
            stage_token(As, lda, st.t, tbase, t_smem, m0, M, k0, K, tm,
                        kc, valid);
            stage_dense(Bs, ldb, wbase, N, k0, K, n0, kc, ldb);
          }
          cp_async_wait_all();
          __syncthreads();
          if (!active) continue;
          const int kb0 = k0 / bk, kbs = min(kc / bk, n_kb - kb0);
          kblocks_fold_rows(st.tr, As, lda, ty, n_ty, Bs, ldb, 4 * tx, bk,
                            kbs, kb0, acc);
        }
        if (!active || 4 * tx >= tn) continue;
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) {
          const int m = m0 + ty + i * n_ty;
          if (i >= st.tr || m >= M) continue;
          const int n = n0 + 4 * tx;
          if (st.out_mid >= 0) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (n + c < N)
                smem[p.mid_offset[st.out_mid] + m * N + n + c] = acc[i][c];
            continue;
          }
          float* yrow = p.y + t0 * p.y_tok_stride + __ldg(st.c_row + m);
          if (st.y_vec && n + 3 < N && __ldg(st.c_col_tok + n + 3) < valid) {
            // Y's columns are the block's tokens, contiguous and aligned
            *reinterpret_cast<float4*>(yrow + n) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            continue;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (n + c >= N) continue;
            const int tok = st.c_row_tok != nullptr ? __ldg(st.c_row_tok + m)
                                                    : __ldg(st.c_col_tok + n + c);
            if (tok < valid) yrow[__ldg(st.c_col + n + c)] = acc[i][c];
          }
        }
      }
    }
    __syncthreads();  // the next step reads this step's interior result
  }
}

}  // namespace

// Two launches on `stream`: the pack of the batch-free operands, then the
// chain over `n_blocks` token blocks.  Returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int fused_path_launch(const PackParams* pack,
                                 const FusedParams* params, int n_blocks,
                                 int smem_bytes, void* stream) {
  if (params->n_steps < 2 || params->n_steps > kMaxSteps || n_blocks < 1 ||
      pack->n_ops < 1 || pack->n_ops > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < params->n_steps; ++s) {
    const ChainStep& st = params->steps[s];
    const int n_tx = (st.tile_n + 3) / 4;
    if (st.bk < 1 || st.bk % 4 != 0 || st.kc < st.bk || st.kc % st.bk != 0 ||
        st.tr < 1 ||
        st.tr > gemm_tile::kTileRows || st.tile_m % st.tr != 0 ||
        n_tx * (st.tile_m / st.tr) > kThreads)
      return (int)cudaErrorInvalidValue;
  }
  int longest = 1;
  for (int i = 0; i < pack->n_ops; ++i) {
    const int n = pack->ops[i].rows * pack->ops[i].cols;
    if (n > longest) longest = n;
  }
  const int pack_blocks = (longest + kThreads - 1) / kThreads;
  pack_kernel<<<dim3(pack_blocks < 1024 ? pack_blocks : 1024, pack->n_ops),
                kThreads, 0, (cudaStream_t)stream>>>(*pack);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  fused_kernel<<<n_blocks, kThreads, smem_bytes,
                 (cudaStream_t)stream>>>(*params);
  return (int)cudaGetLastError();
}

extern "C" int fused_path_max_steps() { return kMaxSteps; }

extern "C" int fused_path_max_tile() { return kThreads * 4 * kTileRows; }

extern "C" const char* fused_path_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
