// Streaming TT contraction  Y = X . (G_1 ... G_2d)  along a planned path,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/streaming_tt.py
// (_kernel, :77, launched by the pallas_call in streaming_tt_linear, :149;
// K1).  On the TPU every grid step pins all TT cores whole in VMEM and
// contracts one token block against the full core chain, so X is read
// once, Y is written once and no intermediate spills.
//
// What bounds it on this card.  The plans size their token block for
// 8 MiB of VMEM; a Hopper block has at most 227 KB of shared memory, and
// the peak live fp32 set along the committed full-width paths is 0.9-2.2 MB
// at 256 tokens.  Most of that is token-free: the first steps of a typical
// path merge core with core and carry no token edge.  The work per token is
// tiny (two thin GEMMs of K = 16 or 768), so the kernel is bound by memory
// traffic and by latency, far from the fp32 FMA rate.
//
// What the design does about it.  The host compiles (network, path_steps)
// into a step table (kernels/streaming_tt.py::compile_program): one entry
// per pairwise contraction, each a GEMM C[M,N] = A[M,K] B[K,N] whose
// operands are addressed through offset tables (row, shared and column
// multi-indices mapped to element offsets), so one kernel serves every
// plan and path without per-path code.
//
//   1. The token-free steps run first, once per call, each as a grid-wide
//      launch of free_step_kernel into a small device workspace (it stays
//      resident in the 50 MB L2 for the stream that follows).
//   2. stream_kernel then runs one block per token block.  The block
//      stages its X rows in shared memory and walks the token-carrying
//      steps: the token operand lives in shared memory (two ping-pong
//      buffers), the token-free operand is read from the workspace or the
//      cores, and the last step scatters straight into Y in its
//      (tokens, out_dim) layout.  X is read once, Y written once.
//
// The host picks the kernel's token block (a power of two no larger than
// the plan's clamped block) so that both buffers fit the shared-memory
// budget, and raises when even one token does not fit.  Token rows are
// independent and every output element is one fp32 FMA chain in ascending
// shared-index order, so no choice of token block changes a single output
// value, and a row never depends on the other rows of the launch.

#include <cuda_runtime.h>

// The step-table structs cross the C interface (streaming_tt_launch), so
// they have external linkage; the kernels below stay file-local.
constexpr int kThreads = 256;
constexpr int kMaxTokSteps = 16;

// One GEMM of the path:  C[m, n] = sum_k A[row_a[m] + k_a[k]] * B[k_b[k] + col_b[n]]
struct GemmTables {
  const int* row_a;
  const int* k_a;
  const int* k_b;
  const int* col_b;
  int M, K, N;
};

struct FreeStep {
  const float* a;
  const float* b;
  float* c;  // contiguous (M, N): the tensordot layout of the result
  GemmTables t;
};

struct TokStep {
  const float* w;       // token-free operand (workspace or core)
  const int* c_row;     // final step only: Y offsets of the (m, n) result
  const int* c_col;
  GemmTables t;
  int token_is_a;       // token operand is A (else B)
  int src;              // shared buffer holding the token operand
  int dst;              // shared buffer for the result, -1 = Y
};

struct StreamParams {
  const float* x;
  float* y;
  long long tokens;
  int n_in;
  int out_dim;
  int block_tokens;
  int buf0_elems;
  int n_steps;
  TokStep steps[kMaxTokSteps];
};

namespace {

__device__ __forceinline__ float gemm_elem(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           const GemmTables& t, int m, int n) {
  const float* ap = a + __ldg(t.row_a + m);
  const float* bp = b + __ldg(t.col_b + n);
  float s = 0.f;
  for (int k = 0; k < t.K; ++k)
    s = fmaf(ap[__ldg(t.k_a + k)], bp[__ldg(t.k_b + k)], s);
  return s;
}

__global__ void __launch_bounds__(kThreads)
free_step_kernel(const __grid_constant__ FreeStep st) {
  const long long total = (long long)st.t.M * st.t.N;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       o < total; o += (long long)gridDim.x * blockDim.x) {
    int m = (int)(o / st.t.N), n = (int)(o % st.t.N);
    st.c[o] = gemm_elem(st.a, st.b, st.t, m, n);
  }
}

// __grid_constant__: the steps are indexed at run time straight from the
// parameter space, without a per-thread copy of the table
__global__ void __launch_bounds__(kThreads)
stream_kernel(const __grid_constant__ StreamParams p) {
  extern __shared__ float smem[];
  float* buf[2] = {smem, smem + p.buf0_elems};
  const long long t0 = (long long)blockIdx.x * p.block_tokens;
  const long long rem = p.tokens - t0;
  const int valid = rem < p.block_tokens ? (int)rem : p.block_tokens;

  // stage this block's X rows; rows past the last token are zero
  const float* xb = p.x + t0 * p.n_in;
  for (int idx = threadIdx.x; idx < p.block_tokens * p.n_in;
       idx += blockDim.x)
    buf[0][idx] = idx < valid * p.n_in ? xb[idx] : 0.f;
  __syncthreads();

  float* yb = p.y + t0 * p.out_dim;
  const long long y_limit = (long long)valid * p.out_dim;
  for (int s = 0; s < p.n_steps; ++s) {
    const TokStep& st = p.steps[s];
    const float* tok = buf[st.src];
    const float* a = st.token_is_a ? tok : st.w;
    const float* b = st.token_is_a ? st.w : tok;
    const int mn = st.t.M * st.t.N;
    for (int o = threadIdx.x; o < mn; o += blockDim.x) {
      int m = o / st.t.N, n = o - m * st.t.N;
      float v = gemm_elem(a, b, st.t, m, n);
      if (st.dst >= 0) {
        buf[st.dst][o] = v;
      } else {
        long long off = (long long)__ldg(st.c_row + m) + __ldg(st.c_col + n);
        if (off < y_limit) yb[off] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Runs the token-free steps, then the token stream, all on `stream`.
// Returns the first non-zero cudaError_t, else 0.
extern "C" int streaming_tt_launch(const FreeStep* free_steps, int n_free,
                                   const StreamParams* params, int n_blocks,
                                   int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (params->n_steps < 1 || params->n_steps > kMaxTokSteps)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_free; ++i) {
    long long total = (long long)free_steps[i].t.M * free_steps[i].t.N;
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 1024) blocks = 1024;
    if (blocks < 1) blocks = 1;
    free_step_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(free_steps[i]);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  stream_kernel<<<n_blocks, kThreads, smem_bytes, s>>>(*params);
  return (int)cudaGetLastError();
}

extern "C" int streaming_tt_max_steps() { return kMaxTokSteps; }

extern "C" const char* streaming_tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
