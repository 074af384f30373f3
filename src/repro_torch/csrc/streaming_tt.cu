// Streaming TT contraction  Y = X . (G_1 ... G_2d)  along a planned path,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/streaming_tt.py
// (_kernel, :77, launched by the pallas_call in streaming_tt_linear, :149;
// K1).  On the TPU every grid step pins all TT cores whole in VMEM and
// contracts one token block against the full core chain, so X is read
// once, Y is written once and no intermediate spills.
//
// What bounds it on this card.  Along every committed full-width path the
// work per token is two thin GEMMs (a "down" step of K = 768 or 2048 into
// 16 columns, an "up" step of K = 16 into 768 or 2048 columns) after four
// token-free core merges; the decode pair's paths are chains of up to five
// token steps of K = 8-256.  At 4-32 tokens that is a few MFLOP: the kernel
// is bound by latency and by how many SMs it reaches, far from the fp32
// FMA rate and from the bytes of X and Y.
//
// What the design does about it.  The host compiles (network, path) into a
// program, per token (kernels/streaming_tt.py::compile_program), and lays
// out every intermediate for the step that reads it:
//
//   1. tt_free_kernel runs all token-free steps in one launch.  Every block
//      stages the cores with cp.async, computes the intermediates (results
//      that other token-free steps read) whole in its shared memory, then
//      its share of the sinks: each token step's token-free operand W,
//      written to the workspace as a dense (K, Qp) matrix (a core read by a
//      token step is copied there).  No block waits on another.  The
//      permutations that the old kernel paid at every FMA are paid here
//      once per element, on write.
//   2. tt_stream_kernel runs token tiles x column slices of the last step
//      (a 4-token decode call reaches as many SMs as the last step has
//      column slices; the host picks both per call, launch_grid).  A block
//      stages its X tile and the steps' W in shared memory with cp.async
//      (16-byte copies; a W over the staging budget, or an X tile that does
//      not fit, is read in place), then runs the token steps: each is, per
//      token, C[p, q] = sum_k T[p, k] W[k, q] with T read through strides
//      and W dense; a thread owns 4 tokens x 4 columns (float4 reads of W).
//      A long K splits into interleaved groups (fixed by the step's shape)
//      that run on separate threads and fold in order.  The result goes
//      through the step's output map into the next step's dense buffer, or
//      into Y (whole float4 stores where Y's layout allows).  It is
//      launched with programmatic dependent launch, so its X staging
//      overlaps the free phase.
//
// Experts.  One launch sequence also runs E experts of one geometry, as
// the reference's jax.vmap of the projection over the stacked expert axis
// runs (src/repro/nn/moe.py:148, one pallas_call whose grid gains a
// leading expert axis): the free phase's grid gains a y axis and the
// stream kernel's a z axis, one index per expert, and each expert reads
// its own cores, X rows, workspace region and Y rows through per-expert
// strides.  Every expert keeps the program and the tile and slice layout
// an unbatched launch at the same token count takes, so its rows are bit
// for bit the unbatched launch's.
//
// Bits.  Every output is one ascending fp32 FMA chain per k-group and an
// ascending fold of the groups; the groups are fixed by the step's shape,
// never by the token count, the tile, the slices or the grid, and a row
// reads no other row.  So no grid changes a bit, and a row's bits do not
// depend on the other rows of the call.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kFreeThreads = 512;
constexpr int kMaxTokSteps = 16;
constexpr int kMaxFreeOps = 16;
constexpr int kMaxCores = 16;
constexpr int kSmemLimit = 232448;

// offset(i) = table ? table[i] : i * stride
struct AxisMap {
  const int* table;
  int stride;
  int pad;
};

// C[m, n] = sum_k A[ra(m) + ka(k)] * B[kb(k) + cb(n)]   (K == 0: A[ra(m) + cb(n)])
// stored at out[orow(m) + ocol(n)].  An operand is its shared-memory copy
// at a_sh / b_sh, else cores[core], else (core -1) ws + off; the result goes
// to shared memory at out_sh, else to ws + out_off.  A copy (K == 0)
// instead walks its dst_len destinations in order: inv maps each to
// m * N + n (a stride where that is the identity), or to -1 for padding,
// which is written as 0.
struct FreeOp {
  AxisMap ra, ka, kb, cb, orow, ocol, inv;
  int a_core, a_off, b_core, b_off;
  int a_sh, b_sh, out_sh, out_off;
  int M, K, N, dst_len;
};

// ops [0, n_inter) are intermediates, computed whole by every block; ops
// [n_inter, n_ops) feed the token steps and are split over the blocks
// An expert (blockIdx.y) reads core i at cores[i] + e * core_stride[i] and
// its workspace region at ws + e * ws_stride.
struct FreeParams {
  const float* cores[kMaxCores];
  float* ws;
  long long ws_stride;
  long long core_stride[kMaxCores];
  int n_ops, n_inter, n_stage, smem_floats, blocks, pad;
  int stage_core[kMaxCores], stage_off[kMaxCores], stage_len[kMaxCores];
  FreeOp ops[kMaxFreeOps];
};

// per token t:  C[p, q] = sum_k T[t*tok_stride + p*ps + k*ks] * W[k*Qp + q]
// stored at dst[t*out_stride + orow(p) + ocol(q)] (dst -1: Y)
struct TokOp {
  AxisMap orow, ocol;
  int P, K, Q, Qp, G;  // G k-groups: group g takes k = g, g + G, ...
  int w_off;   // W in the workspace, dense (K, Qp)
  int w_smem;  // its staged copy in shared memory (floats), -1: read from ws
  int tok_stride, ps, ks;
  int src, dst;
  int out_stride;
  int vec_store;
  int pad;
};

// An expert (blockIdx.z) reads its X rows at x + e * x_stride, its
// workspace region at ws + e * ws_stride and writes Y at y + e * y_stride.
struct StreamParams {
  const float* x;
  float* y;
  const float* ws;
  long long x_stride, y_stride, ws_stride;
  AxisMap xrow, xk;  // relayout of X into a dense (P, K) buffer
  int tokens, n_in, out_dim;
  int tile, n_tiles, slices;
  int x_global;  // the first step reads X in place (its tile does not fit)
  int buf_off[2];
  int part_off;
  int w_last_off;
  int relayout, x_P, x_K;
  int n_steps;
  TokOp steps[kMaxTokSteps];
};

namespace {

__device__ __forceinline__ int at(const AxisMap& m, int i) {
  return m.table ? __ldg(m.table + i) : i * m.stride;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the most recent copy group have landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// this block's expert's workspace region (the free phase's grid y)
__device__ __forceinline__ float* expert_ws(const FreeParams& p) {
  return p.ws + blockIdx.y * p.ws_stride;
}

__device__ __forceinline__ const float* expert_core(const FreeParams& p, int core) {
  return p.cores[core] + blockIdx.y * p.core_stride[core];
}

__device__ __forceinline__ const float* global_operand(const FreeParams& p, int core,
                                                      int off) {
  return core >= 0 ? expert_core(p, core) : expert_ws(p) + off;
}

// one token-free op over items t = tid, tid + nth, ...: row m and the four
// columns r, r + nq, r + 2 nq, r + 3 nq (nq = N / 4 rounded up; columns past
// the edge read the last one and store nothing), so a k step is one load of
// A and four of B, each of them across a warp on consecutive columns, and
// four FMAs.  kShared: both operands sit in shared memory (read with LDS).
template <bool kShared>
__device__ void run_free_op(const FreeParams& p, float* fsm, const FreeOp op,
                            int tid, int nth) {
  const float* a = kShared ? fsm + op.a_sh : global_operand(p, op.a_core, op.a_off);
  const float* b = kShared ? fsm + op.b_sh : global_operand(p, op.b_core, op.b_off);
  const bool strided = !op.ka.table && !op.kb.table;
  const int K = op.K, M = op.M, N = op.N, sa = op.ka.stride, sb = op.kb.stride;
  const int nq = (N + 3) >> 2;
#pragma unroll 1
  for (int t = tid; t < M * nq; t += nth) {
    const int m = t / nq, r = t - m * nq;
    const int ra = at(op.ra, m);
    int cb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cb[j] = at(op.cb, min(r + j * nq, N - 1));
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (strided) {
      const float* ak = a + ra;
      const float* bk = b;
#pragma unroll 2
      for (int k = 0; k < K; ++k, ak += sa, bk += sb) {
        const float av = *ak;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = fmaf(av, bk[cb[j]], v[j]);
      }
    } else {
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        const float av = a[ra + at(op.ka, k)];
        const float* bk = b + at(op.kb, k);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = fmaf(av, bk[cb[j]], v[j]);
      }
    }
    const int row = at(op.orow, m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = r + j * nq;
      if (n >= N) break;
      const int o = row + at(op.ocol, n);
      if (op.out_sh >= 0)
        fsm[op.out_sh + o] = v[j];
      else
        expert_ws(p)[op.out_off + o] = v[j];
    }
  }
}

// one copy of a core into a token step's operand, over destination quads
// d = 4 * (tid, tid + nth, ...): four consecutive workspace floats, one
// float4 store, coalesced whatever the layout permutes
__device__ void run_copy(const FreeParams& p, const FreeOp op, int tid, int nth) {
  const float* a = global_operand(p, op.a_core, op.a_off);
  float4* out = reinterpret_cast<float4*>(expert_ws(p) + op.out_off);
#pragma unroll 1
  for (int q = tid; q < op.dst_len >> 2; q += nth) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = at(op.inv, 4 * q + j);
      v[j] = 0.f;
      if (o >= 0) {
        const int m = o / op.N;
        v[j] = a[at(op.ra, m) + at(op.cb, o - m * op.N)];
      }
    }
    out[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <bool kShared>
__device__ void run_free_ops(const FreeParams& p, float* fsm) {
  // intermediates: whole in every block, so no block waits on another;
  // then the sinks, split over the blocks
  for (int i = 0; i < p.n_inter; ++i) {
    run_free_op<kShared>(p, fsm, p.ops[i], threadIdx.x, blockDim.x);
    __syncthreads();
  }
  for (int i = p.n_inter; i < p.n_ops; ++i)
    if (p.ops[i].K == 0)
      run_copy(p, p.ops[i], blockIdx.x * blockDim.x + threadIdx.x,
               gridDim.x * blockDim.x);
    else
      run_free_op<kShared>(p, fsm, p.ops[i], blockIdx.x * blockDim.x + threadIdx.x,
                           gridDim.x * blockDim.x);
}

__global__ void __launch_bounds__(kFreeThreads)
tt_free_kernel(const __grid_constant__ FreeParams p) {
  // let the stream kernel launch now: it stages X while this runs, and
  // waits for this grid (griddepcontrol.wait) before it reads the workspace
  asm volatile("griddepcontrol.launch_dependents;\n");
  extern __shared__ __align__(16) float fsm[];
  // the cores the ops read, all copies in flight at once
  for (int i = 0; i < p.n_stage; ++i) {
    const float* src = expert_core(p, p.stage_core[i]);
    float* dst = fsm + p.stage_off[i];
    for (int j = threadIdx.x; j < p.stage_len[i]; j += blockDim.x)
      cp_async4(dst + j, src + j, true);
  }
  cp_async_wait_all();
  __syncthreads();
  if (p.smem_floats > 0)
    run_free_ops<true>(p, fsm);
  else
    run_free_ops<false>(p, fsm);
}

// the operands of one expert (the stream kernel's grid z)
struct Expert {
  const float* x;
  float* y;
  const float* ws;
};

// one output vector (token t, row p, columns 4 * q4 .. + 3) of a step
__device__ __forceinline__ void store_out(const StreamParams& p, const Expert& ex,
                                          const TokOp& st, float* smem, int t,
                                          int pp, int q4, float4 v, int t0,
                                          int valid) {
  const int q = 4 * q4;
  const float vals[4] = {v.x, v.y, v.z, v.w};
  if (st.dst >= 0) {
    float* d = smem + p.buf_off[st.dst] + t * st.out_stride + at(st.orow, pp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (q + j < st.Q) d[at(st.ocol, q + j)] = vals[j];
    return;
  }
  if (t >= valid) return;
  float* d = ex.y + (long long)(t0 + t) * p.out_dim + at(st.orow, pp);
  if (st.vec_store) {
    *reinterpret_cast<float4*>(d + q) = v;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (q + j < st.Q) d[at(st.ocol, q + j)] = vals[j];
}

// One token step over the block's tile: items (k-group, 4-token quad, p,
// column vector), 4 x 4 outputs each; with more than one k-group the
// partial sums go to shared memory and fold in group order.
// kXGlobal: the token operand is X in place (first step only); its rows
// past the last token repeat the last row, whose results are never stored.
// kWShared: W is staged in shared memory.  Each combination compiles to
// its own loop, so shared-memory operands are read with LDS.
template <bool kXGlobal, bool kWShared>
__device__ void run_step(const StreamParams& p, const Expert& ex, int s, float* smem,
                         int t0, int valid, int qv_lo, int qv_hi) {
  const TokOp st = p.steps[s];
  const bool last = s == p.n_steps - 1;
  const int lo = last ? qv_lo : 0;
  const int nqv = last ? qv_hi - qv_lo : st.Qp >> 2;
  const float* W = kWShared ? smem + (last ? p.w_last_off : st.w_smem)
                            : ex.ws + st.w_off;
  const int wstride = last ? 4 * nqv : st.Qp;
  const float* T = kXGlobal ? ex.x + (long long)t0 * p.n_in : smem + p.buf_off[st.src];
  const int rmax = kXGlobal ? valid - 1 : p.tile - 1;
  float4* part = reinterpret_cast<float4*>(smem + p.part_off);
  const int nq4 = p.tile >> 2;
  const int P = st.P, G = st.G, K = st.K;
  const int ts = st.tok_stride, ps = st.ps, ks = st.ks;
  const int items = G * nq4 * P * nqv;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int qv = it % nqv;
    int r = it / nqv;
    const int pp = r % P;
    r /= P;
    const int tq = r % nq4;
    const int g = r / nq4;
    const float* a = T + pp * ps;
    int ro[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ro[i] = min(4 * tq + i, rmax) * ts;
    const float* w = W + 4 * qv;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = g; k < K; k += G) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k * wstride);
      const float* ak = a + k * ks;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = ak[ro[i]];
        acc[i][0] = fmaf(av, wv.x, acc[i][0]);
        acc[i][1] = fmaf(av, wv.y, acc[i][1]);
        acc[i][2] = fmaf(av, wv.z, acc[i][2]);
        acc[i][3] = fmaf(av, wv.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (G == 1)
        store_out(p, ex, st, smem, 4 * tq + i, pp, lo + qv, v, t0, valid);
      else
        part[((g * p.tile + 4 * tq + i) * P + pp) * nqv + qv] = v;
    }
  }
  if (G > 1) {
    __syncthreads();
    const int outs = p.tile * P * nqv;
    for (int o = threadIdx.x; o < outs; o += kThreads) {
      const int qv = o % nqv;
      const int r = o / nqv;
      const int pp = r % P;
      const int t = r / P;
      float4 v = part[(t * P + pp) * nqv + qv];
      for (int g = 1; g < G; ++g) {
        const float4 u = part[((g * p.tile + t) * P + pp) * nqv + qv];
        v.x = __fadd_rn(v.x, u.x);
        v.y = __fadd_rn(v.y, u.y);
        v.z = __fadd_rn(v.z, u.z);
        v.w = __fadd_rn(v.w, u.w);
      }
      store_out(p, ex, st, smem, t, pp, lo + qv, v, t0, valid);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
tt_stream_kernel(const __grid_constant__ StreamParams p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int qv_all = p.steps[p.n_steps - 1].Qp >> 2;
  const int qv_lo = (int)((long long)blockIdx.y * qv_all / p.slices);
  const int qv_hi = (int)((long long)(blockIdx.y + 1) * qv_all / p.slices);
  const Expert ex{p.x + blockIdx.z * p.x_stride, p.y + blockIdx.z * p.y_stride,
                  p.ws + blockIdx.z * p.ws_stride};
  const bool x_vec = (p.n_in & 3) == 0 && ((uintptr_t)ex.x & 15) == 0;
  bool staged = false;
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const int t0 = tile * p.tile;
    const int valid = min(p.tile, p.tokens - t0);
    // this tile's X rows; rows past the last token are zero
    float* xs = smem + p.buf_off[p.relayout ? 1 : 0];
    const float* xg = ex.x + (long long)t0 * p.n_in;
    const int n = p.x_global ? 0 : p.tile * p.n_in, lim = valid * p.n_in;
    if (x_vec) {
      for (int i = 4 * tid; i < n; i += 4 * kThreads)
        cp_async16(xs + i, i < lim ? xg + i : ex.x, i < lim);
    } else {
      for (int i = tid; i < n; i += kThreads)
        cp_async4(xs + i, i < lim ? xg + i : ex.x, i < lim);
    }
    // two copy groups on the first tile: X and the operands of the steps
    // before the last, then the last step's slice, which lands while the
    // first steps run
    bool last_pending = false;
    if (!staged) {
      // the workspace is the free phase's: wait for that grid to finish
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int s = 0; s + 1 < p.n_steps; ++s) {
        const TokOp& st = p.steps[s];
        if (st.w_smem >= 0)
          for (int i = tid; i < (st.K * st.Qp) >> 2; i += kThreads)
            cp_async16(smem + st.w_smem + 4 * i, ex.ws + st.w_off + 4 * i, true);
      }
      cp_async_commit();
      const TokOp& st = p.steps[p.n_steps - 1];
      const int w = qv_hi - qv_lo;
      for (int i = tid; i < st.K * w; i += kThreads) {
        const int k = i / w, v = i - k * w;
        cp_async16(smem + p.w_last_off + 4 * i,
                   ex.ws + st.w_off + k * st.Qp + 4 * (qv_lo + v), true);
      }
      cp_async_commit();
      cp_async_wait_one();
      last_pending = p.n_steps > 1;
      if (!last_pending) cp_async_wait_all();
      staged = true;
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (p.relayout) {
      const float* raw = smem + p.buf_off[1];
      float* d = smem + p.buf_off[0];
      const int per = p.x_P * p.x_K;
      for (int i = tid; i < p.tile * per; i += kThreads) {
        const int t = i / per, r = i - t * per;
        const int pp = r / p.x_K, k = r - pp * p.x_K;
        d[i] = raw[t * p.n_in + at(p.xrow, pp) + at(p.xk, k)];
      }
      __syncthreads();
    }
    for (int s = 0; s < p.n_steps; ++s) {
      if (s == p.n_steps - 1 && last_pending) {
        cp_async_wait_all();
        __syncthreads();
      }
      const bool xg = s == 0 && p.x_global;
      const bool wsh = s == p.n_steps - 1 || p.steps[s].w_smem >= 0;
      if (xg)
        wsh ? run_step<true, true>(p, ex, s, smem, t0, valid, qv_lo, qv_hi)
            : run_step<true, false>(p, ex, s, smem, t0, valid, qv_lo, qv_hi);
      else
        wsh ? run_step<false, true>(p, ex, s, smem, t0, valid, qv_lo, qv_hi)
            : run_step<false, false>(p, ex, s, smem, t0, valid, qv_lo, qv_hi);
    }
  }
}

int g_smem_set[64];
int g_free_smem_set[64];

}  // namespace

// Runs the free phase (when the program has token-free ops), then the
// token stream, on `stream`, for `experts` experts of one program: expert
// e reads core i at cores[i] + e * core_strides[i], X at x + e * tokens *
// n_in, its workspace at ws + e * ws_stride, and writes Y at y + e *
// tokens * out_dim (one expert: the strides are not read).  `geo`: tile,
// n_tiles, slices, buf0, buf1, part, w_last (shared-memory offsets in
// floats), blocks, smem bytes, x_global.
// Returns the first non-zero cudaError_t, else 0.
extern "C" int streaming_tt_launch(FreeParams* fp, StreamParams* sp,
                                   const void* const* cores,
                                   const long long* core_strides, int n_cores,
                                   int experts, const float* x, float* y, float* ws,
                                   long long ws_stride, int tokens, const int* geo,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (sp->n_steps < 1 || sp->n_steps > kMaxTokSteps || fp->n_ops > kMaxFreeOps ||
      fp->n_stage > kMaxCores || n_cores > kMaxCores || geo[8] > kSmemLimit ||
      geo[0] % 4 != 0 || (fp->n_ops > 0 && fp->blocks < 1) || experts < 1 ||
      experts > 65535 || geo[2] > 65535 || ws_stride % 4 != 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_cores; ++i) {
    fp->cores[i] = (const float*)cores[i];
    fp->core_stride[i] = experts > 1 ? core_strides[i] : 0;
  }
  fp->ws = ws;
  fp->ws_stride = ws_stride;
  sp->x = x;
  sp->y = y;
  sp->ws = ws;
  sp->x_stride = (long long)tokens * sp->n_in;
  sp->y_stride = (long long)tokens * sp->out_dim;
  sp->ws_stride = ws_stride;
  sp->tokens = tokens;
  sp->tile = geo[0];
  sp->n_tiles = geo[1];
  sp->slices = geo[2];
  sp->buf_off[0] = geo[3];
  sp->buf_off[1] = geo[4];
  sp->part_off = geo[5];
  sp->w_last_off = geo[6];
  sp->x_global = geo[9];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  const bool free_phase = fp->n_ops > 0;
  if (free_phase) {
    const int bytes = 4 * fp->smem_floats;
    if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
    if (bytes > g_free_smem_set[dev]) {
      err = cudaFuncSetAttribute(tt_free_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return (int)err;
      g_free_smem_set[dev] = kSmemLimit;
    }
    tt_free_kernel<<<dim3(fp->blocks, experts), kFreeThreads, bytes, s>>>(*fp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (geo[8] > g_smem_set[dev]) {
    // once per device: the largest size a block may ask for
    err = cudaFuncSetAttribute(tt_stream_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    g_smem_set[dev] = kSmemLimit;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)geo[7], (unsigned)geo[2], (unsigned)experts);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)geo[8];
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = free_phase ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, tt_stream_kernel, *sp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The wrapper checks these against its own before the first launch.
extern "C" void streaming_tt_limits(int* out) {
  out[0] = kMaxTokSteps;
  out[1] = kMaxFreeOps;
  out[2] = kMaxCores;
  out[3] = (int)sizeof(FreeParams);
  out[4] = (int)sizeof(StreamParams);
}

extern "C" const char* streaming_tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
