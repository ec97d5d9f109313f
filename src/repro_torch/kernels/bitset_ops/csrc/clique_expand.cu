// clique_expand for Hopper (sm_90a): max clique's whole expand_tasks
// (src/repro/problems/max_clique.py:56 `expand_tasks`) for a batch of task
// rows in one launch; MIS runs it on the complement adjacency.  It is the
// redesign, for this card, of the Pallas TPU kernel
// src/repro/kernels/bitset_ops/kernel.py:138 `batched_expand_stats`, whose
// panel it computes inside the work that consumes it.
//
// For task row t of instance i = inst[t] (instance 0 when inst is null),
// with adj (B, n, W), masks (the candidate sets P) and sols (the cliques R)
// (T, W) packed 32-bit words, it writes, bit for bit as the JAX package:
// the panel deg(v) = popcount(adj[v] & P) for v in P, |P| and |R|; the first
// vertex u of maximum degree (u = 0 when P is empty) and deg_u; words
// (3, T, W) = [left_mask = adj[u] & P, left_sol = R | bit(u), right_mask =
// P & ~bit(u)]; stats (4, T) = [bound = -(|R| + |P|), terminal_value =
// -|R|, left_bound = -(|R| + 1 + deg_u), right_bound = -(|R| + |P| - 1)];
// is_terminal (T,) = |P| == 0.  right_sol and terminal_sol are R itself:
// the wrapper returns the sols tensor for them.
//
// Design.  As vc_expand.cu without the loop (bitset_block.cuh): the
// instance's adjacency staged in shared memory where it fits (12 KB at
// p_hat300's n = 300, W = 10; 45.6 KB for MIS at n = 600, W = 19), one warp
// per 32-vertex word, the pivot as a __reduce_max_sync of a (degree,
// vertex) key.  A block serves `rows_per_block` consecutive rows, chosen by
// the wrapper so that the grid fills the SMs once (ceil(T / SMs): one row a
// block at the plane's T = 128, eight at 1,024), and stages the adjacency
// again only when a row's instance differs from the one staged, so rows of
// one instance (the plane lays rows out instance-major) share one staging.
// Three block barriers a row.
//
// What bounds it on an H100.  At the max-clique plane's shape it moves
// ~40 KB (adjacency, masks and sols read once, three word rows and four
// scalars a row written): ~0.012 us at 3.35 TB/s; its operations (|P| W x 3
// a row, for the candidates in P) are fewer still.  A launch costs its
// latency and the barriers of one row; what it removes is the ~25 torch
// launches around the panel.

#include "bitset_block.cuh"

namespace {

using namespace bitset_block;

template <bool kShared>
__global__ void __launch_bounds__(1024) clique_expand_kernel(
    const uint32_t* __restrict__ adj, const uint32_t* __restrict__ masks,
    const uint32_t* __restrict__ sols, const int32_t* __restrict__ inst,
    uint32_t* __restrict__ words, int32_t* __restrict__ stats,
    uint8_t* __restrict__ is_terminal, int n, int W, int Ws, int T, int B,
    int rows_per_block) {
  extern __shared__ __align__(128) uint32_t smem[];
  __shared__ uint32_t red[5][kMaxWarps];
  uint32_t* mask = smem + (kShared ? n * Ws : 0);
  const size_t TW = static_cast<size_t>(T) * W;
  const int t0 = blockIdx.x * rows_per_block;
  const int t1 = min(T, t0 + rows_per_block);
  int staged = -1;
  for (int t = t0; t < t1; ++t) {
    const int i = inst == nullptr ? 0 : inst[t];
    if (i < 0 || i >= B) __trap();  // a task of no instance: a caller's bug
    const uint32_t* adj_g = adj + static_cast<size_t>(i) * n * W;
    if constexpr (kShared) {
      if (i != staged) {  // the previous row ended with a block barrier
        stage_adj(smem, adj_g, n, W, Ws);
        staged = i;
      }
    }
    const Adj<kShared> A{kShared ? smem : adj_g, Ws};
    const uint32_t* m_row = masks + static_cast<size_t>(t) * W;
    const uint32_t* s_row = sols + static_cast<size_t>(t) * W;
    uint32_t pm = 0, ps = 0;
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      const uint32_t m = m_row[x];
      mask[x] = m;
      pm += __popc(m);
      ps += __popc(s_row[x]);
    }
    __syncthreads();  // the mask row is in shared memory
    Panel p = panel<kShared, false>(A, mask, n, W, nullptr);
    p.sum0 = pm;
    p.sum1 = ps;
    p = combine(p, red);
    const int deg_u = pivot_degree(p.key);
    const int u = pivot_vertex(p.key);
    const int pc_mask = static_cast<int>(p.sum0);
    const int pc_sol = static_cast<int>(p.sum1);
    uint32_t* out = words + static_cast<size_t>(t) * W;
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      const uint32_t m = mask[x];
      const uint32_t ub = x == (u >> 5) ? 1u << (u & 31) : 0u;
      out[x] = A.word(u, x) & m;     // left_mask: u joins, P & N(u)
      out[TW + x] = s_row[x] | ub;   // left_sol: R + u
      out[2 * TW + x] = m & ~ub;     // right_mask: u discarded
    }
    if (threadIdx.x == 0) {
      stats[t] = -(pc_sol + pc_mask);                // bound
      stats[T + t] = -pc_sol;                        // terminal_value
      stats[2 * T + t] = -(pc_sol + 1 + deg_u);      // left_bound
      stats[3 * T + t] = -(pc_sol + pc_mask - 1);    // right_bound
      is_terminal[t] = pc_mask == 0;
    }
    __syncthreads();  // the next row rewrites mask and red (and may restage)
  }
}

}  // namespace

// Launches on `stream` without synchronising.  Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int clique_expand_launch(const void* adj, const void* masks, const void* sols,
                                    const void* inst, void* words, void* stats,
                                    void* is_terminal, int n, int W, int T, int B,
                                    int rows_per_block, void* stream) {
  if (n <= 0 || W <= 0 || T <= 0 || B <= 0 || n > 32 * W || n > kMaxN ||
      rows_per_block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t limit = 0;
  cudaError_t err = max_smem_per_block(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = block_threads(n);
  const int blocks = (T + rows_per_block - 1) / rows_per_block;
  const size_t row = static_cast<size_t>(W) * sizeof(uint32_t);  // the mask row
  const int Ws = staged_stride(W);
  const size_t staged = static_cast<size_t>(n) * Ws * sizeof(uint32_t) + row;
  const auto* a = static_cast<const uint32_t*>(adj);
  const auto* m = static_cast<const uint32_t*>(masks);
  const auto* s = static_cast<const uint32_t*>(sols);
  const auto* r = static_cast<const int32_t*>(inst);
  auto* w = static_cast<uint32_t*>(words);
  auto* st = static_cast<int32_t*>(stats);
  auto* term = static_cast<uint8_t*>(is_terminal);
  if (staged + kStaticSmem <= limit) {
    err = launch(clique_expand_kernel<true>, blocks, threads, staged, stream, a, m, s, r, w,
                 st, term, n, W, Ws, T, B, rows_per_block);
  } else {  // the adjacency does not fit: read it from L2
    err = launch(clique_expand_kernel<false>, blocks, threads, row, stream, a, m, s, r, w,
                 st, term, n, W, W, T, B, rows_per_block);
  }
  return static_cast<int>(err);
}

extern "C" const char* clique_expand_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
