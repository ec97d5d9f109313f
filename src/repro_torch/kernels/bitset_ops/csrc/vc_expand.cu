// vc_expand for Hopper (sm_90a): vertex cover's whole expand_tasks
// (src/repro/problems/vertex_cover.py:173 `expand_tasks`) for a batch of
// task rows in one launch, its reduction loop included.  It is the
// redesign, for this card, of the Pallas TPU kernel
// src/repro/kernels/bitset_ops/kernel.py:180 `batched_degrees`, whose panel
// it computes inside the work that consumes it: the JAX package calls that
// kernel for the two panels of an explore round and, per lane, inside
// `reduce_instance`'s while_loop.
//
// For task row t of instance i = inst[t] (instance 0 when inst is null),
// with adj (B, n, W), masks and sols (T, W) packed 32-bit words, it writes
// what expand_tasks computes for that lane, bit for bit:
//   1. bound = popcount(sol) + ceil(E / maxdeg) from the degree panel of the
//      raw mask (`lower_bound`, vertex_cover.py:62; E = sum of degrees / 2);
//   2. the reduction (`reduce_instance`, :122): sweeps of `_reduce_step`
//      (:78) until a sweep changes nothing or n + 1 sweeps have run.  Rule
//      1 drops every isolated vertex; else rule 2 takes the first degree-1
//      vertex (its neighbour joins the cover); else rule 3 the first
//      degree-2 vertex whose two neighbours are adjacent (both join);
//   3. from the reduced mask's panel, the first vertex u of maximum degree
//      (u = 0 for an empty mask) and the branch: words (5, T, W) =
//      [left_mask, left_sol, right_mask, right_sol, terminal_sol], stats
//      (5, T) = [bound, terminal_value, left_bound = pc + 1, right_bound =
//      pc + maxdeg, sweeps], is_terminal (T,) = maxdeg <= 0, where pc =
//      popcount(reduced sol) and sweeps is the row's trip count, the last
//      sweep (which changed nothing) included.
//
// Design.  One block per task row (grid T): the row's loop runs to its own
// fixpoint on the card with no host in it, each row independent of the
// others.  At the plane's shape (T = 128, n = 600, W = 19) the 128 blocks
// fill 128 of the 132 SMs, one warp per 32-vertex word (19 warps).  The
// instance's adjacency (45.6 KB there, n * W * 4 bytes) is staged once into
// shared memory by coalesced loads into an odd row stride; adjacencies above
// the block's shared memory (n = 2048, W = 64: 512 KB) are read through the
// read-only path from L2 instead, by the same code with the template
// parameter kShared false, chosen by the launch shape.  mask,
// sol and the isolated set live in shared memory.  A sweep: each thread
// recomputes its vertex's degree with __popc over W words; rule 1's
// isolated set is one __ballot_sync per word and clears the mask word by
// word; rules 2 and 3's first vertex is a __reduce_min_sync per warp and one
// shared word per warp; rule 3 is word-wise (the first and last neighbour by
// __ffs/__clz over adj[v] & mask, then one bit of the first's row): O(n W)
// a sweep, where the JAX sweep unpacks (n, n) bits.  Two block barriers a
// sweep.  The first sweep's panel is the raw mask's (the bound), and the
// last sweep, which changed nothing, leaves the reduced mask's panel (the
// pivot), so no panel is computed twice.
//
// Not taken.  Incremental degree updates: recomputing the panel is n W word
// operations a sweep (11,400 at the plane's shape over 608 threads), cheap
// and plainly exact.  The binary tensor-core product (mma .b1 .and.popc):
// the panel is an AND-popcount product, but of one mask row per block (M =
// 1), so the tensor cores buy nothing.  A CUDA graph of the superstep, which
// would remove the launches around this one: a later step.
//
// What bounds it on an H100.  Its bound is operations: 3 integer
// operations (AND, popcount, add) per word of each sweep's panel, which
// covers the vertices in the mask at that sweep: ~0.005 ms at 67 TOP/s for
// 128 rows of ~100 sweeps of ~500 vertices at n = 600, where its bytes (the
// adjacency, the rows in and out, ~120 KB) take ~0.04 us.  What it waits on
// is the loop's serial chain in each block: the panel's shared-memory
// loads, then the reductions and two barriers, every sweep.
//
// Padding.  Rows past an instance's own n are zero and outside every mask.
// The sweep bound is the padded n + 1, as in the JAX package; it never
// binds (every changing sweep removes a vertex).  A row whose instance is
// outside [0, B) traps.

#include "bitset_block.cuh"

namespace {

using namespace bitset_block;

template <bool kShared>
__global__ void __launch_bounds__(1024) vc_expand_kernel(
    const uint32_t* __restrict__ adj, const uint32_t* __restrict__ masks,
    const uint32_t* __restrict__ sols, const int32_t* __restrict__ inst,
    uint32_t* __restrict__ words, int32_t* __restrict__ stats,
    uint8_t* __restrict__ is_terminal, int n, int W, int Ws, int T, int B) {
  extern __shared__ __align__(128) uint32_t smem[];
  __shared__ uint32_t red[5][kMaxWarps];
  __shared__ uint32_t partial[kMaxWarps];
  const int t = blockIdx.x;
  const int i = inst == nullptr ? 0 : inst[t];
  if (i < 0 || i >= B) __trap();  // a task of no instance: a caller's bug
  const uint32_t* adj_g = adj + static_cast<size_t>(i) * n * W;
  uint32_t* mask = smem + (kShared ? n * Ws : 0);
  uint32_t* sol = mask + W;
  uint32_t* iso = sol + W;
  if constexpr (kShared) stage_adj(smem, adj_g, n, W, Ws);
  const Adj<kShared> A{kShared ? smem : adj_g, Ws};

  uint32_t pc = 0;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    mask[x] = masks[static_cast<size_t>(t) * W + x];
    const uint32_t s = sols[static_cast<size_t>(t) * W + x];
    sol[x] = s;
    pc += __popc(s);
  }
  const uint32_t pc_sol0 = block_sum(pc, partial);  // its barriers publish mask, sol

  const int Wn = (n + 31) >> 5;
  int sweeps = 0;
  bool changed = true;
  int32_t bound = 0;
  Panel p;
  while (changed && sweeps < n + 1) {
    p = combine(panel<kShared, true>(A, mask, n, W, iso), red);
    if (sweeps == 0) {  // the raw mask's panel: the task's lower bound
      const int maxdeg0 = max(pivot_degree(p.key), 0);
      const int E = static_cast<int>(p.sum0 / 2);
      bound = static_cast<int32_t>(pc_sol0) + (maxdeg0 > 0 ? (E + maxdeg0 - 1) / maxdeg0 : 0);
    }
    changed = p.iso || p.u2 != kNone || p.u3 != kNone;
    if (changed) {  // rule 1 > rule 2 > rule 3; each thread owns its words
      const int u = static_cast<int>(p.u2 != kNone ? p.u2 : p.u3);
      for (int x = threadIdx.x; x < W; x += blockDim.x) {
        uint32_t m = mask[x];
        if (p.iso) {
          if (x < Wn) m &= ~iso[x];
        } else {
          const uint32_t nb = A.word(u, x) & m;
          sol[x] |= nb;
          m &= ~nb;
          if (x == (u >> 5)) m &= ~(1u << (u & 31));
        }
        mask[x] = m;
      }
    }
    __syncthreads();  // the next sweep reads the new mask and rewrites red
    ++sweeps;
  }
  if (changed) {  // the n + 1 bound ended the loop: the reduced mask's panel
    p = combine(panel<kShared, false>(A, mask, n, W, nullptr), red);
  }

  const int maxdeg = pivot_degree(p.key);
  const int u = pivot_vertex(p.key);
  const size_t TW = static_cast<size_t>(T) * W;
  uint32_t* out = words + static_cast<size_t>(t) * W;
  pc = 0;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const uint32_t m = mask[x];
    const uint32_t s = sol[x];
    const uint32_t ub = x == (u >> 5) ? 1u << (u & 31) : 0u;
    const uint32_t nb = A.word(u, x) & m;
    out[x] = m & ~ub;               // left_mask: G - u
    out[TW + x] = s | ub;           // left_sol: S + u
    out[2 * TW + x] = m & ~(nb | ub);  // right_mask: G - N[u]
    out[3 * TW + x] = s | nb;       // right_sol: S + N(u)
    out[4 * TW + x] = s;            // terminal_sol
    pc += __popc(s);
  }
  pc = block_sum(pc, partial);
  if (threadIdx.x == 0) {
    const int32_t v = static_cast<int32_t>(pc);
    stats[t] = bound;
    stats[T + t] = v;               // terminal_value
    stats[2 * T + t] = v + 1;       // left_bound
    stats[3 * T + t] = v + maxdeg;  // right_bound
    stats[4 * T + t] = sweeps;
    is_terminal[t] = maxdeg <= 0;
  }
}

}  // namespace

// Launches on `stream` without synchronising.  Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int vc_expand_launch(const void* adj, const void* masks, const void* sols,
                                const void* inst, void* words, void* stats,
                                void* is_terminal, int n, int W, int T, int B,
                                void* stream) {
  if (n <= 0 || W <= 0 || T <= 0 || B <= 0 || n > 32 * W || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t limit = 0;
  cudaError_t err = max_smem_per_block(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = block_threads(n);
  const size_t rows = 3 * static_cast<size_t>(W) * sizeof(uint32_t);  // mask, sol, iso
  const int Ws = staged_stride(W);
  const size_t staged = static_cast<size_t>(n) * Ws * sizeof(uint32_t) + rows;
  const auto* a = static_cast<const uint32_t*>(adj);
  const auto* m = static_cast<const uint32_t*>(masks);
  const auto* s = static_cast<const uint32_t*>(sols);
  const auto* r = static_cast<const int32_t*>(inst);
  auto* w = static_cast<uint32_t*>(words);
  auto* st = static_cast<int32_t*>(stats);
  auto* term = static_cast<uint8_t*>(is_terminal);
  if (staged + kStaticSmem <= limit) {
    err = launch(vc_expand_kernel<true>, T, threads, staged, stream, a, m, s, r, w, st, term,
                 n, W, Ws, T, B);
  } else {  // the adjacency does not fit: read it from L2
    err = launch(vc_expand_kernel<false>, T, threads, rows, stream, a, m, s, r, w, st, term,
                 n, W, W, T, B);
  }
  return static_cast<int>(err);
}

extern "C" const char* vc_expand_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
