// Block-level building blocks of the fused bitset kernels for Hopper
// (sm_90a): vc_expand.cu and clique_expand.cu.
//
// A block serves one task row at a time.  Its instance's adjacency (n rows
// of W packed 32-bit words) is staged in shared memory where it fits, or
// read from global memory (L2) through the read-only path where it does not;
// the mask row, and for vertex cover the sol row and the isolated set, sit
// in shared memory beside it.
//
// Vertices are laid out warp-major: word w of a mask (vertices 32w .. 32w+31)
// belongs to warp w mod nwarps, and lane l of that warp owns vertex 32w + l.
// So one __ballot_sync turns a per-vertex predicate into that word of a
// packed set, and a block-wide "first vertex such that" is a
// __reduce_min_sync per warp, then one shared word per warp.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bitset_block {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr uint32_t kNone = 0xffffffffu;  // "no vertex" in a min reduction
// Pivot key of vertex v: (deg(v) + 1) << kKeyBits | (kMaxN - v), deg = -1
// outside the mask.  The largest key is the first vertex of maximum degree,
// as jnp.argmax picks it; n <= kMaxN keeps every key below 2^30.
constexpr int kKeyBits = 15;
constexpr int kMaxN = (1 << kKeyBits) - 1;
// An upper bound of a fused kernel's static shared memory (its reduction
// words; ptxas reports 640-768 bytes), which counts against the block's
// shared memory beside the dynamic part.
constexpr size_t kStaticSmem = 1024;

// The instance's adjacency as the block reads it: rows of `stride` words,
// staged in shared memory (kShared) or in global memory, read through the
// read-only (L2) path.
template <bool kShared>
struct Adj {
  const uint32_t* base;
  int stride;
  __device__ __forceinline__ uint32_t word(int v, int x) const {
    if constexpr (kShared) {
      return base[v * stride + x];
    } else {
      return __ldg(base + static_cast<size_t>(v) * stride + x);
    }
  }
};

// Shared-memory row stride of a staged adjacency: odd, so the 32 lanes of a
// warp, which read word x of 32 consecutive rows, hit 32 different banks.
__host__ __device__ __forceinline__ int staged_stride(int W) { return W | 1; }

// Stage the instance rows adj_g (n rows of W words) into adj_s (row stride
// Ws) with coalesced loads; every thread sees adj_s on return.  A caller
// restaging a buffer the block has been reading syncs the block first.
// Loads, not one bulk async copy (cp.async.bulk on an mbarrier): the copy
// could serve only the odd widths, whose padded stride equals W, and the
// adjacency is staged once a block, before a loop of ~100 sweeps, so its
// staging is not what the kernel waits on.
__device__ __forceinline__ void stage_adj(uint32_t* adj_s, const uint32_t* adj_g, int n,
                                          int W, int Ws) {
  const int words = n * W;
  for (int k = threadIdx.x; k < words; k += blockDim.x) {
    const int r = k / W;
    adj_s[r * Ws + (k - r * W)] = __ldg(adj_g + k);
  }
  __syncthreads();
}

// One thread's share of a degree panel, and after combine() the block's.
struct Panel {
  uint32_t key;   // max pivot key over the vertices v < n
  uint32_t sum0;  // vertex cover: sum of the degrees in the mask (kRules);
                  // max clique: |P|, set by the kernel
  uint32_t sum1;  // max clique: |R|, set by the kernel
  uint32_t u2;    // first vertex of degree 1 (kNone)
  uint32_t u3;    // first vertex of degree 2 whose two neighbours are adjacent (kNone)
  bool iso;       // some vertex of the mask has degree 0
};

// The thread's share of the degree panel of `mask` (shared memory, W words):
// deg(v) = popcount(adj[v] & mask) for v in the mask.  kRules adds what the
// vertex-cover reduction reads: the isolated set (one ballot per word,
// written to iso_words[w] for w < ceil(n / 32)), the first degree-1 vertex,
// and the first degree-2 vertex whose neighbours are adjacent, found word by
// word: the first and last neighbour come from the first and last nonzero
// word of adj[v] & mask (__ffs, __clz), then one bit of the first one's row.
template <bool kShared, bool kRules>
__device__ __forceinline__ Panel panel(const Adj<kShared> adj, const uint32_t* mask, int n,
                                       int W, uint32_t* iso_words) {
  Panel p{0u, 0u, 0u, kNone, kNone, false};
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int Wn = (n + 31) >> 5;
  for (int w = threadIdx.x >> 5; w < Wn; w += nwarps) {  // warp-uniform
    const int v = (w << 5) + lane;
    const bool inside = v < n && ((mask[w] >> lane) & 1u);
    int deg = -1;
    if (inside) {
      deg = 0;
      int fw = -1, lw = -1;
      uint32_t fa = 0, la = 0;
      for (int x = 0; x < W; ++x) {
        const uint32_t b = adj.word(v, x) & mask[x];
        deg += __popc(b);
        if (kRules && b) {
          if (fw < 0) {
            fw = x;
            fa = b;
          }
          lw = x;
          la = b;
        }
      }
      if (kRules) {
        if (deg == 0) {
          p.iso = true;
        } else if (deg == 1) {
          p.u2 = min(p.u2, static_cast<uint32_t>(v));
        } else if (deg == 2) {
          const int first = (fw << 5) + __ffs(fa) - 1;
          const int last = (lw << 5) + 31 - __clz(la);
          if ((adj.word(first, last >> 5) >> (last & 31)) & 1u) {
            p.u3 = min(p.u3, static_cast<uint32_t>(v));
          }
        }
      }
      if (kRules) p.sum0 += static_cast<uint32_t>(deg);
    }
    if (v < n) {
      const uint32_t key =
          (static_cast<uint32_t>(deg + 1) << kKeyBits) | static_cast<uint32_t>(kMaxN - v);
      p.key = max(p.key, key);
    }
    if (kRules) {
      const uint32_t iso = __ballot_sync(kFull, inside && deg == 0);
      if (lane == 0) iso_words[w] = iso;
    }
  }
  return p;
}

// The block's panel from every thread's share; every thread gets it.  `red`
// is 5 x kMaxWarps words of shared memory; the caller syncs the block before
// the next combine() writes it again.
__device__ __forceinline__ Panel combine(Panel p, uint32_t (*red)[kMaxWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const uint32_t key = __reduce_max_sync(kFull, p.key);
  const uint32_t s0 = __reduce_add_sync(kFull, p.sum0);
  const uint32_t s1 = __reduce_add_sync(kFull, p.sum1);
  const uint32_t u2 = __reduce_min_sync(kFull, p.u2);
  const uint32_t u3 = __reduce_min_sync(kFull, p.u3);
  if (lane == 0) {
    red[0][warp] = key;
    red[1][warp] = s0;
    red[2][warp] = s1;
    red[3][warp] = u2;
    red[4][warp] = u3;
  }
  Panel out{0u, 0u, 0u, kNone, kNone, __syncthreads_or(p.iso) != 0};
  for (int w = 0; w < nwarps; ++w) {
    out.key = max(out.key, red[0][w]);
    out.sum0 += red[1][w];
    out.sum1 += red[2][w];
    out.u2 = min(out.u2, red[3][w]);
    out.u3 = min(out.u3, red[4][w]);
  }
  return out;
}

// The block-wide sum of each thread's `v`; every thread gets it.  `slot` is
// kMaxWarps words of shared memory, free again on return.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* slot) {
  const int nwarps = blockDim.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t s = 0;
  for (int w = 0; w < nwarps; ++w) s += slot[w];
  __syncthreads();
  return s;
}

__device__ __forceinline__ int pivot_degree(uint32_t key) {
  return static_cast<int>(key >> kKeyBits) - 1;
}

__device__ __forceinline__ int pivot_vertex(uint32_t key) {
  return kMaxN - static_cast<int>(key & static_cast<uint32_t>(kMaxN));
}

// Threads of a block for n vertices: one warp per 32-vertex word, at most 32.
__host__ __forceinline__ int block_threads(int n) {
  const int words = (n + 31) / 32;
  return 32 * (words < kMaxWarps ? words : kMaxWarps);
}

// The most shared memory a block may use on the current device (dynamic
// and static together), after opting in.
__host__ __forceinline__ cudaError_t max_smem_per_block(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  *bytes = static_cast<size_t>(optin);
  return err;
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, opting in
// above the default 48 KB.
template <typename Kernel, typename... Args>
__host__ cudaError_t launch(Kernel kernel, int blocks, int threads, size_t smem,
                            void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace bitset_block
