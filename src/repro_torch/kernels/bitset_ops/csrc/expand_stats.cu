// batched_expand_stats for Hopper (sm_90a): the CUDA port of the Pallas TPU
// kernel src/repro/kernels/bitset_ops/kernel.py:138 `batched_expand_stats`
// (body `_expand_stats_kernel`, kernel.py:95).
//
//   deg[t, v] = popcount(adj[i(t)][v] & masks[t])   if bit v of masks[t] is set
//             = -1                                  otherwise
//   pc[t]     = [popcount(masks[t]), popcount(sols[t])]
//
// adj (B, n, W), masks and sols (T, W) hold packed 32-bit words (int32
// tensors in the port, the same bits as the reference's uint32); inst (T,)
// int32 names each task's instance i(t), and a null inst means instance 0
// for every task.  Out: deg (T, n) and pc (T, 2) int32.
//
// Design.  The layout of degrees.cu: the TPU kernel keeps all of adj in
// VMEM, which 227 KB of shared memory does not hold at large n, so the
// vertex axis is tiled over blocks: grid (ceil(n / 256), min(T, 65535)),
// 256 threads, one vertex per thread, __popc over the W words against task
// t's mask row staged in shared memory.  The blocks with blockIdx.x == 0
// also reduce both popcounts over the W words of the mask and sol rows, from
// registers: each thread sums its strided share, warps reduce with shuffles, and warp 0
// sums the per-warp partials into pc[t].  Blocks loop over t in steps of
// gridDim.y when T > 65535.
//
// What bounds it.  At the max-clique path's shape (T = 128, n = 300,
// W = 10) it reads ~22 KB and writes ~155 KB: ~0.05 us at 3.35 TB/s, so a
// launch costs its launch latency, not its body.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ int warp_sum(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads) batched_expand_stats_kernel(
    const uint32_t* __restrict__ adj, const uint32_t* __restrict__ masks,
    const uint32_t* __restrict__ sols, const int32_t* __restrict__ inst,
    int32_t* __restrict__ deg, int32_t* __restrict__ pc, int n, int W, int T,
    int B) {
  extern __shared__ uint32_t mask_row[];  // task t's mask row, W words
  __shared__ int partial[2][kWarps];
  const bool stats_block = blockIdx.x == 0;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    const int i = inst == nullptr ? 0 : inst[t];
    if (i < 0 || i >= B) __trap();  // a task of no instance: a caller's bug
    const uint32_t* m = masks + static_cast<size_t>(t) * W;
    const uint32_t* s = sols + static_cast<size_t>(t) * W;
    int pm = 0, ps = 0;
    for (int w = threadIdx.x; w < W; w += kThreads) {
      const uint32_t mw = m[w];
      mask_row[w] = mw;
      if (stats_block) {
        pm += __popc(mw);
        ps += __popc(s[w]);
      }
    }
    if (stats_block) {
      pm = warp_sum(pm);
      ps = warp_sum(ps);
      if (lane == 0) {
        partial[0][warp] = pm;
        partial[1][warp] = ps;
      }
    }
    __syncthreads();
    if (stats_block && warp == 0) {
      pm = lane < kWarps ? partial[0][lane] : 0;
      ps = lane < kWarps ? partial[1][lane] : 0;
      pm = warp_sum(pm);
      ps = warp_sum(ps);
      if (lane == 0) {
        pc[2 * static_cast<size_t>(t)] = pm;
        pc[2 * static_cast<size_t>(t) + 1] = ps;
      }
    }
    if (v < n) {
      const uint32_t* row =
          adj + (static_cast<size_t>(i) * n + static_cast<size_t>(v)) * W;
      int d = 0;
      for (int w = 0; w < W; ++w) d += __popc(__ldg(row + w) & mask_row[w]);
      const bool inside = (mask_row[v >> 5] >> (v & 31)) & 1u;
      deg[static_cast<size_t>(t) * n + v] = inside ? d : -1;
    }
    __syncthreads();  // the next task overwrites mask_row and partial
  }
}

}  // namespace

// Launches on `stream` without synchronising.  Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int batched_expand_stats_launch(const void* adj, const void* masks,
                                           const void* sols, const void* inst,
                                           void* deg, void* pc, int n, int W,
                                           int T, int B, void* stream) {
  if (n <= 0 || W <= 0 || T <= 0 || B <= 0 || n > 32 * W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(W) * sizeof(uint32_t);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        batched_expand_stats_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kThreads - 1) / kThreads, T < kMaxGridY ? T : kMaxGridY);
  batched_expand_stats_kernel<<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(adj), static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(sols), static_cast<const int32_t*>(inst),
      static_cast<int32_t*>(deg), static_cast<int32_t*>(pc), n, W, T, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* expand_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
