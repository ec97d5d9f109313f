// batched_degrees for Hopper (sm_90a): the CUDA port of the Pallas TPU kernel
// src/repro/kernels/bitset_ops/kernel.py:180 `batched_degrees` (body
// `_degrees_kernel`, kernel.py:72).
//
//   deg[t, v] = popcount(adj[i(t)][v] & masks[t])   if bit v of masks[t] is set
//             = -1                                  otherwise
//
// adj (B, n, W) and masks (T, W) hold packed 32-bit words (int32 tensors in
// the port, the same bits as the reference's uint32); inst (T,) int32 names
// each task's instance i(t), and a null inst means instance 0 for every
// task (the solo plane).  Out (T, n) int32.
//
// Design.  The TPU kernel keeps the whole adjacency in VMEM and walks a grid
// of 8-task blocks.  227 KB of shared memory per block does not hold adj at
// the sizes the solver runs (n = 2048 is 512 KiB), so here the vertex axis is
// tiled over blocks instead: grid (ceil(n / 256), min(T, 65535)), 256 threads.
// A block stages task t's mask row (W words) in shared memory; each thread
// owns one vertex v and sums __popc(adj[v][w] & mask[w]) over the W words,
// then writes -1 where bit v of the mask is clear.  Blocks with T > 65535
// tasks loop over t in steps of gridDim.y.
//
// What bounds it.  At the solver's main-path shape (T = 128 tasks, n = 600,
// W = 19) the kernel reads about 55 KB and writes 307 KB: about 0.1 us at
// 3.35 TB/s, so one launch costs its launch latency, not its body.  Each
// thread reads its own adjacency row, W words apart from its neighbour's, so
// loads are not coalesced; a transposed (W, n) adjacency layout would fix
// that and is left for when the body, not the launch, is what costs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads) batched_degrees_kernel(
    const uint32_t* __restrict__ adj, const uint32_t* __restrict__ masks,
    const int32_t* __restrict__ inst, int32_t* __restrict__ out, int n, int W,
    int T, int B) {
  extern __shared__ uint32_t mask_row[];
  const int v = blockIdx.x * kThreads + threadIdx.x;
  for (int t = blockIdx.y; t < T; t += gridDim.y) {
    const int i = inst == nullptr ? 0 : inst[t];
    if (i < 0 || i >= B) __trap();  // a task of no instance: a caller's bug
    const uint32_t* m = masks + static_cast<size_t>(t) * W;
    for (int w = threadIdx.x; w < W; w += kThreads) mask_row[w] = m[w];
    __syncthreads();
    if (v < n) {
      const uint32_t* row =
          adj + (static_cast<size_t>(i) * n + static_cast<size_t>(v)) * W;
      int deg = 0;
      for (int w = 0; w < W; ++w) deg += __popc(__ldg(row + w) & mask_row[w]);
      const bool inside = (mask_row[v >> 5] >> (v & 31)) & 1u;
      out[static_cast<size_t>(t) * n + v] = inside ? deg : -1;
    }
    __syncthreads();  // the next task overwrites mask_row
  }
}

}  // namespace

// Launches on `stream` without synchronising.  Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int batched_degrees_launch(const void* adj, const void* masks,
                                      const void* inst, void* out, int n,
                                      int W, int T, int B, void* stream) {
  if (n <= 0 || W <= 0 || T <= 0 || B <= 0 || n > 32 * W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(W) * sizeof(uint32_t);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        batched_degrees_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kThreads - 1) / kThreads, T < kMaxGridY ? T : kMaxGridY);
  batched_degrees_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(adj), static_cast<const uint32_t*>(masks),
      static_cast<const int32_t*>(inst), static_cast<int32_t*>(out), n, W, T,
      B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitset_ops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
