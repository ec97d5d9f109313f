// wkv6 for Hopper (sm_90a): the CUDA port of the Pallas TPU kernel
// src/repro/kernels/wkv6/kernel.py:92 `wkv6` (body `_wkv6_kernel`,
// kernel.py:31).
//
//   o_t = r_t . (S + (u * k_t) (x) v_t)        S <- diag(d_t) S + k_t (x) v_t
//
// per (batch, head), with r, k, decay (B, T, H, K), v (B, T, H, V), u (H, K),
// an optional initial state s0 (B, H, K, V) (null: zeros), all float32 and
// contiguous.  Out: o (B, T, H, V) and the final state sT (B, H, K, V).
// Decays are clipped to [1e-30, 1], as the TPU kernel's log(clip(d)) at
// kernel.py:113 does.
//
// Design.  The recurrence of wkv6/ref.py in time order; the TPU's chunked
// reformulation (kernel.py:57-84) exists to feed the MXU and its (C, C, K)
// scores are not needed here.  Grid (B * H), 64 threads: thread j owns value
// column j and keeps its column S[:, j] of the f32 state in registers (K <= 64,
// the loop over K unrolled so the array stays in registers).  r_t, k_t, the
// clipped d_t and v_t of 32 steps at a time are staged in shared memory with
// coalesced loads, so a step waits on no global load (each step's r, k and d
// are read by every thread, as broadcasts).  The dot product over K runs in
// four partial sums to shorten its dependency chain.  T needs no padding.
//
// What bounds it.  At RWKV6-3B's prefill (B 4, T 1024, 40 heads, K = V = 64)
// it moves 213 MB (0.064 ms at 3.35 TB/s) and does 4 GFLOP (0.06 ms at
// 67 TFLOP/s f32): bound by bytes.  This first kernel is bound instead by the
// latency of T dependent steps per block, with 160 blocks of 64 threads on
// 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxV = 64;
constexpr int kThreads = 64;  // >= kMaxV and >= kMaxK
constexpr int kChunk = 32;    // steps staged in shared memory at a time

__global__ void __launch_bounds__(kThreads) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ decay,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ o, float* __restrict__ sT, int B, int T, int H, int K,
    int V) {
  __shared__ float rs[kChunk][kMaxK];
  __shared__ float ks[kChunk][kMaxK];
  __shared__ float ds[kChunk][kMaxK];
  __shared__ float vs[kChunk][kMaxV];
  __shared__ float us[kMaxK];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const bool owns = j < V;

  float s[kMaxK];
  const size_t state0 = static_cast<size_t>(bh) * K * V;
#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) {
    s[kk] = (owns && kk < K && s0 != nullptr) ? s0[state0 + static_cast<size_t>(kk) * V + j]
                                              : 0.f;
  }
  if (j < K) us[j] = u[h * K + j];

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int n = min(kChunk, T - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = j; i < n * K; i += kThreads) {
      const int tt = i / K, kk = i - (i / K) * K;
      const size_t g = ((static_cast<size_t>(b) * T + t0 + tt) * H + h) * K + kk;
      rs[tt][kk] = r[g];
      ks[tt][kk] = k[g];
      ds[tt][kk] = fminf(fmaxf(decay[g], 1e-30f), 1.f);
    }
    for (int i = j; i < n * V; i += kThreads) {
      const int tt = i / V, jj = i - (i / V) * V;
      vs[tt][jj] = v[((static_cast<size_t>(b) * T + t0 + tt) * H + h) * V + jj];
    }
    __syncthreads();
    if (owns) {
      for (int tt = 0; tt < n; ++tt) {
        const float vv = vs[tt][j];
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < kMaxK; ++kk) {
          if (kk < K) {
            const float kv = ks[tt][kk] * vv;
            part[kk & 3] += rs[tt][kk] * (s[kk] + us[kk] * kv);
            s[kk] = ds[tt][kk] * s[kk] + kv;
          }
        }
        o[((static_cast<size_t>(b) * T + t0 + tt) * H + h) * V + j] =
            (part[0] + part[1]) + (part[2] + part[3]);
      }
    }
  }
  if (owns) {
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) {
      if (kk < K) sT[state0 + static_cast<size_t>(kk) * V + j] = s[kk];
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising.  Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* decay, const void* u, const void* s0,
                           void* o, void* sT, int B, int T, int H, int K, int V,
                           void* stream) {
  if (B <= 0 || T < 0 || H <= 0 || K <= 0 || V <= 0 || K > kMaxK || V > kMaxV) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  wkv6_kernel<<<B * H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(decay),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(sT), B, T, H, K, V);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
