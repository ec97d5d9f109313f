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
// Design.  The recurrence in time order; the TPU's chunked reformulation
// (kernel.py:57-84) exists to feed the MXU, and its factored form overflows
// f32 at decays near 1e-30, so it is not carried over.  The value columns of
// one (b, h) are independent given r, k and d, so they are split over blocks:
// grid (B * H, ceil(V / kColsPerBlock)), kColsPerBlock = 16.  Inside a block,
// K is split too: thread (g, sl) owns the register tile S[k, j] of kCols = 4
// value columns j of column group g by the kSliceK = 4 keys k = 4 sl .. 4 sl
// + 3 of slice sl < 16, so each r, k, d value it loads serves 4 columns.  The
// bonus is factored as the TPU kernel's diagonal is (kernel.py:74-79):
// o_j = sum_k r_k S_kj + v_j sum_k r_k u_k k_k, which leaves 3 instructions
// per (k, j) a step.  r, k, clipped d and v of kChunk steps are staged in
// shared memory, double-buffered with cp.async (the next chunk loads while
// this one runs), rows padded with zeros to K = 64 so that no step masks; a
// step reads them as float4 broadcasts.  A step's partial sums of o over a
// slice go to shared memory as one float4; after the chunk, each (t, column)
// sums its 16 slices and is written once, so a step waits on no other lane.
// T needs no padding.
//
// What bounds it.  At RWKV6-3B's prefill (B 4, T 1024, 40 heads, K = V = 64)
// it moves 213 MB (0.064 ms at 3.35 TB/s) and does 671 M (b, t, h, k, v)
// updates at 3 instructions each (~0.07 ms of f32 issue on 132 SMs): bytes
// and issue alike.  Its 640 blocks of two warps keep every SM busy; each
// step's chain is the state's one fma.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxV = 64;
constexpr int kSliceK = 4;                            // keys a thread: one float4
constexpr int kSlices = kMaxK / kSliceK;              // 16 K slices of a column group
constexpr int kCols = 4;                              // value columns a thread: one float4
constexpr int kColsPerBlock = 16;
constexpr int kGroups = kColsPerBlock / kCols;        // 4 column groups a block
constexpr int kThreads = kGroups * kSlices;           // 64
constexpr int kChunk = 8;                             // steps staged at a time
constexpr int kStages = 2;                            // chunks in the shared-memory ring
constexpr int kPartRow = kColsPerBlock + 4;           // padded: the float4 stores miss no bank

struct Stage {
  float r[kChunk][kMaxK];
  float k[kChunk][kMaxK];
  float d[kChunk][kMaxK];
  float v[kChunk][kColsPerBlock];
};

// per step and slice, the slice's partial sums of o for the block's columns
struct Partials {
  float o[kChunk][kSlices][kPartRow];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues this thread's share of the copies of steps t0 .. t0 + n - 1 into st.
// vec: 16-byte copies (K and V multiples of 4 and 16-byte-aligned bases),
// else 4-byte ones.  r, k and d rows are split in the same order as in
// clip_decays, which touches only what this thread copied.
__device__ __forceinline__ void stage_chunk(Stage& st, bool vec, const float* r, const float* k,
                                            const float* decay, const float* v, int b, int h,
                                            int t0, int n, int T, int H, int K, int V, int col0,
                                            int ncols) {
  const int w = vec ? 4 : 1;  // floats a copy
  const int per_row = K / w;
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int tt = i / per_row, kk = (i - tt * per_row) * w;
    const size_t g = ((static_cast<size_t>(b) * T + t0 + tt) * H + h) * K + kk;
    if (vec) {
      cp_async16(&st.r[tt][kk], r + g);
      cp_async16(&st.k[tt][kk], k + g);
      cp_async16(&st.d[tt][kk], decay + g);
    } else {
      cp_async4(&st.r[tt][kk], r + g);
      cp_async4(&st.k[tt][kk], k + g);
      cp_async4(&st.d[tt][kk], decay + g);
    }
  }
  const int vrow = ncols / w;
  for (int i = threadIdx.x; i < n * vrow; i += kThreads) {
    const int tt = i / vrow, jj = (i - tt * vrow) * w;
    const float* src = v + ((static_cast<size_t>(b) * T + t0 + tt) * H + h) * V + col0 + jj;
    if (vec) {
      cp_async16(&st.v[tt][jj], src);
    } else {
      cp_async4(&st.v[tt][jj], src);
    }
  }
}

// Clips to [1e-30, 1] the decays this thread copied into st (its own copies
// are visible to it once they have landed).
__device__ __forceinline__ void clip_decays(Stage& st, bool vec, int n, int K) {
  const int w = vec ? 4 : 1;
  const int per_row = K / w;
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int tt = i / per_row, kk = (i - tt * per_row) * w;
    for (int e = 0; e < w; ++e) st.d[tt][kk + e] = fminf(fmaxf(st.d[tt][kk + e], 1e-30f), 1.f);
  }
}

__global__ void __launch_bounds__(kThreads) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ decay, const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ o, float* __restrict__ sT, int B, int T, int H, int K, int V, int vec) {
  __shared__ __align__(16) Stage stage[kStages];
  __shared__ __align__(16) Partials part;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int col0 = blockIdx.y * kColsPerBlock;  // the block's first column
  const int ncols = min(kColsPerBlock, V - col0);
  const int tid = threadIdx.x;
  const int g = tid / kSlices, sl = tid % kSlices;
  const int jcol = g * kCols;    // the thread's first column within the block
  const int k0 = sl * kSliceK;   // its first key

  // zero the ring: the pads k >= K and columns >= ncols are never copied
  {
    float* all = reinterpret_cast<float*>(stage);
    for (int i = tid; i < static_cast<int>(sizeof(stage) / sizeof(float)); i += kThreads)
      all[i] = 0.f;
  }
  __syncthreads();

  float s[kSliceK][kCols];
  float uk[kSliceK];
  const size_t state0 = static_cast<size_t>(bh) * K * V;
#pragma unroll
  for (int i = 0; i < kSliceK; ++i) {
    const int kk = k0 + i;
    uk[i] = kk < K ? u[h * K + kk] : 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = col0 + jcol + j;
      s[i][j] = (s0 != nullptr && kk < K && col < V)
                    ? s0[state0 + static_cast<size_t>(kk) * V + col]
                    : 0.f;
    }
  }

  // chunk c goes to stage c % kStages, kStages - 1 chunks ahead of the one in use
  const int nchunks = (T + kChunk - 1) / kChunk;
  const auto load = [&](int c) {
    if (c < nchunks) {
      stage_chunk(stage[c % kStages], vec, r, k, decay, v, b, h, c * kChunk,
                  min(kChunk, T - c * kChunk), T, H, K, V, col0, ncols);
    }
    cp_async_commit();  // an empty group past the end keeps the count of groups
  };
  for (int c = 0; c < kStages - 1; ++c) load(c);
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
    load(c + kStages - 1);  // into the stage chunk c - 1 used
    cp_async_wait<kStages - 1>();  // this chunk's copies (by this thread) have landed
    Stage& st = stage[c % kStages];
    clip_decays(st, vec, n, K);
    __syncthreads();  // the chunk is staged; the previous chunk's partials are read

#pragma unroll 2
    for (int tt = 0; tt < n; ++tt) {
      const float4 r4 = *reinterpret_cast<const float4*>(&st.r[tt][k0]);
      const float4 k4 = *reinterpret_cast<const float4*>(&st.k[tt][k0]);
      const float4 d4 = *reinterpret_cast<const float4*>(&st.d[tt][k0]);
      const float4 v4 = *reinterpret_cast<const float4*>(&st.v[tt][jcol]);
      const float rr[kSliceK] = {r4.x, r4.y, r4.z, r4.w};
      const float kv[kSliceK] = {k4.x, k4.y, k4.z, k4.w};
      const float dd[kSliceK] = {d4.x, d4.y, d4.z, d4.w};
      const float vv[kCols] = {v4.x, v4.y, v4.z, v4.w};

      float bonus = 0.f;  // this slice's share of sum_k r_k u_k k_k
#pragma unroll
      for (int i = 0; i < kSliceK; ++i) bonus = fmaf(rr[i] * uk[i], kv[i], bonus);
      float acc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = vv[j] * bonus;
#pragma unroll
      for (int i = 0; i < kSliceK; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          acc[j] = fmaf(rr[i], s[i][j], acc[j]);
          s[i][j] = fmaf(dd[i], s[i][j], kv[i] * vv[j]);
        }
      *reinterpret_cast<float4*>(&part.o[tt][sl][jcol]) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();  // the partials are written; this stage may be refilled

    // each (t, 4 columns) sums its slices and is written once
    if (tid < n * kGroups) {
      const int tt = tid / kGroups, j4 = (tid % kGroups) * kCols;
      float4 sum = *reinterpret_cast<const float4*>(&part.o[tt][0][j4]);
#pragma unroll
      for (int q = 1; q < kSlices; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(&part.o[tt][q][j4]);
        sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
      }
      const float out[kCols] = {sum.x, sum.y, sum.z, sum.w};
      float* row = o + ((static_cast<size_t>(b) * T + t0 + tt) * H + h) * V + col0;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j4 + j < ncols) row[j4 + j] = out[j];
    }
  }

#pragma unroll
  for (int i = 0; i < kSliceK; ++i) {
    const int kk = k0 + i;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = col0 + jcol + j;
      if (kk < K && col < V) sT[state0 + static_cast<size_t>(kk) * V + col] = s[i][j];
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
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = K % 4 == 0 && V % 4 == 0 && aligned(r) && aligned(k) && aligned(v) &&
                  aligned(decay);
  const dim3 grid(B * H, (V + kColsPerBlock - 1) / kColsPerBlock);
  wkv6_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(decay),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(sT), B, T, H, K, V, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
