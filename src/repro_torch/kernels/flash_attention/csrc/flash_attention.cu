// flash_attention for Hopper (sm_90a): the CUDA port of the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:91 `flash_attention` (body
// `_flash_kernel`, kernel.py:29).
//
//   out[b, i, hq] = softmax_j(scale * q[b, i, hq] . k[b, j, hk]) @ v[b, :, hk]
//
// with hk = hq / (Hq / Hkv) (GQA), queries at the end of the key timeline
// (qpos = i + Sk - Sq), keys masked by kpos < Sk, kpos <= qpos (causal) and
// kpos > qpos - window (sliding window), masked scores -1e30, scale applied to
// q in f32, f32 scores, running max, normalizer and accumulator, and the
// output acc / max(l, 1e-30) in q's dtype (float or bfloat16).
//
// Design.  Grid (ceil(Sq / 32), B * Hq): one block of 128 threads per tile of
// 32 queries of one query head.  q, k and v are read in place through their
// (b, s, h) strides, so the TPU wrapper's transposes and K/V padding are gone;
// the tail tile is masked instead.  The q tile is scaled in f32 into shared
// memory once.  The block loops over 64-key tiles from lo to hi, the TPU
// kernel's bounds (kernel.py:52-59: the causal upper bound skips tiles past
// the last query, the window lower bound tiles before the first); each tile
// is staged as f32 in shared memory (K rows padded by one float so that 16
// lanes reading 16 keys hit 16 banks).  Thread t owns rows 4 * (t / 16) + i
// (i < 4): it computes a 4 x 4 block of scores (keys t % 16 + 16 c), four
// threads per row reduce the row's max and sum with shuffles, and the thread
// keeps a 4 x (D / 16) block of the accumulator (columns t % 16 + 16 x) in
// registers.  Any D up to 128 is taken; columns >= D are masked.
//
// What bounds it.  At the prefill shape (B 4, S 1024, 16 heads of 64, causal,
// bf16) it moves 34 MB and does 8.6 GFLOP: 0.010 ms at 3.35 TB/s, 0.009 ms on
// the bf16 tensor cores.  This kernel does the products in f32 on the CUDA
// cores out of shared memory (67 TFLOP/s peak: 0.13 ms), so it is bound by
// operations and shared-memory traffic.  It serves every f32 call (whose
// 1e-5 tolerance TF32 products would break) and the bf16 shapes the
// tensor-core variant, flash_attention_wgmma.cu, does not take (the
// wrapper's select_variant).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBq = 32;                       // query rows per block
constexpr int kBk = 64;                       // keys per tile
constexpr int kThreads = 128;
constexpr int kLanesPerRowGroup = 16;         // threads sharing 4 rows
constexpr int kRows = 4;                      // rows per thread
constexpr int kKeys = kBk / kLanesPerRowGroup;  // keys per thread in a tile: 4
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr int kMaxGridY = 65535;

static_assert(kThreads / kLanesPerRowGroup * kRows == kBq, "rows per block");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, Hq, Hkv, D;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int D) {
  // q tile, K tile (rows padded by one), V tile, probabilities, m, l, alpha
  return sizeof(float) *
         (static_cast<size_t>(kBq) * D + static_cast<size_t>(kBk) * (D + 1) +
          static_cast<size_t>(kBk) * D + kBq * kBk + 3 * kBq);
}

// DC = column chunks of 16 per thread: ceil(D / 16) rounded up to 1, 2, 4, 8
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ldk = D + 1;
  float* qs = smem;               // kBq x D, scaled
  float* ks = qs + kBq * D;       // kBk x (D + 1)
  float* vs = ks + kBk * ldk;     // kBk x D
  float* ps = vs + kBk * D;       // kBq x kBk: scores, then probabilities
  float* m_s = ps + kBq * kBk;    // running max per row
  float* l_s = m_s + kBq;         // normalizer per row
  float* a_s = l_s + kBq;         // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBq;
  const int b = blockIdx.y / p.Hq;
  const int hq = blockIdx.y % p.Hq;
  const int hk = hq / (p.Hq / p.Hkv);
  const int q_offset = p.Sk - p.Sq;

  const T* qg = static_cast<const T*>(p.q) + b * p.qsb + hq * p.qsh;
  const T* kg = static_cast<const T*>(p.k) + b * p.ksb + hk * p.ksh;
  const T* vg = static_cast<const T*>(p.v) + b * p.vsb + hk * p.vsh;

  for (int i = tid; i < kBq * D; i += kThreads) {
    const int r = i / D, d = i - (i / D) * D;
    const int s = q0 + r;
    qs[i] = s < p.Sq ? to_f32(qg[s * p.qss + d]) * p.scale : 0.f;
  }
  if (tid < kBq) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // the TPU kernel's tile bounds (kernel.py:52-59)
  const int nblocks = (p.Sk + kBk - 1) / kBk;
  int hi = nblocks;
  if (p.causal) hi = min((q0 + kBq - 1 + q_offset) / kBk + 1, nblocks);
  int lo = 0;
  if (p.window > 0) lo = max((q0 + q_offset - p.window + 1) / kBk, 0);

  const int rg = tid / kLanesPerRowGroup;  // rows kRows * rg + i
  const int cl = tid % kLanesPerRowGroup;  // keys cl + 16 c, columns cl + 16 x
  float acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int x = 0; x < DC; ++x) acc[i][x] = 0.f;
  __syncthreads();

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kBk;
    for (int i = tid; i < kBk * D; i += kThreads) {
      const int c = i / D, d = i - (i / D) * D;
      const int s = k0 + c;
      const bool in = s < p.Sk;
      ks[c * ldk + d] = in ? to_f32(kg[s * p.kss + d]) : 0.f;
      vs[i] = in ? to_f32(vg[s * p.vss + d]) : 0.f;
    }
    __syncthreads();

    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) sc[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(kRows * rg + i) * D + d];
#pragma unroll
      for (int c = 0; c < kKeys; ++c) kv[c] = ks[(cl + kLanesPerRowGroup * c) * ldk + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kKeys; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = kRows * rg + i;
      const int qpos = q0 + r + q_offset;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int col = cl + kLanesPerRowGroup * c;
        const int kpos = k0 + col;
        bool ok = kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        ps[r * kBk + col] = ok ? sc[i][c] : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax: four consecutive lanes per row
      const int r = tid >> 2, part = tid & 3;
      float* row = ps + r * kBk;
      float mx = kNegInf;
      for (int x = part; x < kBk; x += 4) mx = fmaxf(mx, row[x]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int x = part; x < kBk; x += 4) {
        const float e = expf(row[x] - m_new);
        row[x] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float alpha = a_s[kRows * rg + i];
#pragma unroll
      for (int x = 0; x < DC; ++x) acc[i][x] *= alpha;
    }
    for (int c = 0; c < kBk; ++c) {
      float pr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = ps[(kRows * rg + i) * kBk + c];
#pragma unroll
      for (int x = 0; x < DC; ++x) {
        const int d = cl + kLanesPerRowGroup * x;
        const float vv = d < D ? vs[c * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][x] = fmaf(pr[i], vv, acc[i][x]);
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs and ps
  }

  T* og = static_cast<T*>(p.o) + (static_cast<long long>(b) * p.Sq * p.Hq + hq) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = kRows * rg + i;
    const int s = q0 + r;
    if (s >= p.Sq) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int x = 0; x < DC; ++x) {
      const int d = cl + kLanesPerRowGroup * x;
      if (d < D) og[static_cast<long long>(s) * p.Hq * D + d] = from_f32<T>(acc[i][x] / den);
    }
  }
}

template <typename T, int DC>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D);
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.Sq + kBq - 1) / kBq, p.B * p.Hq);
  flash_attention_kernel<T, DC><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  const int chunks = (p.D + kLanesPerRowGroup - 1) / kLanesPerRowGroup;
  if (chunks <= 1) return launch<T, 1>(p, stream);
  if (chunks <= 2) return launch<T, 2>(p, stream);
  if (chunks <= 4) return launch<T, 4>(p, stream);
  return launch<T, 8>(p, stream);
}

}  // namespace

// q, k, v are read through their (b, s, h) strides in elements (the head
// dimension contiguous); o is a contiguous (B, Sq, Hq, D) tensor.  dtype: 0
// float32, 1 bfloat16.  Launches on `stream` without synchronising and
// returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
    int Hq, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || D <= 0 || D > kMaxD ||
      Hq % Hkv != 0 || static_cast<long long>(B) * Hq > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{q, k, v, o, B, Sq, Sk, Hq, Hkv, D, qsb, qss, qsh, ksb, kss, ksh,
                 vsb, vss, vsh, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
