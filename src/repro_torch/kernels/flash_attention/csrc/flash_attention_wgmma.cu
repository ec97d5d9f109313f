// flash_attention on Hopper's tensor cores (sm_90a): the bf16 variant of the
// CUDA port of the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:91
// `flash_attention` (body `_flash_kernel`, kernel.py:29).  The function is the
// one csrc/flash_attention.cu computes:
//
//   out[b, i, hq] = softmax_j(scale * q[b, i, hq] . k[b, j, hk]) @ v[b, :, hk]
//
// with hk = hq / (Hq / Hkv), queries at the end of the key timeline (qpos =
// i + Sk - Sq), keys masked by kpos < Sk, kpos <= qpos (causal) and kpos >
// qpos - window, masked scores -1e30, f32 running max, normalizer and
// accumulator, and the output acc / max(l, 1e-30) rounded once to bf16.
//
// Design.  Grid (ceil(Sq / 64), B * Hq), the q tiles with the most keys first.
// A block is one consumer warpgroup (warps 0-3: 64 query rows of one query
// head) and one producer warp (warp 4).  The producer's lane 0 loads the q
// tile once and then K/V tiles of 64 keys into a ring of kStages stages with
// TMA (cp.async.bulk.tensor.4d over the (D, S, H, B) strides of q, k and v, so
// no transpose or padding: rows past Sq or Sk and columns past D are filled
// with zeros), 128-byte swizzled, each stage completing on its `full`
// mbarrier; the consumer warps release a stage on its `empty` mbarrier, so the
// copy of tile j + 1 runs under the products of tile j.  Per tile:
//   S = Q K^T    wgmma m64n64k16, both operands K-major in shared memory;
//   online softmax in f32 in the accumulator registers: thread t holds rows
//                16 (t / 32) + (t % 32) / 4 (+ 8), a row spread over 4 threads
//                (max and sum by quad shuffles); the scale (times log2 e, for
//                exp2) is applied to the f32 scores; masks only on the
//                diagonal, window-edge and Sk-tail tiles; alpha in registers;
//   O += P V     wgmma m64nDk16 with P from registers (the S fragment repacked
//                as bf16x2 A fragments) and V MN-major (the transpose bit).
// P is carried as kPSplit bf16 terms, p = hi + lo (+ ...), each its own P V
// product: a P rounded to bf16 alone puts ~2^-9 of a row's |p v| into every
// output element, more than one bf16 step of an output that nearly cancels;
// hi + lo keeps ~16 bits.  The tile bounds lo/hi are the TPU kernel's
// (kernel.py:52-59).  D is padded in shared memory to 64 or 128 (one or two
// 64-column panels); the wrapper sends here only bf16 with D % 16 == 0, D <=
// 128 and 16-byte-aligned strides and base pointers (TMA's rule).
//
// cuTensorMapEncodeTiled is taken from the driver through
// cudaGetDriverEntryPoint, so the library links no -lcuda.
//
// What bounds it.  At qwen1.5-0.5b's prefill (B 4, S 1024, 16 heads of 64,
// causal) the call moves 34 MB (0.010 ms at 3.35 TB/s) and does 8.6 GFLOP of
// products (0.009 ms at 989 TFLOP/s bf16; 12.9 GFLOP with P in two terms).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kBq = 64;                 // query rows per block: one wgmma M
constexpr int kBk = 64;                 // keys per K/V tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kConsumers = 128;         // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kPanelCols = 64;          // bf16 columns of one 128-byte swizzled row
constexpr int kPanelBytes = 64 * 128;   // (64 rows x 64 columns) bf16: 8 KB
constexpr int kPSplit = 3;              // bf16 terms of P
constexpr float kNegInf = -1e30f;
constexpr int kMaxGridY = 65535;
// error codes beyond the CUDA runtime's: cuTensorMapEncodeTiled's CUresult
// is returned as kEncodeError + result, a missing driver entry point as
// kNoEncoder
constexpr int kEncodeError = 100000;
constexpr int kNoEncoder = 200000;

struct Params {
  __nv_bfloat16* o;
  int Sq, Sk, Hq, Hkv, D;
  int causal;
  int window;        // <= 0: no window
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the phase of parity `parity` has completed; a wait that
// never ends (a fault in the ring's bookkeeping) traps, so the launch fails
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptors for 128-byte-swizzled tiles (layout type 1
// in bits 62-63), addresses and offsets in 16-byte units.  K-major (q and k:
// rows of 64 bf16 along the product's K): stride 1024 B between 8-row groups,
// the leading offset unused.  MN-major (v, read transposed): stride 1024 B
// between groups of 8 keys (the product's K), leading offset one panel
// between the 64-column halves of D = 128.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kPanelBytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64) (+)= A (64 x 16, shared, K-major) * B (64 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// NP: 64-column panels of D (1: D <= 64, 2: D <= 128)
template <int NP>
__global__ void __launch_bounds__(kThreads) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t q_bar;
  // swizzled tiles start on 1024-byte boundaries
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + NP * kPanelBytes;
  const uint32_t v_s = k_s + kStages * NP * kPanelBytes;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int b = blockIdx.y / p.Hq;
  const int hq = blockIdx.y % p.Hq;
  const int hk = hq / (p.Hq / p.Hkv);
  const int q_offset = p.Sk - p.Sq;

  // the TPU kernel's tile bounds (kernel.py:52-59)
  const int nblocks = (p.Sk + kBk - 1) / kBk;
  int hi = nblocks;
  if (p.causal) hi = min((q0 + kBq - 1 + q_offset) / kBk + 1, nblocks);
  int lo = 0;
  if (p.window > 0) lo = max((q0 + q_offset - p.window + 1) / kBk, 0);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], kConsumers / 32);
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one lane issues every copy
    if (tid == kConsumers) {
      mbar_expect_tx(&q_bar, NP * kPanelBytes);
      for (int c = 0; c < NP; ++c)
        tma_load_4d(q_s + c * kPanelBytes, &tq, &q_bar, c * kPanelCols, q0, hq, b);
      for (int j = lo; j < hi; ++j) {
        const int it = j - lo, st = it % kStages;
        if (it >= kStages) mbar_wait(&empty_bar[st], ((it / kStages) - 1) & 1);
        mbar_expect_tx(&full_bar[st], 2 * NP * kPanelBytes);
        for (int c = 0; c < NP; ++c) {
          const uint32_t off = (st * NP + c) * kPanelBytes;
          tma_load_4d(k_s + off, &tk, &full_bar[st], c * kPanelCols, j * kBk, hk, b);
          tma_load_4d(v_s + off, &tv, &full_bar[st], c * kPanelCols, j * kBk, hk, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
  const int c0 = 2 * (lane % 4);        // its columns in each 8-column block: c0, c0 + 1
  float o[32 * NP];
#pragma unroll
  for (int i = 0; i < 32 * NP; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_part[2] = {0.f, 0.f};  // this thread's share of each row's normalizer

  mbar_wait(&q_bar, 0);
  for (int j = lo; j < hi; ++j) {
    const int it = j - lo, st = it % kStages;
    mbar_wait(&full_bar[st], (it / kStages) & 1);

    // S = Q K^T: 4 * NP k-steps of 16 columns of D (32 bytes within a panel)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
      wgmma_ss(s, desc_kmajor(q_s + off), desc_kmajor(k_s + st * NP * kPanelBytes + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale, mask, tile max.  s[i] is row r0 + 8 * ((i >> 1) & 1), column
    // 8 * (i / 4) + c0 + (i & 1) of the tile
    const int k0 = j * kBk;
    const bool edge = k0 + kBk > p.Sk || (p.causal && k0 + kBk - 1 > q0 + q_offset) ||
                      (p.window > 0 && k0 <= q0 + kBq - 1 + q_offset - p.window);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float x = s[i] * p.scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * (i / 4) + c0 + (i & 1);
        const int qpos = q0 + r0 + 8 * h + q_offset;
        bool ok = kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        x = ok ? x : kNegInf;
      }
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float alpha = exp2f(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_part[h] *= alpha;
#pragma unroll
      for (int i = 0; i < 32 * NP; ++i)
        if (((i >> 1) & 1) == h) o[i] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = exp2f(s[i] - m_run[h]);
      l_part[h] += s[i];
    }

    // P as kPSplit bf16 terms, in the A-fragment layout: for k-step kk (keys
    // 16 kk ..), register rr holds s[8 kk + 2 rr], s[8 kk + 2 rr + 1]
    uint32_t a[kPSplit][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        float x0 = s[8 * kk + 2 * rr], x1 = s[8 * kk + 2 * rr + 1];
#pragma unroll
        for (int t = 0; t < kPSplit; ++t) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
          a[t][kk][rr] = *reinterpret_cast<const uint32_t*>(&h2);
          x0 -= __low2float(h2);
          x1 -= __high2float(h2);
        }
      }
    }

    // O += P V: V's stage read transposed, 16 keys (2 KB) a k-step
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_mnmajor(v_s + st * NP * kPanelBytes + kk * 16 * 128);
#pragma unroll
      for (int t = 0; t < kPSplit; ++t) wgmma_rs(o, a[t][kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[st]);  // this warp is done with the stage
  }

  // epilogue: acc / max(l, 1e-30), rounded once to bf16, rows < Sq, columns < D
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_part[h] += __shfl_xor_sync(0xffffffffu, l_part[h], 1);
    l_part[h] += __shfl_xor_sync(0xffffffffu, l_part[h], 2);
  }
  const float den[2] = {fmaxf(l_part[0], 1e-30f), fmaxf(l_part[1], 1e-30f)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= p.Sq) continue;
    __nv_bfloat16* out =
        p.o + ((static_cast<long long>(b) * p.Sq + row) * p.Hq + hq) * p.D;
#pragma unroll
    for (int x = 0; x < 8 * NP; ++x) {  // 8-column blocks
      const int col = 8 * x + c0;
      if (col < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(o[4 * x + 2 * h] / den[h], o[4 * x + 2 * h + 1] / den[h]);
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// a 4-D map over (D, S, H, B) with element strides (ss, sh, sb), boxes of 64
// columns x 64 rows, 128-byte swizzle, zeros out of bounds
int encode(CUtensorMap* map, const void* base, int D, int S, int H, int B, long long ss,
           long long sh, long long sb) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kPanelCols, kBk, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

template <int NP>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           int B, cudaStream_t stream) {
  const int smem = (1 + 2 * kStages) * NP * kPanelBytes + 1024;  // + alignment slack
  static bool opted_in = false;  // above 48 KB only as opted-in dynamic shared memory
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid((p.Sq + kBq - 1) / kBq, B * p.Hq);
  flash_attention_wgmma_kernel<NP><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: bf16, read through their (b, s, h) strides in elements (the head
// dimension contiguous; every stride a multiple of 8 and every base 16-byte
// aligned); o: a contiguous (B, Sq, Hq, D) bf16 tensor.  Launches on
// `stream` without synchronising; returns 0 on success, a CUDA error code, or
// one of this file's codes above (flash_attention_wgmma_error_string names
// each).
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int Hq,
    int Hkv, int D, long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hkv <= 0 || D <= 0 || D > 2 * kPanelCols ||
      D % 16 != 0 || Hq % Hkv != 0 || static_cast<long long>(B) * Hq > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, D, Sq, Hq, B, qss, qsh, qsb);
  if (rc == 0) rc = encode(&tk, k, D, Sk, Hkv, B, kss, ksh, ksb);
  if (rc == 0) rc = encode(&tv, v, D, Sk, Hkv, B, vss, vsh, vsb);
  if (rc != 0) return rc;
  const Params p{static_cast<__nv_bfloat16*>(o), Sq, Sk, Hq, Hkv, D, causal, window,
                 scale * 1.4426950408889634f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= kPanelCols ? launch<1>(tq, tk, tv, p, B, s) : launch<2>(tq, tk, tv, p, B, s);
}

extern "C" const char* flash_attention_wgmma_error_string(int code) {
  static thread_local char buf[96];
  if (code >= kNoEncoder) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code >= kEncodeError) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed with CUresult %d",
             code - kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
