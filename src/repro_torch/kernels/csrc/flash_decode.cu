// Split-KV single-token decode attention for Hopper (sm_90a), with the
// token's position t read on the device.
//
// Replaces the Pallas TPU kernel `flash_decode_pallas`
// (src/repro/kernels/flash_decode.py, body `_decode_kernel`). One new token
// per sequence, q [B, H, hd], attends over a cache [B, S, KV, hd] at
// positions p <= t (and t - p < window when a window is set): score
// s = (q . k_p) * hd^-0.5 in float32, cap * tanh(s / cap) when a cap is
// set, softmax over the allowed positions, output sum_p softmax_p v_p in
// q's dtype. Query head h = kv * G + g reads KV head kv (G = H / KV). In
// bfloat16 the probabilities are rounded to bfloat16 before the P.V sum, as
// the TPU kernel does (`p.astype(v.dtype)`); l sums them unrounded. As the
// TPU kernel reads t from SMEM at run time, this kernel reads it from a
// device int32: the launch shape depends only on the cache length, the
// window and the split size, nothing syncs with the host, and a call can be
// captured in a CUDA graph and replayed at another t.
//
// What bounds it on an H100. A call must read K and V at the allowed
// positions once: at gemma2-2b's decode (B 4, KV 4, hd 256, bfloat16,
// t 8191) 4 * 8192 * 4 * 256 * 2 * 2 = 134 MB, 0.040 ms at 3.35 TB/s,
// against 2 * 2 * B * H * hd * (t + 1) = 1.3e8 operations: the bound is
// bytes, and the design keeps every SM streaming.
//
// Layout. The TPU kernel folds the cache's sequence blocks along a
// sequential grid axis into one (m, l, acc) per (b, kv head). Hopper CTAs
// run in parallel and in no order, so the grid is (splits, KV, B), the
// split count chosen by the wrapper from the SM count so that both the
// global and the local layer fill the card several times over. Split i of
// (b, kv) takes positions [(blk0 + i) * block_s, (blk0 + i + 1) * block_s)
// clipped to [lo, t], where lo = max(0, t - window + 1) and blk0 =
// lo / block_s, both computed here from t; a split with no allowed position
// does no work. A CTA serves all G query heads of its KV head, so each K/V
// row it loads serves G heads. Each of its 4 warps streams its own rows
// (rounds of kRows rows, interleaved across the warps) through a private
// kStages-deep cp.async ring in shared memory, K and V of a row together;
// each lane copies and then reads only its own 16-byte chunks of a row, so
// the ring needs no barrier, only cp.async.wait_group. A warp keeps a
// running (m, l, acc) per head with lanes across hd (a shuffle sum per
// score), so V's loads overlap K's scoring; the 4 warps' states merge in a
// fixed order into the CTA's partial (m, l, acc), written to global memory.
// The last CTA of each (b, kv) to finish (an atomic counter, zeroed by the
// wrapper for each call, so calls on two streams or in two CUDA graphs share
// none) merges the partials of the splits that hold an
// allowed position, each output a sum in split order (4 outputs a thread,
// their loads from L2 in flight across splits): out = sum acc_s 2^(m_s - M) /
// max(sum l_s 2^(m_s - M), 1e-30), as `lse_merge` in
// src/repro/models/attention.py (in base 2). Every sum runs in a fixed
// order, so the result does not change from run to run.
//
// The soft cap's tanh is tanhf: tanh.approx.f32, faster by a few
// microseconds a call, moved the 2-layer LM check's logits enough to flip a
// greedy near-tie against the CPU (PERF.md), on a step that waits on the
// host anyway.
//
// A t outside [0, S) is not checked on the host (that would sync): the
// kernel then writes NaN to the call's outputs and sets the device error
// word, which the wrapper reads on request (`flash_decode.take_error`) and
// chip_smoke.py checks after its decode runs.
//
// A shard's mergeable partial. Where a cache's sequence is cut into shards
// (the reference's `decode_attend_seqsharded`, src/repro/models/attention.py,
// whose `_partial_attend` this serves), the kernel runs over one shard's
// slice: S positions from global position pos0, rows of a batch `stride_b`
// positions apart (a view of the whole cache, no copy). The allowed range
// is the global [max(0, t - window + 1), t - excl] (excl 1: the reference's
// read-only cache, the new token folded in by the caller) intersected with
// [pos0, pos0 + S); t is checked against the whole cache's length `total`.
// On request the output is float32 and unrounded (`o32`) and the row's
// natural log-sum-exp of the scores goes beside it (`lse`, [B, H]), so the
// shards merge as `lse_merge` does: the split merge below already holds
// M and L in base 2, lse = (M + log2 L) ln 2. A shard with no allowed
// position reads no K or V and writes o = 0, lse = -inf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;    // positions per stage of a warp's ring
constexpr int kStages = 3;  // stages of a warp's ring
constexpr int kMaxHd = 256;
constexpr int kMaxSmem = 128 * 1024;  // dynamic shared memory a launch may ask for
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
struct Vec;  // 16 bytes of T, widened to float
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const unsigned char* p, float (&x)[N]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static float round(float x) { return x; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const unsigned char* p, float (&x)[N]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// cp.async of round j of a warp (rows (j * kWarps + warp) * kRows + r of the
// split, K and V) into its ring slot; each lane copies its own chunks
template <int C>
__device__ __forceinline__ void issue_round(unsigned char* ring, const unsigned char* kg,
                                            const unsigned char* vg, int j, int warp, int lane,
                                            int start, int n, int row_bytes, int chunks,
                                            size_t row_stride) {
  unsigned char* slot = ring + static_cast<size_t>(j % kStages) * kRows * 2 * row_bytes;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = (j * kWarps + warp) * kRows + r;
    if (row < n) {
      const size_t off = static_cast<size_t>(start + row) * row_stride;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int ci = lane + 32 * c;
        if (ci < chunks) {
          cp_async16(slot + (2 * r) * row_bytes + ci * 16, kg + off + ci * 16);
          cp_async16(slot + (2 * r + 1) * row_bytes + ci * 16, vg + off + ci * 16);
        }
      }
    }
  }
}

// T: cache dtype; GM: the G this instantiation holds registers for (G <= GM)
template <typename T, int GM>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ t_dev,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, unsigned* __restrict__ counters,
                        int* __restrict__ error, T* __restrict__ o, float* __restrict__ o32,
                        float* __restrict__ lse, int S, int stride_b, int pos0, int excl,
                        int total, int KV, int G, int hd, int window, int block_s, float c1,
                        float c2, int cap) {
  constexpr int N = Vec<T>::N;                            // elements per 16-byte chunk
  constexpr int C = (kMaxHd * sizeof(T) / 16 + 31) / 32;  // chunks per lane, at most
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned is_last;

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int pair = b * KV + kvh;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = KV * G;
  const size_t out_row = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G;
  T* og = o32 ? nullptr : o + out_row * hd;
  float* og32 = o32 ? o32 + out_row * hd : nullptr;

  const int t = *t_dev;
  if (t < 0 || t >= total) {  // every CTA sees the same t: none touches the counter
    if (sp == 0) {
      const float nan = __int_as_float(0x7fc00000);
      for (int i = tid; i < G * hd; i += kThreads) {
        if (og32) og32[i] = nan; else store_out(og + i, nan);
      }
      if (lse && tid < G) lse[out_row + tid] = nan;
      if (tid == 0) atomicOr(error, 1);
    }
    return;
  }
  // the allowed range in the slice's own positions, [lo, hi]
  const int lo = max(window > 0 ? max(0, t - window + 1) : 0, pos0) - pos0;
  const int hi = min(t - excl, pos0 + S - 1) - pos0;
  const bool empty = hi < lo;  // no allowed position: no split reads anything
  const int blk0 = empty ? 0 : lo / block_s;
  const int n_active = empty ? 0 : hi / block_s - blk0 + 1;  // splits holding an allowed position
  const int start = max((blk0 + sp) * block_s, lo);
  const int n = empty ? 0 : min((blk0 + sp + 1) * block_s, hi + 1) - start;  // <= 0 past hi

  const int row_bytes = hd * static_cast<int>(sizeof(T));
  const int chunks = row_bytes / 16;
  const size_t row_stride = static_cast<size_t>(KV) * row_bytes;  // bytes between positions
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(kc) +
                            (static_cast<size_t>(b) * stride_b * KV + kvh) * row_bytes;
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(vc) +
                            (static_cast<size_t>(b) * stride_b * KV + kvh) * row_bytes;

  if (n > 0) {
    // each lane's chunks of the G queries, widened, in registers
    float qr[GM][C][N];
    const unsigned char* qg = reinterpret_cast<const unsigned char*>(q) +
                              (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * row_bytes;
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int ci = lane + 32 * c;
        if (g < G && ci < chunks) {
          Vec<T>::load(qg + g * row_bytes + ci * 16, qr[g][c]);
        } else {
#pragma unroll
          for (int e = 0; e < N; ++e) qr[g][c][e] = 0.f;
        }
      }

    // this warp's ring: kStages x kRows x (K row, V row)
    unsigned char* ring = smem + static_cast<size_t>(warp) * kStages * kRows * 2 * row_bytes;
    // round j of this warp covers rows (j * kWarps + warp) * kRows + r of the split
    const int first = warp * kRows;
    const int n_rounds = n > first ? (n - first + kWarps * kRows - 1) / (kWarps * kRows) : 0;

    float m[GM], l[GM], acc[GM][C][N];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int e = 0; e < N; ++e) acc[g][c][e] = 0.f;
    }

#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < n_rounds)
        issue_round<C>(ring, kg, vg, j, warp, lane, start, n, row_bytes, chunks, row_stride);
      cp_async_commit();
    }
    for (int j = 0; j < n_rounds; ++j) {
      if (j + kStages - 1 < n_rounds)
        issue_round<C>(ring, kg, vg, j + kStages - 1, warp, lane, start, n, row_bytes, chunks,
                       row_stride);
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // round j has landed (this lane's own chunks)
      const unsigned char* slot = ring + static_cast<size_t>(j % kStages) * kRows * 2 * row_bytes;

      // scores of the round's rows, base 2; -inf past the split's end
      float y[kRows][GM];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool valid = (j * kWarps + warp) * kRows + r < n;  // warp-uniform
        float part[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) part[g] = 0.f;
        if (valid) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int ci = lane + 32 * c;
            if (ci < chunks) {
              float x[N];
              Vec<T>::load(slot + (2 * r) * row_bytes + ci * 16, x);
#pragma unroll
              for (int g = 0; g < GM; ++g)
#pragma unroll
                for (int e = 0; e < N; ++e) part[g] += qr[g][c][e] * x[e];
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float s = warp_sum(part[g]);
          y[r][g] = !valid ? -INFINITY : cap ? tanhf(s * c1) * c2 : s * c1;
        }
      }
      // fold the round into each head's running state
      float p[kRows][GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int r = 0; r < kRows; ++r) m_new = fmaxf(m_new, y[r][g]);
        const float alpha = ex2(m[g] - m_new);
        m[g] = m_new;
        float ps = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          p[r][g] = ex2(y[r][g] - m_new);
          ps += p[r][g];
          p[r][g] = Vec<T>::round(p[r][g]);
        }
        l[g] = l[g] * alpha + ps;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int e = 0; e < N; ++e) acc[g][c][e] *= alpha;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if ((j * kWarps + warp) * kRows + r >= n) break;  // warp-uniform
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int ci = lane + 32 * c;
          if (ci < chunks) {
            float x[N];
            Vec<T>::load(slot + (2 * r + 1) * row_bytes + ci * 16, x);
#pragma unroll
            for (int g = 0; g < GM; ++g)
#pragma unroll
              for (int e = 0; e < N; ++e) acc[g][c][e] += p[r][g] * x[e];
          }
        }
      }
    }
    cp_async_wait<0>();

    // the warps' states, then the CTA's partial, merged in warp order
    __syncthreads();  // every warp is done with its ring: the scratch reuses it
    float* red_m = reinterpret_cast<float*>(smem);  // [kWarps][GM]
    float* red_l = red_m + kWarps * GM;             // [kWarps][GM]
    float* red_acc = red_l + kWarps * GM;           // [kWarps][G][hd]
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        red_m[warp * GM + g] = m[g];
        red_l[warp * GM + g] = l[g];
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int ci = lane + 32 * c;
          if (ci < chunks) {
#pragma unroll
            for (int e = 0; e < N; ++e)
              red_acc[(warp * G + g) * hd + ci * N + e] = acc[g][c][e];
          }
        }
      }
    }
    __syncthreads();
    const size_t part_row = static_cast<size_t>(pair) * n_splits + sp;
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * GM + g]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float corr = ex2(red_m[w * GM + g] - mx);  // 0 for a warp with no rows
        num += red_acc[w * G * hd + i] * corr;
        den += red_l[w * GM + g] * corr;
      }
      part_acc[part_row * G * hd + i] = num;
      if (i % hd == 0) {
        part_m[part_row * G + g] = mx;
        part_l[part_row * G + g] = den;
      }
    }
    __threadfence();  // this thread's partials are visible before the count below
  }

  // the last CTA of this (b, kv) to finish merges the splits' partials
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[pair], 1u) == static_cast<unsigned>(n_splits - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // weights 2^(m_s - M) of the splits holding an allowed position, per head
  float* wt = reinterpret_cast<float*>(smem);  // [n_active][G]
  float* den = wt + n_splits * G;              // [G]
  const size_t base = static_cast<size_t>(pair) * n_splits;
  for (int i = tid; i < n_active * G; i += kThreads) wt[i] = __ldcg(part_m + base * G + i);
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int s = lane; s < n_active; s += 32) mx = fmaxf(mx, wt[s * G + g]);
    mx = warp_max(mx);
    float d = 0.f;
    for (int s = lane; s < n_active; s += 32) {
      const float c = ex2(wt[s * G + g] - mx);
      wt[s * G + g] = c;
      d += __ldcg(part_l + (base + s) * G + g) * c;
    }
    d = warp_sum(d);
    if (lane == 0) {
      den[g] = fmaxf(d, 1e-30f);
      if (lse) lse[out_row + g] = n_active > 0 ? (mx + log2f(d)) * kLn2 : -INFINITY;
    }
  }
  __syncthreads();
  // the outputs, 4 at a time, each a sum over the splits in split order
  const float4* acc4 = reinterpret_cast<const float4*>(part_acc + base * G * hd);
  for (int i = tid; i < G * hd / 4; i += kThreads) {
    const int g = 4 * i / hd;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < n_active; ++s) {
      const float4 a = __ldcg(acc4 + static_cast<size_t>(s) * G * hd / 4 + i);
      const float c = wt[s * G + g];
      num.x += a.x * c;
      num.y += a.y * c;
      num.z += a.z * c;
      num.w += a.w * c;
    }
    if (og32) {
      og32[4 * i] = num.x / den[g];
      og32[4 * i + 1] = num.y / den[g];
      og32[4 * i + 2] = num.z / den[g];
      og32[4 * i + 3] = num.w / den[g];
    } else {
      store_out(og + 4 * i, num.x / den[g]);
      store_out(og + 4 * i + 1, num.y / den[g]);
      store_out(og + 4 * i + 2, num.z / den[g]);
      store_out(og + 4 * i + 3, num.w / den[g]);
    }
  }
}

template <typename T, int GM>
int launch(const void* q, const void* kc, const void* vc, const int* t, void* part_m,
           void* part_l, void* part_acc, unsigned* counters, int* error, void* o, float* o32,
           float* lse, int B, int S, int stride_b, int pos0, int excl, int total, int KV, int G,
           int hd, int window, int block_s, int n_splits, float c1, float c2, int cap, int smem,
           cudaStream_t stream) {
  // once per instantiation: a permission (the wrapper's smem_bytes never
  // passes it), not an allocation (the launch asks for `smem`)
  static const cudaError_t e = cudaFuncSetAttribute(
      flash_decode_kernel<T, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_decode_kernel<T, GM><<<dim3(n_splits, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), t,
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc),
      counters, error, static_cast<T*>(o), o32, lse, S, stride_b, pos0, excl, total, KV, G, hd,
      window, block_s, c1, c2, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_g(const void* q, const void* kc, const void* vc, const int* t, void* part_m,
             void* part_l, void* part_acc, unsigned* counters, int* error, void* o, float* o32,
             float* lse, int B, int S, int stride_b, int pos0, int excl, int total, int KV, int G,
             int hd, int window, int block_s, int n_splits, float c1, float c2, int cap, int smem,
             cudaStream_t stream) {
#define REPRO_DECODE_LAUNCH(GM)                                                               \
  return launch<T, GM>(q, kc, vc, t, part_m, part_l, part_acc, counters, error, o, o32, lse, \
                       B, S, stride_b, pos0, excl, total, KV, G, hd, window, block_s,        \
                       n_splits, c1, c2, cap, smem, stream)
  if (G <= 1) REPRO_DECODE_LAUNCH(1);
  if (G <= 2) REPRO_DECODE_LAUNCH(2);
  if (G <= 4) REPRO_DECODE_LAUNCH(4);
  REPRO_DECODE_LAUNCH(8);
#undef REPRO_DECODE_LAUNCH
}

}  // namespace

// Plain C entry point for ctypes: one launch on `stream`, grid (n_splits,
// KV, B); returns cudaGetLastError() after it. `t` points to a device int32.
// The wrapper chooses block_s and n_splits (`flash_decode.split_plan`:
// n_splits covers every split an allowed range can touch), allocates the
// partials ([B * KV, n_splits, G] for m and l, [B * KV, n_splits, G, hd]
// for acc) and a zeroed counter per (b, kv), all for this call alone, and
// raises when this is not cudaSuccess. cap <= 0 means no soft
// cap (scores s * c1, c1 = scale * log2 e), else tanh(s * c1) * c2 with
// c1 = scale / cap, c2 = cap * log2 e; window <= 0 means no window. The
// cache holds S positions from global position pos0, a batch row every
// stride_b positions; positions up to t - excl are allowed, and t must lie
// in [0, total). o32 and lse, when not null, take a float32 output
// [B, H, hd] (o is then not written) and the rows' log-sum-exp [B, H].
extern "C" int flash_decode_launch(const void* q, const void* kc, const void* vc, const void* t,
                                   void* part_m, void* part_l, void* part_acc, void* counters,
                                   void* error, void* o, void* o32, void* lse, int B, int S,
                                   int stride_b, int pos0, int excl, int total, int KV, int G,
                                   int hd, int window, int block_s, int n_splits, float scale,
                                   float cap, int bf16, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float c1 = cap > 0.f ? scale / cap : scale * kLog2e;
  const float c2 = cap > 0.f ? cap * kLog2e : 0.f;
  const int* tp = static_cast<const int*>(t);
  unsigned* cnt = static_cast<unsigned*>(counters);
  int* err = static_cast<int*>(error);
  float* o32f = static_cast<float*>(o32);
  float* lsef = static_cast<float*>(lse);
  if (bf16) {
    return launch_g<__nv_bfloat16>(q, kc, vc, tp, part_m, part_l, part_acc, cnt, err, o, o32f,
                                   lsef, B, S, stride_b, pos0, excl, total, KV, G, hd, window,
                                   block_s, n_splits, c1, c2, cap > 0.f, smem, s);
  }
  return launch_g<float>(q, kc, vc, tp, part_m, part_l, part_acc, cnt, err, o, o32f, lsef, B, S,
                         stride_b, pos0, excl, total, KV, G, hd, window, block_s, n_splits, c1,
                         c2, cap > 0.f, smem, s);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
