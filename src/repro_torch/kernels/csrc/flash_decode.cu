// Split-KV single-token decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_decode_pallas`
// (src/repro/kernels/flash_decode.py, body `_decode_kernel`). One new token
// per sequence, q [B, H, hd], attends over a cache [B, S, KV, hd] at
// positions p <= t (and t - p < window when a window is set): score
// s = (q . k_p) * hd^-0.5 in float32, cap * tanh(s / cap) when a cap is
// set, softmax over the allowed positions, output sum_p softmax_p v_p in
// q's dtype. Query head h = kv * G + g reads KV head kv (G = H / KV). In
// bfloat16 the probabilities are rounded to bfloat16 before the P.V sum, as
// the TPU kernel does (`p.astype(v.dtype)`); l sums them unrounded.
//
// What bounds it on an H100. A call must read K and V at the allowed
// positions once: at gemma2-2b's decode (B 4, KV 4, hd 256, bfloat16,
// t 8191) 4 * 8192 * 4 * 256 * 2 * 2 = 134 MB, 0.040 ms at 3.35 TB/s,
// against 2 * 2 * B * H * hd * (t + 1) = 1.3e8 operations: the bound is
// bytes, and the design keeps every SM streaming.
//
// Layout. The TPU kernel folds the cache's sequence blocks along a
// sequential grid axis into one (m, l, acc) per (b, kv head). Hopper CTAs
// run in parallel and in no order, so the work splits in two kernels:
//   1. `flash_decode_partial`, grid (splits, KV, B): a CTA takes block_s
//      positions of one (b, kv head) and all G query heads of that KV head,
//      so each K/V row it loads serves G heads. Only blocks that hold an
//      allowed position are launched (the host passes the first split and
//      the count; t is a launch argument, so nothing syncs per layer), and
//      inside a block only allowed positions are read. Pass 1: each warp
//      scores rows (16-byte loads, lanes across hd against the queries held
//      in registers, a shuffle sum per head; kRows rows' loads in flight
//      before the first sum) into shared memory. Pass 2: warp g takes head g's block max m, the
//      probabilities p = exp(s - m) and their sum l. Pass 3: each warp
//      accumulates p.V over its rows with lanes across hd; the warps' sums
//      are added in a fixed order. The CTA writes its (m, l, acc) in float32.
//      Pass 3 keeps kRows rows' loads in flight the same way.
//   2. `flash_decode_combine`, grid (KV, B): the LSE merge of the splits'
//      partials, as `lse_merge` in src/repro/models/attention.py:
//      out = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30).
// Every sum runs in a fixed order, so the result does not change from run
// to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kMaxHd = 256;
constexpr int kRows = 4;  // rows a warp has in flight per pass

template <typename T>
struct Vec;  // 16 bytes of T, widened to float
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&x)[N]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static float round(float x) { return x; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&x)[N]) {
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_partial(const T* __restrict__ q, const T* __restrict__ kc,
                         const T* __restrict__ vc, float* __restrict__ part_m,
                         float* __restrict__ part_l, float* __restrict__ part_acc, int S,
                         int KV, int G, int hd, int t, int lo, int block_s, int split0,
                         float scale, float cap) {
  constexpr int N = Vec<T>::N;
  constexpr int kChunks = (kMaxHd + 32 * N - 1) / (32 * N);
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                    // [G][hd] the queries, widened (then in registers)
  float* ss = sq + G * hd;             // [G][block_s] scores, then p
  float* red = ss + G * block_s;       // [kWarps][G][hd] per-warp p.V sums

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int H = KV * G;
  const int start = max((split0 + sp) * block_s, lo);
  const int end = min((split0 + sp + 1) * block_s, t + 1);
  const int n = end - start;  // >= 1: the host launches only blocks with an allowed row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row_stride = static_cast<size_t>(KV) * hd;
  const T* kg = kc + (static_cast<size_t>(b) * S * KV + kvh) * hd;
  const T* vg = vc + (static_cast<size_t>(b) * S * KV + kvh) * hd;

  const T* qg = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) sq[i] = to_float(qg[i]);
  __syncthreads();
  // each lane's dims of the G queries, in registers for the whole pass
  float qr[kMaxG][kChunks][N];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d0 = (c * 32 + lane) * N;
#pragma unroll
      for (int e = 0; e < N; ++e) qr[g][c][e] = (g < G && d0 < hd) ? sq[g * hd + d0 + e] : 0.f;
    }

  // pass 1: scores, lanes across hd; a warp loads kRows rows (strided by
  // kWarps) before it reduces any, so kRows loads per lane are in flight
  for (int r0 = warp; r0 < n; r0 += kWarps * kRows) {
    float x[kRows][kChunks][N];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i * kWarps;
      const T* kr = kg + static_cast<size_t>(start + r) * row_stride;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d0 = (c * 32 + lane) * N;
        if (r < n && d0 < hd) Vec<T>::load(kr + d0, x[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i * kWarps;
      if (r >= n) break;  // warp-uniform
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d0 = (c * 32 + lane) * N;
        if (d0 < hd) {
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
#pragma unroll
              for (int e = 0; e < N; ++e) part[g] += qr[g][c][e] * x[i][c][e];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float s = part[g];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) {
            float y = s * scale;
            if (cap > 0.f) y = cap * tanhf(y / cap);
            ss[g * block_s + r] = y;
          }
        }
      }
    }
  }
  __syncthreads();

  // pass 2: warp g takes head g's block max, probabilities and their sum
  const size_t part_row = (static_cast<size_t>(b) * KV + kvh) * gridDim.x + sp;
  if (warp < G) {
    float* row = ss + warp * block_s;
    float m = -INFINITY;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, row[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float p = expf(row[r] - m);
      l += p;
      row[r] = Vec<T>::round(p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      part_m[part_row * G + warp] = m;
      part_l[part_row * G + warp] = l;
    }
  }
  __syncthreads();

  // pass 3: p.V, lanes across hd, rows split across warps
  float acc[kMaxG][kChunks * N];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < kChunks * N; ++e) acc[g][e] = 0.f;
  for (int r0 = warp; r0 < n; r0 += kWarps * kRows) {
    float x[kRows][kChunks][N];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i * kWarps;
      const T* vr = vg + static_cast<size_t>(start + r) * row_stride;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d0 = (c * 32 + lane) * N;
        if (r < n && d0 < hd) Vec<T>::load(vr + d0, x[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i * kWarps;
      if (r >= n) break;  // warp-uniform
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d0 = (c * 32 + lane) * N;
        if (d0 < hd) {
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float p = ss[g * block_s + r];
#pragma unroll
              for (int e = 0; e < N; ++e) acc[g][c * N + e] += p * x[i][c][e];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d0 = (c * 32 + lane) * N;
    if (d0 < hd) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < N; ++e) red[(warp * G + g) * hd + d0 + e] = acc[g][c * N + e];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w * G * hd + i];
    part_acc[part_row * G * hd + i] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_decode_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
                         const float* __restrict__ part_acc, T* __restrict__ o, int KV, int G,
                         int hd, int n_splits) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const size_t base = (static_cast<size_t>(b) * KV + kvh) * n_splits;
  T* og = o + (static_cast<size_t>(b) * KV * G + static_cast<size_t>(kvh) * G) * hd;
  for (int i = threadIdx.x; i < G * hd; i += kThreads) {
    const int g = i / hd;
    float mg = -INFINITY;
    for (int s = 0; s < n_splits; ++s) mg = fmaxf(mg, part_m[(base + s) * G + g]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float corr = expf(part_m[(base + s) * G + g] - mg);
      den += part_l[(base + s) * G + g] * corr;
      num += part_acc[(base + s) * G * hd + i] * corr;
    }
    store_out(og + i, num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, void* part_m, void* part_l,
           void* part_acc, void* o, int B, int S, int KV, int G, int hd, int t, int lo,
           int block_s, int split0, int n_splits, float scale, float cap, int smem,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(flash_decode_partial<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_decode_partial<T><<<dim3(n_splits, KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc),
      S, KV, G, hd, t, lo, block_s, split0, scale, cap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_decode_combine<T><<<dim3(KV, B), kThreads, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(o), KV, G, hd, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes: both kernels on `stream`; returns
// cudaGetLastError() after each launch (the first failure). The wrapper
// computes lo = max(0, t - window + 1), split0 = lo / block_s and n_splits
// = t / block_s - split0 + 1, allocates the partials
// ([B, KV, n_splits, G] for m and l, [B, KV, n_splits, G, hd] for acc) and
// raises when this is not cudaSuccess. cap <= 0 means no soft cap.
extern "C" int flash_decode_launch(const void* q, const void* kc, const void* vc,
                                   void* part_m, void* part_l, void* part_acc, void* o, int B,
                                   int S, int KV, int G, int hd, int t, int lo, int block_s,
                                   int split0, int n_splits, float scale, float cap, int bf16,
                                   int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(q, kc, vc, part_m, part_l, part_acc, o, B, S, KV, G, hd, t,
                                 lo, block_s, split0, n_splits, scale, cap, smem, s);
  }
  return launch<float>(q, kc, vc, part_m, part_l, part_acc, o, B, S, KV, G, hd, t, lo,
                       block_s, split0, n_splits, scale, cap, smem, s);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
