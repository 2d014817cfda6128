// Dense score + top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `score_topk_pallas`
// (src/repro/kernels/score_topk.py, body `_score_topk_kernel`). For every
// query q [dim] and every document row d [dim] it takes the score
// sum_{x < dim} q[x] * d[x] in float32, and keeps each query's top k
// documents ordered by (score desc, id asc); empty slots stay (-inf, -1)
// when k exceeds the corpus. Rows are float32 or bfloat16; bfloat16 values
// are widened to float32 on load (the product of two bfloat16 values is
// exact in float32).
//
// What bounds it on an H100. A call must read the document matrix once
// (n_d * dim * 4 bytes: 16 GiB for 2^24 x 256 float32, 5.1 ms at 3.35 TB/s)
// and do 2 * n_q * n_d * dim float32 operations on the CUDA cores (64
// queries over 2^24 x 256: 5.5e11, 8.2 ms at 128 FMA lanes x 2 x 132 SMs x
// 1.98 GHz = 66.9e12/s). TF32 tensor cores would be faster but keep ~10
// bits of mantissa, and the reference is checked to 1e-5: the bound is
// operations, on the float32 pipe.
//
// Layout. The TPU kernel carries its top-k state in its output refs across
// sequential grid steps; Hopper CTAs run in parallel and in no order, so
// the work splits in two kernels, as in lexical_scan.cu:
//   1. `score_topk_partial`, grid (query groups, doc splits), group index
//      fastest: the CTAs of one split run together and read the same rows
//      through L2. A CTA holds its group's queries (as float32) and each
//      query's candidate buffer in shared memory; each query's running
//      top-k_pad list lives in its row of the partial output and comes into
//      shared memory only to be merged with a full buffer. The CTA walks its
//      split in tiles of `tile_docs` rows. Thread t owns kRows rows of the tile
//      and kQ queries (its slot's), so each element it loads from shared
//      memory feeds several independent fused multiply-adds (kRows x kQ
//      accumulators in registers). A tile is staged kStageBytes (one L2
//      line) of every row at a time, double-buffered: cp.async copies of
//      the next stage land while the current one is scored. A staged row is
//      padded to 36 words, so a quarter-warp's 16-byte loads of 8
//      consecutive rows hit 32 distinct banks; a query chunk is one broadcast load. Each score is
//      summed x = 0, 1, 2, ... in order, one __fmaf_rn per element. A score
//      that is ahead of its query's current k-th entry is appended to that
//      query's candidate buffer (a warp ballot and one shared atomic per
//      warp); a full buffer is bitonic-sorted and merged into the state
//      (topk_merge.cuh). Each CTA leaves its sorted top k_pad per query.
//   2. `score_topk_merge`, grid (n_q): folds the n_splits partial lists with
//      the same (score desc, id asc) bitonic merge.
// Both merges depend only on the values, so the result is the exact
// lexicographic top k of the kernel's scores whatever the group, split and
// tile sizes are.
//
// Shared memory per CTA: two stage buffers (2 x tile_docs x 144 bytes),
// slots x kQ x dim float32 queries, group x cap x 8 bytes of candidates
// (8 KB per query at k = 1000) and one k_pad x 8 bytes state for the merge;
// the wrapper sizes the group to fit 227 KB (16 queries at k = 1000, dim
// 256, float32). Fewer groups means fewer passes over the documents: each
// group's CTAs stream the whole corpus through L2.
//
// Float bits. Each score is one float32 sum in a fixed order with fused
// multiply-adds (__fmaf_rn stays fused under the build's --fmad=false). The
// plain PyTorch version sums through a matrix product in another order, so
// the two agree to the reference's 1e-5, and to the bit where every
// product and partial sum is exact (integer-valued inputs).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "topk_merge.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRows = 2;  // rows one thread scores per tile
constexpr int kQ = 8;  // queries one thread scores each row against
constexpr int kStageBytes = 128;  // bytes of every row staged per step: one L2 line
constexpr int kChunks = kStageBytes / 16;
constexpr int kRowStride = kStageBytes + 16;  // 36 words: conflict-free 16-byte loads

// One 16-byte chunk of a staged row, widened to float32.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ static __forceinline__ void load(const unsigned char* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static __forceinline__ void load(const unsigned char* p, float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
score_topk_partial(const T* __restrict__ q,     // [n_q, dim]
                   const T* __restrict__ docs,  // [n_d, dim]
                   float* __restrict__ part_s,  // [n_q, n_splits, k_pad]
                   int* __restrict__ part_i,
                   int n_q, int dim, int n_d, int k, int k_pad, int cap,
                   int group, int slots, int split_rows, int n_splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kDims = kStageBytes / static_cast<int>(sizeof(T));  // per stage
  constexpr int kN = Chunk<T>::kN;
  const int q0 = blockIdx.x * group;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int d_begin = split * split_rows;
  const int d_end = min(n_d, d_begin + split_rows);
  const int row_bytes = dim * static_cast<int>(sizeof(T));
  const int n_stages = row_bytes / kStageBytes;
  const int lanes = kThreads / slots;  // doc lanes per query slot, >= 32
  const int tile_docs = lanes * kRows;
  const int slot = tid / lanes;  // warp-uniform
  const int ld = tid - slot * lanes;
  const int n_here = min(group, n_q - q0);
  const int q_rows = slots * kQ;

  unsigned char* buf = smem;  // [2][tile_docs][kRowStride] bytes
  float* qs = reinterpret_cast<float*>(smem + 2 * tile_docs * kRowStride);  // [q_rows, dim]
  float* cd_s = qs + q_rows * dim;  // [group, cap]
  int* cd_i = reinterpret_cast<int*>(cd_s + group * cap);
  float* st_s = reinterpret_cast<float*>(cd_i + group * cap);  // [k_pad]: one query's state
  int* st_i = reinterpret_cast<int*>(st_s + k_pad);
  float* thr_s = reinterpret_cast<float*>(st_i + k_pad);
  int* thr_i = reinterpret_cast<int*>(thr_s + group);
  int* cnt = thr_i + group;
  // each query's running top-k_pad lives in its row of the partial output
  // (read and written only at a flush); shared memory holds its candidates
  const long long row0 = (static_cast<long long>(q0) * n_splits + split) * k_pad;
  const long long row_step = static_cast<long long>(n_splits) * k_pad;

  for (int t = tid; t < n_here * k_pad; t += kThreads) {
    const int g = t / k_pad;
    const long long o = row0 + g * row_step + (t - g * k_pad);
    part_s[o] = -CUDART_INF_F;
    part_i[o] = -1;
  }
  // the group's queries as float32; rows past the group's last query are
  // zero (scored, never kept)
  for (int t = tid; t < q_rows * dim; t += kThreads) {
    qs[t] = t < n_here * dim ? to_f32(q[static_cast<long long>(q0) * dim + t]) : 0.0f;
  }
  for (int g = tid; g < group; g += kThreads) {
    thr_s[g] = -CUDART_INF_F;
    thr_i[g] = -1;
    cnt[g] = 0;
  }
  __syncthreads();

  // sort query g's candidates and merge them into its state (cap is a power
  // of two >= every count the buffer reaches); the state comes into shared
  // memory for the merge and goes back
  auto flush = [&](int g) {
    float* gs = part_s + row0 + g * row_step;
    int* gi = part_i + row0 + g * row_step;
    for (int t = tid; t < k_pad; t += kThreads) {
      st_s[t] = gs[t];
      st_i[t] = gi[t];
    }
    topk::flush_candidates(st_s, st_i, cd_s + g * cap, cd_i + g * cap, cnt + g,
                           thr_s + g, thr_i + g, k_pad, k);
    for (int t = tid; t < k_pad; t += kThreads) {
      gs[t] = st_s[t];
      gi[t] = st_i[t];
    }
    __syncthreads();
  };

  const unsigned char* src = reinterpret_cast<const unsigned char*>(docs);
  for (int d0 = d_begin; d0 < d_end; d0 += tile_docs) {
    const int nt = min(tile_docs, d_end - d0);
    for (int g = 0; g < n_here; ++g) {
      if (cnt[g] + tile_docs > cap) flush(g);
    }
    const unsigned char* rows = src + static_cast<long long>(d0) * row_bytes;
    // stage st of the tile: kStageBytes of every row, 16-byte asynchronous
    // copies, consecutive threads on consecutive pieces of a row
    auto issue = [&](int st) {
      unsigned char* dst = buf + (st & 1) * tile_docs * kRowStride;
      for (int c = tid; c < nt * kChunks; c += kThreads) {
        const int r = c / kChunks;
        const int x = c - r * kChunks;
        __pipeline_memcpy_async(
            dst + r * kRowStride + x * 16,
            rows + static_cast<long long>(r) * row_bytes + st * kStageBytes + x * 16, 16);
      }
      __pipeline_commit();
    };

    float acc[kRows][kQ];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[r][j] = 0.0f;
    }
    issue(0);
    for (int st = 0; st < n_stages; ++st) {
      if (st + 1 < n_stages) {
        issue(st + 1);  // the next stage lands while this one is scored
      } else {
        __pipeline_commit();  // an empty group keeps the count uniform
      }
      __pipeline_wait_prior(1);
      __syncthreads();
      const unsigned char* tile = buf + (st & 1) * tile_docs * kRowStride;
      const float* qst = qs + slot * kQ * dim + st * kDims;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float x[kRows][kN];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          Chunk<T>::load(tile + (ld + r * lanes) * kRowStride + c * 16, x[r]);
        }
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          const float* qv = qst + j * dim + c * kN;
#pragma unroll
          for (int e = 0; e < kN; e += 4) {
            const float4 w = *reinterpret_cast<const float4*>(qv + e);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              acc[r][j] = __fmaf_rn(w.x, x[r][e], acc[r][j]);
              acc[r][j] = __fmaf_rn(w.y, x[r][e + 1], acc[r][j]);
              acc[r][j] = __fmaf_rn(w.z, x[r][e + 2], acc[r][j]);
              acc[r][j] = __fmaf_rn(w.w, x[r][e + 3], acc[r][j]);
            }
          }
        }
      }
      __syncthreads();  // every warp is done with this buffer before its refill
    }

    // threshold filter: strictly ahead of the query's current k-th entry
    // (ids are distinct); g is warp-uniform, so the ballot is per query
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int doc = ld + r * lanes;
      const int gid = d0 + doc;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int g = slot * kQ + j;
        if (g < n_here) {
          const float s = acc[r][j];
          const bool take =
              doc < nt && (s > thr_s[g] || (s == thr_s[g] && gid < thr_i[g]));
          const unsigned mask = __ballot_sync(kFullMask, take);
          if (mask) {
            const int leader = __ffs(mask) - 1;
            int base = 0;
            if (lane == leader) base = atomicAdd(&cnt[g], __popc(mask));
            base = __shfl_sync(kFullMask, base, leader);
            if (take) {
              const int pos = base + __popc(mask & ((1u << lane) - 1u));
              cd_s[g * cap + pos] = s;
              cd_i[g * cap + pos] = gid;
            }
          }
        }
      }
    }
    __syncthreads();
  }
  for (int g = 0; g < n_here; ++g) {
    if (cnt[g] > 0) flush(g);
  }
}

__global__ void __launch_bounds__(kThreads)
score_topk_merge(const float* __restrict__ part_s,  // [n_q, n_splits, k_pad]
                 const int* __restrict__ part_i,
                 float* __restrict__ out_s,  // [n_q, k]
                 int* __restrict__ out_i, int n_splits, int k, int k_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long q = blockIdx.x;
  topk::merge_partial_lists(part_s + q * n_splits * k_pad, part_i + q * n_splits * k_pad,
                            out_s + q * k, out_i + q * k, n_splits, k, k_pad, smem,
                            k_pad);
}

template <typename T>
int launch_partial(const void* q, const void* docs, void* part_s, void* part_i,
                   int n_q, int dim, int n_d, int k, int k_pad, int cap, int group,
                   int slots, int split_rows, int n_splits, int smem_bytes,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      score_topk_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_q + group - 1) / group, n_splits);
  score_topk_partial<T><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(docs),
      static_cast<float*>(part_s), static_cast<int*>(part_i), n_q, dim, n_d, k,
      k_pad, cap, group, slots, split_rows, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after its
// launch; the Python wrapper raises when that is not cudaSuccess.
extern "C" int score_topk_partial_launch(
    const void* q, const void* docs, void* part_s, void* part_i, int n_q, int dim,
    int n_d, int k, int k_pad, int cap, int group, int slots, int split_rows,
    int n_splits, int bf16, int smem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_partial<__nv_bfloat16>(q, docs, part_s, part_i, n_q, dim, n_d, k,
                                         k_pad, cap, group, slots, split_rows,
                                         n_splits, smem_bytes, s);
  }
  return launch_partial<float>(q, docs, part_s, part_i, n_q, dim, n_d, k, k_pad, cap,
                               group, slots, split_rows, n_splits, smem_bytes, s);
}

extern "C" int score_topk_merge_launch(const void* part_s, const void* part_i,
                                       void* out_s, void* out_i, int n_q,
                                       int n_splits, int k, int k_pad,
                                       int smem_bytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      score_topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  score_topk_merge<<<n_q, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n_splits, k, k_pad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* score_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
