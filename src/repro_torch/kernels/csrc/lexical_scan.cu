// Multi-model lexical scan with a k-bounded top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `lexical_scan_topk_pallas`
// (src/repro/kernels/lexical_scan.py, body `_lexical_scan_kernel`). For every
// query q and every document d it counts, in int32, how often each query
// term occurs in d's raw token row, applies each model's epilogue
// (`scoring.apply_epilogue`: ql / bm25 / tfidf, length prior, rsqrt norm) to
// that shared tf, and keeps each (model, query)'s top k documents ordered by
// (score desc, id asc). Zero-length rows score -inf and never enter; empty
// slots stay (-inf, -1).
//
// What bounds it on an H100. Per call the kernel must read the token matrix
// once (n_d * L_d * 4 bytes: 128 MiB for a 262,144 x 128 segment, ~40 us at
// 3.35 TB/s) and do n_q * L_q * n_d * L_d compare-and-adds on the CUDA cores
// (64 * 4 * 262,144 * 128 = 8.6e9 per segment, 1.7e10 INT32 operations:
// ~1.03 ms at 64 INT32 results per clock per SM x 132 SMs x 1.98 GHz). The
// compares dominate: the bound is operations, not bytes.
//
// Layout and what it re-reads. The TPU kernel carries its top-k state from
// one grid step to the next; Hopper CTAs run in parallel and in no order, so
// the work splits in two kernels:
//   1. `lexical_scan_partial`, grid (n_q, n_splits), query index fastest: the
//      CTAs of one doc split run together and read the same token tiles
//      through L2, so HBM sees each token roughly once while L2 serves it
//      n_q times. Each CTA walks its split in tiles of `tile_docs` rows:
//      a tile is staged in shared memory by asynchronous copies (cp.async),
//      one warp counts each row's query terms (a lane holds its share of the
//      row in registers; one warp reduction per term, no bank conflicts as
//      lanes read consecutive words), and every (model, doc) whose score beats that
//      model's current k-th entry is appended to a candidate buffer. A full
//      buffer is bitonic-sorted and bitonic-merged into the model's running
//      top-k_pad state; the k-th entry is the next threshold. Dropping a
//      candidate that is not ahead of the current k-th entry is exact: the
//      state only improves, so such a candidate can never be in the final
//      top k. Each CTA writes its sorted top k per model.
//   2. `lexical_merge_partials`, grid (n_q, n_models): folds the n_splits
//      partial lists with the same (score desc, id asc) bitonic merge.
// The (score, id) order, the bitonic sort and the bitonic merge live in
// topk_merge.cuh, shared with the dense kernel (score_topk.cu).
// Both merges depend only on the values, so the result is the exact
// lexicographic top k whatever n_splits, block_d or tile_docs are.
//
// Shared memory per CTA: n_models * (k_pad + cap) * 8 bytes of state and
// candidates (80 KB for 5 models at k = 1000) plus the token tile; the
// wrapper groups models so that one CTA fits in 227 KB.
//
// Float bits. Built with --fmad=false and without fast math: every product
// and quotient rounds on its own, and logf / log1pf / sqrtf / '/' are the
// IEEE-accurate library versions. The per-term sum runs l = 0, 1, 2, ... in
// the same order as the plain PyTorch version, which therefore agrees with
// this kernel bit for bit on the card.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "topk_merge.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

// tf of each query term in one staged row, by one warp: lane j holds tokens
// j, j + 32, ... (T of them) in registers; positions past L_d read as PAD,
// which no query term equals (query pads were remapped to PAD - 1).
template <int T>
__device__ __forceinline__ void row_tf(const int* row, int l_d, const int* qs,
                                       int l_q, int* out, int lane) {
  int v[T];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const int x = lane + 32 * j;
    v[j] = x < l_d ? row[x] : -1;
  }
  for (int l = 0; l < l_q; ++l) {
    const int term = qs[l];
    int c = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) c += (v[j] == term);
    c = __reduce_add_sync(kFullMask, c);
    if (lane == 0) out[l] = c;
  }
}

// One model's epilogue on one document's tf, as `scoring.apply_epilogue`.
__device__ __forceinline__ float score_doc(const int* tf, const float* w,
                                           int l_q, float alpha, float beta,
                                           int mode, int dlen) {
  const float dlf = fmaxf(static_cast<float>(dlen), 1.0f);
  const int kind = mode & 3;
  const float norm = alpha + beta * static_cast<float>(dlen);
  float s = 0.0f;
  for (int l = 0; l < l_q; ++l) {
    const float t = static_cast<float>(tf[l]);
    float pt;
    if (kind == 0) {
      pt = log1pf((w[l] * t) / dlf);
    } else if (kind == 1) {
      pt = (w[l] * t) / (t + norm);
    } else {
      pt = w[l] * log1pf(t);
    }
    s = (l == 0) ? pt : s + pt;
  }
  if (mode & 4) s = s + logf(dlf);
  if (mode & 8) s = s / sqrtf(dlf);
  return dlen > 0 ? s : -CUDART_INF_F;
}

}  // namespace

// Mode code per model: bits 0-1 = 0 ql | 1 bm25 | 2 tfidf, bit 2 = length
// prior, bit 3 = rsqrt length norm.
extern "C" __global__ void __launch_bounds__(kThreads)
lexical_scan_partial(const int* __restrict__ q_safe,     // [n_q, l_q]
                     const float* __restrict__ weights,  // [n_models, n_q, l_q]
                     const float* __restrict__ ab,       // [n_models, 2]
                     const int* __restrict__ modes,      // [n_models]
                     const int* __restrict__ docs,       // [n_d, l_d]
                     const int* __restrict__ lens,       // [n_d]
                     float* __restrict__ part_s,  // [n_models, n_q, n_splits, k]
                     int* __restrict__ part_i,
                     int n_q, int l_q, int n_models, int n_d, int l_d, int k,
                     int k_pad, int cap, int block_d, int tile_docs,
                     int n_splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int d_begin = split * block_d;
  const int d_end = min(n_d, d_begin + block_d);

  float* st_s = reinterpret_cast<float*>(smem);  // [n_models, k_pad]
  int* st_i = reinterpret_cast<int*>(st_s + n_models * k_pad);
  float* cd_s = reinterpret_cast<float*>(st_i + n_models * k_pad);  // [n_models, cap]
  int* cd_i = reinterpret_cast<int*>(cd_s + n_models * cap);
  int* tok = cd_i + n_models * cap;  // [tile_docs, l_d]
  int* tf = tok + tile_docs * l_d;   // [tile_docs, l_q]
  int* dl = tf + tile_docs * l_q;         // [tile_docs]
  int* qs = dl + tile_docs;               // [l_q]
  float* w = reinterpret_cast<float*>(qs + l_q);  // [n_models, l_q]
  float* alpha = w + n_models * l_q;
  float* beta = alpha + n_models;
  int* mode = reinterpret_cast<int*>(beta + n_models);
  float* thr_s = reinterpret_cast<float*>(mode + n_models);
  int* thr_i = reinterpret_cast<int*>(thr_s + n_models);
  int* cnt = thr_i + n_models;

  for (int t = tid; t < n_models * k_pad; t += blockDim.x) {
    st_s[t] = -CUDART_INF_F;
    st_i[t] = -1;
  }
  for (int t = tid; t < l_q; t += blockDim.x) qs[t] = q_safe[q * l_q + t];
  for (int t = tid; t < n_models * l_q; t += blockDim.x) {
    const int m = t / l_q, l = t % l_q;
    w[t] = weights[(static_cast<long long>(m) * n_q + q) * l_q + l];
  }
  for (int m = tid; m < n_models; m += blockDim.x) {
    alpha[m] = ab[2 * m];
    beta[m] = ab[2 * m + 1];
    mode[m] = modes[m];
    thr_s[m] = -CUDART_INF_F;
    thr_i[m] = -1;
    cnt[m] = 0;
  }
  __syncthreads();

  // sort model m's candidates and merge them into its state
  auto flush = [&](int m) {
    const int n = cnt[m];
    int width = k_pad;
    while (width < n) width <<= 1;  // <= cap: cap is a power of two >= n
    float* cs = cd_s + m * cap;
    int* ci = cd_i + m * cap;
    for (int t = n + tid; t < width; t += blockDim.x) {
      cs[t] = -CUDART_INF_F;
      ci[t] = -1;
    }
    __syncthreads();
    topk::bitonic_sort(cs, ci, width);
    topk::merge_into(st_s + m * k_pad, st_i + m * k_pad, cs, ci, k_pad);
    if (tid == 0) {
      cnt[m] = 0;
      thr_s[m] = st_s[m * k_pad + k - 1];
      thr_i[m] = st_i[m * k_pad + k - 1];
    }
    __syncthreads();
  };

  for (int d0 = d_begin; d0 < d_end; d0 += tile_docs) {
    const int nt = min(tile_docs, d_end - d0);
    for (int m = 0; m < n_models; ++m) {
      if (cnt[m] + tile_docs > cap) flush(m);
    }
    // stage the tile: one warp per row, lanes along the row (coalesced);
    // asynchronous copies, so a thread's loads are all in flight at once
    for (int r = warp; r < nt; r += n_warps) {
      const int* row = docs + static_cast<long long>(d0 + r) * l_d;
      for (int c = lane; c < l_d; c += 32) {
        __pipeline_memcpy_async(tok + r * l_d + c, row + c, sizeof(int));
      }
    }
    __pipeline_commit();
    for (int t = tid; t < nt; t += blockDim.x) dl[t] = lens[d0 + t];
    __pipeline_wait_prior(0);
    __syncthreads();

    // tf: one warp per row; each lane keeps its share of the row in
    // registers, and one warp reduction per query term gives that term's count
    for (int r = warp; r < nt; r += n_warps) {
      const int* row = tok + r * l_d;
      int* out = tf + r * l_q;
      if (l_d <= 32) {
        row_tf<1>(row, l_d, qs, l_q, out, lane);
      } else if (l_d <= 64) {
        row_tf<2>(row, l_d, qs, l_q, out, lane);
      } else if (l_d <= 128) {
        row_tf<4>(row, l_d, qs, l_q, out, lane);
      } else if (l_d <= 256) {
        row_tf<8>(row, l_d, qs, l_q, out, lane);
      } else {
        for (int l = 0; l < l_q; ++l) {
          int c = 0;
          for (int x = lane; x < l_d; x += 32) c += (row[x] == qs[l]);
          c = __reduce_add_sync(kFullMask, c);
          if (lane == 0) out[l] = c;
        }
      }
    }
    __syncthreads();

    // epilogue + threshold filter; tile_docs % 32 == 0 keeps m warp-uniform
    for (int p = tid; p < n_models * tile_docs; p += blockDim.x) {
      const int m = p / tile_docs;
      const int doc = p % tile_docs;
      const int gid = d0 + doc;
      float s = -CUDART_INF_F;
      bool take = false;
      if (doc < nt) {
        s = score_doc(tf + doc * l_q, w + m * l_q, l_q, alpha[m], beta[m],
                      mode[m], dl[doc]);
        // strictly ahead of the current k-th entry (ids are distinct)
        take = s > thr_s[m] || (s == thr_s[m] && gid < thr_i[m]);
      }
      const unsigned mask = __ballot_sync(kFullMask, take);
      if (mask) {
        const int leader = __ffs(mask) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&cnt[m], __popc(mask));
        base = __shfl_sync(kFullMask, base, leader);
        if (take) {
          const int pos = base + __popc(mask & ((1u << lane) - 1u));
          cd_s[m * cap + pos] = s;
          cd_i[m * cap + pos] = gid;
        }
      }
    }
    __syncthreads();
  }
  for (int m = 0; m < n_models; ++m) {
    if (cnt[m] > 0) flush(m);
  }
  for (int t = tid; t < n_models * k; t += blockDim.x) {
    const int m = t / k, i = t % k;
    const long long o =
        ((static_cast<long long>(m) * n_q + q) * n_splits + split) * k + i;
    part_s[o] = st_s[m * k_pad + i];
    part_i[o] = st_i[m * k_pad + i];
  }
}

extern "C" __global__ void __launch_bounds__(kThreads)
lexical_merge_partials(const float* __restrict__ part_s,  // [G, n_q, n_splits, k]
                       const int* __restrict__ part_i,
                       float* __restrict__ out_s,  // [G, n_q, k]
                       int* __restrict__ out_i,
                       int n_q, int n_splits, int k, int k_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* st_s = reinterpret_cast<float*>(smem);
  int* st_i = reinterpret_cast<int*>(st_s + k_pad);
  float* b_s = reinterpret_cast<float*>(st_i + k_pad);
  int* b_i = reinterpret_cast<int*>(b_s + k_pad);
  const int q = blockIdx.x;
  const int m = blockIdx.y;
  const long long row = static_cast<long long>(m) * n_q + q;
  const float* ps = part_s + row * n_splits * k;
  const int* pi = part_i + row * n_splits * k;
  for (int t = threadIdx.x; t < k_pad; t += blockDim.x) {
    st_s[t] = t < k ? ps[t] : -CUDART_INF_F;
    st_i[t] = t < k ? pi[t] : -1;
  }
  for (int sp = 1; sp < n_splits; ++sp) {
    for (int t = threadIdx.x; t < k_pad; t += blockDim.x) {
      b_s[t] = t < k ? ps[sp * k + t] : -CUDART_INF_F;
      b_i[t] = t < k ? pi[sp * k + t] : -1;
    }
    __syncthreads();
    topk::merge_into(st_s, st_i, b_s, b_i, k_pad);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    out_s[row * k + t] = st_s[t];
    out_i[row * k + t] = st_i[t];
  }
}

// Plain C entry points for ctypes. Each returns cudaGetLastError() after its
// launch; the Python wrapper raises when that is not cudaSuccess.
extern "C" int lexical_scan_partial_launch(
    const void* q_safe, const void* weights, const void* ab, const void* modes,
    const void* docs, const void* lens, void* part_s, void* part_i, int n_q,
    int l_q, int n_models, int n_d, int l_d, int k, int k_pad, int cap,
    int block_d, int tile_docs, int n_splits, int smem_bytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      lexical_scan_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_q, n_splits);
  lexical_scan_partial<<<grid, kThreads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q_safe), static_cast<const float*>(weights),
      static_cast<const float*>(ab), static_cast<const int*>(modes),
      static_cast<const int*>(docs), static_cast<const int*>(lens),
      static_cast<float*>(part_s), static_cast<int*>(part_i), n_q, l_q,
      n_models, n_d, l_d, k, k_pad, cap, block_d, tile_docs, n_splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lexical_merge_partials_launch(const void* part_s,
                                             const void* part_i, void* out_s,
                                             void* out_i, int n_q, int n_models,
                                             int n_splits, int k, int k_pad,
                                             int smem_bytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      lexical_merge_partials, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_q, n_models);
  lexical_merge_partials<<<grid, kThreads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_s), static_cast<const int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), n_q, n_splits, k,
      k_pad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lexical_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
