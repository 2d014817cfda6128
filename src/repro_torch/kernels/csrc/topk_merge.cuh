// The k-bounded (score, id) top-k machinery of the port's scan kernels: the
// order, a bitonic sort and the bitonic merge into a running state (both
// lexical_scan.cu and score_topk.cu), the flush of a candidate buffer and
// the merge of per-split partial lists (score_topk.cu).
//
// Order: score descending, then id ascending (the reference's
// `bitonic_merge_desc` / `lax.top_k` positional tie-break). Scores are
// compared as floats, so -0.0 equals +0.0 as in the reference. Every
// routine here depends only on the values it is given, never on how the
// work was split, so a scan's result is the exact lexicographic top k
// whatever its block and split sizes.
//
// Every routine is called by all threads of a CTA (it synchronizes). They
// have internal linkage, as each kernel's own definitions would: every
// source that includes this header compiles its own copy, with the same
// inlining it would get for a local function.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace topk {
namespace {

// (as, ai) goes before (bs, bi): score descending, id ascending on ties.
__device__ __forceinline__ bool before(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai <= bi);
}

// Bitonic sort of n (a power of two) entries into before-order.
__device__ void bitonic_sort(float* s, int* id, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool forward = (i & size) == 0;
        const float si = s[i], sj = s[j];
        const int ii = id[i], ij = id[j];
        if (forward != before(si, ii, sj, ij)) {
          s[i] = sj; s[j] = si; id[i] = ij; id[j] = ii;
        }
      }
      __syncthreads();
    }
  }
}

// st <- top m of (st ++ b), both sorted in before-order, m a power of two:
// the first stage of the bitonic merge of st ++ reverse(b) keeps the better
// of each pair in the lower half, the half-cleaners then sort that half.
__device__ void merge_into(float* st_s, int* st_i, const float* b_s,
                                  const int* b_i, int m) {
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const float bs = b_s[m - 1 - t];
    const int bi = b_i[m - 1 - t];
    if (!before(st_s[t], st_i[t], bs, bi)) { st_s[t] = bs; st_i[t] = bi; }
  }
  __syncthreads();
  for (int stride = m >> 1; stride > 0; stride >>= 1) {
    for (int t = threadIdx.x; t < m / 2; t += blockDim.x) {
      const int i = 2 * t - (t & (stride - 1));
      const int j = i + stride;
      const float si = st_s[i], sj = st_s[j];
      const int ii = st_i[i], ij = st_i[j];
      if (!before(si, ii, sj, ij)) {
        st_s[i] = sj; st_s[j] = si; st_i[i] = ij; st_i[j] = ii;
      }
    }
    __syncthreads();
  }
}

// Sort the *cnt candidates in (cs, ci) (room for a power of two >= *cnt and
// >= k_pad) and merge them into the running state (st_s, st_i) of k_pad
// entries; then empty the buffer and set the threshold to the state's k-th
// entry. A candidate is appended only when it is ahead of that threshold:
// exact, because the state only improves.
__device__ void flush_candidates(float* st_s, int* st_i, float* cs, int* ci,
                                        int* cnt, float* thr_s, int* thr_i,
                                        int k_pad, int k) {
  const int n = *cnt;
  int width = k_pad;
  while (width < n) width <<= 1;
  for (int t = n + threadIdx.x; t < width; t += blockDim.x) {
    cs[t] = -CUDART_INF_F;
    ci[t] = -1;
  }
  __syncthreads();
  bitonic_sort(cs, ci, width);
  merge_into(st_s, st_i, cs, ci, k_pad);
  if (threadIdx.x == 0) {
    *cnt = 0;
    *thr_s = st_s[k - 1];
    *thr_i = st_i[k - 1];
  }
  __syncthreads();
}

// Fold n_splits sorted lists of k entries (ps, pi: [n_splits, stride], the
// first k of each row) into one (out_s, out_i: [k]). smem holds 4 * k_pad
// words.
__device__ void merge_partial_lists(const float* ps, const int* pi,
                                           float* out_s, int* out_i,
                                           int n_splits, int k, int k_pad,
                                           unsigned char* smem, int stride) {
  float* st_s = reinterpret_cast<float*>(smem);
  int* st_i = reinterpret_cast<int*>(st_s + k_pad);
  float* b_s = reinterpret_cast<float*>(st_i + k_pad);
  int* b_i = reinterpret_cast<int*>(b_s + k_pad);
  for (int t = threadIdx.x; t < k_pad; t += blockDim.x) {
    st_s[t] = t < k ? ps[t] : -CUDART_INF_F;
    st_i[t] = t < k ? pi[t] : -1;
  }
  for (int sp = 1; sp < n_splits; ++sp) {
    for (int t = threadIdx.x; t < k_pad; t += blockDim.x) {
      b_s[t] = t < k ? ps[static_cast<long long>(sp) * stride + t] : -CUDART_INF_F;
      b_i[t] = t < k ? pi[static_cast<long long>(sp) * stride + t] : -1;
    }
    __syncthreads();
    merge_into(st_s, st_i, b_s, b_i, k_pad);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    out_s[t] = st_s[t];
    out_i[t] = st_i[t];
  }
}

}  // namespace
}  // namespace topk
