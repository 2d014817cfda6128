// The k-bounded (score, id) top-k machinery of the port's two scan kernels
// (lexical_scan.cu and score_topk.cu): the order, the threshold key, each
// CTA's running lists, the bound that the CTAs of a call prove together, and
// the final merge.
//
// Order: score descending, then id ascending (the reference's
// `bitonic_merge_desc` / `lax.top_k` positional tie-break). Scores compare as
// floats, so -0.0 equals +0.0 as in the reference; an empty slot is
// (-inf, -1), which every real (-inf, id >= 0) entry ranks after.
//
// Design. A call ranks `n_lists` lists (one per query, or per (model,
// query)); the n_split CTAs of a launch each scan a split of the documents.
// Each CTA keeps, for every list, its own running top k_pad (score, id) in
// device memory, and a candidate buffer. A score goes into the buffer only
// when it is ahead of the list's threshold; a buffer that one more tile could
// overflow is flushed by one warp: the candidates still ahead of the
// threshold are sorted and merged into the CTA's list. No list is shared
// between CTAs, so nothing is locked.
//
// The threshold is the best of two valid bounds, both raised as lists grow:
// the CTA's own k-th entry, and a bound the CTAs prove together. After a
// flush a CTA publishes its list's r-th entry, r = ceil(k / n_split); the
// smallest published value X is a lower bound on the call's k-th entry,
// because each of the n_split CTAs then holds r >= k / n_split documents of
// its own split ranking at or ahead of X. That bound tracks the k-th best of
// everything scanned so far, so a call's candidates number a small multiple
// of k ln(n_d / k) per list, not n_split times as many.
//
// Exactness. A document that does not rank ahead of a valid bound can never
// be in the final top k, and every other document reaches its CTA's list,
// whose first k_pad entries are exact for that split. The final merge takes
// every list entry at or ahead of the final bound (at least k of them, and
// every member of the top k) and sorts them; where there are too many for
// shared memory it merges the CTAs' lists pairwise instead. The result is
// the exact lexicographic top k whatever the splits, tiles or query groups.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace topk {
namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRounds = 8;  // rounds of 32 list entries a flush reads at once

// (score, id) as one 64-bit key whose unsigned order is the ranking order:
// the high word is the score's float order (after s + 0.0f, so -0.0 and
// +0.0 share one key), the low word 0x7fffffff - id (a smaller signed id
// ranks first, so an empty list's threshold (-inf, -1) is ahead of every real
// (-inf, id), which never enters). Ids of real documents are distinct, so
// their keys are.
__device__ __forceinline__ unsigned long long pack_key(float s, int id) {
  unsigned u = __float_as_uint(s + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned>(0x7fffffffu - static_cast<unsigned>(id));
}

// The score of a key (-0.0 comes back as +0.0) and its id.
__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_id(unsigned long long key) {
  return static_cast<int>(0x7fffffffu - static_cast<unsigned>(key));
}

// (as, ai) goes before (bs, bi): score descending, id ascending on ties.
__device__ __forceinline__ bool before(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai <= bi);
}

// The lists of one call, in device memory (allocated and initialised by the
// wrapper for each call, so no state outlives a call or is shared by two).
struct Lists {
  float* st_s;              // [n_ctas, per_cta, k_pad]: each CTA's running
  int* st_i;                //   top k_pad of each of its lists, in order
  int* st_len;              // [n_ctas, per_cta]: their lengths (at the end)
  unsigned long long* pub;  // [n_lists, n_split]: each CTA's r-th entry's key
  unsigned long long* thr;  // [n_lists]: the best bound proven so far
  float* cb_s;              // [n_ctas, per_cta, cap]: candidate buffers
  int* cb_i;
  int k, k_pad, cap, per_cta, rank;  // rank r = ceil(k / n_split)
};

// A CTA's view of its lists, in shared memory: the threshold (score, id),
// the buffer's fill count, the list's length and the keys of its r-th and
// k-th entries (0 until the list is that long).
struct Local {
  float* ts;
  int* ti;
  int* cnt;
  int* len;
  unsigned long long* rkey;
  unsigned long long* kkey;
};

// Note the key written at list position `pos` when it is the r-th or k-th.
__device__ __forceinline__ void track(const Lists& L, const Local& loc, int l, int pos,
                                      unsigned long long key) {
  if (pos == L.rank - 1) loc.rkey[l] = key;
  if (pos == L.k - 1) loc.kkey[l] = key;
}

// Offer (s, id) to list `l` (local index): append it to the CTA's buffer when
// it is ahead of the threshold, and return the buffer's new count (0 when it
// was not appended). The caller guarantees room (a buffer is flushed when
// one more tile could overflow it).
__device__ __forceinline__ int offer(const Lists& L, const Local& loc, size_t cb_base, int l,
                                     float s, int id) {
  const float t = loc.ts[l];
  if (s > t || (s == t && id < loc.ti[l])) {
    const int pos = atomicAdd(&loc.cnt[l], 1);
    const size_t o = cb_base + static_cast<size_t>(l) * L.cap + pos;
    L.cb_s[o] = s;
    L.cb_i[o] = id;
    return pos + 1;
  }
  return 0;
}

__device__ __forceinline__ void set_local(const Local& loc, int l, unsigned long long key) {
  loc.ts[l] = key_score(key);
  loc.ti[l] = key_id(key);
}

// Raise list `l`'s threshold to the call's proven bound for list `g`.
__device__ __forceinline__ void refresh(const Lists& L, const Local& loc, int l, int g) {
  const unsigned long long mine = pack_key(loc.ts[l], loc.ti[l]);
  const unsigned long long all = __ldcg(&L.thr[g]);
  if (all > mine) set_local(loc, l, all);
}

// Number of the first m keys of the descending array `ck` that rank ahead of
// `ek` (keys are distinct).
__device__ __forceinline__ int ahead_of(const unsigned long long* ck, int m,
                                        unsigned long long ek) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ck[mid] > ek) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Flush the CTA's buffer of list `l` (local index; global index `g`) into its
// list; `cta` is the CTA's index among all, `split` among the n_split CTAs of
// its group. One warp; every lane calls it. `sk`/`ss` are the warp's
// scratch: room for next_pow2(cap) keys and scores.
__device__ void warp_flush(const Lists& L, const Local& loc, size_t cb_base, int cta, int split,
                           int n_split, int l, int g, unsigned long long* sk, float* ss) {
  const int lane = threadIdx.x & 31;
  const int n = loc.cnt[l];
  const unsigned long long thr = pack_key(loc.ts[l], loc.ti[l]);
  // keep what is still ahead of the threshold, compacted in buffer order
  const float* bs = L.cb_s + cb_base + static_cast<size_t>(l) * L.cap;
  const int* bi = L.cb_i + cb_base + static_cast<size_t>(l) * L.cap;
  int m = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    float s = 0.0f;
    unsigned long long key = 0;
    if (j < n) {
      s = __ldcg(bs + j);
      key = pack_key(s, __ldcg(bi + j));
    }
    const bool keep = j < n && key > thr;
    const unsigned mask = __ballot_sync(kFullMask, keep);
    if (keep) {
      const int p = m + __popc(mask & ((1u << lane) - 1u));
      sk[p] = key;
      ss[p] = s;
    }
    m += __popc(mask);
  }
  const int k_pad = L.k_pad;
  const size_t row = static_cast<size_t>(cta) * L.per_cta + l;
  float* st_s = L.st_s + row * k_pad;
  int* st_i = L.st_i + row * k_pad;
  const int len = loc.len[l];
  if (m > 0) {
    // bitonic sort of the kept keys, descending; key 0 (below every real
    // key) pads to a power of two and sorts last
    int width = 1;
    while (width < m) width <<= 1;
    for (int j = m + lane; j < width; j += 32) sk[j] = 0;
    __syncwarp();
    for (int size = 2; size <= width; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = lane; t < width / 2; t += 32) {
          const int i = 2 * t - (t & (stride - 1));
          const int j = i + stride;
          const bool desc = (i & size) == 0;
          const unsigned long long a = sk[i], b = sk[j];
          if ((a < b) == desc) {
            const float sa = ss[i];
            sk[i] = b; sk[j] = a;
            ss[i] = ss[j]; ss[j] = sa;
          }
        }
        __syncwarp();
      }
    }
    // Merge from the top of the list's `len` entries, kRounds x 32 a batch:
    // entry i moves to i + s_i, s_i the candidates ahead of it; candidates
    // s_i .. s_{i+1}-1 land between entries i and i + 1 (at i + 1 + j),
    // those after the last entry at len + j. A batch is read whole (one
    // round trip) before any of its writes, and every write lands at or
    // above the entry it comes from, so the list is updated in place. A
    // batch whose lowest entry does not move ends the merge.
    const unsigned long long best = sk[0], worst = sk[m - 1];
    int carry = m;  // s of the entry above the batch (above the last: every candidate)
    for (int top = len; top > 0; top -= 32 * kRounds) {
      float es[kRounds];
      int ei[kRounds], sv[kRounds];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int i = top - 32 * (r + 1) + lane;
        es[r] = 0.0f;
        ei[r] = 0;
        if (i >= 0) {
          es[r] = __ldcg(st_s + i);
          ei[r] = __ldcg(st_i + i);
        }
      }
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int i = top - 32 * (r + 1) + lane;
        const unsigned long long ek = pack_key(es[r], ei[r]);
        sv[r] = i < 0 || ek > best ? 0 : ek < worst ? m : ahead_of(sk, m, ek);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int i = top - 32 * (r + 1) + lane;
        const int s = sv[r];
        int s_next = __shfl_down_sync(kFullMask, s, 1);
        const int above = r == 0 ? carry : __shfl_sync(kFullMask, sv[r > 0 ? r - 1 : 0], 0);
        if (lane == 31) s_next = above;
        if (i >= 0) {
          if (s > 0 && i + s < k_pad) {
            __stcg(st_s + i + s, es[r]);
            __stcg(st_i + i + s, ei[r]);
            track(L, loc, l, i + s, pack_key(es[r], ei[r]));
          }
          for (int j = s; j < s_next && i + 1 + j < k_pad; ++j) {
            __stcg(st_s + i + 1 + j, ss[j]);
            __stcg(st_i + i + 1 + j, key_id(sk[j]));
            track(L, loc, l, i + 1 + j, sk[j]);
          }
          if (i == 0) {
            for (int j = 0; j < s && j < k_pad; ++j) {
              __stcg(st_s + j, ss[j]);
              __stcg(st_i + j, key_id(sk[j]));
              track(L, loc, l, j, sk[j]);
            }
          }
        }
      }
      carry = __shfl_sync(kFullMask, sv[kRounds - 1], 0);
      if (carry == 0) break;
    }
    if (len == 0) {  // an empty list: the candidates are the list
      for (int j = lane; j < m && j < k_pad; j += 32) {
        __stcg(st_s + j, ss[j]);
        __stcg(st_i + j, key_id(sk[j]));
        track(L, loc, l, j, sk[j]);
      }
    }
  }
  const int new_len = min(k_pad, len + m);
  __syncwarp();
  // publish the r-th entry; the smallest published value over the group's
  // CTAs is a bound for all of them (0, below every key, until all publish)
  unsigned long long kth = pack_key(loc.ts[l], loc.ti[l]);
  if (m > 0 && new_len >= L.rank && lane == 0) {
    __stcg(&L.pub[static_cast<size_t>(g) * n_split + split], loc.rkey[l]);
  }
  if (new_len >= L.k && loc.kkey[l] > kth) kth = loc.kkey[l];
  unsigned long long low = ~0ull;
  for (int c = lane; c < n_split; c += 32) {
    const unsigned long long v = __ldcg(&L.pub[static_cast<size_t>(g) * n_split + c]);
    low = v < low ? v : low;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long v = __shfl_xor_sync(kFullMask, low, o);
    low = v < low ? v : low;
  }
  if (lane == 0) {
    // the CTA's threshold rises to the bound now; what other CTAs proved
    // comes in at the next refresh
    const unsigned long long bound = low > kth ? low : kth;
    atomicMax(&L.thr[g], bound);
    set_local(loc, l, bound);
    loc.len[l] = new_len;
    loc.cnt[l] = 0;
  }
  __syncwarp();
}

// st <- top m of (st ++ b), both sorted in before-order, m a power of two:
// the first stage of the bitonic merge of st ++ reverse(b) keeps the better
// of each pair in the lower half, the half-cleaners then sort that half.
// All threads of the CTA.
__device__ void merge_into(float* st_s, int* st_i, const float* b_s, const int* b_i, int m) {
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

// Entries the final merge sorts at once, when no more than this many rank at
// or ahead of the bound (the wrapper sizes its shared memory with
// kGatherCap * 12 + 16 * k_pad + 8 * n_split + 16 bytes, the larger path).
constexpr int kGatherCap = 4096;

// The final top k of list `g` (local index `l` in the CTAs `cta0 ..
// cta0 + n_split - 1`) into out_s, out_i [k]. All threads of one CTA.
__device__ void merge_lists(const Lists& L, int g, int l, int cta0, int n_split, float* out_s,
                            int* out_i, unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int k_pad = L.k_pad, k = L.k;
  int* pre = reinterpret_cast<int*>(smem);  // [n_split]: entries at or ahead of the bound
  int* off = pre + n_split;                 // [n_split + 1]
  unsigned char* body = smem + ((8 * n_split + 4 + 15) & ~15);
  const unsigned long long bound = __ldcg(&L.thr[g]);
  // each CTA's list is sorted: count its prefix at or ahead of the bound
  for (int c = warp; c < n_split; c += n_warps) {
    const size_t row = static_cast<size_t>(cta0 + c) * L.per_cta + l;
    const int len = __ldcg(&L.st_len[row]);
    int p = 0;
    for (int j0 = 0; j0 < len; j0 += 32) {
      const int j = j0 + lane;
      const bool in = j < len && pack_key(__ldcg(L.st_s + row * k_pad + j),
                                          __ldcg(L.st_i + row * k_pad + j)) >= bound;
      const unsigned mask = __ballot_sync(kFullMask, in);
      p += __popc(mask);
      if (mask != kFullMask) break;
    }
    if (lane == 0) pre[c] = p;
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int c = 0; c < n_split; ++c) {
      off[c] = total;
      total += pre[c];
    }
    off[n_split] = total;
  }
  __syncthreads();
  const int total = off[n_split];
  if (total <= kGatherCap) {
    int width = 1;
    while (width < total) width <<= 1;
    unsigned long long* gk = reinterpret_cast<unsigned long long*>(body);
    float* gs = reinterpret_cast<float*>(gk + kGatherCap);
    for (int c = warp; c < n_split; c += n_warps) {
      const size_t row = static_cast<size_t>(cta0 + c) * L.per_cta + l;
      for (int j = lane; j < pre[c]; j += 32) {
        const float s = __ldcg(L.st_s + row * k_pad + j);
        gk[off[c] + j] = pack_key(s, __ldcg(L.st_i + row * k_pad + j));
        gs[off[c] + j] = s;
      }
    }
    for (int j = total + tid; j < width; j += blockDim.x) gk[j] = 0;
    __syncthreads();
    for (int size = 2; size <= width; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < width / 2; t += blockDim.x) {
          const int i = 2 * t - (t & (stride - 1));
          const int j = i + stride;
          const bool desc = (i & size) == 0;
          const unsigned long long a = gk[i], b = gk[j];
          if ((a < b) == desc) {
            const float sa = gs[i];
            gk[i] = b; gk[j] = a;
            gs[i] = gs[j]; gs[j] = sa;
          }
        }
        __syncthreads();
      }
    }
    for (int j = tid; j < k; j += blockDim.x) {
      out_s[j] = j < total ? gs[j] : -CUDART_INF_F;
      out_i[j] = j < total ? key_id(gk[j]) : -1;
    }
    return;
  }
  // too many entries at or ahead of the bound: merge the lists pairwise
  float* st_s = reinterpret_cast<float*>(body);
  int* st_i = reinterpret_cast<int*>(st_s + k_pad);
  float* b_s = reinterpret_cast<float*>(st_i + k_pad);
  int* b_i = reinterpret_cast<int*>(b_s + k_pad);
  for (int c = 0; c < n_split; ++c) {
    const size_t row = static_cast<size_t>(cta0 + c) * L.per_cta + l;
    const int len = __ldcg(&L.st_len[row]);
    float* ds = c == 0 ? st_s : b_s;
    int* di = c == 0 ? st_i : b_i;
    for (int t = tid; t < k_pad; t += blockDim.x) {
      ds[t] = t < len ? __ldcg(L.st_s + row * k_pad + t) : -CUDART_INF_F;
      di[t] = t < len ? __ldcg(L.st_i + row * k_pad + t) : -1;
    }
    __syncthreads();
    if (c > 0) merge_into(st_s, st_i, b_s, b_i, k_pad);
  }
  for (int j = tid; j < k; j += blockDim.x) {
    out_s[j] = st_s[j];
    out_i[j] = st_i[j];
  }
}

}  // namespace
}  // namespace topk
