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
// What bounds it on an H100. The least work these inputs need: read the
// token matrix and the lengths once (n_d * (L_d + 1) * 4 bytes: 129 MiB for a
// 262,144 x 128 segment, ~40 us at 3.35 TB/s; packed in 17-bit planes,
// n_d * (68 + 1) * 4 bytes, ~22 us), look each token up once
// against the block's query terms, and one epilogue and compare for each
// (model, query, doc). The bytes bound it. (Comparing every query term with
// every token would be 1.7e10 INT32 operations a segment, ~1.03 ms: looking
// each token up once is what takes that work away.)
//
// Layout. One launch, one CTA per SM; a CTA takes every n_split-th tile of
// `tile_docs` rows (so the CTAs scan the ids in order together) and holds
// every (model, query) list of the call. Steps per tile:
//   1. stage: the tile's rows are one contiguous range of bytes of the token
//      matrix, copied by 16-byte cp.async (4-byte copies, and plain loads for
//      the bytes before and after a 4-byte boundary, at its ragged ends) into
//      one of two buffers, while the previous tile is counted. A packed
//      tile (the `Pack` template argument: uint8 or uint16 rows, or int32
//      bit-planes, `repro_torch.core.packing`) stages as its packed bytes.
//   2. count: one warp per row; lane j reads positions j, j + 32, ... (below
//      the row's unpacked length only: bit-planes pad their last group with
//      zeros, and 0 is a real term), a packed token decoded right there, so
//      no second buffer of decoded rows is needed (uint8 / uint16: the lane
//      reads its element; bit-planes: lane p reads plane p of the group and
//      a bit transpose across the warp hands lane t its token; the PAD
//      sentinel `vocab` maps back to -1). Each lane
//      tests its tokens against a
//      65,536-bit map of the query terms (token & 0xffff), and a hit looks
//      the token up in an open-addressing table of the distinct terms; the
//      warp's count of that term goes up by one (shared-memory atomics). A
//      token is looked at once, however many queries share its term.
//      A term's first hit in the row also appends it to the warp's list of
//      the row's matched terms and puts its place in that list in the high
//      half of the term's count word (the count stays in the low half: no
//      row of 2^16 tokens fits the staging ring, even in 1-bit planes).
//   3. epilogue, model by model: first the warp's lanes take the row's
//      matched terms and score each once into the warp's table, with the w
//      of the term's first slot. A slot of the model whose w has the same
//      bits as that slot's would score the very same bits at this row, the
//      same function on the same arguments; at ql, bm25 and tf-idf every
//      slot does, as w depends on the term alone. Then the lanes take the
//      model's (model, query) lists in turn and sum each list's slots in
//      order l = 0, 1, ... Where every w of the list is finite and shares
//      its term's score, and the norm is positive, a slot with tf > 0 reads
//      its term's score from the table and a slot with tf = 0 scores w * 0,
//      which is what the term's formula gives at tf 0 there; four slots'
//      reads go out together, with no branch, before their sum runs on. Any
//      other list scores each slot itself. The list's score is offered to
//      its threshold (topk_merge.cuh). Where no two slots share a term, the table holds
//      one score a matched slot, as many as scoring each slot on its own
//      would take. The slots' terms and weights lie l-major in shared
//      memory, so that the lanes' reads of one l fall in distinct banks.
//   Before the next tile, buffers that one more tile could overflow are
//   flushed into the CTA's own lists, and the CTAs prove a common threshold
//   together (topk_merge.cuh); every `block_d` rows a CTA also flushes every
//   non-empty buffer. A second kernel, grid (lists), merges each list.
//
// Counters. Each CTA counts its flush passes by cause (an offer raised
// `need`, the schedule of tile 1 and every 4th tile, `block_d` rows reached,
// the final pass; a pass with several causes counts under the rows, else
// under `need`), its list flushes and the candidates they took, and thread
// 0's clock64 cycles inside flush passes (from after a pass's first barrier
// to after its last, so the wait at the barrier is left out) and over the
// whole tile loop; then the term scores its warps computed with tf > 0 (a
// table entry, or a slot that scores itself), the (row, list, slot) uses of
// them (what scoring each slot on its own would compute), and thread 0's
// cycles from the end of each of its rows' count to the end of the row's
// offers. At its end it adds them once, by atomicAdd, into the
// caller's uint64 `counters[kCounters]` (`lexical_scan.COUNTERS` names them
// in order), or nowhere when `counters` is null. They never change what the
// kernel computes.
//
// Float bits. Built with --fmad=false and without fast math: every product
// and quotient rounds on its own, and logf / log1pf / sqrtf / '/' are the
// IEEE-accurate library versions. The per-term sum runs l = 0, 1, 2, ... in
// the same order as the plain PyTorch version, which therefore agrees with
// this kernel bit for bit on the card.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

constexpr int kThreads = 512;  // 16 warps: the epilogue's float chains want the occupancy
constexpr int kWarps = kThreads / 32;
constexpr int kEmpty = static_cast<int>(0x80000000u);  // a free hash slot
constexpr int kMapWords = 65536 / 32;
// counters[]: flush passes (need, scheduled, block_d rows, final), list
// flushes, candidates flushed, flush cycles, tile-loop cycles, term scores,
// term uses, epilogue cycles
constexpr int kCounters = 11;
// a CTA's counts in shared memory (registers are all taken): each warp's
// list flushes, candidates, term scores and term uses, then thread 0's
// passes by cause, its flush cycles, the loop's first cycle and its
// epilogue cycles
constexpr int kTally = 4 * kWarps + 6;
enum { kTallyScores = 2 * kWarps, kTallyUses = 3 * kWarps };
enum { kTallyNeed = 4 * kWarps, kTallySched, kTallyRows, kTallyCycles, kTallyStart, kTallyEpi };

// the token layouts: int32 rows, uint8 rows, uint16 rows, int32 bit-planes
constexpr int kPackNone = 0, kPackU8 = 1, kPackU16 = 2, kPackBits = 3;

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes16) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (bytes16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
  }
}

// The token at position x (< the unpacked length) of a staged int32, uint8
// or uint16 row. A packed PAD is the sentinel `vocab`: back to -1.
template <int Pack>
__device__ __forceinline__ int row_token(const unsigned char* row, int x, int sentinel) {
  if constexpr (Pack == kPackNone) {
    return reinterpret_cast<const int*>(row)[x];
  } else {
    const int tok = Pack == kPackU8 ? row[x] : reinterpret_cast<const unsigned short*>(row)[x];
    return tok == sentinel ? -1 : tok;
  }
}

// One round of a 32 x 32 bit transpose across a warp (lane r holds row r,
// bit c is column c): elements (r, c) whose bit j of r and of c differ move
// to (r ^ j, c ^ j); `m` holds the columns whose bit j is 0.
__device__ __forceinline__ unsigned transpose_round(unsigned x, int lane, int j, unsigned m) {
  const unsigned other = __shfl_xor_sync(0xffffffffu, x, j);
  return (lane & j) ? (x & ~m) | ((other >> j) & m) : (x & m) | ((other << j) & ~m);
}

// The token at position 32 g + lane of a row of bit-planes, decoded by the
// whole warp at once (every lane must call it): lane p reads plane p of
// group g, whose bit t is bit p of the token at 32 g + t, and five rounds of
// shuffles transpose the planes so that lane t holds its token (one shared
// read and ~25 operations a lane for 32 tokens, where each lane reading
// every plane would take `bits` reads and ~3 `bits` operations a token).
__device__ __forceinline__ int plane_token(const unsigned char* row, int g, int lane, int bits,
                                           int sentinel) {
  unsigned x = lane < bits ? reinterpret_cast<const unsigned*>(row)[g * bits + lane] : 0u;
  x = transpose_round(x, lane, 16, 0x0000ffffu);
  x = transpose_round(x, lane, 8, 0x00ff00ffu);
  x = transpose_round(x, lane, 4, 0x0f0f0f0fu);
  x = transpose_round(x, lane, 2, 0x33333333u);
  x = transpose_round(x, lane, 1, 0x55555555u);
  return static_cast<int>(x) == sentinel ? -1 : static_cast<int>(x);
}

__device__ __forceinline__ unsigned hash_slot(int term, int log2h) {
  return (static_cast<unsigned>(term) * 2654435761u) >> (32 - log2h);
}

// One term of one model's epilogue, as `scoring.apply_epilogue`. At tf 0
// the same bits come without the division or the log: w * 0 is +-0 (or NaN
// for an infinite w), and +-0 over a positive norm or a dlf >= 1 is itself,
// as log1pf(+-0) is; only a NaN, or a norm that is not positive, takes the
// general expression.
__device__ __forceinline__ float term_score(int kind, float w, float t, float dlf, float norm) {
  if (t == 0.0f) {
    const float z = w * 0.0f;
    if (kind == 0) return z == 0.0f ? z : log1pf(z / dlf);
    if (kind == 1) return z == 0.0f && norm > 0.0f ? z : z / (t + norm);
    return w * 0.0f;  // w * log1pf(0), log1pf(0) = +0
  }
  if (kind == 0) return log1pf((w * t) / dlf);
  if (kind == 1) return (w * t) / (t + norm);
  return w * log1pf(t);
}

// The length prior, rsqrt norm and zero-length rule after the per-term sum.
__device__ __forceinline__ float finish(float s, int mode, int dlen, float log_dlf,
                                       float sqrt_dlf) {
  if (mode & 4) s = s + log_dlf;
  if (mode & 8) s = s / sqrt_dlf;
  return dlen > 0 ? s : -CUDART_INF_F;
}

}  // namespace

// Mode code per model: bits 0-1 = 0 ql | 1 bm25 | 2 tfidf, bit 2 = length
// prior, bit 3 = rsqrt length norm. Lists are (model, query), model-major.
// A doc row is `row_bytes` bytes holding `l_tok` tokens in layout `Pack`.
template <int Pack>
__global__ void __launch_bounds__(kThreads, 1)
lexical_scan_kernel(const int* __restrict__ q_safe,     // [n_q, l_q]
                    const float* __restrict__ weights,  // [n_models, n_q, l_q]
                    const float* __restrict__ ab,       // [n_models, 2]
                    const int* __restrict__ modes,      // [n_models]
                    const unsigned char* __restrict__ docs,  // [n_d, row_bytes]
                    const int* __restrict__ lens,       // [n_d]
                    topk::Lists L, int n_q, int l_q, int n_models, int n_d, int l_tok,
                    int row_bytes, int bits, int sentinel, int tile_docs, int flush_rows,
                    int log2h, unsigned long long* __restrict__ counters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_slots = n_q * l_q;
  const int n_lists = n_models * n_q;
  const int hsize = 1 << log2h;
  // a tile + 15 bytes of alignment slack, in whole 16-byte units
  const int buf_bytes = (tile_docs * row_bytes + 30) & ~15;

  unsigned char* ring = smem;                         // [2][buf_bytes]
  unsigned* map = reinterpret_cast<unsigned*>(ring + 2 * buf_bytes);  // [kMapWords]
  int* hkey = reinterpret_cast<int*>(map + kMapWords);  // [hsize]
  int* hval = hkey + hsize;                           // [hsize]: the term's index
  // the slots l-major, [l_q][n_q], so that lanes over the queries read
  // consecutive words (q-major, a warp's 32 reads of one l hit 4 banks)
  int* slot_term = hval + hsize;                      // [n_slots]: a slot's term
  const int qwords = (n_q + 31) / 32;
  int* wcnt = slot_term + n_slots;                    // [kWarps][n_slots]
  // a row matches at most min(n_slots, l_tok) distinct terms
  const int n_cap = min(n_slots, l_tok);
  int* mterm = wcnt + kWarps * n_slots;               // [kWarps][n_cap]: the row's matched terms
  int* n_match = mterm + kWarps * n_cap;              // [kWarps]: their number
  float* tab = reinterpret_cast<float*>(n_match + kWarps);  // [kWarps][n_cap]: their scores
  int* tfirst = reinterpret_cast<int*>(tab + kWarps * n_cap);  // [n_slots]: a term's first slot
  int* tslots = tfirst + n_slots;                     // [n_slots]: the slots holding a term
  // [n_models][qwords]: the lists with a slot whose w is not finite or
  // differs from the w of its term's first slot
  unsigned* qown = reinterpret_cast<unsigned*>(tslots + n_slots);
  float* w = reinterpret_cast<float*>(qown + n_models * qwords);  // [n_models][n_slots]
  float* alpha = w + n_models * n_slots;
  float* beta = alpha + n_models;
  int* mode = reinterpret_cast<int*>(beta + n_models);
  float* ts = reinterpret_cast<float*>(mode + n_models);  // [n_lists]
  int* ti = reinterpret_cast<int*>(ts + n_lists);
  int* cnt = ti + n_lists;
  int* len = cnt + n_lists;
  int* n_terms = len + n_lists;
  int* need = n_terms + 1;  // a buffer may overflow in the next tile: flush first
  int sc = 1;
  while (sc < L.cap) sc <<= 1;
  unsigned long long* rkey = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<uintptr_t>(n_terms + 2) + 7 & ~static_cast<uintptr_t>(7));
  unsigned long long* kkey = rkey + n_lists;
  unsigned long long* tally = kkey + n_lists;  // [kTally]
  unsigned long long* scratch = tally + kTally;
  unsigned long long* sk = scratch + warp * sc;
  float* ss = reinterpret_cast<float*>(scratch + kWarps * sc) + warp * sc;
  const topk::Local loc{ts, ti, cnt, len, rkey, kkey};
  const size_t cb_base = static_cast<size_t>(blockIdx.x) * n_lists * L.cap;

  // the query terms: a bitmap, a hash table of the distinct terms
  for (int i = tid; i < kMapWords; i += kThreads) map[i] = 0;
  for (int i = tid; i < hsize; i += kThreads) hkey[i] = kEmpty;
  for (int i = tid; i < kWarps * n_slots; i += kThreads) wcnt[i] = 0;
  for (int i = tid; i < n_slots; i += kThreads) {
    tfirst[i] = n_slots;
    tslots[i] = 0;
  }
  for (int i = tid; i < n_models * qwords; i += kThreads) qown[i] = 0;
  for (int i = tid; i < kWarps; i += kThreads) n_match[i] = 0;
  for (int i = tid; i < n_models * n_slots; i += kThreads) {  // weights are [n_models, n_q, l_q]
    const int m = i / n_slots, s = i - m * n_slots, qi = s / l_q;
    w[m * n_slots + (s - qi * l_q) * n_q + qi] = weights[i];
  }
  for (int m = tid; m < n_models; m += kThreads) {
    alpha[m] = ab[2 * m];
    beta[m] = ab[2 * m + 1];
    mode[m] = modes[m];
  }
  for (int l = tid; l < n_lists; l += kThreads) {
    topk::set_local(loc, l, __ldcg(&L.thr[l]));
    cnt[l] = 0;
    len[l] = 0;
    rkey[l] = kkey[l] = 0;
  }
  if (tid == 0) {
    *n_terms = 0;
    *need = 0;
  }
  if (tid < kTally) tally[tid] = 0;
  __syncthreads();
  for (int s = tid; s < n_slots; s += kThreads) {
    const int term = q_safe[s];
    unsigned h = hash_slot(term, log2h);
    for (;;) {
      const int prev = atomicCAS(&hkey[h], kEmpty, term);
      if (prev == kEmpty || prev == term) break;
      h = (h + 1) & (hsize - 1);
    }
    atomicOr(&map[(term & 0xffff) >> 5], 1u << (term & 31));
  }
  __syncthreads();
  for (int h = tid; h < hsize; h += kThreads) {
    if (hkey[h] != kEmpty) hval[h] = atomicAdd(n_terms, 1);
  }
  __syncthreads();
  auto lookup = [&](int term) -> int {
    unsigned h = hash_slot(term, log2h);
    for (;;) {
      const int key = hkey[h];
      if (key == term) return hval[h];
      if (key == kEmpty) return -1;
      h = (h + 1) & (hsize - 1);
    }
  };
  for (int s = tid; s < n_slots; s += kThreads) {
    const int t = lookup(q_safe[s]);
    const int qi = s / l_q, j = (s - qi * l_q) * n_q + qi;
    slot_term[j] = t;
    atomicAdd(&tslots[t], 1);
    atomicMin(&tfirst[t], j);
  }
  __syncthreads();
  // the (model, query) lists with a slot whose w is not finite (its zero
  // path is not w * 0) or differs in its bits from the w of its term's
  // first slot: they score each slot themselves (at tf = 0 the others'
  // terms give w * 0: ql's (w * 0) / dlf for any dlf >= 1, bm25's
  // (w * 0) / (0 + norm) for any norm > 0, tf-idf's w * log1pf(0))
  for (int p = tid; p < n_models * n_slots; p += kThreads) {
    const int m = p / n_slots, j = p - m * n_slots, qi = j % n_q;
    if (w[p] * 0.0f != 0.0f ||
        __float_as_uint(w[p]) != __float_as_uint(w[m * n_slots + tfirst[slot_term[j]]])) {
      atomicOr(&qown[m * qwords + qi / 32], 1u << (qi & 31));
    }
  }
  __syncthreads();

  // the CTAs take the tiles in turn (CTA c: tiles c, c + n_split, ...), so
  // together they scan the ids in order: among equal scores the lowest ids
  // rank first, and a bound found early holds for every later tile
  const int n_tiles = ((n_d + tile_docs - 1) / tile_docs - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto tile_start = [&](int t) { return (blockIdx.x + t * gridDim.x) * tile_docs; };
  // stage tile `t` into buffer t & 1: its rows are bytes [g0, g0 + n) of the
  // matrix, placed `mis` bytes into the buffer, their address's offset from
  // a 16-byte boundary, so copies align on both sides. The range splits at
  // 4- and 16-byte boundaries: [0, a) and [e, n) are the bytes off a 4-byte
  // boundary (uint8 / uint16 rows only), plain loads and shared stores;
  // [a, b) and [c, e) 4-byte cp.async; [b, c) 16-byte cp.async. Nothing past
  // the tile's last byte is read.
  auto misalign = [&](size_t g0) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(docs + g0) & 15);
  };
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int d0 = tile_start(t);
      const size_t g0 = static_cast<size_t>(d0) * row_bytes;
      const int n = min(tile_docs, n_d - d0) * row_bytes;
      const int mis = misalign(g0);
      unsigned char* dst = ring + (t & 1) * buf_bytes + mis;
      const unsigned char* src = docs + g0;
      const int a = min(n, (4 - mis) & 3);
      const int b = a + min((n - a) & ~3, (16 - ((mis + a) & 15)) & 15);
      const int c = b + ((n - b) & ~15);
      const int e = c + ((n - c) & ~3);
      for (int i = tid; i < a; i += kThreads) dst[i] = src[i];
      for (int i = a + 4 * tid; i < b; i += 4 * kThreads) cp_async(dst + i, src + i, 0);
      for (int i = b + 16 * tid; i < c; i += 16 * kThreads) cp_async(dst + i, src + i, 1);
      for (int i = c + 4 * tid; i < e; i += 4 * kThreads) cp_async(dst + i, src + i, 0);
      for (int i = e + tid; i < n; i += kThreads) dst[i] = src[i];
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (tid == 0) tally[kTallyStart] = clock64();
  // runs between barriers, when an offer raised `need`, every `flush_rows`
  // rows (flushing every non-empty buffer) and at the end; then raises each
  // threshold to the bound the CTAs proved
  auto flush = [&](bool all) {
    __syncthreads();
    if (tid == 0) {
      *need = 0;
      tally[kTallyCycles] -= clock64();  // the pass's cycles: its end less its start
    }
    const int start = (blockIdx.x * kWarps) % n_lists;
    for (int j = warp; j < n_lists; j += kWarps) {
      const int l = (start + j) % n_lists;
      const int c = cnt[l];
      // a list's first flush comes after one tile, so that the CTA's bound
      // is published early; then when one more tile could overflow it
      if (all ? c > 0 : c + tile_docs > L.cap || (c > 0 && len[l] == 0)) {
        if (lane == 0) {
          ++tally[warp];
          tally[kWarps + warp] += c;
        }
        topk::warp_flush(L, loc, cb_base, blockIdx.x, blockIdx.x, gridDim.x, l, l, sk, ss);
      }
    }
    __syncthreads();
    for (int l = tid; l < n_lists; l += kThreads) topk::refresh(L, loc, l, l);
    __syncthreads();
    if (tid == 0) tally[kTallyCycles] += clock64();
  };

  int* wc = wcnt + warp * n_slots;
  int* mt = mterm + warp * n_cap;
  float* tb = tab + warp * n_cap;
  // count one token against the query terms
  auto count = [&](int tok) {
    if ((map[(tok & 0xffff) >> 5] >> (tok & 31)) & 1u) {
      const int idx = lookup(tok);
      if (idx >= 0 && atomicAdd(&wc[idx], 1) == 0) {  // the term's first hit: list it
        const int at = atomicAdd(&n_match[warp], 1);
        mt[at] = idx;
        atomicOr(&wc[idx], static_cast<int>(static_cast<unsigned>(at + 1) << 16));
      }
    }
  };
  int since_flush = 0;
  issue(0);
  for (int t = 0; t < n_tiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    // the last tile's offers are all in (the barrier above)
    const bool all = since_flush >= flush_rows;
    if (all) since_flush = 0;
    if (all || *need || (t & 3) == 0 || t == 1) {
      if (tid == 0) ++tally[all ? kTallyRows : *need ? kTallyNeed : kTallySched];
      flush(all);
    }
    issue(t + 1);  // the next tile lands while this one is counted
    const int d0 = tile_start(t);
    const int nt = min(tile_docs, n_d - d0);
    const size_t g0 = static_cast<size_t>(d0) * row_bytes;
    const unsigned char* tile = ring + (t & 1) * buf_bytes + misalign(g0);
    for (int r = warp; r < nt; r += kWarps) {
      const unsigned char* row = tile + r * row_bytes;
      const int gid = d0 + r;
      // the row's length, from global memory: asked for now, so that the
      // load is in flight while the row is counted and not waited for when
      // the epilogue starts
      const int dlen = __ldg(lens + gid);
      // count: each token once against the query terms; only positions
      // below the row's unpacked length (bit-planes pad their last group
      // with zeros, and 0 is a real term)
      if constexpr (Pack == kPackBits) {
        for (int x0 = 0; x0 < l_tok; x0 += 32) {  // the warp decodes 32 positions together
          const int tok = plane_token(row, x0 >> 5, lane, bits, sentinel);
          if (x0 + lane < l_tok) count(tok);
        }
      } else {
        for (int x = lane; x < l_tok; x += 32) count(row_token<Pack>(row, x, sentinel));
      }
      __syncwarp();
      if (tid == 0) tally[kTallyEpi] -= clock64();  // the row's epilogue: its end less its start
      const float dlf = fmaxf(static_cast<float>(dlen), 1.0f);
      const float log_dlf = logf(dlf), sqrt_dlf = sqrtf(dlf);
      const int nm = n_match[warp];
      // epilogue, model by model: the matched terms' scores, then lanes
      // over the lists
      for (int m = 0; m < n_models; ++m) {
        const int md = mode[m], kind = md & 3;
        const float norm = alpha[m] + beta[m] * static_cast<float>(dlen);
        const bool zero_ok = kind != 1 || norm > 0.0f;
        const float* wm = w + m * n_slots;
        const unsigned* om = qown + m * qwords;
        __syncwarp();  // the last model's sums have read the table
        unsigned n_uses = 0;
        for (int i = lane; i < nm; i += 32) {
          const int t = mt[i];
          if (zero_ok) {  // else no list reads the table; term_score at tf > 0
            const float wf = wm[tfirst[t]], tf = static_cast<float>(wc[t] & 0xffff);
            tb[i] = kind == 0 ? log1pf((wf * tf) / dlf)
                    : kind == 1 ? (wf * tf) / (tf + norm) : wf * log1pf(tf);
          }
          n_uses += tslots[t];
        }
        __syncwarp();
        unsigned n_self = 0;  // the tf > 0 slots that score themselves
        for (int qi = lane; qi < n_q; qi += 32) {
          const int p = m * n_q + qi;
          float s = 0.0f;
          if (zero_ok && !((om[qi >> 5] >> (qi & 31)) & 1u)) {
            // a slot with tf > 0 reads its term's score, one with tf = 0
            // scores w * 0 (term_score's zero path, as w is finite and the
            // norm positive); four slots' reads go out together, then their
            // sum runs on in order
            for (int l0 = 0; l0 < l_q; l0 += 4) {
              float pt[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int x = min(l0 + j, l_q - 1) * n_q + qi;
                const unsigned v = wc[slot_term[x]];
                const float z = wm[x] * 0.0f, tv = tb[max(v >> 16, 1u) - 1];
                pt[j] = v == 0 ? z : tv;
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (l0 + j < l_q) s = (l0 + j == 0) ? pt[j] : s + pt[j];
              }
            }
          } else {
            for (int l = 0; l < l_q; ++l) {  // each slot scores itself
              const int v = wc[slot_term[l * n_q + qi]] & 0xffff;
              n_self += v != 0;
              const float pt = term_score(kind, wm[l * n_q + qi], static_cast<float>(v), dlf,
                                          norm);
              s = (l == 0) ? pt : s + pt;
            }
          }
          if (topk::offer(L, loc, cb_base, p, finish(s, md, dlen, log_dlf, sqrt_dlf), gid) +
                  tile_docs > L.cap) {
            *need = 1;
          }
        }
        n_self = __reduce_add_sync(0xffffffffu, n_self);
        n_uses = __reduce_add_sync(0xffffffffu, n_uses);
        if (lane == 0) {
          tally[kTallyScores + warp] += (zero_ok ? nm : 0) + n_self;
          tally[kTallyUses + warp] += n_uses;
        }
      }
      if (tid == 0) tally[kTallyEpi] += clock64();
      __syncwarp();
      for (int i = lane; i < nm; i += 32) wc[mt[i]] = 0;
      if (lane == 0) n_match[warp] = 0;
      __syncwarp();
    }
    since_flush += tile_docs;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  flush(true);
  for (int l = tid; l < n_lists; l += kThreads) {
    L.st_len[static_cast<size_t>(blockIdx.x) * n_lists + l] = len[l];
  }
  // the flush's last barrier has put every warp's counts in
  if (tid == 0 && counters != nullptr) {
    unsigned long long lists = 0, cands = 0, scores = 0, uses = 0;
    for (int i = 0; i < kWarps; ++i) {
      lists += tally[i];
      cands += tally[kWarps + i];
      scores += tally[kTallyScores + i];
      uses += tally[kTallyUses + i];
    }
    const unsigned long long counts[kCounters] = {
        tally[kTallyNeed], tally[kTallySched], tally[kTallyRows], 1ull, lists, cands,
        tally[kTallyCycles], clock64() - tally[kTallyStart], scores, uses, tally[kTallyEpi]};
#pragma unroll
    for (int i = 0; i < kCounters; ++i) atomicAdd(&counters[i], counts[i]);
  }
}

// The final top k of each list from the CTAs' lists: grid (n_lists).
extern "C" __global__ void __launch_bounds__(kThreads)
lexical_scan_merge(topk::Lists L, float* __restrict__ out_s, int* __restrict__ out_i,
                   int n_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = blockIdx.x;
  topk::merge_lists(L, l, l, 0, n_split, out_s + static_cast<size_t>(l) * L.k,
                    out_i + static_cast<size_t>(l) * L.k, smem);
}

// Plain C entry point for ctypes: the scan, then the merge. `pack` is the
// token layout (kPack*), `l_tok` the unpacked row length, `row_bytes` a
// stored row's bytes, `bits` the bit-planes and `sentinel` the packed PAD;
// the scan adds its counts to `counters` (kCounters uint64s, or null).
// Returns cudaGetLastError() after the launches (the Python wrapper raises
// when that is not cudaSuccess).
extern "C" int lexical_scan_launch(
    const void* q_safe, const void* weights, const void* ab, const void* modes,
    const void* docs, const void* lens, void* st_s, void* st_i, void* st_len, void* pub,
    void* thr, void* cb_s, void* cb_i, void* out_s, void* out_i, int n_q, int l_q,
    int n_models, int n_d, int l_tok, int row_bytes, int pack, int bits, int sentinel, int k,
    int k_pad, int cap, int n_splits, int tile_docs, int flush_rows, int log2h,
    int smem_bytes, int merge_smem_bytes, void* counters, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_lists = n_models * n_q;
  const topk::Lists L{static_cast<float*>(st_s), static_cast<int*>(st_i),
                      static_cast<int*>(st_len), static_cast<unsigned long long*>(pub),
                      static_cast<unsigned long long*>(thr), static_cast<float*>(cb_s),
                      static_cast<int*>(cb_i), k, k_pad, cap, n_lists,
                      (k + n_splits - 1) / n_splits};
  // the scan kernel of this token layout
  decltype(&lexical_scan_kernel<kPackNone>) scan;
  switch (pack) {
    case kPackNone: scan = lexical_scan_kernel<kPackNone>; break;
    case kPackU8: scan = lexical_scan_kernel<kPackU8>; break;
    case kPackU16: scan = lexical_scan_kernel<kPackU16>; break;
    case kPackBits: scan = lexical_scan_kernel<kPackBits>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  scan<<<n_splits, kThreads, smem_bytes, s>>>(
      static_cast<const int*>(q_safe), static_cast<const float*>(weights),
      static_cast<const float*>(ab), static_cast<const int*>(modes),
      static_cast<const unsigned char*>(docs), static_cast<const int*>(lens), L, n_q, l_q,
      n_models, n_d, l_tok, row_bytes, bits, sentinel, tile_docs, flush_rows, log2h,
      static_cast<unsigned long long*>(counters));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(lexical_scan_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           merge_smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  lexical_scan_merge<<<n_lists, kThreads, merge_smem_bytes, s>>>(
      L, static_cast<float*>(out_s), static_cast<int*>(out_i), n_splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lexical_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
