// Dense score + top-k for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel `score_topk_pallas`
// (src/repro/kernels/score_topk.py, body `_score_topk_kernel`). For every
// query q [dim] and every document row d [dim] it takes the score q . d,
// accumulated in float32, and keeps each query's top k documents ordered by
// (score desc, id asc); empty slots stay (-inf, -1) when k exceeds the corpus.
//
// Scores on the tensor cores, at float32 accuracy. `mma.sync` m16n8k8 TF32
// for float32 rows, with each operand split in registers as x = hi + lo,
// hi = tf32(x), lo = tf32(x - hi) (cvt.rna: round to nearest, ties away), and
// three products per 8-wide step: hi_d.hi_q summed in one accumulator,
// lo_d.hi_q + hi_d.lo_q in another, the score their sum (the dropped lo.lo
// term is below 2^-21 of a product); m16n8k16 bfloat16 for
// bfloat16 rows, one product, exact in the float32 accumulator. Values that
// fit TF32 (integer-valued rows, every bfloat16 value) have lo = 0, so their
// products are exact. A score is the same fixed sequence of tensor-core steps
// over x = 0, 8, 16, ... for every (query, document) pair, wherever the pair
// sits in a tile: the result does not depend on the block, split, tile or
// query bucket.
//
// What bounds it on an H100. A call reads the document matrix once (16 GiB
// for 2^24 x 256 float32: 5.1 ms at 3.35 TB/s); three TF32 products are
// 3 x 2 x n_q x n_d x dim operations (64 queries: 1.65e12, 3.3 ms at 495
// TFLOP/s). The least time at float32-level accuracy is the byte bound.
//
// Layout. One launch: grid (doc splits, query groups), one CTA per SM. A CTA
// holds its group's queries (up to 128, padded to a power of two >= 8) in
// shared memory for the whole call, so a 64- or 128-query block streams the
// corpus once. It walks its split in tiles of 32 x DW rows; each row is
// staged 128 bytes at a time (one L2 line) through a ring of `stages`
// buffers filled by 16-byte cp.async copies, so the next chunks land while
// this one is scored. Eight warps: QW along the queries (NW each) and DW
// along the rows (32 each); a warp's accumulators are 32 rows x NW queries.
// Staged rows and query rows are padded by 16 bytes, so the fragment loads
// (8 rows x 4 words) hit 32 distinct banks. After a tile, every score is
// offered to its query's threshold and the few that pass go to the CTA's
// candidate buffer; full buffers are flushed into the CTA's own list for
// the query, and the CTAs prove a common threshold together
// (topk_merge.cuh). A second kernel, grid (n_q), merges each query's lists.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "topk_merge.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 128;  // bytes of every row staged per step: one L2 line
constexpr int kRowStride = kStageBytes + 16;  // 36 words: conflict-free fragment loads

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One staged 128-byte chunk of the tile's rows against the warp's queries.
// `tw`: the chunk's words, kRowStride / 4 words a row; `qw`: the queries'
// words at this chunk, `qs` words a row. Rows (M) are the warp's 32 (two
// m16 tiles), queries (N) its NW (NW / 8 n8 tiles).
template <typename T, int NW>
struct Chunk;

template <int NW>
struct Chunk<float, NW> {
  __device__ static __forceinline__ void score(const float* tw, const float* qw, int qs,
                                               int row0, int q0, int g, int t,
                                               float (&acc)[2][NW / 8][4],
                                               float (&lo)[2][NW / 8][4]) {
    constexpr int R = kRowStride / 4;
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* r = tw + (row0 + mt * 16 + g) * R + kk + t;
        split(r[0], ahi[mt][0], alo[mt][0]);
        split(r[8 * R], ahi[mt][1], alo[mt][1]);
        split(r[4], ahi[mt][2], alo[mt][2]);
        split(r[8 * R + 4], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NW / 8; ++nt) {
        const float* c = qw + (q0 + nt * 8 + g) * qs + kk + t;
        uint32_t bhi0, blo0, bhi1, blo1;
        split(c[0], bhi0, blo0);
        split(c[4], bhi1, blo1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], ahi[mt], bhi0, bhi1);
          mma_tf32(lo[mt][nt], alo[mt], bhi0, bhi1);
          mma_tf32(lo[mt][nt], ahi[mt], blo0, blo1);
        }
      }
    }
  }
};

template <int NW>
struct Chunk<__nv_bfloat16, NW> {
  __device__ static __forceinline__ void score(const uint32_t* tw, const uint32_t* qw, int qs,
                                               int row0, int q0, int g, int t,
                                               float (&acc)[2][NW / 8][4],
                                               float (&)[2][NW / 8][4]) {
    constexpr int R = kRowStride / 4;
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8) {  // 8 words = 16 bfloat16 per step
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* r = tw + (row0 + mt * 16 + g) * R + kk + t;
        a[mt][0] = r[0];
        a[mt][1] = r[8 * R];
        a[mt][2] = r[4];
        a[mt][3] = r[8 * R + 4];
      }
#pragma unroll
      for (int nt = 0; nt < NW / 8; ++nt) {
        const uint32_t* c = qw + (q0 + nt * 8 + g) * qs + kk + t;
        const uint32_t b0 = c[0], b1 = c[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
};

template <typename T>
using Word = typename std::conditional<std::is_same<T, float>::value, float, uint32_t>::type;

// QW warps along the queries (NW each), kWarps / QW along the rows (32 each)
template <typename T, int NW, int QW>
__global__ void __launch_bounds__(kThreads, 1)
score_topk_scan(const T* __restrict__ q,     // [n_q, dim]
                const T* __restrict__ docs,  // [n_d, dim]
                topk::Lists L, int n_q, int dim, int n_d, int group, int split_rows,
                int stages) {
  constexpr int DW = kWarps / QW;
  constexpr int kTile = 32 * DW;
  constexpr int kQP = NW * QW;  // padded queries of the group
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wq = warp % QW, wd = warp / QW;
  const int q_first = blockIdx.y * group;
  const int n_here = min(group, n_q - q_first);
  const int d_begin = blockIdx.x * split_rows;
  const int d_end = min(n_d, d_begin + split_rows);
  const int row_bytes = dim * static_cast<int>(sizeof(T));
  const int n_ch = row_bytes / kStageBytes;
  const int qs_bytes = row_bytes + 16;

  unsigned char* ring = smem;  // [stages][kTile][kRowStride]
  unsigned char* qsm = ring + stages * kTile * kRowStride;  // [kQP][qs_bytes]
  float* ts = reinterpret_cast<float*>(qsm + kQP * qs_bytes);
  int* ti = reinterpret_cast<int*>(ts + kQP);
  int* cnt = ti + kQP;
  int* len = cnt + kQP;
  int* need = len + kQP;  // a buffer may overflow in the next tile: flush first
  unsigned long long* rkey = reinterpret_cast<unsigned long long*>(len + kQP + 2);
  unsigned long long* kkey = rkey + kQP;
  unsigned long long* scratch = kkey + kQP;
  const int sc = [&] { int w = 1; while (w < L.cap) w <<= 1; return w; }();
  unsigned long long* sk = scratch + warp * sc;  // this warp's flush scratch
  float* ss = reinterpret_cast<float*>(scratch + kWarps * sc) + warp * sc;
  const topk::Local loc{ts, ti, cnt, len, rkey, kkey};
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t cb_base = static_cast<size_t>(cta) * group * L.cap;

  // the group's queries, zero rows past its last
  const unsigned char* qsrc = reinterpret_cast<const unsigned char*>(q) +
                              static_cast<size_t>(q_first) * row_bytes;
  for (int c = tid; c < kQP * (row_bytes / 16); c += kThreads) {
    const int r = c / (row_bytes / 16), x = c - r * (row_bytes / 16);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < n_here) v = *reinterpret_cast<const uint4*>(qsrc + static_cast<size_t>(r) * row_bytes + x * 16);
    *reinterpret_cast<uint4*>(qsm + r * qs_bytes + x * 16) = v;
  }
  for (int l = tid; l < n_here; l += kThreads) {
    topk::set_local(loc, l, __ldcg(&L.thr[q_first + l]));
    cnt[l] = 0;
    len[l] = 0;
    rkey[l] = kkey[l] = 0;
  }
  if (tid == 0) *need = 0;

  const int n_tiles = (d_end - d_begin + kTile - 1) / kTile;
  const int n_it = max(0, n_tiles * n_ch);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(docs);
  auto issue = [&](int it) {
    if (it < n_it) {
      const int tile = it / n_ch, ch = it - tile * n_ch;
      const int d0 = d_begin + tile * kTile;
      const int nt = min(kTile, d_end - d0);
      unsigned char* dst = ring + (it % stages) * kTile * kRowStride;
      for (int c = tid; c < nt * (kStageBytes / 16); c += kThreads) {
        const int r = c >> 3, x = c & 7;
        cp_async16(dst + r * kRowStride + x * 16,
                   src + static_cast<size_t>(d0 + r) * row_bytes + ch * kStageBytes + x * 16);
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  // flush every buffer that one more tile could overflow (all non-empty ones
  // at the end); warps take lists in turn, starting apart across CTAs. Runs
  // only when an offer raised `need` (and at the end), between barriers
  auto flush = [&](bool last) {
    __syncthreads();
    if (tid == 0) *need = 0;
    const int start = (blockIdx.x * kWarps) % max(1, n_here);
    for (int j = warp; j < n_here; j += kWarps) {
      const int l = (start + j) % n_here;
      const int c = cnt[l];
      // a list's first flush comes after one tile, so that the CTA's bound
      // is published early; then when one more tile could overflow it
      if (last ? c > 0 : c + kTile > L.cap || (c > 0 && len[l] == 0)) {
        topk::warp_flush(L, loc, cb_base, cta, blockIdx.x, gridDim.x, l, q_first + l, sk, ss);
      }
    }
    __syncthreads();
    if (last) {
      for (int l = tid; l < n_here; l += kThreads) {
        L.st_len[static_cast<size_t>(cta) * group + l] = len[l];
      }
    }
  };

  // hi x hi products in acc, the two cross products in lo (two independent
  // chains for the tensor cores); a score is acc + lo (lo stays 0 for
  // bfloat16 rows and for values that fit TF32)
  float acc[2][NW / 8][4], lo[2][NW / 8][4];
  for (int s = 0; s < stages - 1; ++s) issue(s);
  for (int it = 0; it < n_it; ++it) {
    const int tile = it / n_ch, ch = it - tile * n_ch;
    if (ch == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NW / 8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][nt][r] = lo[mt][nt][r] = 0.0f;
    }
    // stage `it` has landed once at most stages - 2 younger groups are pending
    switch (stages) {
      case 8: cp_async_wait<6>(); break;
      case 7: cp_async_wait<5>(); break;
      case 6: cp_async_wait<4>(); break;
      case 5: cp_async_wait<3>(); break;
      case 4: cp_async_wait<2>(); break;
      case 3: cp_async_wait<1>(); break;
      default: cp_async_wait<0>();
    }
    __syncthreads();
    issue(it + stages - 1);  // into the buffer every warp finished with above
    if (ch == 0) {
      // the last tile's offers are all in (the barrier above): flush if one
      // asked, then raise each threshold to the bound the CTAs proved; no
      // thread reads a threshold before the filter, after the next barrier
      if (*need || tile == 1) flush(false);
      for (int l = tid; l < n_here; l += kThreads) topk::refresh(L, loc, l, q_first + l);
      if (n_ch == 1) __syncthreads();
    }
    const unsigned char* tb = ring + (it % stages) * kTile * kRowStride;
    Chunk<T, NW>::score(reinterpret_cast<const Word<T>*>(tb),
                        reinterpret_cast<const Word<T>*>(qsm + ch * kStageBytes),
                        qs_bytes / 4, wd * 32, wq * NW, g, t, acc, lo);
    if (ch == n_ch - 1) {
      const int d0 = d_begin + tile * kTile;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NW / 8; ++nt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int doc = d0 + wd * 32 + mt * 16 + g + (r >> 1) * 8;
            const int ql = wq * NW + nt * 8 + 2 * t + (r & 1);
            if (doc < d_end && ql < n_here &&
                topk::offer(L, loc, cb_base, ql, acc[mt][nt][r] + lo[mt][nt][r], doc) +
                        kTile > L.cap) {
              *need = 1;
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  flush(true);
}

// The final top k of each query from its group's CTA lists: grid (n_q).
__global__ void __launch_bounds__(kThreads)
score_topk_merge(topk::Lists L, float* __restrict__ out_s, int* __restrict__ out_i, int group,
                 int n_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  const int gi = q / group;
  topk::merge_lists(L, q, q - gi * group, gi * n_split, n_split,
                    out_s + static_cast<size_t>(q) * L.k, out_i + static_cast<size_t>(q) * L.k,
                    smem);
}

template <typename T, int NW, int QW>
int launch(const void* q, const void* docs, const topk::Lists& L, int n_q, int dim, int n_d,
           int group, int split_rows, int n_splits, int n_groups, int stages, int smem_bytes,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(score_topk_scan<T, NW, QW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  score_topk_scan<T, NW, QW><<<dim3(n_splits, n_groups), kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(docs), L, n_q, dim, n_d, group,
      split_rows, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_padded(int n_qp, const void* q, const void* docs, const topk::Lists& L, int n_q,
                  int dim, int n_d, int group, int split_rows, int n_splits, int n_groups,
                  int stages, int smem_bytes, cudaStream_t s) {
  switch (n_qp) {
    case 8: return launch<T, 8, 1>(q, docs, L, n_q, dim, n_d, group, split_rows, n_splits, n_groups, stages, smem_bytes, s);
    case 16: return launch<T, 16, 1>(q, docs, L, n_q, dim, n_d, group, split_rows, n_splits, n_groups, stages, smem_bytes, s);
    case 32: return launch<T, 32, 1>(q, docs, L, n_q, dim, n_d, group, split_rows, n_splits, n_groups, stages, smem_bytes, s);
    case 64: return launch<T, 32, 2>(q, docs, L, n_q, dim, n_d, group, split_rows, n_splits, n_groups, stages, smem_bytes, s);
    case 128: return launch<T, 32, 4>(q, docs, L, n_q, dim, n_d, group, split_rows, n_splits, n_groups, stages, smem_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point for ctypes: the scan, then the merge. Returns
// cudaGetLastError() after the launches (the Python wrapper raises when that
// is not cudaSuccess).
extern "C" int score_topk_launch(const void* q, const void* docs, void* st_s, void* st_i,
                                 void* st_len, void* pub, void* thr, void* cb_s, void* cb_i,
                                 void* out_s, void* out_i, int n_q, int dim, int n_d, int k,
                                 int k_pad, int cap, int group, int n_qp, int split_rows,
                                 int n_splits, int n_groups, int stages, int bf16,
                                 int smem_bytes, int merge_smem_bytes, void* stream) {
  const topk::Lists L{static_cast<float*>(st_s), static_cast<int*>(st_i),
                      static_cast<int*>(st_len), static_cast<unsigned long long*>(pub),
                      static_cast<unsigned long long*>(thr), static_cast<float*>(cb_s),
                      static_cast<int*>(cb_i), k, k_pad, cap, group,
                      (k + n_splits - 1) / n_splits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = bf16 ? launch_padded<__nv_bfloat16>(n_qp, q, docs, L, n_q, dim, n_d, group,
                                                     split_rows, n_splits, n_groups, stages,
                                                     smem_bytes, s)
                      : launch_padded<float>(n_qp, q, docs, L, n_q, dim, n_d, group,
                                             split_rows, n_splits, n_groups, stages,
                                             smem_bytes, s);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(score_topk_merge,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       merge_smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  score_topk_merge<<<n_q, kThreads, merge_smem_bytes, s>>>(
      L, static_cast<float*>(out_s), static_cast<int*>(out_i), group, n_splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* score_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
