// Blockwise (flash) attention for Hopper (sm_90a): causal and sliding-window
// masks, gemma2's logit soft cap, native GQA.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attn.py, body `_flash_kernel`). For query row i of
// head h and key row j of KV head h / (H / KV) it takes the score
// s = (q_i . k_j) * hd^-0.5 in float32, then cap * tanh(s / cap) when a cap
// is set, masks s to NEG = -1e30 where j > i (causal) or i - j >= window,
// and returns sum_j softmax_j(s) v_j in the input dtype. The running
// online-softmax state (m, l, acc) is float32; in bfloat16 the
// probabilities are rounded to bfloat16 before the P.V product, as the TPU
// kernel does (`p.astype(v.dtype)`), and l sums them unrounded. The output
// is acc / max(l, 1e-30). NEG is finite: a row whose keys so far are all
// masked carries exp(NEG - NEG) = 1 until its first real score, whose
// exp(NEG - m) = 0 then wipes it; -inf would give NaN there.
//
// What bounds it on an H100. At gemma2-2b's prefill (B 4, S 8192, H 8,
// hd 256, bfloat16) one global layer is 4 * B * H * hd * S(S+1)/2 = 1.1e12
// tensor-core operations (1.11 ms at 989 TFLOP/s) against 0.40 GB of
// q, k, v and o (0.12 ms at 3.35 TB/s): the bound is operations, on the
// bfloat16 tensor cores.
//
// Layout. The TPU kernel walks the KV blocks as the sequential innermost
// grid axis, carrying (m, l, acc) in VMEM scratch. Hopper CTAs run in
// parallel and in no order, so one CTA owns one (b, h, q-block) and loops
// over the KV blocks itself, keeping the state in registers:
//   * bfloat16 (`flash_attn_bf16<HD>`): block_q / 16 warps, each owning 16
//     query rows. Q, K and V tiles are staged in shared memory by cp.async,
//     rows padded by 16 bytes so the 8 row addresses of an ldmatrix hit 8
//     distinct bank groups. Each warp takes the staged K/V block 64 keys at
//     a time: S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 accumulate) into
//     registers, scale / cap / mask / online softmax on the accumulator
//     fragment, then O += P V with P re-packed from the accumulator as the
//     A operand and V read by ldmatrix.trans. The score tile never leaves
//     registers, so shared memory holds only Q, K and V: at block_q =
//     block_k = 128 and hd 256, 3 x 128 x 264 x 2 = 202,752 bytes (of the
//     232,448 a block may use). The wrapper checks the tile against that
//     limit and raises; it does not tile hd.
//   * float32 (`flash_attn_f32`): the reference checks float32 to 3e-4 /
//     3e-5, which TF32 tensor cores (10 mantissa bits) cannot meet, so this
//     path runs on the CUDA cores: a warp per query row, 32 keys at a time
//     (lane j scores key j against the row staged in shared memory), then
//     each lane accumulates its dims of P V. It is the checking path, not
//     the model's (the model serves in bfloat16).
// KV blocks (and, per warp, 64-key sub-tiles) wholly outside the
// causal / window band are skipped: exact, by the NEG argument above. CTAs
// are issued longest rows first (q blocks in reverse), so the causal tail
// does not idle the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kSub = 64;  // keys per compute sub-tile of the bf16 path
constexpr int kPad = 8;   // bf16 elements of padding per staged row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a (16x16 bf16, row-major fragment) x b (16x8 bf16, col fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float score_of(float dot, float scale, float cap) {
  float x = dot * scale;
  if (cap > 0.f) x = cap * tanhf(x / cap);
  return x;
}

__device__ __forceinline__ bool allowed(int i, int j, int causal, int window) {
  return (!causal || j <= i) && (window <= 0 || i - j < window);
}

// KV block range [lo, hi] that can hold an allowed key for rows q0..q0+n-1
__device__ __forceinline__ void kv_blocks(int q0, int n, int S, int block_k, int causal,
                                          int window, int& lo, int& hi) {
  hi = causal ? (q0 + n - 1) / block_k : S / block_k - 1;
  lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / block_k;
}

template <int HD>
__global__ void __launch_bounds__(256, 1)
    flash_attn_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
                    int H, int KV, float scale, float cap, int causal, int window,
                    int block_q, int block_k) {
  constexpr int LD = HD + kPad;
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + block_q * LD;
  __nv_bfloat16* sV = sK + block_k * LD;

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qb * block_q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const __nv_bfloat16* qg = q + (static_cast<size_t>(b) * S * H + h) * HD;
  const __nv_bfloat16* kg = k + (static_cast<size_t>(b) * S * KV + kvh) * HD;
  const __nv_bfloat16* vg = v + (static_cast<size_t>(b) * S * KV + kvh) * HD;

  for (int c = tid; c < block_q * CH; c += blockDim.x) {
    const int r = c / CH, cc = c % CH;
    cp_async16(sQ + r * LD + cc * 8, qg + static_cast<size_t>(q0 + r) * q_stride + cc * 8);
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  const int w0 = q0 + warp * 16;          // the warp's first row
  const int row_a = w0 + (lane >> 2);     // this thread's rows: row_a, row_a + 8
  const int col_t = (lane & 3) * 2;       // this thread's column pair in an 8-wide tile

  int kb_lo, kb_hi;
  kv_blocks(q0, block_q, S, block_k, causal, window, kb_lo, kb_hi);
  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * block_k;
    __syncthreads();  // every warp is done with the previous K/V block
    for (int c = tid; c < block_k * CH; c += blockDim.x) {
      const int r = c / CH, cc = c % CH;
      const size_t off = static_cast<size_t>(k0 + r) * kv_stride + cc * 8;
      cp_async16(sK + r * LD + cc * 8, kg + off);
      cp_async16(sV + r * LD + cc * 8, vg + off);
    }
    cp_async_wait_all();
    __syncthreads();

    for (int sub = 0; sub < block_k; sub += kSub) {
      const int c0 = k0 + sub;
      if (causal && c0 > w0 + 15) continue;                    // all keys after all rows
      if (window > 0 && w0 - (c0 + kSub - 1) >= window) continue;  // all before the window

      float s[kSub / 8][4];
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, sQ + (warp * 16 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < kSub / 16; ++np) {
          uint32_t bb[4];
          ldmatrix_x4(bb, sK + (sub + np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + ks * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }

      // scale, cap, mask; the running max of each of this thread's two rows
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = row_a + (e >> 1) * 8;
          const int j = c0 + n * 8 + col_t + (e & 1);
          const float x = allowed(i, j, causal, window) ? score_of(s[n][e], scale, cap) : kNeg;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 threads of a row group share its rows
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = expf(m_r[r] - mx[r]);
        m_r[r] = mx[r];
      }
      uint32_t pa[kSub / 16][4];
#pragma unroll
      for (int n = 0; n < kSub / 8; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(s[n][e] - m_r[e >> 1]);
          rs[e >> 1] += p[e];
        }
        pa[n >> 1][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l_r[r] = l_r[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, sV + (sub + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                    dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pa[kk], bb[0], bb[1]);
          mma_bf16(acc[2 * dp + 1], pa[kk], bb[2], bb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(l_r[r], 1e-30f);
    __nv_bfloat16* og = o + (static_cast<size_t>(b) * S * H + h) * HD +
                        static_cast<size_t>(row_a + r * 8) * q_stride;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(og + n * 8 + col_t) =
          __floats2bfloat162_rn(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    }
  }
}

constexpr int kF32Warps = 4;
constexpr int kF32MaxHd = 256;

__global__ void __launch_bounds__(kF32Warps * 32)
    flash_attn_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, int S, int H, int KV,
                   int hd, float scale, float cap, int causal, int window, int block_q) {
  __shared__ __align__(16) float sq[kF32Warps][kF32MaxHd];
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t q_stride = static_cast<size_t>(H) * hd;
  const size_t kv_stride = static_cast<size_t>(KV) * hd;
  const float* kg = k + (static_cast<size_t>(b) * S * KV + kvh) * hd;
  const float* vg = v + (static_cast<size_t>(b) * S * KV + kvh) * hd;
  constexpr int kDims = kF32MaxHd / 32;

  for (int i = qb * block_q + warp; i < (qb + 1) * block_q; i += kF32Warps) {
    const size_t row_off = (static_cast<size_t>(b) * S + i) * q_stride + static_cast<size_t>(h) * hd;
    __syncwarp();
    for (int d = lane; d < hd; d += 32) sq[warp][d] = q[row_off + d];
    __syncwarp();
    const int lo = (window > 0 && i - window + 1 > 0) ? i - window + 1 : 0;
    const int hi = causal ? i : S - 1;
    float m = -INFINITY, l = 0.f;
    float acc[kDims];
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[c] = 0.f;
    for (int j0 = lo; j0 <= hi; j0 += 32) {
      const int j = j0 + lane;
      float s = kNeg;
      if (j <= hi) {
        const float4* kr = reinterpret_cast<const float4*>(kg + static_cast<size_t>(j) * kv_stride);
        const float4* qr = reinterpret_cast<const float4*>(sq[warp]);
        float dot = 0.f;
        for (int d4 = 0; d4 < hd / 4; ++d4) {
          const float4 kk = kr[d4], qq = qr[d4];
          dot += qq.x * kk.x;
          dot += qq.y * kk.y;
          dot += qq.z * kk.z;
          dot += qq.w * kk.w;
        }
        s = score_of(dot, scale, cap);
      }
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      const float p = j <= hi ? expf(s - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l = l * alpha + ps;
      m = m_new;
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[c] *= alpha;
      const int n = min(32, hi - j0 + 1);
      for (int jj = 0; jj < n; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const float* vr = vg + static_cast<size_t>(j0 + jj) * kv_stride;
#pragma unroll
        for (int c = 0; c < kDims; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) acc[c] += pj * vr[d];
        }
      }
    }
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) o[row_off + d] = acc[c] / den;
    }
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int KV, float scale, float cap, int causal, int window, int block_q,
                int block_k, cudaStream_t stream) {
  const int smem = (block_q + 2 * block_k) * (HD + kPad) * 2;
  cudaError_t e = cudaFuncSetAttribute(flash_attn_bf16<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(S / block_q, H, B);
  flash_attn_bf16<HD><<<grid, (block_q / 16) * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, KV, scale,
      cap, causal, window, block_q, block_k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after its
// launch (cudaErrorInvalidValue for a head_dim the bf16 path is not built
// for); the Python wrapper checks shapes first and raises when this is not
// cudaSuccess. cap <= 0 means no soft cap, window <= 0 no window.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int B,
                                 int S, int H, int KV, int hd, float scale, float cap,
                                 int causal, int window, int block_q, int block_k, int bf16,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) {
    const dim3 grid(S / block_q, H, B);
    flash_attn_f32<<<grid, kF32Warps * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, hd, scale, cap, causal,
        window, block_q);
    return static_cast<int>(cudaGetLastError());
  }
  switch (hd) {
    case 32: return launch_bf16<32>(q, k, v, o, B, S, H, KV, scale, cap, causal, window, block_q, block_k, s);
    case 64: return launch_bf16<64>(q, k, v, o, B, S, H, KV, scale, cap, causal, window, block_q, block_k, s);
    case 80: return launch_bf16<80>(q, k, v, o, B, S, H, KV, scale, cap, causal, window, block_q, block_k, s);
    case 128: return launch_bf16<128>(q, k, v, o, B, S, H, KV, scale, cap, causal, window, block_q, block_k, s);
    case 256: return launch_bf16<256>(q, k, v, o, B, S, H, KV, scale, cap, causal, window, block_q, block_k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
