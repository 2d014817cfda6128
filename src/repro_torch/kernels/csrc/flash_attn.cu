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
// The TPU kernel walks the KV blocks as the sequential innermost grid axis,
// carrying (m, l, acc) in VMEM scratch. Hopper CTAs run in parallel and in
// no order, so a CTA owns its query rows and loops over the KV blocks
// itself, with the state in registers. Three routes, chosen by dtype and
// head_dim alone (`flash_attn_launch`; never because another one failed):
//
//   1. bfloat16 at head_dim 64, 128, 256 (`flash_attn_wgmma<HD>`): TMA,
//      wgmma, warp-specialised. A CTA takes 128 query rows of one head and
//      runs three warpgroups:
//        * the producer (warpgroup 0, registers cut to 24 by setmaxnreg):
//          one thread loads Q once, then K and V tiles of BK keys into a
//          two-stage ring, by TMA (cp.async.bulk.tensor) straight from the
//          model's [B, S, heads, hd] layouts (3-D tensor maps over (hd,
//          heads, B*S): one head's rows lie H*hd apart, nothing is copied
//          first), 128-byte swizzled, 64 columns per box. Each stage has a
//          full and an empty mbarrier for K and for V, so S = Q K^T can
//          start before V lands.
//        * two consumers (warpgroups 1 and 2, registers raised to 240), 64
//          query rows each: S = Q K^T by wgmma with both operands in shared
//          memory (K-major), the scale / soft cap / mask / online softmax on
//          the accumulator registers, then O += P V by wgmma with P, rounded
//          to bfloat16, as the A operand in registers and V read MN-major
//          (transposed) from shared memory. At hd 256, O is 128 float32
//          registers per thread.
//      The two consumers run unsynchronised, so one's softmax overlaps the
//      other's products wherever the scheduler lets it (strict turns at the
//      tensor cores by named barriers timed the same: PERF.md). The
//      softmax works in base 2: log2(e) and scale / cap are folded into one
//      multiply before tanh and one after, the exponential is ex2 and the
//      tanh is tanh.approx.f32 (tanhf timed slower: PERF.md).
//      Only tiles that cross the diagonal, the window's edge or the end of
//      the sequence take a per-element mask. BK is 64 at hd 256 (Q 64 KiB +
//      two stages of K and V at 32 KiB each = 192 KiB of the 227 KiB a block
//      may use; 64 divides the 128-row query block, so the diagonal lies in
//      two tiles), 128 at hd 64 and 128. GQA: a CTA takes one query head;
//      the G query heads of a KV head are neighbouring CTAs (blockIdx.x), so
//      the second read of a K/V tile comes from L2. The grid's slowest axis
//      walks the query blocks from the last, so the longest causal rows run
//      first.
//   2. bfloat16 at head_dim 32 and 80 (`flash_attn_bf16<HD>`, h2o-danube-
//      1.8b's 80): wgmma's 128-byte swizzle takes hd in multiples of 64, so
//      these run on mma.sync m16n8k16: block_q / 16 warps, each owning 16
//      query rows; Q, K and V tiles staged in shared memory by cp.async,
//      rows padded by 16 bytes so the 8 row addresses of an ldmatrix hit 8
//      distinct bank groups; the score tile stays in registers, and P is
//      re-packed from the accumulator as the A operand of P V (V read by
//      ldmatrix.trans).
//   3. float32 (`flash_attn_f32`): the reference checks float32 to 3e-4 /
//      3e-5, which TF32 tensor cores (10 mantissa bits) cannot meet, so this
//      path runs on the CUDA cores: a warp per query row, 32 keys at a time
//      (lane j scores key j against the row staged in shared memory), then
//      each lane accumulates its dims of P V. It is the checking path, not
//      the model's (the model serves in bfloat16).
// KV blocks wholly outside the causal / window band are skipped on every
// route: exact, by the NEG argument above.
//
// The tensor maps are encoded on the host for each call by
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint(ByVersion)
// so that the library links no libcuda, and passed as
// `const __grid_constant__ CUtensorMap` parameters.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma, setmaxnreg

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
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

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the soft cap's tanh: one MUFU instruction (relative error about 2^-11,
// under the bfloat16 rounding of p)
__device__ __forceinline__ float cap_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ bool allowed(int i, int j, int causal, int window) {
  return (!causal || j <= i) && (window <= 0 || i - j < window);
}

// KV block range [lo, hi] that can hold an allowed key for rows q0..q0+n-1
__device__ __forceinline__ void kv_blocks(int q0, int n, int S, int block_k, int causal,
                                          int window, int& lo, int& hi) {
  hi = causal ? min(q0 + n - 1, S - 1) / block_k : (S - 1) / block_k;
  lo = 0;
  if (window > 0 && q0 - window + 1 > 0) lo = (q0 - window + 1) / block_k;
}

// ---------------------------------------------------------------------------
// Route 1: bfloat16, head_dim 64 / 128 / 256 — TMA + wgmma, warp-specialised

// d (64 x 64, f32) = (accumulate ? d : 0) + A . B^T: A 64 x 16 and B 64 x 16,
// both bf16 in shared memory, K-major, 128-byte swizzle
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) = (accumulate ? d : 0) + A . B^T: A 64 x 16 and B 128 x 16,
// both bf16 in shared memory, K-major, 128-byte swizzle
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A . B: A 64 x 16 bf16 in registers, B 16 x 64 bf16 in
// shared memory, MN-major (transposed), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A . B: A 64 x 16 bf16 in registers, B 16 x 128 bf16 in
// shared memory, MN-major (transposed), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A . B: A 64 x 16 bf16 in registers, B 16 x 256 bf16 in
// shared memory, MN-major (transposed), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


constexpr int kWgRows = 64;                // query rows per consumer warpgroup
constexpr int kBq = 2 * kWgRows;           // query rows per CTA
constexpr int kWgThreads = 3 * 128;        // producer + two consumer warpgroups
constexpr int kStages = 2;                 // K/V ring depth

template <int HD>
struct WgLayout {
  static constexpr int BK = HD == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int kQBytes = kBq * HD * 2;
  static constexpr int kTileBytes = BK * HD * 2;   // one K or one V tile
  static constexpr int kQ = 0;                     // Q: HD / 64 boxes of kBq x 128 bytes
  static constexpr int kK = kQBytes;               // K stage s at kK + s * kTileBytes
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBars = 1 + 4 * kStages;    // q_full, k/v full, k/v empty
  static constexpr int kBytes = kBar + kBars * 8 + 1024;  // + slack to align to 1024
};

// scale / cap / mask one S tile in place (base-2 scores) and fold it into
// the running row maxima; rows row_a and row_a + 8, columns from col0
template <int BK, bool CAP, bool MASK>
__device__ __forceinline__ void score_tile(float (&s)[BK / 2], float (&mx)[2], float c1, float c2,
                                           int row_a, int col0, int S, int causal, int window) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float y = CAP ? cap_tanh(s[i] * c1) * c2 : s[i] * c1;
    if (MASK) {
      const int row = row_a + ((i >> 1) & 1) * 8;
      const int col = col0 + (i >> 2) * 8 + (i & 1);
      if (col >= S || !allowed(row, col, causal, window)) y = kNeg;
    }
    s[i] = y;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], y);
  }
}

template <int HD, bool CAP>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_attn_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                     int S, int H, int KV, float c1, float c2, int causal, int window) {
  using L = WgLayout<HD>;
  constexpr int BK = L::BK;
  constexpr int kBoxes = HD / 64;  // 64-column swizzle atoms per row
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* smem = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBq;  // longest causal rows first
  const int kvh = h / (H / KV);
  int kb_lo, kb_hi;
  kv_blocks(q0, kBq, S, BK, causal, window, kb_lo, kb_hi);
  const int n_tiles = kb_hi - kb_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], 2 * 128);
      mbar_init(&v_empty[st], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load_3d(smem + L::kQ + c * kBq * 128, &tq, q_full, c * 64, h, b * S + q0);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int row = b * S + (kb_lo + it) * BK;
        mbar_wait(&k_empty[st], ph ^ 1);
        mbar_expect_tx(&k_full[st], L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load_3d(smem + L::kK + st * L::kTileBytes + c * BK * 128, &tk, &k_full[st], c * 64,
                      kvh, row);
        mbar_wait(&v_empty[st], ph ^ 1);
        mbar_expect_tx(&v_full[st], L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kBoxes; ++c)
          tma_load_3d(smem + L::kV + st * L::kTileBytes + c * BK * 128, &tv, &v_full[st], c * 64,
                      kvh, row);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    setmaxnreg_inc<240>();
    const int w = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid & 31;
    const int r0 = q0 + w * kWgRows;                         // the warpgroup's first row
    const int row_a = r0 + (tid >> 5) * 16 + (lane >> 2);    // this thread's rows: row_a, +8
    const int col_t = (lane & 3) * 2;
    const uint32_t sq = smem_u32(smem + L::kQ) + w * kWgRows * 128;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int k0 = (kb_lo + it) * BK;
      const uint32_t sk = smem_u32(smem + L::kK + st * L::kTileBytes);
      const uint32_t sv = smem_u32(smem + L::kV + st * L::kTileBytes);

      // S = Q K^T, 16 columns of hd per wgmma
      float s[BK / 2];
      mbar_wait(&k_full[st], ph);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t off = (ks & 3) * 32;
        wgmma_ss(s, smem_desc(sq + (ks >> 2) * kBq * 128 + off, 16, 1024),
                 smem_desc(sk + (ks >> 2) * BK * 128 + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      mbar_arrive(&k_empty[st]);

      // online softmax, base 2
      float mx[2] = {m_r[0], m_r[1]};
      const bool mask = (causal && k0 + BK - 1 > r0) ||
                        (window > 0 && r0 + kWgRows - 1 - k0 >= window) || k0 + BK > S;
      if (mask)
        score_tile<BK, CAP, true>(s, mx, c1, c2, row_a, k0 + col_t, S, causal, window);
      else
        score_tile<BK, CAP, false>(s, mx, c1, c2, row_a, k0 + col_t, S, causal, window);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share its rows
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2(m_r[r] - mx[r]);
        m_r[r] = mx[r];
      }
      uint32_t pa[BK / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = ex2(s[4 * j] - m_r[0]), p1 = ex2(s[4 * j + 1] - m_r[0]);
        const float p2 = ex2(s[4 * j + 2] - m_r[1]), p3 = ex2(s[4 * j + 3] - m_r[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l_r[0] = l_r[0] * alpha[0] + rs[0];
      l_r[1] = l_r[1] * alpha[1] + rs[1];
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }

      // O += P V, 16 keys per wgmma
      mbar_wait(&v_full[st], ph);
      fence_regs(acc);  // the rescale and P are written before the fence
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, pa[kk], smem_desc(sv + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&v_empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
      const int row = row_a + r * 8;
      if (row >= S) continue;
      const float den = fmaxf(l_r[r], 1e-30f);
      __nv_bfloat16* og = o + ((static_cast<size_t>(b) * S + row) * H + h) * HD + col_t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(og + j * 8) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// Route 2: bfloat16, head_dim 32 / 80 — mma.sync m16n8k16

constexpr int kSub = 64;  // keys per compute sub-tile
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

__device__ __forceinline__ float score_of(float dot, float scale, float cap) {
  float x = dot * scale;
  if (cap > 0.f) x = cap * tanhf(x / cap);
  return x;
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

// ---------------------------------------------------------------------------
// Host side

// cuTensorMapEncodeTiled, from the driver through the runtime: no libcuda link
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kErrNoEncode = 100000;   // the driver entry point was not found
constexpr int kErrTensorMap = 100001;  // + the CUresult of a failed encode

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a [rows, heads, hd] bfloat16 tensor (rows = B * S) as a 3-D map over
// (hd, heads, rows), boxes of 64 columns x 1 head x box_rows rows, swizzled
// 128 bytes; rows past the end read as zeros
int encode_rows(CUtensorMap* map, const void* base, int hd, int heads, int rows, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(heads) * hd * 2};
  const cuuint32_t box[3] = {64, 1, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                 int KV, float scale, float cap, int causal, int window, cudaStream_t stream) {
  using L = WgLayout<HD>;
  CUtensorMap tq, tk, tv;
  int rc = encode_rows(&tq, q, HD, H, B * S, kBq);
  if (rc == 0) rc = encode_rows(&tk, k, HD, KV, B * S, L::BK);
  if (rc == 0) rc = encode_rows(&tv, v, HD, KV, B * S, L::BK);
  if (rc != 0) return rc;
  auto kernel = cap > 0.f ? flash_attn_wgmma<HD, true> : flash_attn_wgmma<HD, false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  // base-2 scores: s * c1, or tanh(s * c1) * c2 under the cap
  const float c1 = cap > 0.f ? scale / cap : scale * kLog2e;
  const float c2 = cap > 0.f ? cap * kLog2e : 0.f;
  const dim3 grid(H, B, (S + kBq - 1) / kBq);
  kernel<<<grid, kWgThreads, L::kBytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), S,
                                                  H, KV, c1, c2, causal, window);
  return static_cast<int>(cudaGetLastError());
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

// Plain C entry points for ctypes. `flash_attn_launch` picks the route by
// dtype and head_dim alone (bfloat16 hd 64/128/256: wgmma, tile fixed at 128
// query rows x BK keys, block_q / block_k unused; bfloat16 hd 32/80:
// mma.sync on block_q x block_k tiles; float32: the CUDA cores) and returns
// cudaGetLastError() after its launch, cudaErrorInvalidValue for a bfloat16
// head_dim no route is built for, or a code >= 100000 when a tensor map
// could not be encoded; the Python wrapper checks shapes first and raises
// when this is not 0. cap <= 0 means no soft cap, window <= 0 no window.
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
    case 64: return launch_wgmma<64>(q, k, v, o, B, S, H, KV, scale, cap, causal, window, s);
    case 128: return launch_wgmma<128>(q, k, v, o, B, S, H, KV, scale, cap, causal, window, s);
    case 256: return launch_wgmma<256>(q, k, v, o, B, S, H, KV, scale, cap, causal, window, s);
    case 32: return launch_bf16<32>(q, k, v, o, B, S, H, KV, scale, cap, causal, window, block_q, block_k, s);
    case 80: return launch_bf16<80>(q, k, v, o, B, S, H, KV, scale, cap, causal, window, block_q, block_k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attn_error_string(int code) {
  if (code == kErrNoEncode) return "cuTensorMapEncodeTiled not found in the driver";
  if (code >= kErrTensorMap) return "cuTensorMapEncodeTiled failed (code - 100001 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
