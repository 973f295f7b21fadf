// Hopper (sm_90a) building blocks shared by the flash attention kernels in
// 16 bits: K1 (flash_fwd_sm90.cu) and K2/K3 (flash_bwd_sm90.cu).
//
// mbarriers, TMA loads through 4-D tensor maps with 128-byte swizzle,
// wgmma shared-memory descriptors and products (bf16 and fp16, f32
// accumulate, N 64 or 128), the accumulator -> A-fragment rounding, quad
// reductions, a producer's K and V rings and their release, the attention
// masks and the tile walk, and the host's tensor map encoding. Everything lives in an anonymous namespace: each kernel
// source builds into its own library.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBoxCols = 64;  // 16-bit columns of one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// One arrival, from the threads where `on` holds: a predicated instruction,
// not a branch, so the warpgroup's path stays convergent for ptxas.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool on) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.u32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
               "r"((uint32_t)on)
               : "memory");
}

// 2^x on the special-function unit (flushing results below 2^-126 to 0).
// flash_attention.cu's kernels call exp2f; in K1 that read the same errors
// against the plain version and took 27% longer (PERF.md).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Wait for the phase of parity `parity` to complete: the whole spin loop is
// one PTX block, which keeps the warpgroup's path convergent for ptxas (a
// loop written in C++ made it serialise every wgmma). A wait that has not
// ended after 10 s (a pipeline fault) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 10000000000;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of the tensor map at coordinates (col, row, head, batch) into
// shared memory; completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
// K-major: rows 128 bytes apart, 8-row groups 1024 apart (the stride
// offset), the leading offset unused. MN-major: 8-row groups of the K
// dimension 1024 apart (the stride offset), 64-column boxes `lbo` apart
// (the leading offset).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Wait until at most N of this warpgroup's committed groups are pending
// (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers an in-flight wgmma reads or writes: nothing that uses them
// moves across this point, and the registers are not reused before it.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[i][e])::"memory");
  }
}
template <int N>
__device__ __forceinline__ void pin(unsigned (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(x[i][e])::"memory");
  }
}

// d[8][4] (+)= A (shared, descriptor da) * B (shared, db); TY "bf16" or "f16"
#define WGMMA_SS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "\
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]) \
      : "l"(da), "l"(db), "r"(scale_d))

// d[8][4] += A (registers a[4]) * B (shared, db, MN-major: transpose bit set)
#define WGMMA_RS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "\
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d[16][4] (+)= A (shared, descriptor da) * B (shared, db); TY "bf16" or "f16"
#define WGMMA_SS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "\
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "\
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "\
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
      "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
      "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
      "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
      "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]) \
      : "l"(da), "l"(db), "r"(scale_d))

// d[16][4] += A (registers a[4]) * B (shared, db, MN-major: transpose bit set)
#define WGMMA_RS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "\
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "\
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "\
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
      "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
      "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
      "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
      "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// One warpgroup's products: ss, d[N / 8][4] (+)= A (shared) B (shared), and
// rs, d += A (registers) B (shared, MN-major). The accumulator layout is
// mma.sync's m16n8 one, warp w of the group holding rows 16 w .. 16 w + 15:
// lane l has rows l / 4 and l / 4 + 8, columns 2 (l % 4) and 2 (l % 4) + 1 of
// each 8-column tile.
template <typename T, int N>
struct Wgmma;

#define WGMMA_OPS(T, TY, N)                                                                               \
  template <>                                                                                             \
  struct Wgmma<T, N> {                                                                                    \
    static __device__ __forceinline__ void ss(float (&d)[N / 8][4], uint64_t da, uint64_t db, int scale_d) { \
      WGMMA_SS_N##N(TY);                                                                                  \
    }                                                                                                     \
    static __device__ __forceinline__ void rs(float (&d)[N / 8][4], const unsigned (&a)[4], uint64_t db) {  \
      WGMMA_RS_N##N(TY);                                                                                  \
    }                                                                                                     \
  };

WGMMA_OPS(__nv_bfloat16, "bf16", 64)
WGMMA_OPS(__nv_bfloat16, "bf16", 128)
WGMMA_OPS(__half, "f16", 64)
WGMMA_OPS(__half, "f16", 128)

// Issue d[N / 8][4] = A B^T as one wgmma group: A (64 rows) and B (N rows)
// both K-major in shared memory, K = KD columns stored as KD / 64 boxes of
// 64 columns, a box `a_rows` (`b_rows`) rows deep. KD / 16 steps of k16, a
// step 32 bytes into the swizzled rows.
template <typename T, int KD, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 8][4], uint32_t a, int a_rows, uint32_t b, int b_rows) {
  wgmma_fence();  // right before the group, after any wait: ptxas adds none of its own
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    Wgmma<T, N>::ss(d, smem_desc(a + (kk / 4) * a_rows * kRowBytes + col, 0),
                    smem_desc(b + (kk / 4) * b_rows * kRowBytes + col, 0), kk > 0);
  }
  wgmma_commit();
}

// Issue d[N / 8][4] += A B as one wgmma group: A from registers (KS k16
// fragments), B MN-major in shared memory (16 KS rows of N columns, stored
// as N / 64 boxes of 64 columns `b_rows` rows deep), a step 16 rows (2048
// bytes) down B.
template <typename T, int N, int KS>
__device__ __forceinline__ void issue_rs(float (&d)[N / 8][4], const unsigned (&af)[KS][4], uint32_t b, int b_rows) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) Wgmma<T, N>::rs(d, af[kk], smem_desc(b + kk * 16 * kRowBytes, b_rows * kRowBytes));
  wgmma_commit();
}

template <typename T>
__device__ __forceinline__ unsigned pack2(float x, float y);
template <>
__device__ __forceinline__ unsigned pack2<__nv_bfloat16>(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<unsigned*>(&v);
}
template <>
__device__ __forceinline__ unsigned pack2<__half>(float x, float y) {
  __half2 v = __floats2half2_rn(x, y);
  return *reinterpret_cast<unsigned*>(&v);
}

// The accumulators acc[2 KS][4] rounded to T, as KS A fragments (m64k16) of
// the next product: the two layouts line up, so no shuffle is needed.
template <typename T, int KS>
__device__ __forceinline__ void acc_to_afrags(unsigned (&af)[KS][4], const float (&acc)[2 * KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    af[ks][0] = pack2<T>(acc[2 * ks][0], acc[2 * ks][1]);
    af[ks][1] = pack2<T>(acc[2 * ks][2], acc[2 * ks][3]);
    af[ks][2] = pack2<T>(acc[2 * ks + 1][0], acc[2 * ks + 1][1]);
    af[ks][3] = pack2<T>(acc[2 * ks + 1][2], acc[2 * ks + 1][3]);
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <int N>
__device__ __forceinline__ void quad_max(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = fmaxf(x[i], __shfl_xor_sync(0xffffffffu, x[i], 1));
    x[i] = fmaxf(x[i], __shfl_xor_sync(0xffffffffu, x[i], 2));
  }
}

template <int N>
__device__ __forceinline__ void quad_sum(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] += __shfl_xor_sync(0xffffffffu, x[i], 1);
    x[i] += __shfl_xor_sync(0xffffffffu, x[i], 2);
  }
}

// ---------------------------------------------------------------------------
// a K and V ring (K1, K2): Stages stages each, with full and empty barriers
// k_full/k_empty and v_full/v_empty and tile addresses k_tile/v_tile
// ---------------------------------------------------------------------------

// The producer's K and V loads: lane 0 of warp 0 loads the K tiles of the
// block's live key tiles lo .. lo + n - 1 (`keys` rows each, `bytes` a
// tile, D / 64 boxes) through the K ring, lane 0 of warp 1 the V tiles
// through the V ring; two threads, so a K load never waits for a V slot.
// Every other thread returns at once.
template <int Stages, int D, typename R>
__device__ __forceinline__ void stream_kv(const R& ring, const CUtensorMap* tk, const CUtensorMap* tv, int hk,
                                          int b, int lo, int n, int keys, uint32_t bytes) {
  const int tid = threadIdx.x;
  if (tid != 0 && tid != 32) return;
  const bool k_side = tid == 0;
  const CUtensorMap* map = k_side ? tk : tv;
  for (int i = 0; i < n; ++i) {
    const int st = i % Stages, k0 = (lo + i) * keys;
    mbar_wait(k_side ? ring.k_empty(st) : ring.v_empty(st), ((i / Stages) & 1) ^ 1);  // the first round passes
    const uint32_t full = k_side ? ring.k_full(st) : ring.v_full(st);
    const uint32_t tile = k_side ? ring.k_tile(st) : ring.v_tile(st);
    mbar_expect_tx(full, bytes);
    for (int c = 0; c < D / kBoxCols; ++c) tma_load(tile + c * keys * kRowBytes, map, full, c * kBoxCols, k0, hk, b);
  }
}

// Stage release of block tile i by a consumer that does not use it: wait
// until the tile is loaded (so the arrival counts toward this round of the
// ring, not the last), then arrive on its K and V empty barriers.
template <int Stages, typename R>
__device__ __forceinline__ void release_kv(const R& ring, int i, bool leader) {
  const int st = i % Stages, ph = (i / Stages) & 1;
  mbar_wait(ring.k_full(st), ph);
  mbar_arrive_if(ring.k_empty(st), leader);
  mbar_wait(ring.v_full(st), ph);
  mbar_arrive_if(ring.v_empty(st), leader);
}

// ---------------------------------------------------------------------------
// masks and the tile walk (flash_attention.cu's, for tiles of `rows` query
// rows x `keys` keys). P is any struct with sq, sk, causal and window.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// (query row, key col) unmasked?
template <typename P>
__device__ __forceinline__ bool is_valid(int row, int col, const P& p) {
  bool ok = row < p.sq && col < p.sk;
  if (p.causal) ok = ok && row + (p.sk - p.sq) >= col;
  if (p.window > 0) ok = ok && col > row + (p.sk - p.sq) - p.window;
  return ok;
}

// _block_live of the Pallas kernel: some (row, col) of the tile unmasked
template <typename P>
__device__ __forceinline__ bool tile_live(int q0, int rows, int k0, int keys, const P& p) {
  const int off = p.sk - p.sq;
  bool live = p.causal ? (q0 + rows - 1 + off >= k0) : true;
  if (p.window > 0) live = live && (k0 + keys - 1 > q0 + off - p.window);
  return live;
}

// every element of the tile unmasked (no per-element test needed)
template <typename P>
__device__ __forceinline__ bool tile_full(int q0, int rows, int k0, int keys, const P& p) {
  const int off = p.sk - p.sq;
  bool full = q0 + rows <= p.sq && k0 + keys <= p.sk;
  if (p.causal) full = full && q0 + off >= k0 + keys - 1;
  if (p.window > 0) full = full && k0 > q0 + rows - 1 + off - p.window;
  return full;
}

// Live key tiles [*lo, *hi] (tiles of `keys`) of query rows q0 .. q0 + rows
// - 1 (empty if lo > hi).
template <typename P>
__device__ __forceinline__ void live_key_tiles(int q0, int rows, int keys, const P& p, int* lo, int* hi) {
  int h_ = (p.sk + keys - 1) / keys - 1;
  if (p.causal) h_ = min(h_, floor_div(q0 + rows - 1 + p.sk - p.sq, keys));
  int l_ = 0;
  while (l_ <= h_ && !tile_live(q0, rows, l_ * keys, keys, p)) ++l_;
  *lo = l_;
  *hi = h_;
}

// ---------------------------------------------------------------------------
// host: tensor maps and the register split
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// [B, S, heads, D] through element strides (batch, seq, head), boxes of 64
// columns x `rows` rows, 128-byte swizzle, rows past S read as zeros.
CUresult encode(CUtensorMap* map, CUtensorMapDataType type, const void* base, int b, int s, int heads, int d,
                const long long* strides, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads, (cuuint64_t)b};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[1] * 2, (cuuint64_t)strides[2] * 2, (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, type, 4, const_cast<void*>(base), dims, bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A block of `threads` threads whose producer warpgroup drops to
// `producer_regs` and whose `consumers` warpgroups rise to `consumer_regs`:
// the consumers raise their registers from what the block starts with, so a
// kernel compiled to fewer than the split needs would wait for them forever.
cudaError_t registers_suffice(const void* kernel, int threads, int producer_regs, int consumers, int consumer_regs) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return attr.numRegs * threads >= 128 * (producer_regs + consumers * consumer_regs) ? cudaSuccess
                                                                                     : cudaErrorInvalidConfiguration;
}

}  // namespace
