// K1 for Hopper (sm_90a) in bf16 and fp16: the flash attention forward on
// TMA, wgmma and warp specialisation.
//
// Replaces the 16-bit path of the Pallas TPU kernel
// accelerate_tpu/ops/pallas_attention.py::_fwd_kernel (:89): out =
// softmax(q k^T * scale) v and the row log-sum-exp lse, online softmax in
// f32. f32 keeps flash_attention.cu's kernel (wgmma on f32 is TF32, which
// would change its numbers); K2 and K3 there read this kernel's out and lse.
// Layout, masks and rounding points are flash_attention.cu's: q/out [B, Sq,
// H, D], k/v [B, Sk, Hkv, D] read through their strides, lse [B, H, Sq] f32;
// causal aligned bottom-right, the band keeps keys > i + Sk - Sq - window, a
// row with no live key gives out 0 and lse -inf, P is rounded to v's type
// before P v, and both products accumulate in f32.
//
// What bounds it. At the training shape (B 8, H 32, Hkv 4, S 2048, D 64,
// causal) the two products are about 137 GFLOP against some 100 MB of HBM
// traffic, so the tensor cores bound it (0.14 ms at 989 TFLOP/s). At D 64 the
// softmax's exp2 costs the special-function units about as long again: one
// exp2 a (query, key) pair against 4 D tensor-core FLOPs.
//
// What the design does about it. A block is a producer warpgroup and one
// consumer warpgroup for each 64 query rows (three at D 64, two at D 128;
// see Smem). The producer gives up registers (setmaxnreg); one of its threads
// loads Q once and then the K tiles of 128 keys, another the V tiles, each
// through its own ring of two stages with a full and an empty mbarrier a
// stage, all as TMA loads. TMA swizzles each 64-column box 128 bytes wide (D
// 128: two boxes a row) and zero-fills rows past S, so no thread computes an
// address or masks a load. The consumers take the producer's registers: S =
// Q K^T is one wgmma.mma_async m64n128k16 chain with both operands read from
// shared memory through descriptors (Q and K are K-major as stored); P,
// rounded to v's type, stays in registers as the A operand of O += P V (the
// m64 accumulator and the A fragment line up), and V is read MN-major
// through the descriptor's transpose bit. Each consumer issues tile i's S
// product before tile i - 1's P V, so its softmax runs while P V is on the
// tensor cores, and the consumers run out of step, so one's softmax overlaps
// another's products. Only tiles that _block_live keeps for the block are
// loaded, each consumer computes only those live for its own 64 rows, the
// per-element mask runs only on tiles that are not full, and blocks take the
// heaviest causal tiles first. It allocates nothing and launches on the
// caller's stream; the tensor maps travel in the launch's parameters
// (__grid_constant__), encoded on the host through the driver entry point,
// so the library needs no -lcuda. Tried and measured on the card, and left
// out (PERF.md): a ping-pong order between the consumers, three stages,
// 64-key tiles, and persistent blocks.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kKeys = 128;      // keys of a K or V tile
constexpr int kStages = 2;      // K and V tiles in flight
constexpr int kBoxCols = 64;    // 16-bit columns of one 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A block: warpgroup 0 produces, the others consume, 64 query rows each.
// D 64: three consumers (192 rows), so each K and V tile serves more rows and
// each scheduler has three warps whose softmax hides the others' latency;
// D 128: two, which the registers allow. Warpgroups trade registers with
// setmaxnreg: producer x 128 + consumer x 128 x consumers = 65,536, so the
// kernel must start with at least 65,536 / threads registers a thread.
//
// Shared memory: Q [D / 64][kRows][64], then K and V [kStages][D / 64][kKeys]
// [64], each 64-column box 128-byte swizzled and 1024-byte aligned; then the
// mbarriers. 1024 bytes of slack align the base.
template <int D>
struct Smem {
  static constexpr int kConsumers = D == 64 ? 3 : 2;
  static constexpr int kRows = 64 * kConsumers;  // query rows a block owns
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = kConsumers == 2 ? 24 : 32;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
  static constexpr int kQ = kRows * D * 2;
  static constexpr int kKV = kKeys * D * 2;  // one stage of K (or V)
  static constexpr int kBars = kQ + 2 * kStages * kKV;
  static constexpr int kBytes = 1024 + kBars + (1 + 4 * kStages) * 8;
};

struct Args {
  void* out;   // [B, Sq, H, D] contiguous, q's type
  float* lse;  // [B, H, Sq]
  int h, hkv, sq, sk;
  float scale;
  int causal, window;  // window 0: no band
};

int rows_of(int d) { return d == 64 ? Smem<64>::kRows : Smem<128>::kRows; }

dim3 grid_of(int b, int h, int sq, int d) { return dim3(b * h, (sq + rows_of(d) - 1) / rows_of(d)); }

// ---------------------------------------------------------------------------
// primitives: mbarriers, TMA, wgmma
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
// flash_attention.cu's kernels call exp2f; here that read the same errors
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

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128).
// K-major (Q, K): rows 128 bytes apart, 8-row groups 1024 apart (the stride
// offset), the leading offset unused. MN-major (V): 8-key groups 1024 apart
// (the stride offset), 64-column boxes `lbo` apart (the leading offset).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

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
// masks and the tile walk (flash_attention.cu's, for tiles of `rows` x `keys`)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// (query row, key col) unmasked?
__device__ __forceinline__ bool is_valid(int row, int col, const Args& p) {
  bool ok = row < p.sq && col < p.sk;
  if (p.causal) ok = ok && row + (p.sk - p.sq) >= col;
  if (p.window > 0) ok = ok && col > row + (p.sk - p.sq) - p.window;
  return ok;
}

// _block_live of the Pallas kernel: some (row, col) of the tile unmasked
__device__ __forceinline__ bool tile_live(int q0, int rows, int k0, const Args& p) {
  const int off = p.sk - p.sq;
  bool live = p.causal ? (q0 + rows - 1 + off >= k0) : true;
  if (p.window > 0) live = live && (k0 + kKeys - 1 > q0 + off - p.window);
  return live;
}

// every element of the tile unmasked (no per-element test needed)
__device__ __forceinline__ bool tile_full(int q0, int rows, int k0, const Args& p) {
  const int off = p.sk - p.sq;
  bool full = q0 + rows <= p.sq && k0 + kKeys <= p.sk;
  if (p.causal) full = full && q0 + off >= k0 + kKeys - 1;
  if (p.window > 0) full = full && k0 > q0 + rows - 1 + off - p.window;
  return full;
}

// Live key tiles [*lo, *hi] of query rows q0 .. q0 + rows - 1 (empty if lo > hi).
__device__ __forceinline__ void live_key_tiles(int q0, int rows, const Args& p, int* lo, int* hi) {
  int h_ = (p.sk + kKeys - 1) / kKeys - 1;
  if (p.causal) h_ = min(h_, floor_div(q0 + rows - 1 + p.sk - p.sq, kKeys));
  int l_ = 0;
  while (l_ <= h_ && !tile_live(q0, rows, l_ * kKeys, p)) ++l_;
  *lo = l_;
  *hi = h_;
}

// ---------------------------------------------------------------------------
// a consumer warpgroup's steps
// ---------------------------------------------------------------------------

// Issue S = Q K^T (64 rows x kKeys) as one wgmma group: D / 16 steps of k16,
// a step 32 bytes into the swizzled rows.
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&s)[kKeys / 8][4], uint32_t q_tile, uint32_t k_tile) {
  wgmma_fence();  // right before the group, after any wait: ptxas adds none of its own
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    Wgmma<T, kKeys>::ss(s, smem_desc(q_tile + (kk / 4) * Smem<D>::kRows * kRowBytes + col, 0),
                        smem_desc(k_tile + (kk / 4) * kKeys * kRowBytes + col, 0), kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V as one wgmma group: kKeys / 16 steps of k16, P from
// registers, a step 16 keys (2048 bytes) down the V tile.
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 8][4], const unsigned (&pf)[kKeys / 16][4], uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) Wgmma<T, D>::rs(o, pf[kk], smem_desc(v_tile + kk * 16 * kRowBytes, kKeys * kRowBytes));
  wgmma_commit();
}

// The online softmax of one tile of scores, in the log2 domain: s becomes P,
// the row max m and row sum l move on, corr is what O must be scaled by.
// `row` is the thread's first row (its second is row + 8), `col` its first
// column of the tile (then + 1, and each 8-column tile on).
__device__ __forceinline__ void softmax_step(float (&s)[kKeys / 8][4], float (&m)[2], float (&l)[2], float (&corr)[2],
                                             int row, int col, bool full, float sl2, const Args& p) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * sl2;
      if (!full && !is_valid(row + ((e >> 1) << 3), col + j * 8 + (e & 1), p)) x = -INFINITY;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  quad_max(mx);
  float safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], mx[r]);
    safe[r] = mn == -INFINITY ? 0.f : mn;  // a row with every key masked so far
    corr[r] = m[r] == -INFINITY ? 0.f : fast_exp2(m[r] - safe[r]);
    m[r] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = fast_exp2(s[j][e] - safe[e >> 1]);  // masked: exp2(-inf) = 0
      s[j][e] = pv;
      sum[e >> 1] += pv;
    }
  }
  quad_sum(sum);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

template <int D>
__device__ __forceinline__ void scale_rows(float (&o)[D / 8][4], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Shared-memory addresses of a block: the tiles and the mbarriers.
template <int D>
struct Ring {
  uint32_t q, k, v, bars;
  __device__ explicit Ring(uint32_t base)
      : q(base), k(base + Smem<D>::kQ), v(base + Smem<D>::kQ + kStages * Smem<D>::kKV), bars(base + Smem<D>::kBars) {}
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t k_full(int st) const { return bars + 8 * (1 + st); }
  __device__ uint32_t k_empty(int st) const { return bars + 8 * (1 + kStages + st); }
  __device__ uint32_t v_full(int st) const { return bars + 8 * (1 + 2 * kStages + st); }
  __device__ uint32_t v_empty(int st) const { return bars + 8 * (1 + 3 * kStages + st); }
  __device__ uint32_t k_tile(int st) const { return k + st * Smem<D>::kKV; }
  __device__ uint32_t v_tile(int st) const { return v + st * Smem<D>::kKV; }
};

// The producer: lane 0 of warp 0 loads Q once, then the K tiles of the live
// key tiles lo .. lo + n - 1 through the K ring; lane 0 of warp 1 the V tiles
// through the V ring. Two threads, so a K load never waits for a V slot.
template <int D>
__device__ __forceinline__ void produce(const Ring<D>& ring, const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int q0, int h, int hk, int b, int lo, int n) {
  constexpr int kChunks = D / kBoxCols;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_expect_tx(ring.q_full(), Smem<D>::kQ);
    for (int c = 0; c < kChunks; ++c)
      tma_load(ring.q + c * Smem<D>::kRows * kRowBytes, tq, ring.q_full(), c * kBoxCols, q0, h, b);
  }
  if (tid != 0 && tid != 32) return;
  const bool keys = tid == 0;
  const CUtensorMap* map = keys ? tk : tv;
  for (int i = 0; i < n; ++i) {
    const int st = i % kStages, k0 = (lo + i) * kKeys;
    mbar_wait(keys ? ring.k_empty(st) : ring.v_empty(st), ((i / kStages) & 1) ^ 1);  // the first round passes
    const uint32_t full = keys ? ring.k_full(st) : ring.v_full(st);
    const uint32_t tile = keys ? ring.k_tile(st) : ring.v_tile(st);
    mbar_expect_tx(full, Smem<D>::kKV);
    for (int c = 0; c < kChunks; ++c) tma_load(tile + c * kKeys * kRowBytes, map, full, c * kBoxCols, k0, hk, b);
  }
}

// Stage release of block tile i by a consumer that does not use it: wait
// until the tile is loaded (so the arrival counts toward this round of the
// ring, not the last), then arrive on its K and V empty barriers.
template <int D>
__device__ __forceinline__ void release(const Ring<D>& ring, int i, bool leader) {
  const int st = i % kStages, ph = (i / kStages) & 1;
  mbar_wait(ring.k_full(st), ph);
  mbar_arrive_if(ring.k_empty(st), leader);
  mbar_wait(ring.v_full(st), ph);
  mbar_arrive_if(ring.v_empty(st), leader);
}

// A consumer warpgroup (cw 0, 1 or 2): query rows r0 = q0 + 64 cw .. + 63.
// The block loads its n live key tiles from lo; the consumer computes only
// those live for its own rows (a sub-range: at the causal diagonal the lower
// rows end up to two tiles earlier; rows all past Sq have none) and releases
// the others unread. Tile i's
// S product is issued before tile i - 1's P V, so its softmax runs while P V
// is on the tensor cores. A wgmma op is complete for the whole warpgroup once
// one thread has waited for it, so that thread releases the stage.
template <typename T, int D>
__device__ __forceinline__ void consume(const Ring<D>& ring, const Args& p, int cw, int q0, int b, int h, int lo,
                                        int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const bool leader = (tid & 127) == 0;
  const int r0 = q0 + cw * 64, row = r0 + warp * 16 + g;
  const uint32_t q_tile = ring.q + cw * 64 * kRowBytes;
  int clo, chi;
  live_key_tiles(r0, 64, p, &clo, &chi);
  if (r0 >= p.sq) chi = clo - 1;  // rows past Sq: nothing to compute, nothing stored
  const int i0 = min(max(clo - lo, 0), n), i1 = min(max(chi - lo + 1, i0), n);  // its tiles: block tiles i0 .. i1 - 1
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  const float sl2 = p.scale * kLog2e;  // scores in the log2 domain
  float s[kKeys / 8][4];
  unsigned pf[kKeys / 16][4];

  mbar_wait(ring.q_full(), 0);
  for (int i = 0; i < i0; ++i) release(ring, i, leader);
  if (i1 > i0) {
    // tile i0: S, then its softmax
    const int st0 = i0 % kStages, k00 = (lo + i0) * kKeys;
    mbar_wait(ring.k_full(st0), (i0 / kStages) & 1);
    issue_qk<T, D>(s, q_tile, ring.k_tile(st0));
    wgmma_wait_all();
    pin(s);
    mbar_arrive_if(ring.k_empty(st0), leader);
    softmax_step(s, m, l, corr, row, k00 + 2 * t, tile_full(r0, 64, k00, p), sl2, p);
    acc_to_afrags<T, kKeys / 16>(pf, s);  // P, rounded to v's type
    for (int i = i0 + 1; i < i1; ++i) {  // tile i's S, then tile i - 1's P V behind it
      const int st = i % kStages, pst = (i - 1) % kStages, k0 = (lo + i) * kKeys;
      mbar_wait(ring.k_full(st), (i / kStages) & 1);
      mbar_wait(ring.v_full(pst), ((i - 1) / kStages) & 1);
      issue_qk<T, D>(s, q_tile, ring.k_tile(st));
      issue_pv<T, D>(o, pf, ring.v_tile(pst));
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S done, P V in flight
      pin(s);
      mbar_arrive_if(ring.k_empty(st), leader);
      softmax_step(s, m, l, corr, row, k0 + 2 * t, tile_full(r0, 64, k0, p), sl2, p);
      wgmma_wait_all();
      pin(o);
      pin(pf);
      mbar_arrive_if(ring.v_empty(pst), leader);
      scale_rows<D>(o, corr);
      acc_to_afrags<T, kKeys / 16>(pf, s);
    }
    const int pst = (i1 - 1) % kStages;  // the last tile's P V
    mbar_wait(ring.v_full(pst), ((i1 - 1) / kStages) & 1);
    issue_pv<T, D>(o, pf, ring.v_tile(pst));
    wgmma_wait_all();
    pin(o);
    pin(pf);
    mbar_arrive_if(ring.v_empty(pst), leader);
  }
  for (int i = i1; i < n; ++i) release(ring, i, leader);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= p.sq) continue;
    const float lv = fmaxf(l[r], 1e-37f);
    T* orow = static_cast<T*>(p.out) + (((long long)b * p.sq + rr) * p.h + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(orow + j * 8 + 2 * t, o[j][2 * r] / lv, o[j][2 * r + 1] / lv);
    if (t == 0) p.lse[((long long)b * p.h + h) * p.sq + rr] = m[r] == -INFINITY ? -INFINITY : m[r] * kLn2 + logf(lv);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Smem<D>::kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<D> ring((smem_u32(smem_raw) + 1023u) & ~1023u);
  // the role as a warp-uniform value: ptxas then sees each warpgroup's path as
  // convergent, keeps the wgmma ops asynchronous and honours setmaxnreg
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int b = blockIdx.x / p.h, h = blockIdx.x % p.h, hk = h / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * Smem<D>::kRows;  // heaviest causal tiles first
  int lo, hi;
  live_key_tiles(q0, Smem<D>::kRows, p, &lo, &hi);
  const int n = max(hi - lo + 1, 0);  // 0: no live key for any row of the block

  if (threadIdx.x == 0) {
    mbar_init(ring.q_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(ring.k_full(st), 1);
      mbar_init(ring.v_full(st), 1);
      mbar_init(ring.k_empty(st), Smem<D>::kConsumers);  // one arrival from each consumer releases a stage
      mbar_init(ring.v_empty(st), Smem<D>::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: two threads issue every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Smem<D>::kProducerRegs));
    produce<D>(ring, &tq, &tk, &tv, q0, h, hk, b, lo, n);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Smem<D>::kConsumerRegs));
    consume<T, D>(ring, p, wg - 1, q0, b, h, lo, n);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps and the launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
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

// The consumers raise their registers from what the block starts with: a
// kernel compiled to fewer than the split needs would wait for them forever.
template <typename T, int D>
cudaError_t registers_suffice() {
  static const cudaError_t ok = [] {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, flash_fwd_wgmma<T, D>);
    if (err != cudaSuccess) return err;
    using S = Smem<D>;
    return attr.numRegs * S::kThreads >= 128 * (S::kProducerRegs + S::kConsumers * S::kConsumerRegs) ? cudaSuccess
                                                                                 : cudaErrorInvalidConfiguration;
  }();
  return ok;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const Args& a, int b, int sq, int sk,
           const long long* strides, cudaStream_t stream) {
  constexpr CUtensorMapDataType type =
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = encode(&tq, type, q, b, sq, a.h, D, strides, Smem<D>::kRows);
  if (r == CUDA_SUCCESS) r = encode(&tk, type, k, b, sk, a.hkv, D, strides + 3, kKeys);
  if (r == CUDA_SUCCESS) r = encode(&tv, type, v, b, sk, a.hkv, D, strides + 6, kKeys);
  if (r != CUDA_SUCCESS) return -(int)r;  // a CUresult of cuTensorMapEncodeTiled, negated
  cudaError_t err = registers_suffice<T, D>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wgmma<T, D><<<grid_of(b, a.h, sq, D), Smem<D>::kThreads, Smem<D>::kBytes, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

bool bad_config(int dtype, int b, int h, int sq, int d) {
  return (dtype != 1 && dtype != 2) || (d != 64 && d != 128) || b <= 0 || h <= 0 || sq <= 0 ||
         (sq + rows_of(d) - 1) / rows_of(d) > 65535;
}

}  // namespace

// dtype 1 bf16, 2 f16 (f32 runs flash_attention_fwd); strides: 9 element
// strides (batch, seq, head) of q, k and v. Returns the launch's cudaError_t,
// or minus the CUresult when a tensor map cannot be encoded.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v, void* out, float* lse, int dtype, int b,
                              int h, int hkv, int sq, int sk, int d, const long long* strides, float scale,
                              int causal, int window, void* stream) {
  if (bad_config(dtype, b, h, sq, d) || hkv <= 0 || h % hkv != 0 || sk <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const Args a = {out, lse, h, hkv, sq, sk, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return d == 64 ? launch<__nv_bfloat16, 64>(q, k, v, a, b, sq, sk, strides, s)
                                 : launch<__nv_bfloat16, 128>(q, k, v, a, b, sq, sk, strides, s);
  return d == 64 ? launch<__half, 64>(q, k, v, a, b, sq, sk, strides, s)
                 : launch<__half, 128>(q, k, v, a, b, sq, sk, strides, s);
}

// What flash_fwd_sm90 launches for these shapes: out[0..1] grid x, y,
// out[2] threads a block, out[3] dynamic shared memory bytes.
extern "C" int flash_fwd_sm90_config(int dtype, int b, int h, int sq, int d, int* out) {
  if (bad_config(dtype, b, h, sq, d)) return (int)cudaErrorInvalidValue;
  const dim3 g = grid_of(b, h, sq, d);
  out[0] = (int)g.x;
  out[1] = (int)g.y;
  out[2] = d == 64 ? Smem<64>::kThreads : Smem<128>::kThreads;
  out[3] = d == 64 ? Smem<64>::kBytes : Smem<128>::kBytes;
  return 0;
}
