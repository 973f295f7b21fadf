// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of accelerate_tpu/ops/pallas_attention.py
// that its _flash custom_vjp binds together:
//   K1 _fwd_kernel -> flash_fwd_f32 here for f32, flash_fwd_sm90.cu for bf16
//      and fp16: out = softmax(q k^T * scale) v and the row log-sum-exp lse,
//      online softmax in f32;
//   K2 _dq_kernel  -> flash_dq: dq = sum_k dS k with P recomputed from lse,
//      dS = P * (dP - delta) * scale, dP = dO v^T, delta = rowsum(dO * out);
//   K3 _dkv_kernel -> flash_dkv: dv = sum_q P^T dO, dk = sum_q dS^T q.
//
// Layout: q/out/dO [B, Sq, H, D], k/v [B, Sk, Hkv, D] read in place through
// their strides (last dim contiguous), lse/delta [B, H, Sq] f32, dq [B, Sq,
// H, D] f32, dk/dv [B, Sk, Hkv, D] f32 (all contiguous outputs). GQA reads
// kv head h / (H / Hkv). Masks follow the Pallas kernel: causal is aligned
// bottom-right (query i sees keys <= i + Sk - Sq), the band keeps keys >
// i + Sk - Sq - window, and a row with no live key gives out 0 and lse -inf.
// Rounding points are the Pallas kernel's: P is cast to v's type before P v
// and before P^T dO, dS to k's type before dS k and to q's type before
// dS^T q; every product accumulates in f32.
//
// What bounds it on this card. At the training slice's shapes (B 8, H 32,
// Hkv 4, S 2048, D 64, causal, bf16) each kernel does 2-4 matrix products of
// 64 x 64 x D tiles per pair of live tiles: about 137 GFLOP for K1, 206 for K2
// and 275 for K3, against some 150 MB of HBM traffic. So the tensor cores bound
// all three (0.14 / 0.21 / 0.28 ms at 989 TFLOP/s), and what matters is how
// close the products come to their rate. The 16-bit K1 comes closest: it
// runs on wgmma fed by TMA with a producer warpgroup (flash_fwd_sm90.cu).
//
// What the design here does about it. One block of 4 warps owns 64 rows (query rows
// in K1 and K2, key rows in K3), 16 a warp, and walks the live tiles of the
// other side in a loop inside the block: the TPU grid's sequential axis
// becomes this loop, and nothing is carried between blocks. Tiles that
// _block_live skips are never loaded, so causal costs half and a band
// O(S * W). K2 and K3 in bf16 and fp16 run on the tensor cores with mma.sync m16n8k16
// (f32 accumulate) fed by ldmatrix from padded shared tiles (row pitch D + 8
// elements: conflict-free), and the next tile streams in with cp.async while
// the current one is multiplied (two stages). Each warp's dS or P tile is
// rounded to the operand type in registers and becomes the A operand of the
// next product as it stands (the m16n8 accumulator and the m16k16 A
// fragment line up). Registers, not shared memory, set how many blocks an
// SM holds, and those blocks are what hides the latency. K3 loops over the G query heads of its kv head inside
// the block, so the GQA sum of the Pallas backward happens in registers: no
// [B, H, Sk, D] intermediate and no atomics. f32 runs the same blocks with
// the products done by scalar FMAs on the CUDA cores (no TF32), one stage,
// P and dS through a small shared buffer per warp. wgmma, TMA and warp
// specialisation for K2 and K3 are later work. Blocks take the heaviest causal tiles first.
// It allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // rows a block owns, and rows of each tile it walks
constexpr int kPad = 8;    // shared row padding, in elements
constexpr int kLdP = kTile + kPad;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;   // [B, Sq, H, D] contiguous
  const float* lse;   // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* out;          // [B, Sq, H, D] contiguous, q's type
  float* lse_out;
  float* dq;  // [B, Sq, H, D]
  float* dk;  // [B, Sk, Hkv, D]
  float* dv;
  int b, h, hkv, sq, sk;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal, window;  // window 0: no band
};

// ---------------------------------------------------------------------------
// primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src then is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Two f32 values stored as a pair (the f32 kernels' P, dS and outputs).
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// One k-step of a warp's product: acc[NT][4] += a (16 x 16, an A fragment in
// registers) * B[16 ks .. 16 ks + 15][0 .. 8 NT), B stored [N][K] in shared
// memory (pitch ldb) or, with B_KN, [K][N]. acc follows the m16n8
// accumulator layout: lane l holds rows l/4 and l/4 + 8, columns 2 (l % 4)
// and 2 (l % 4) + 1 of each 8-column tile.
template <typename T, int NT, bool B_KN>
__device__ __forceinline__ void mma_kstep(float (&acc)[NT][4], const unsigned (&a)[4], const T* b, int ldb, int ks,
                                          int lane) {
  static_assert(NT % 2 == 0, "B fragments load in pairs of 8-column tiles");
#pragma unroll
  for (int jp = 0; jp < NT / 2; ++jp) {
    unsigned bf[4];
    if constexpr (B_KN) {
      ldmatrix_x4_trans(bf, b + (ks * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ldb + jp * 16 + ((lane >> 4) << 3));
    } else {
      ldmatrix_x4(bf, b + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldb + ks * 16 + (((lane >> 3) & 1) << 3));
    }
    Mma<T>::run(acc[2 * jp], a, bf[0], bf[1]);
    Mma<T>::run(acc[2 * jp + 1], a, bf[2], bf[3]);
  }
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

// The 16 x 16*KS accumulators acc[2 KS][4], rounded to T, as the A fragments
// of the next product: the two layouts line up, so no shuffle is needed.
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

// One warp: acc[NT][4] += A (16 x 16*KS) * B (16*KS x 8*NT) with A
// fragments in registers (16-bit types).
template <typename T, int NT, int KS, bool B_KN>
__device__ __forceinline__ void warp_gemm_ra(float (&acc)[NT][4], const unsigned (&af)[KS][4], const T* b, int ldb,
                                             int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) mma_kstep<T, NT, B_KN>(acc, af[ks], b, ldb, ks, lane);
}

// One warp: acc[NT][4] += A (16 x 16*KS, row-major in shared memory, pitch
// lda) * B. For f32 the same accumulator elements are computed by scalar
// FMAs on the CUDA cores.
template <typename T, int NT, int KS, bool B_KN>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const T* a, int lda, const T* b, int ldb, int lane) {
  if constexpr (std::is_same<T, float>::value) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + ((e >> 1) << 3), c = j * 8 + 2 * t + (e & 1);
        const float* ar = a + r * lda;
        float s = acc[j][e];
#pragma unroll 8
        for (int kk = 0; kk < 16 * KS; ++kk) s = fmaf(ar[kk], B_KN ? b[kk * ldb + c] : b[c * ldb + kk], s);
        acc[j][e] = s;
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned af[4];
      ldmatrix_x4(af, a + (lane & 15) * lda + ks * 16 + ((lane >> 4) << 3));
      mma_kstep<T, NT, B_KN>(acc, af, b, ldb, ks, lane);
    }
  }
}

// Register operands: for 16-bit types P and dS go to the next product in
// registers; f32 passes them through a shared buffer per warp. (Keeping the
// loop-invariant A fragments in registers as well was tried: it costs
// registers, and with them blocks per SM, and made all three kernels
// slower.)
template <typename T>
constexpr bool kRegOperands = sizeof(T) == 2;

// kTile rows of D elements from src (row stride in elements) into dst
// (pitch D + kPad); rows >= valid are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int valid, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + kPad) + c, src + (ok ? r : 0) * stride + c, ok);
  }
}

__device__ __forceinline__ void load_row_stats(float* dst, const float* src, int valid, int tid) {
  if (tid < kTile) cp_async4(dst + tid, src + (tid < valid ? tid : 0), tid < valid);
}

__device__ __forceinline__ int floor_div(int a, int b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }

// (query row, key col) unmasked?
__device__ __forceinline__ bool is_valid(int row, int col, const Params& p) {
  bool ok = row < p.sq && col < p.sk;
  if (p.causal) ok = ok && row + (p.sk - p.sq) >= col;
  if (p.window > 0) ok = ok && col > row + (p.sk - p.sq) - p.window;
  return ok;
}

// _block_live of the Pallas kernel for a kTile x kTile tile
__device__ __forceinline__ bool tile_live(int q_start, int k_start, const Params& p) {
  const int off = p.sk - p.sq;
  bool live = p.causal ? (q_start + kTile - 1 + off >= k_start) : true;
  if (p.window > 0) live = live && (k_start + kTile - 1 > q_start + off - p.window);
  return live;
}

// every element of the tile unmasked (no per-element test needed)
__device__ __forceinline__ bool tile_full(int q_start, int k_start, const Params& p) {
  const int off = p.sk - p.sq;
  bool full = q_start + kTile <= p.sq && k_start + kTile <= p.sk;
  if (p.causal) full = full && q_start + off >= k_start + kTile - 1;
  if (p.window > 0) full = full && k_start > q_start + kTile - 1 + off - p.window;
  return full;
}

// Live key tiles [*lo, *hi] of the query tile at q_start (empty if lo > hi).
__device__ __forceinline__ void live_key_tiles(int q_start, const Params& p, int* lo, int* hi) {
  int h_ = (p.sk + kTile - 1) / kTile - 1;
  if (p.causal) h_ = min(h_, floor_div(q_start + kTile - 1 + p.sk - p.sq, kTile));
  int l_ = 0;
  while (l_ <= h_ && !tile_live(q_start, l_ * kTile, p)) ++l_;
  *lo = l_;
  *hi = h_;
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
// K1: forward
// ---------------------------------------------------------------------------

// The per-warp P / dS buffer of the shared-memory path.
template <typename T>
constexpr size_t warp_buf_bytes() {
  return kRegOperands<T> ? 0 : (size_t)kWarps * 16 * kLdP * sizeof(T);
}

// K1 in f32 (bf16 and fp16 run flash_fwd_sm90.cu): one stage, the products
// by scalar FMAs, P through the warp's shared buffer.
template <int D>
constexpr size_t fwd_smem_f32() {
  return (size_t)3 * kTile * (D + kPad) * sizeof(float) + warp_buf_bytes<float>();
}

inline dim3 fwd_grid(int b, int h, int sq) { return dim3(b * h, (sq + kTile - 1) / kTile); }

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  using T = float;
  constexpr int LD = D + kPad;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kTile * LD;
  T* vs = ks + kTile * LD;
  T* pw = vs + kTile * LD + (threadIdx.x >> 5) * 16 * kLdP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.h, h = blockIdx.x % p.h, hk = h / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest causal tiles first
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int lo, hi;
  live_key_tiles(q0, p, &lo, &hi);
  load_tile<T, D>(qs, qg, p.q_ss, p.sq - q0, tid);
  if (lo <= hi) {
    load_tile<T, D>(ks, kg + (long long)lo * kTile * p.k_ss, p.k_ss, p.sk - lo * kTile, tid);
    load_tile<T, D>(vs, vg + (long long)lo * kTile * p.v_ss, p.v_ss, p.sk - lo * kTile, tid);
  }
  cp_async_commit();

  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = p.scale * kLog2e;  // scores in the log2 domain

  for (int kt = lo; kt <= hi; ++kt) {
    cp_async_wait<0>();
    __syncthreads();

    float s[kTile / 8][4] = {};
    warp_gemm<T, kTile / 8, D / 16, false>(s, qs + warp * 16 * LD, LD, ks, LD, lane);

    const int k0 = kt * kTile;
    const bool full = tile_full(q0, k0, p);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (!full && !is_valid(q0 + warp * 16 + g + ((e >> 1) << 3), k0 + j * 8 + 2 * t + (e & 1), p)) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    quad_max(mx);
    float corr[2], safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], mx[r]);
      safe[r] = mn == -INFINITY ? 0.f : mn;  // a row with every key masked so far
      corr[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] - safe[r]);
      m[r] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(s[j][e] - safe[e >> 1]);  // masked: exp2(-inf) = 0
        s[j][e] = pv;
        sum[e >> 1] += pv;
      }
    }
    quad_sum(sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      store2(pw + g * kLdP + j * 8 + 2 * t, s[j][0], s[j][1]);
      store2(pw + (g + 8) * kLdP + j * 8 + 2 * t, s[j][2], s[j][3]);
    }
    __syncwarp();
    warp_gemm<T, D / 8, kTile / 16, true>(o, pw, kLdP, vs, LD, lane);
    __syncthreads();
    if (kt < hi) {  // one stage: the next tile loads once this one is done
      const int nx = (kt + 1) * kTile;
      load_tile<T, D>(ks, kg + (long long)nx * p.k_ss, p.k_ss, p.sk - nx, tid);
      load_tile<T, D>(vs, vg + (long long)nx * p.v_ss, p.v_ss, p.sk - nx, tid);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.sq) continue;
    const float lv = fmaxf(l[r], 1e-37f);
    T* orow = static_cast<T*>(p.out) + (((long long)b * p.sq + row) * p.h + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(orow + j * 8 + 2 * t, o[j][2 * r] / lv, o[j][2 * r + 1] / lv);
    if (t == 0) {
      p.lse_out[((long long)b * p.h + h) * p.sq + row] = m[r] == -INFINITY ? -INFINITY : m[r] * kLn2 + logf(lv);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------

template <typename T, int D, int STAGES>
constexpr size_t dq_smem() {
  return (size_t)(2 + 2 * STAGES) * kTile * (D + kPad) * sizeof(T) + warp_buf_bytes<T>();
}

template <typename T, int D, int STAGES>
__global__ void __launch_bounds__(kThreads) flash_dq(const Params p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kTile * LD;
  T* ks = dos + kTile * LD;
  T* vs = ks + STAGES * kTile * LD;
  T* dsw = vs + STAGES * kTile * LD + (threadIdx.x >> 5) * 16 * kLdP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.h, h = blockIdx.x % p.h, hk = h / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const long long o_ss = (long long)p.h * D;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* dog = static_cast<const T*>(p.dout) + ((long long)b * p.sq + q0) * o_ss + (long long)h * D;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int lo, hi;
  live_key_tiles(q0, p, &lo, &hi);
  load_tile<T, D>(qs, qg, p.q_ss, p.sq - q0, tid);
  load_tile<T, D>(dos, dog, o_ss, p.sq - q0, tid);
  if (lo <= hi) {
    load_tile<T, D>(ks, kg + (long long)lo * kTile * p.k_ss, p.k_ss, p.sk - lo * kTile, tid);
    load_tile<T, D>(vs, vg + (long long)lo * kTile * p.v_ss, p.v_ss, p.sk - lo * kTile, tid);
  }
  cp_async_commit();

  float lse2[2], dlt[2];  // per row: lse in the log2 domain (-inf: dead row), delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const long long i = ((long long)b * p.h + h) * p.sq + row;
    lse2[r] = row < p.sq ? p.lse[i] * kLog2e : -INFINITY;
    dlt[r] = row < p.sq ? p.delta[i] : 0.f;
  }
  float dq[D / 8][4] = {};
  const float sl2 = p.scale * kLog2e;

  for (int kt = lo; kt <= hi; ++kt) {
    const int st = STAGES == 2 ? (kt - lo) & 1 : 0;
    if (STAGES == 2 && kt < hi) {
      const int nx = (kt + 1) * kTile;
      load_tile<T, D>(ks + (st ^ 1) * kTile * LD, kg + (long long)nx * p.k_ss, p.k_ss, p.sk - nx, tid);
      load_tile<T, D>(vs + (st ^ 1) * kTile * LD, vg + (long long)nx * p.v_ss, p.v_ss, p.sk - nx, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kst = ks + st * kTile * LD;
    const T* vst = vs + st * kTile * LD;

    float s[kTile / 8][4] = {};
    float dp[kTile / 8][4] = {};
    warp_gemm<T, kTile / 8, D / 16, false>(s, qs + warp * 16 * LD, LD, kst, LD, lane);
    warp_gemm<T, kTile / 8, D / 16, false>(dp, dos + warp * 16 * LD, LD, vst, LD, lane);

    const int k0 = kt * kTile;
    const bool full = tile_full(q0, k0, p);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = lse2[r] != -INFINITY &&
                        (full || is_valid(q0 + warp * 16 + g + 8 * r, k0 + j * 8 + 2 * t + (e & 1), p));
        const float pv = ok ? exp2f(s[j][e] * sl2 - lse2[r]) : 0.f;
        dp[j][e] = pv * (dp[j][e] - dlt[r]) * p.scale;  // dS
      }
    }
    if constexpr (kRegOperands<T>) {  // dS, rounded to k's type, straight into the A operand of dS k
      unsigned dsf[kTile / 16][4];
      acc_to_afrags<T, kTile / 16>(dsf, dp);
      warp_gemm_ra<T, D / 8, kTile / 16, true>(dq, dsf, kst, LD, lane);
    } else {
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        store2(dsw + g * kLdP + j * 8 + 2 * t, dp[j][0], dp[j][1]);
        store2(dsw + (g + 8) * kLdP + j * 8 + 2 * t, dp[j][2], dp[j][3]);
      }
      __syncwarp();
      warp_gemm<T, D / 8, kTile / 16, true>(dq, dsw, kLdP, kst, LD, lane);
    }
    __syncthreads();
    if (STAGES == 1 && kt < hi) {
      const int nx = (kt + 1) * kTile;
      load_tile<T, D>(ks, kg + (long long)nx * p.k_ss, p.k_ss, p.sk - nx, tid);
      load_tile<T, D>(vs, vg + (long long)nx * p.v_ss, p.v_ss, p.sk - nx, tid);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.sq) continue;
    float* drow = p.dq + (((long long)b * p.sq + row) * p.h + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(drow + j * 8 + 2 * t, dq[j][2 * r], dq[j][2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// K3: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int D, int STAGES>
constexpr size_t dkv_smem() {
  return (size_t)(2 + 2 * STAGES) * kTile * (D + kPad) * sizeof(T) + (size_t)STAGES * 2 * kTile * sizeof(float) +
         warp_buf_bytes<T>();
}

template <typename T, int D, int STAGES>
__global__ void __launch_bounds__(kThreads) flash_dkv(const Params p) {
  constexpr int LD = D + kPad;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kTile * LD;
  T* qs = vs + kTile * LD;            // [STAGES][kTile][LD]
  T* dos = qs + STAGES * kTile * LD;  // [STAGES][kTile][LD]
  float* lses = reinterpret_cast<float*>(dos + STAGES * kTile * LD);  // [STAGES][kTile]
  float* dels = lses + STAGES * kTile;
  T* pw = reinterpret_cast<T*>(dels + STAGES * kTile) + (threadIdx.x >> 5) * 16 * kLdP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv, groups = p.h / p.hkv;
  const int k0 = blockIdx.y * kTile;  // low key tiles see the most queries under causal: first
  const long long o_ss = (long long)p.h * D;

  load_tile<T, D>(ks, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh + k0 * p.k_ss, p.k_ss, p.sk - k0, tid);
  load_tile<T, D>(vs, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh + k0 * p.v_ss, p.v_ss, p.sk - k0, tid);
  cp_async_commit();

  const int nq = (p.sq + kTile - 1) / kTile;
  int lo = 0, hi = nq - 1;
  while (lo <= hi && !tile_live(lo * kTile, k0, p)) ++lo;
  while (hi >= lo && !tile_live(hi * kTile, k0, p)) --hi;
  const int n_q = hi - lo + 1;
  const int n_iter = n_q > 0 ? groups * n_q : 0;

  // stage `st` <- query tile of iteration `it`: q, dO, lse, delta of head hk * groups + it / n_q
  auto issue = [&](int it, int st) {
    const int hh = hk * groups + it / n_q, q0 = (lo + it % n_q) * kTile;
    load_tile<T, D>(qs + st * kTile * LD, static_cast<const T*>(p.q) + b * p.q_sb + hh * p.q_sh + q0 * p.q_ss,
                    p.q_ss, p.sq - q0, tid);
    load_tile<T, D>(dos + st * kTile * LD,
                    static_cast<const T*>(p.dout) + ((long long)b * p.sq + q0) * o_ss + (long long)hh * D, o_ss,
                    p.sq - q0, tid);
    const long long ri = ((long long)b * p.h + hh) * p.sq + q0;
    load_row_stats(lses + st * kTile, p.lse + ri, p.sq - q0, tid);
    load_row_stats(dels + st * kTile, p.delta + ri, p.sq - q0, tid);
    cp_async_commit();
  };

  float dk[D / 8][4] = {};
  float dv[D / 8][4] = {};
  const float sl2 = p.scale * kLog2e;
  if (n_iter > 0) issue(0, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int st = STAGES == 2 ? it & 1 : 0;
    if (STAGES == 2 && it + 1 < n_iter) {
      issue(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qst = qs + st * kTile * LD;
    const T* dost = dos + st * kTile * LD;
    const float* lst = lses + st * kTile;
    const float* dst = dels + st * kTile;
    const int q0 = (lo + it % n_q) * kTile;

    // s^T = k q^T: rows are this warp's 16 keys, columns the tile's 64 queries
    float s[kTile / 8][4] = {};
    warp_gemm<T, kTile / 8, D / 16, false>(s, ks + warp * 16 * LD, LD, qst, LD, lane);
    const bool full = tile_full(q0, k0, p);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const float lse = lst[c];
        const bool ok = lse != -INFINITY && (full || is_valid(q0 + c, k0 + warp * 16 + g + ((e >> 1) << 3), p));
        s[j][e] = ok ? exp2f(s[j][e] * sl2 - lse * kLog2e) : 0.f;  // P^T
      }
    }
    float dp[kTile / 8][4] = {};
    if constexpr (kRegOperands<T>) {  // P^T and dS^T, rounded, straight into the A operands
      unsigned af[kTile / 16][4];
      acc_to_afrags<T, kTile / 16>(af, s);
      warp_gemm_ra<T, D / 8, kTile / 16, true>(dv, af, dost, LD, lane);  // dv += P^T dO
      warp_gemm<T, kTile / 8, D / 16, false>(dp, vs + warp * 16 * LD, LD, dost, LD, lane);  // dP^T = v dO^T
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dst[j * 8 + 2 * t + (e & 1)]) * p.scale;
      }
      acc_to_afrags<T, kTile / 16>(af, dp);
      warp_gemm_ra<T, D / 8, kTile / 16, true>(dk, af, qst, LD, lane);  // dk += dS^T q
    } else {
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        store2(pw + g * kLdP + j * 8 + 2 * t, s[j][0], s[j][1]);
        store2(pw + (g + 8) * kLdP + j * 8 + 2 * t, s[j][2], s[j][3]);
      }
      __syncwarp();
      warp_gemm<T, D / 8, kTile / 16, true>(dv, pw, kLdP, dost, LD, lane);  // dv += P^T dO
      warp_gemm<T, kTile / 8, D / 16, false>(dp, vs + warp * 16 * LD, LD, dost, LD, lane);  // dP^T = v dO^T
      __syncwarp();  // every lane has read P^T before dS^T replaces it
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[e] = s[j][e] * (dp[j][e] - dst[j * 8 + 2 * t + (e & 1)]) * p.scale;
        store2(pw + g * kLdP + j * 8 + 2 * t, ds[0], ds[1]);
        store2(pw + (g + 8) * kLdP + j * 8 + 2 * t, ds[2], ds[3]);
      }
      __syncwarp();
      warp_gemm<T, D / 8, kTile / 16, true>(dk, pw, kLdP, qst, LD, lane);  // dk += dS^T q
    }
    __syncthreads();
    if (STAGES == 1 && it + 1 < n_iter) issue(it + 1, 0);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= p.sk) continue;
    const long long base = (((long long)b * p.sk + key) * p.hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(p.dk + base + j * 8 + 2 * t, dk[j][2 * r], dk[j][2 * r + 1]);
      store2(p.dv + base + j * 8 + 2 * t, dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename K>
cudaError_t launch_with(K kernel, size_t smem, dim3 grid, const Params& p, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(Kind kind, const Params& p, cudaStream_t s) {
  constexpr int ST = sizeof(T) == 4 ? 1 : 2;  // f32 tiles are twice the bytes: one stage fits
  const int nq = (p.sq + kTile - 1) / kTile, nk = (p.sk + kTile - 1) / kTile;
  switch (kind) {
    case kFwd:  // f32 only: bf16 and fp16 launch flash_fwd_sm90.cu
      if constexpr (std::is_same<T, float>::value) {
        return launch_with(flash_fwd_f32<D>, fwd_smem_f32<D>(), fwd_grid(p.b, p.h, p.sq), p, s);
      } else {
        return cudaErrorInvalidValue;
      }
    case kDq:
      return launch_with(flash_dq<T, D, ST>, dq_smem<T, D, ST>(), dim3(p.b * p.h, nq), p, s);
    case kDkv:
      return launch_with(flash_dkv<T, D, ST>, dkv_smem<T, D, ST>(), dim3(p.b * p.hkv, nk), p, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_dim(Kind kind, int d, const Params& p, cudaStream_t s) {
  if (d == 64) return launch<T, 64>(kind, p, s);
  if (d == 128) return launch<T, 128>(kind, p, s);
  return cudaErrorInvalidValue;
}

int run(Kind kind, int dtype, int d, const Params& p, void* stream) {
  if (p.b <= 0 || p.h <= 0 || p.hkv <= 0 || p.h % p.hkv != 0 || p.sq <= 0 || p.sk <= 0 || p.window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_dim<float>(kind, d, p, s);
    case 1:
      return (int)launch_dim<__nv_bfloat16>(kind, d, p, s);
    case 2:
      return (int)launch_dim<__half>(kind, d, p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, int b, int h, int hkv, int sq, int sk,
                   const long long* strides, float scale, int causal, int window) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.b = b;
  p.h = h;
  p.hkv = hkv;
  p.sq = sq;
  p.sk = sk;
  p.q_sb = strides[0], p.q_ss = strides[1], p.q_sh = strides[2];
  p.k_sb = strides[3], p.k_ss = strides[4], p.k_sh = strides[5];
  p.v_sb = strides[6], p.v_ss = strides[7], p.v_sh = strides[8];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  return p;
}

}  // namespace

// strides: 9 element strides (batch, seq, head) of q, k and v.
// dtype: 0 f32, 1 bf16, 2 f16. Each returns the launch's cudaError_t.

// dtype 0 only: the 16-bit forward is flash_fwd_sm90.cu's.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int dtype,
                                   int b, int h, int hkv, int sq, int sk, int d, const long long* strides,
                                   float scale, int causal, int window, void* stream) {
  Params p = make_params(q, k, v, b, h, hkv, sq, sk, strides, scale, causal, window);
  p.out = out;
  p.lse_out = lse;
  return run(kFwd, dtype, d, p, stream);
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                  const float* delta, float* dq, int dtype, int b, int h, int hkv, int sq, int sk,
                                  int d, const long long* strides, float scale, int causal, int window,
                                  void* stream) {
  Params p = make_params(q, k, v, b, h, hkv, sq, sk, strides, scale, causal, window);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  return run(kDq, dtype, d, p, stream);
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                   const float* delta, float* dk, float* dv, int dtype, int b, int h, int hkv,
                                   int sq, int sk, int d, const long long* strides, float scale, int causal,
                                   int window, void* stream) {
  Params p = make_params(q, k, v, b, h, hkv, sq, sk, strides, scale, causal, window);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  return run(kDkv, dtype, d, p, stream);
}

// What flash_attention_fwd launches for these shapes (f32, dtype 0):
// out[0..1] grid x, y, out[2] threads a block, out[3] dynamic shared memory
// bytes.
extern "C" int flash_attention_fwd_config(int dtype, int b, int h, int sq, int d, int* out) {
  if (dtype != 0 || (d != 64 && d != 128) || b <= 0 || h <= 0 || sq <= 0) return (int)cudaErrorInvalidValue;
  const dim3 g = fwd_grid(b, h, sq);
  out[0] = (int)g.x;
  out[1] = (int)g.y;
  out[2] = kThreads;
  out[3] = (int)(d == 64 ? fwd_smem_f32<64>() : fwd_smem_f32<128>());
  return 0;
}
