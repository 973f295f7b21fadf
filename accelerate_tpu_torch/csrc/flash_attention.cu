// Flash attention in f32, forward and backward, for Hopper (sm_90a).
//
// Replaces the f32 paths of the three Pallas TPU kernels of
// accelerate_tpu/ops/pallas_attention.py that its _flash custom_vjp binds
// together (bf16 and fp16 run the wgmma kernels of flash_fwd_sm90.cu and
// flash_bwd_sm90.cu; wgmma on f32 is TF32, which would change these numbers):
//   K1 _fwd_kernel -> flash_fwd_f32: out = softmax(q k^T * scale) v and the
//      row log-sum-exp lse, online softmax in f32;
//   K2 _dq_kernel  -> flash_dq_f32: dq = sum_k dS k with P recomputed from
//      lse, dS = P * (dP - delta) * scale, dP = dO v^T, delta = rowsum(dO *
//      out);
//   K3 _dkv_kernel -> flash_dkv_f32: dv = sum_q P^T dO, dk = sum_q dS^T q.
//
// Layout: q/out/dO [B, Sq, H, D], k/v [B, Sk, Hkv, D] read in place through
// their strides (last dim contiguous), lse/delta [B, H, Sq] f32, dq [B, Sq,
// H, D] f32, dk/dv [B, Sk, Hkv, D] f32 (all contiguous outputs). GQA reads
// kv head h / (H / Hkv). Masks follow the Pallas kernel: causal is aligned
// bottom-right (query i sees keys <= i + Sk - Sq), the band keeps keys >
// i + Sk - Sq - window, and a row with no live key gives out 0 and lse -inf.
// Every product accumulates in f32.
//
// What bounds it on this card. In f32 the products run on the CUDA cores
// (67 TFLOP/s): at the training slice's shapes (B 8, H 32, Hkv 4, S 2048, D
// 64, causal) about 137 GFLOP for K1, 206 for K2 and 275 for K3, so the
// FMA units bound all three.
//
// Head dims. The kernels are built at the widths D 64, 128 and 256; a head
// dim d (a multiple of 4; the wrappers pass multiples of 8) runs at the
// least of them that holds it, its columns past d loaded as zeros and never
// stored. At D 256 a block owns 32 rows with 2 warps (four tiles of 64 rows
// would not fit in shared memory), and K3 runs two blocks a key tile, each
// accumulating half of dK's and dV's columns (all of them would be 256 f32
// a thread) and each computing S^T and dP^T whole.
//
// What the design here does about it. One block of 4 warps owns 64 rows
// (query rows in K1 and K2, key rows in K3), 16 a warp, and walks the live
// tiles of the other side in a loop inside the block: the TPU grid's
// sequential axis becomes this loop, and nothing is carried between blocks.
// Tiles that _block_live skips are never loaded, so causal costs half and a
// band O(S * W). Tiles come in with cp.async into padded shared tiles (row
// pitch D + 8), one stage; the products are scalar FMAs (no TF32) into
// accumulators laid out as mma.sync's m16n8 ones, and P and dS go to the
// next product through a small shared buffer per warp. K3 loops over the G
// query heads of its kv head inside the block, so the GQA sum of the Pallas
// backward happens in registers: no [B, H, Sk, D] intermediate and no
// atomics. Blocks take the heaviest causal tiles first. It allocates nothing
// and launches on the caller's stream.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPad = 8;  // shared row padding, in elements
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A block at built width D: kTile rows it owns (and rows of each tile it
// walks), 16 a warp; kHalves blocks share a K3 key tile, each on kCols of
// dK's and dV's columns.
template <int D>
struct Tile {
  static constexpr int kTile = D > 128 ? 32 : 64;
  static constexpr int kThreads = 2 * kTile;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kLd = D + kPad;      // pitch of a q, k, v or dO tile
  static constexpr int kLdP = kTile + kPad;  // pitch of a warp's P or dS buffer
  static constexpr int kHalves = D > 128 ? 2 : 1;
  static constexpr int kCols = D / kHalves;
  static constexpr size_t kTileBytes = (size_t)kTile * kLd * sizeof(float);
  static constexpr size_t kWarpBufBytes = (size_t)kWarps * 16 * kLdP * sizeof(float);  // P or dS, 16 rows a warp
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;   // [B, Sq, H, D] contiguous
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  float* out;          // [B, Sq, H, D] contiguous
  float* lse_out;
  float* dq;  // [B, Sq, H, D]
  float* dk;  // [B, Sk, Hkv, D]
  float* dv;
  int b, h, hkv, sq, sk, d;  // d: the head dim, at most the built width
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

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Two f32 values stored as a pair (P, dS and the outputs).
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// One warp: acc[NT][4] += A (16 x 16*KS, row-major in shared memory, pitch
// lda) * B[0 .. 16 KS)[0 .. 8 NT), B stored [N][K] in shared memory (pitch
// ldb) or, with B_KN, [K][N], by scalar FMAs on the CUDA cores. acc follows
// the m16n8 accumulator layout: lane l holds rows l/4 and l/4 + 8, columns
// 2 (l % 4) and 2 (l % 4) + 1 of each 8-column tile.
template <int NT, int KS, bool B_KN>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const float* a, int lda, const float* b, int ldb,
                                          int lane) {
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
}

// kTile rows of D floats from src (row stride in elements) into dst (pitch
// D + kPad); rows >= valid and columns >= d are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride, int valid, int d, int tid) {
  using W = Tile<D>;
  constexpr int kChunks = D / 4;
  for (int i = tid; i < W::kTile * kChunks; i += W::kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r < valid && c < d;
    cp_async16(dst + r * W::kLd + c, src + (ok ? r * stride + c : 0), ok);
  }
}

template <int D>
__device__ __forceinline__ void load_row_stats(float* dst, const float* src, int valid, int tid) {
  if (tid < Tile<D>::kTile) cp_async4(dst + tid, src + (tid < valid ? tid : 0), tid < valid);
}

// The warp's 16 x TILE tile (accumulator layout) into its shared buffer.
template <int TILE>
__device__ __forceinline__ void store_tile(float* w, const float (&x)[TILE / 8][4], int g, int t) {
  constexpr int kLdP = TILE + kPad;
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
    store2(w + g * kLdP + j * 8 + 2 * t, x[j][0], x[j][1]);
    store2(w + (g + 8) * kLdP + j * 8 + 2 * t, x[j][2], x[j][3]);
  }
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
template <int kTile>
__device__ __forceinline__ bool tile_live(int q_start, int k_start, const Params& p) {
  const int off = p.sk - p.sq;
  bool live = p.causal ? (q_start + kTile - 1 + off >= k_start) : true;
  if (p.window > 0) live = live && (k_start + kTile - 1 > q_start + off - p.window);
  return live;
}

// every element of the tile unmasked (no per-element test needed)
template <int kTile>
__device__ __forceinline__ bool tile_full(int q_start, int k_start, const Params& p) {
  const int off = p.sk - p.sq;
  bool full = q_start + kTile <= p.sq && k_start + kTile <= p.sk;
  if (p.causal) full = full && q_start + off >= k_start + kTile - 1;
  if (p.window > 0) full = full && k_start > q_start + kTile - 1 + off - p.window;
  return full;
}

// Live key tiles [*lo, *hi] of the query tile at q_start (empty if lo > hi).
template <int kTile>
__device__ __forceinline__ void live_key_tiles(int q_start, const Params& p, int* lo, int* hi) {
  int h_ = (p.sk + kTile - 1) / kTile - 1;
  if (p.causal) h_ = min(h_, floor_div(q_start + kTile - 1 + p.sk - p.sq, kTile));
  int l_ = 0;
  while (l_ <= h_ && !tile_live<kTile>(q_start, l_ * kTile, p)) ++l_;
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

// q, k, v tiles, then the warps' P buffers.
template <int D>
constexpr size_t fwd_smem() {
  return 3 * Tile<D>::kTileBytes + Tile<D>::kWarpBufBytes;
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads) flash_fwd_f32(const Params p) {
  using W = Tile<D>;
  constexpr int LD = W::kLd, kTile = W::kTile, kLdP = W::kLdP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* pw = vs + kTile * LD + (threadIdx.x >> 5) * 16 * kLdP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.h, h = blockIdx.x % p.h, hk = h / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest causal tiles first
  const float* qg = p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vg = p.v + b * p.v_sb + hk * p.v_sh;

  int lo, hi;
  live_key_tiles<kTile>(q0, p, &lo, &hi);
  load_tile<D>(qs, qg, p.q_ss, p.sq - q0, p.d, tid);
  if (lo <= hi) {
    load_tile<D>(ks, kg + (long long)lo * kTile * p.k_ss, p.k_ss, p.sk - lo * kTile, p.d, tid);
    load_tile<D>(vs, vg + (long long)lo * kTile * p.v_ss, p.v_ss, p.sk - lo * kTile, p.d, tid);
  }
  cp_async_commit();

  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = p.scale * kLog2e;  // scores in the log2 domain

  for (int kt = lo; kt <= hi; ++kt) {
    cp_async_wait_all();
    __syncthreads();

    float s[kTile / 8][4] = {};
    warp_gemm<kTile / 8, D / 16, false>(s, qs + warp * 16 * LD, LD, ks, LD, lane);

    const int k0 = kt * kTile;
    const bool full = tile_full<kTile>(q0, k0, p);
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
    store_tile<kTile>(pw, s, g, t);
    __syncwarp();
    warp_gemm<D / 8, kTile / 16, true>(o, pw, kLdP, vs, LD, lane);
    __syncthreads();
    if (kt < hi) {  // one stage: the next tile loads once this one is done
      const int nx = (kt + 1) * kTile;
      load_tile<D>(ks, kg + (long long)nx * p.k_ss, p.k_ss, p.sk - nx, p.d, tid);
      load_tile<D>(vs, vg + (long long)nx * p.v_ss, p.v_ss, p.sk - nx, p.d, tid);
      cp_async_commit();
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.sq) continue;
    const float lv = fmaxf(l[r], 1e-37f);
    float* orow = p.out + (((long long)b * p.sq + row) * p.h + h) * p.d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j * 8 < p.d) store2(orow + j * 8 + 2 * t, o[j][2 * r] / lv, o[j][2 * r + 1] / lv);
    }
    if (t == 0) {
      p.lse_out[((long long)b * p.h + h) * p.sq + row] = m[r] == -INFINITY ? -INFINITY : m[r] * kLn2 + logf(lv);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------

// q, dO, k, v tiles, then the warps' dS buffers.
template <int D>
constexpr size_t dq_smem() {
  return 4 * Tile<D>::kTileBytes + Tile<D>::kWarpBufBytes;
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads) flash_dq_f32(const Params p) {
  using W = Tile<D>;
  constexpr int LD = W::kLd, kTile = W::kTile, kLdP = W::kLdP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dsw = vs + kTile * LD + (threadIdx.x >> 5) * 16 * kLdP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.h, h = blockIdx.x % p.h, hk = h / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const long long o_ss = (long long)p.h * p.d;
  const float* qg = p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* dog = p.dout + ((long long)b * p.sq + q0) * o_ss + (long long)h * p.d;
  const float* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vg = p.v + b * p.v_sb + hk * p.v_sh;

  int lo, hi;
  live_key_tiles<kTile>(q0, p, &lo, &hi);
  load_tile<D>(qs, qg, p.q_ss, p.sq - q0, p.d, tid);
  load_tile<D>(dos, dog, o_ss, p.sq - q0, p.d, tid);
  if (lo <= hi) {
    load_tile<D>(ks, kg + (long long)lo * kTile * p.k_ss, p.k_ss, p.sk - lo * kTile, p.d, tid);
    load_tile<D>(vs, vg + (long long)lo * kTile * p.v_ss, p.v_ss, p.sk - lo * kTile, p.d, tid);
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
    cp_async_wait_all();
    __syncthreads();

    float s[kTile / 8][4] = {};
    float dp[kTile / 8][4] = {};
    warp_gemm<kTile / 8, D / 16, false>(s, qs + warp * 16 * LD, LD, ks, LD, lane);
    warp_gemm<kTile / 8, D / 16, false>(dp, dos + warp * 16 * LD, LD, vs, LD, lane);

    const int k0 = kt * kTile;
    const bool full = tile_full<kTile>(q0, k0, p);
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
    store_tile<kTile>(dsw, dp, g, t);
    __syncwarp();
    warp_gemm<D / 8, kTile / 16, true>(dq, dsw, kLdP, ks, LD, lane);
    __syncthreads();
    if (kt < hi) {
      const int nx = (kt + 1) * kTile;
      load_tile<D>(ks, kg + (long long)nx * p.k_ss, p.k_ss, p.sk - nx, p.d, tid);
      load_tile<D>(vs, vg + (long long)nx * p.v_ss, p.v_ss, p.sk - nx, p.d, tid);
      cp_async_commit();
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.sq) continue;
    float* drow = p.dq + (((long long)b * p.sq + row) * p.h + h) * p.d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j * 8 < p.d) store2(drow + j * 8 + 2 * t, dq[j][2 * r], dq[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dk, dv
// ---------------------------------------------------------------------------

// k, v, q, dO tiles, the lse and delta rows, then the warps' P / dS buffers.
template <int D>
constexpr size_t dkv_smem() {
  return 4 * Tile<D>::kTileBytes + (size_t)2 * Tile<D>::kTile * sizeof(float) + Tile<D>::kWarpBufBytes;
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads) flash_dkv_f32(const Params p) {
  using W = Tile<D>;
  constexpr int LD = W::kLd, kTile = W::kTile, kLdP = W::kLdP, DC = W::kCols;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* lses = dos + kTile * LD;
  float* dels = lses + kTile;
  float* pw = dels + kTile + (threadIdx.x >> 5) * 16 * kLdP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x / W::kHalves, c0 = (blockIdx.x % W::kHalves) * DC;  // c0: its first dK, dV column
  const int b = bh / p.hkv, hk = bh % p.hkv, groups = p.h / p.hkv;
  const int k0 = blockIdx.y * kTile;  // low key tiles see the most queries under causal: first
  const long long o_ss = (long long)p.h * p.d;

  load_tile<D>(ks, p.k + b * p.k_sb + hk * p.k_sh + k0 * p.k_ss, p.k_ss, p.sk - k0, p.d, tid);
  load_tile<D>(vs, p.v + b * p.v_sb + hk * p.v_sh + k0 * p.v_ss, p.v_ss, p.sk - k0, p.d, tid);
  cp_async_commit();

  const int nq = (p.sq + kTile - 1) / kTile;
  int lo = 0, hi = nq - 1;
  while (lo <= hi && !tile_live<kTile>(lo * kTile, k0, p)) ++lo;
  while (hi >= lo && !tile_live<kTile>(hi * kTile, k0, p)) --hi;
  const int n_q = hi - lo + 1;
  const int n_iter = n_q > 0 ? groups * n_q : 0;

  // the query tile of iteration `it`: q, dO, lse, delta of head hk * groups + it / n_q
  auto issue = [&](int it) {
    const int hh = hk * groups + it / n_q, q0 = (lo + it % n_q) * kTile;
    load_tile<D>(qs, p.q + b * p.q_sb + hh * p.q_sh + q0 * p.q_ss, p.q_ss, p.sq - q0, p.d, tid);
    load_tile<D>(dos, p.dout + ((long long)b * p.sq + q0) * o_ss + (long long)hh * p.d, o_ss, p.sq - q0, p.d, tid);
    const long long ri = ((long long)b * p.h + hh) * p.sq + q0;
    load_row_stats<D>(lses, p.lse + ri, p.sq - q0, tid);
    load_row_stats<D>(dels, p.delta + ri, p.sq - q0, tid);
    cp_async_commit();
  };

  float dk[DC / 8][4] = {};
  float dv[DC / 8][4] = {};
  const float sl2 = p.scale * kLog2e;
  if (n_iter > 0) issue(0);

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait_all();
    __syncthreads();
    const int q0 = (lo + it % n_q) * kTile;

    // s^T = k q^T: rows are this warp's 16 keys, columns the tile's 64 queries
    float s[kTile / 8][4] = {};
    warp_gemm<kTile / 8, D / 16, false>(s, ks + warp * 16 * LD, LD, qs, LD, lane);
    const bool full = tile_full<kTile>(q0, k0, p);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const float lse = lses[c];
        const bool ok = lse != -INFINITY && (full || is_valid(q0 + c, k0 + warp * 16 + g + ((e >> 1) << 3), p));
        s[j][e] = ok ? exp2f(s[j][e] * sl2 - lse * kLog2e) : 0.f;  // P^T
      }
    }
    float dp[kTile / 8][4] = {};
    store_tile<kTile>(pw, s, g, t);
    __syncwarp();
    warp_gemm<DC / 8, kTile / 16, true>(dv, pw, kLdP, dos + c0, LD, lane);              // dv += P^T dO
    warp_gemm<kTile / 8, D / 16, false>(dp, vs + warp * 16 * LD, LD, dos, LD, lane);  // dP^T = v dO^T
    __syncwarp();  // every lane has read P^T before dS^T replaces it
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dels[j * 8 + 2 * t + (e & 1)]) * p.scale;
    }
    store_tile<kTile>(pw, dp, g, t);
    __syncwarp();
    warp_gemm<DC / 8, kTile / 16, true>(dk, pw, kLdP, qs + c0, LD, lane);  // dk += dS^T q
    __syncthreads();
    if (it + 1 < n_iter) issue(it + 1);
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= p.sk) continue;
    const long long base = (((long long)b * p.sk + key) * p.hkv + hk) * p.d + c0;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      if (c0 + j * 8 >= p.d) continue;
      store2(p.dk + base + j * 8 + 2 * t, dk[j][2 * r], dk[j][2 * r + 1]);
      store2(p.dv + base + j * 8 + 2 * t, dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// What a launch of `kind` takes: grid (x, y), dynamic shared memory bytes.
// The built width a head dim runs at.
int width_of(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

template <int D>
void shape_of(Kind kind, int b, int h, int hkv, int sq, int sk, dim3* grid, size_t* smem) {
  constexpr int kTile = Tile<D>::kTile;
  const int nq = (sq + kTile - 1) / kTile, nk = (sk + kTile - 1) / kTile;
  *grid = kind == kDkv ? dim3(b * hkv * Tile<D>::kHalves, nk) : dim3(b * h, nq);
  *smem = kind == kFwd ? fwd_smem<D>() : kind == kDq ? dq_smem<D>() : dkv_smem<D>();
}

bool bad_config(int dtype, int b, int h, int hkv, int sq, int sk, int d) {
  return dtype != 0 || d < 4 || d > 256 || d % 4 != 0 || b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 || sq <= 0 ||
         sk <= 0 || (sq + 31) / 32 > 65535 || (sk + 31) / 32 > 65535;
}

template <int D>
cudaError_t launch(Kind kind, const Params& p, cudaStream_t s) {
  dim3 grid;
  size_t smem;
  shape_of<D>(kind, p.b, p.h, p.hkv, p.sq, p.sk, &grid, &smem);
  auto kernel = kind == kFwd ? flash_fwd_f32<D> : kind == kDq ? flash_dq_f32<D> : flash_dkv_f32<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, Tile<D>::kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

int run(Kind kind, int dtype, const Params& p, void* stream) {
  if (bad_config(dtype, p.b, p.h, p.hkv, p.sq, p.sk, p.d) || p.window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = width_of(p.d);
  return (int)(w == 64 ? launch<64>(kind, p, s) : w == 128 ? launch<128>(kind, p, s) : launch<256>(kind, p, s));
}

template <int D>
void config_of(Kind kind, int b, int h, int hkv, int sq, int sk, int* out) {
  dim3 grid;
  size_t smem;
  shape_of<D>(kind, b, h, hkv, sq, sk, &grid, &smem);
  out[0] = (int)grid.x;
  out[1] = (int)grid.y;
  out[2] = Tile<D>::kThreads;
  out[3] = (int)smem;
}

int config(Kind kind, int dtype, int b, int h, int hkv, int sq, int sk, int d, int* out) {
  if (bad_config(dtype, b, h, hkv, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const int w = width_of(d);
  if (w == 64) {
    config_of<64>(kind, b, h, hkv, sq, sk, out);
  } else if (w == 128) {
    config_of<128>(kind, b, h, hkv, sq, sk, out);
  } else {
    config_of<256>(kind, b, h, hkv, sq, sk, out);
  }
  return 0;
}

Params make_params(const void* q, const void* k, const void* v, int b, int h, int hkv, int sq, int sk, int d,
                   const long long* strides, float scale, int causal, int window) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.b = b;
  p.h = h;
  p.hkv = hkv;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.q_sb = strides[0], p.q_ss = strides[1], p.q_sh = strides[2];
  p.k_sb = strides[3], p.k_ss = strides[4], p.k_sh = strides[5];
  p.v_sb = strides[6], p.v_ss = strides[7], p.v_sh = strides[8];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  return p;
}

}  // namespace

// strides: 9 element strides (batch, seq, head) of q, k and v. dtype: 0
// (f32) only; bf16 and fp16 run flash_fwd_sm90.cu and flash_bwd_sm90.cu.
// Each returns the launch's cudaError_t.

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int dtype,
                                   int b, int h, int hkv, int sq, int sk, int d, const long long* strides,
                                   float scale, int causal, int window, void* stream) {
  Params p = make_params(q, k, v, b, h, hkv, sq, sk, d, strides, scale, causal, window);
  p.out = static_cast<float*>(out);
  p.lse_out = lse;
  return run(kFwd, dtype, p, stream);
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                  const float* delta, float* dq, int dtype, int b, int h, int hkv, int sq, int sk,
                                  int d, const long long* strides, float scale, int causal, int window,
                                  void* stream) {
  Params p = make_params(q, k, v, b, h, hkv, sq, sk, d, strides, scale, causal, window);
  p.dout = static_cast<const float*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  return run(kDq, dtype, p, stream);
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                                   const float* delta, float* dk, float* dv, int dtype, int b, int h, int hkv,
                                   int sq, int sk, int d, const long long* strides, float scale, int causal,
                                   int window, void* stream) {
  Params p = make_params(q, k, v, b, h, hkv, sq, sk, d, strides, scale, causal, window);
  p.dout = static_cast<const float*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  return run(kDkv, dtype, p, stream);
}

// What each entry launches for these shapes (dtype 0): out[0..1] grid x, y,
// out[2] threads a block, out[3] dynamic shared memory bytes.
extern "C" int flash_attention_fwd_config(int dtype, int b, int h, int sq, int d, int* out) {
  return config(kFwd, dtype, b, h, h, sq, sq, d, out);
}

extern "C" int flash_attention_dq_config(int dtype, int b, int h, int hkv, int sq, int sk, int d, int* out) {
  return config(kDq, dtype, b, h, hkv, sq, sk, d, out);
}

extern "C" int flash_attention_dkv_config(int dtype, int b, int h, int hkv, int sq, int sk, int d, int* out) {
  return config(kDkv, dtype, b, h, hkv, sq, sk, d, out);
}
