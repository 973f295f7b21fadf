// The two contract-bearing reference kernels for Hopper (sm_90a).
//
// Replace accelerate_tpu/kernels/reference.py::block_matmul_softmax_kernel
// and ::block_accumulate_kernel, the Pallas TPU kernels launched by
// block_matmul_softmax and block_accumulate there.
//
// block_matmul_softmax: x [B, D], w [D, N] (both f32, bf16 or fp16)
//   ->  out [B, N] f32 = softmax(x @ w, axis=-1), products and sums in f32
//   (f32 inputs multiply in full f32 on the CUDA cores: no TF32).
// The TPU kernel gives every grid step 8 rows of x and all of w, and holds
// the 8 x N logits in VMEM. What bounds it here is the bytes of w, read once
// for every 8 rows: at the decode-logits shape (8 x 2048 @ 2048 x 32000)
// 131 MB in bf16, 0.039 ms at 3.35 TB/s. So the design keeps w streaming
// into every SM and does the products where they cost nothing:
//  1. logits pass, grid (B / 8, splits, ceil(N / 128)), 128 threads: block
//     (r, s, t) owns rows 8r..8r+7, the 128 columns of tile t and the
//     contraction rows of split s (a multiple of the stage depth KD = 128
//     bytes of an x row: 64 rows in 16 bits, 32 in f32; the contraction is
//     split only where the tiles give fewer blocks than SMs). Its w rows and the
//     matching 8 x KD of x stream through a four-stage shared-memory ring
//     of cp.async copies (about 18 KB a stage, three in flight), VEC bytes
//     a copy: 16 where N and D allow, else 8, 4 or 2 (2 by plain loads),
//     zero-filled past D and N. In 16 bits the products run on the tensor
//     cores: logits^T [128 x 8] = w^T x^T by mma.sync m16n8k16 (x's 8 rows
//     are the product's n = 8), w^T's fragments by ldmatrix.trans from the
//     ring; bf16 and fp16 products are exact in f32 and summed in f32. In
//     f32 CUDA-core FMAs: a thread owns 4 columns and 8 rows over its warp's
//     quarter of each stage, and the 4 warps' sums are added in order. A
//     split writes its partial logits and takes a ticket of its (row
//     block, tile) counter; the block that takes the last ticket sums the
//     splits in split order (so two calls are bit-equal), writes the
//     logits, and the tile's row maximum and sum of exp(logit - maximum).
//  2. normalise pass, grid (ceil(N / 1024), B): joins the row's tile maxima
//     and sums (M = max m_t, L = sum l_t exp(m_t - M), in tile order), then
//     out = exp(logit - M) / L in place.
// Measured on the H100 (PERF.md): a plain read of as many bytes, timed the
// same way, runs at about 2.35 TB/s whatever the stripe width; the ring's
// depth (3 to 6 stages), 64- or 256-column tiles and splitting the
// contraction at the decode shape were each no faster, and one cooperative
// launch joining the rows at a grid barrier was 6% slower than two passes.
// cp.async rather than TMA: one path for every row width, ragged ones too.
//
// block_accumulate: acc [B, N] += delta [B, N] in place (one type: f32,
// bf16 or fp16; the sum is formed in f32 and rounded once). Bound by
// bytes: two reads and one write an element. One 16-byte pair a thread
// and a block for every 256 of them, so the whole call is in the grid at
// once; the last block also takes the scalar tail. (A resident wave walking
// the vectors, 2 to 8 pairs in flight a thread, and streaming, read-only or
// L2-prefetch hints each measured no faster on the H100: PERF.md.)
//
// Neither allocates (the caller passes partials, counters and scratch);
// both launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;        // rows of x a logits block owns
constexpr int kCols = 128;      // columns a logits block owns
constexpr int kThreads = 128;   // threads a logits block
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;      // stages of the ring
constexpr int kXRowBytes = 128; // bytes of an x row a stage holds: KD = 128 / sizeof(T)
constexpr int kPad = 16;        // bytes after every ring row: ldmatrix reads 8 rows without bank conflicts
constexpr int kTilePitch = kCols + 4;  // floats a row of the logits tile (conflict-free fragment stores)
constexpr int kNormThreads = 256;
constexpr int kNormCols = 4 * kNormThreads;  // columns a normalise block owns
constexpr int kAccThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// VEC bytes global -> shared, zero-filled when !valid (src is then not read,
// but must still be an address). 16 and 8 and 4 bytes by cp.async; 2 bytes
// (a 16-bit row of odd length) by a plain load and store.
template <int VEC>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (VEC == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0)
                 : "memory");
  } else if constexpr (VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = valid ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory of a logits block, in bytes: the ring (kStages stages of KD
// w rows of kCols columns and the 8 x KD block of x, each row padded by
// kPad), the logits tile [8][kTilePitch] f32, the row reductions
// [8][kWarps] f32 and the join's flag.
template <typename T>
struct Ring {
  static constexpr int kDepth = kXRowBytes / (int)sizeof(T);  // KD
  static constexpr int kWPitch = kCols * (int)sizeof(T) + kPad;
  static constexpr int kXPitch = kXRowBytes + kPad;
  static constexpr int kStageBytes = kDepth * kWPitch + kRows * kXPitch;
  static constexpr int kTileOff = kStages * kStageBytes;
  static constexpr int kRedOff = kTileOff + kRows * kTilePitch * 4;
  static constexpr int kFlagOff = kRedOff + kRows * kWarps * 4;
  static constexpr int kBytes = kFlagOff + 16;
};

// Copy chunk `c` (contraction rows c KD .. c KD + KD - 1, zero past d_end)
// of w's columns col0 .. col0 + 127 and of x's rows row0 .. row0 + 7 into
// ring stage `stage`.
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(char* smem, int stage, int c, const T* __restrict__ x,
                                           const T* __restrict__ w, int row0, int col0, int d, int d_end, int n) {
  using R = Ring<T>;
  constexpr int kEl = VEC / (int)sizeof(T);              // elements a copy
  constexpr int kWCopies = kCols * (int)sizeof(T) / VEC;  // copies a w row
  constexpr int kXCopies = kXRowBytes / VEC;              // copies an x row
  char* st = smem + stage * R::kStageBytes;
  const int d0 = c * R::kDepth;
  for (int i = threadIdx.x; i < R::kDepth * kWCopies; i += kThreads) {
    const int r = i / kWCopies, cc = i % kWCopies;
    const int dd = d0 + r, col = col0 + cc * kEl;
    const bool valid = dd < d_end && col < n;  // N and D are whole copies: a copy is all in or all out
    copy_async<VEC>(st + r * R::kWPitch + cc * VEC, valid ? w + (size_t)dd * n + col : w, valid);
  }
  char* xs = st + R::kDepth * R::kWPitch;
  for (int i = threadIdx.x; i < kRows * kXCopies; i += kThreads) {
    const int r = i / kXCopies, cc = i % kXCopies;
    const int dd = d0 + cc * kEl;
    const bool valid = dd < d_end;
    copy_async<VEC>(xs + r * R::kXPitch + cc * VEC, valid ? x + (size_t)(row0 + r) * d + dd : x, valid);
  }
}

// The tensor-core product of one stage: warp w's columns 32 w .. 32 w + 31
// as two m16 tiles, acc[4 j .. 4 j + 3] the m16n8 fragment of tile j of
// logits^T (rows: columns of the tile; columns: the 8 rows of x).
template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

template <typename T>
__device__ __forceinline__ void stage_mma(float (&acc)[kRows], const char* st) {
  using R = Ring<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const char* xs = st + R::kDepth * R::kWPitch;
  // ldmatrix: lane l addresses row l % 8 of matrix l / 8; matrices (k 0-7, m 0-7), (k 0-7, m 8-15),
  // (k 8-15, m 0-7), (k 8-15, m 8-15) of the stored [k][m] tile, transposed into A's a0..a3
  const int k_lane = (lane & 7) + ((lane >> 4) << 3), m_lane = ((lane >> 3) & 1) << 3;
  const unsigned w_base = smem_u32(st) + k_lane * R::kWPitch + (warp * 32 + m_lane) * 2;
#pragma unroll
  for (int kk = 0; kk < R::kDepth / 16; ++kk) {
    // B = x^T (k x 8), column-major: x's rows as stored; b0 k 2q, 2q+1, b1 k 2q+8, 2q+9, row g
    const unsigned b0 = *reinterpret_cast<const unsigned*>(xs + g * R::kXPitch + (kk * 16 + 2 * q) * 2);
    const unsigned b1 = *reinterpret_cast<const unsigned*>(xs + g * R::kXPitch + (kk * 16 + 8 + 2 * q) * 2);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      unsigned a[4];
      ldmatrix_x4_trans(a, w_base + kk * 16 * R::kWPitch + j * 32);
      Mma<T>::run(acc + 4 * j, a, b0, b1);
    }
  }
}

// The CUDA-core product of one f32 stage: lane l of warp w owns columns
// 4 l .. 4 l + 3 and all 8 rows over the warp's quarter of the stage's
// contraction rows, acc[c][r]: per 4 rows, 4 loads of w and 8 of x (the
// same address across the warp) feed 128 FMAs, so the FMAs and not shared
// memory bound it (a column a thread needed 12 loads for 32).
constexpr int kF32Cols = 4;  // columns a thread in f32
static_assert(kCols == 32 * kF32Cols && kXRowBytes / 4 % (4 * kWarps) == 0, "f32: a warp's lanes span the tile");

__device__ __forceinline__ void stage_fma(float (&acc)[kF32Cols][kRows], const char* st) {
  using R = Ring<float>;
  constexpr int kPer = R::kDepth / kWarps;  // contraction rows a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const char* ws = st + lane * kF32Cols * 4;
  const char* xs = st + R::kDepth * R::kWPitch;
#pragma unroll
  for (int dd = warp * kPer; dd < warp * kPer + kPer; dd += 4) {
    float4 wv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) wv[u] = *reinterpret_cast<const float4*>(ws + (dd + u) * R::kWPitch);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + r * R::kXPitch + dd * 4);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[0][r] = fmaf(xr[u], wv[u].x, acc[0][r]);
        acc[1][r] = fmaf(xr[u], wv[u].y, acc[1][r]);
        acc[2][r] = fmaf(xr[u], wv[u].z, acc[2][r]);
        acc[3][r] = fmaf(xr[u], wv[u].w, acc[3][r]);
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    matmul_softmax_logits(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ out,
                          float* __restrict__ part, float* __restrict__ part_m, float* __restrict__ part_l,
                          int* __restrict__ tickets, int d, int n, int split_chunks) {
  using R = Ring<T>;
  extern __shared__ __align__(16) char smem[];
  float* tile_s = reinterpret_cast<float*>(smem + R::kTileOff);
  float* red = reinterpret_cast<float*>(smem + R::kRedOff);
  int* flag = reinterpret_cast<int*>(smem + R::kFlagOff);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rb = blockIdx.x, split = blockIdx.y, tile = blockIdx.z;
  const int splits = gridDim.y, n_tiles = gridDim.z;
  const int row0 = rb * kRows, col0 = tile * kCols, col = col0 + tid;
  const bool live = col < n;
  const int c0 = split * split_chunks;
  const int chunks = min(split_chunks, (d + R::kDepth - 1) / R::kDepth - c0);
  const int d_end = min(d, (c0 + split_chunks) * R::kDepth);

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < chunks) load_chunk<T, VEC>(smem, p, c0 + p, x, w, row0, col0, d, d_end, n);
    cp_async_commit();
  }
  // f32: columns 4 lane .. 4 lane + 3, rows 0..7, over the warp's rows of each stage;
  // 16 bits: two m16n8 fragments (acc[0])
  float acc[kF32Cols][kRows];
#pragma unroll
  for (int c = 0; c < kF32Cols; ++c) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;
  }
  for (int i = 0; i < chunks; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk i has landed for every thread; stage (i - 1) % kStages is free
    if (i + kStages - 1 < chunks)
      load_chunk<T, VEC>(smem, (i + kStages - 1) % kStages, c0 + i + kStages - 1, x, w, row0, col0, d, d_end, n);
    cp_async_commit();
    const char* st = smem + (i % kStages) * R::kStageBytes;
    if constexpr (sizeof(T) == 4) {
      stage_fma(acc, st);
    } else {
      stage_mma<T>(acc[0], st);
    }
  }
  cp_async_wait<0>();

  // the block's logits into the tile, then a column a thread
  if constexpr (sizeof(T) == 4) {  // each warp's sums through the idle ring, added in warp order
    float* part_s = reinterpret_cast<float*>(smem);  // [kWarps][kRows][kCols]
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      *reinterpret_cast<float4*>(part_s + (warp * kRows + r) * kCols + lane * kF32Cols) =
          make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float sum = part_s[r * kCols + tid];
#pragma unroll
      for (int wi = 1; wi < kWarps; ++wi) sum += part_s[(wi * kRows + r) * kCols + tid];
      tile_s[r * kTilePitch + tid] = sum;
    }
  } else {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = warp * 32 + j * 16 + g;
      tile_s[(2 * q) * kTilePitch + m] = acc[0][4 * j + 0];
      tile_s[(2 * q + 1) * kTilePitch + m] = acc[0][4 * j + 1];
      tile_s[(2 * q) * kTilePitch + m + 8] = acc[0][4 * j + 2];
      tile_s[(2 * q + 1) * kTilePitch + m + 8] = acc[0][4 * j + 3];
    }
  }
  __syncthreads();
  float v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = tile_s[r * kTilePitch + tid];

  if (splits > 1) {  // publish this split, take a ticket; the last block sums the splits in split order
    const size_t plane = (size_t)gridDim.x * kRows * n;
    if (live) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[split * plane + (size_t)(row0 + r) * n + col] = v[r];
    }
    __threadfence();
    __syncthreads();
    const int pair = rb * n_tiles + tile;
    if (tid == 0) *flag = atomicAdd(tickets + pair, 1) == splits - 1;
    __syncthreads();
    if (!*flag) return;
    __threadfence();
    if (live) {
      float sum[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sum[r] = 0.f;
      for (int s = 0; s < splits; ++s) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) sum[r] += s == split ? v[r] : __ldcg(part + s * plane + (size_t)(row0 + r) * n + col);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = sum[r];
    }
    if (tid == 0) tickets[pair] = 0;  // every split of this tile has taken its ticket
  }

  if (live) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[(size_t)(row0 + r) * n + col] = v[r];
  }
  // the tile's maximum a row, then its sum of exp(logit - maximum)
  float m_row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float mv = warp_max(live ? v[r] : -INFINITY);
    if (lane == 0) red[r * kWarps + warp] = mv;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float mv = red[r * kWarps];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) mv = fmaxf(mv, red[r * kWarps + wi]);
    m_row[r] = mv;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float lv = warp_sum(live ? expf(v[r] - m_row[r]) : 0.f);
    if (lane == 0) red[r * kWarps + warp] = lv;
  }
  __syncthreads();
  if (tid < kRows) {
    float l = red[tid * kWarps];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) l += red[tid * kWarps + wi];
    part_m[(size_t)(row0 + tid) * n_tiles + tile] = m_row[tid];
    part_l[(size_t)(row0 + tid) * n_tiles + tile] = l;
  }
}

__global__ void __launch_bounds__(kNormThreads)
    matmul_softmax_normalise(float* __restrict__ out, const float* __restrict__ part_m,
                             const float* __restrict__ part_l, int n, int n_tiles) {
  __shared__ float red[kNormThreads / 32];
  __shared__ float bcast;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = blockIdx.y;
  const float* pm = part_m + (size_t)row * n_tiles;
  const float* pl = part_l + (size_t)row * n_tiles;

  float m = -INFINITY;
  for (int i = tid; i < n_tiles; i += kNormThreads) m = fmaxf(m, pm[i]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float v = red[0];
    for (int wi = 1; wi < kNormThreads / 32; ++wi) v = fmaxf(v, red[wi]);
    bcast = v;
  }
  __syncthreads();
  m = bcast;
  __syncthreads();

  float l = 0.f;
  for (int i = tid; i < n_tiles; i += kNormThreads) l += pl[i] * expf(pm[i] - m);
  l = warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  if (tid == 0) {
    float v = red[0];
    for (int wi = 1; wi < kNormThreads / 32; ++wi) v += red[wi];
    bcast = v;
  }
  __syncthreads();
  l = bcast;

  float* o = out + (size_t)row * n;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = blockIdx.x * kNormCols + e * kNormThreads + tid;
    if (col < n) o[col] = expf(o[col] - m) / l;
  }
}

template <typename T, int VEC>
cudaError_t launch_logits(const void* x, const void* w, float* out, float* part, float* part_m, float* part_l,
                          int* tickets, int d, int n, int row_blocks, int splits, int split_chunks, int n_tiles,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(matmul_softmax_logits<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Ring<T>::kBytes);
  if (err != cudaSuccess) return err;
  matmul_softmax_logits<T, VEC><<<dim3(row_blocks, splits, n_tiles), kThreads, Ring<T>::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), out, part, part_m, part_l, tickets, d, n, split_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  matmul_softmax_normalise<<<dim3((n + kNormCols - 1) / kNormCols, row_blocks * kRows), kNormThreads, 0, stream>>>(
      out, part_m, part_l, n, n_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_softmax(const void* x, const void* w, float* out, float* part, float* part_m, float* part_l,
                           int* tickets, int d, int n, int row_blocks, int splits, int split_chunks, int n_tiles,
                           int vec, cudaStream_t stream) {
  switch (vec) {
    case 16:
      return launch_logits<T, 16>(x, w, out, part, part_m, part_l, tickets, d, n, row_blocks, splits, split_chunks,
                                  n_tiles, stream);
    case 8:
      return launch_logits<T, 8>(x, w, out, part, part_m, part_l, tickets, d, n, row_blocks, splits, split_chunks,
                                 n_tiles, stream);
    case 4:
      return launch_logits<T, 4>(x, w, out, part, part_m, part_l, tickets, d, n, row_blocks, splits, split_chunks,
                                 n_tiles, stream);
    default:
      if constexpr (sizeof(T) == 2) {
        return launch_logits<T, 2>(x, w, out, part, part_m, part_l, tickets, d, n, row_blocks, splits, split_chunks,
                                   n_tiles, stream);
      } else {
        return cudaErrorInvalidValue;
      }
  }
}

// acc += delta over `count` elements: thread t of block b adds 16-byte
// vector 256 b + t; the last block also adds the `count - vecs * V` scalar
// tail, which lies in its stretch.
template <typename T>
__global__ void __launch_bounds__(kAccThreads)
    accumulate_kernel(T* __restrict__ acc, const T* __restrict__ delta, size_t count) {
  constexpr int V = 16 / sizeof(T);
  const size_t vecs = count / V;
  const size_t i = (size_t)blockIdx.x * kAccThreads + threadIdx.x;
  if (i < vecs) {
    uint4 a = reinterpret_cast<const uint4*>(acc)[i];
    const uint4 dl = reinterpret_cast<const uint4*>(delta)[i];
    T* ae = reinterpret_cast<T*>(&a);
    const T* de = reinterpret_cast<const T*>(&dl);
#pragma unroll
    for (int e = 0; e < V; ++e) ae[e] = from_f32<T>(to_f32(ae[e]) + to_f32(de[e]));
    reinterpret_cast<uint4*>(acc)[i] = a;
  }
  const size_t tail = vecs * V + threadIdx.x;
  if (blockIdx.x == gridDim.x - 1 && tail < count) acc[tail] = from_f32<T>(to_f32(acc[tail]) + to_f32(delta[tail]));
}

template <typename T>
cudaError_t launch_accumulate(void* acc, const void* delta, long long count, int blocks, cudaStream_t stream) {
  accumulate_kernel<T><<<blocks, kAccThreads, 0, stream>>>(static_cast<T*>(acc), static_cast<const T*>(delta),
                                                           (size_t)count);
  return cudaGetLastError();
}

int depth(int dtype) { return dtype == 0 ? Ring<float>::kDepth : Ring<__nv_bfloat16>::kDepth; }

}  // namespace

// dtype of x and w: 0 = float32, 1 = bfloat16, 2 = float16; out is f32.
// The grid is the caller's launch declaration (kernels/reference.py):
// (row_blocks, splits, n_tiles) blocks of `threads` threads, split s owning
// contraction chunks s * split_chunks .. of KD rows (64 in 16 bits, 32 in
// f32), every split holding at least one; `vec` the bytes a copy moves. A
// declaration that does not tile [b, n] and d exactly so, or a `vec` that
// N * itemsize, D * itemsize and the two pointers do not allow, is refused.
// Scratch (f32): part [splits][b][n] (unused when splits == 1), part_m and
// part_l [b][n_tiles]; tickets: row_blocks * n_tiles ints (with splits), 0
// on entry and on return. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int block_matmul_softmax(const void* x, const void* w, float* out, float* part, float* part_m,
                                    float* part_l, int* tickets, int dtype, int b, int d, int n, int row_blocks,
                                    int splits, int split_chunks, int n_tiles, int threads, int vec, void* stream) {
  if (dtype < 0 || dtype > 2 || d <= 0 || n <= 0 || threads != kThreads || row_blocks <= 0 ||
      b != row_blocks * kRows || n_tiles <= 0 || n_tiles > 65535 || (long long)(n_tiles - 1) * kCols >= n ||
      (long long)n_tiles * kCols < n || splits <= 0 || splits > 65535 || split_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = (d + depth(dtype) - 1) / depth(dtype);
  if ((long long)(splits - 1) * split_chunks >= chunks || (long long)splits * split_chunks < chunks ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int item = dtype == 0 ? 4 : 2;
  if (vec < item || vec > 16 || (vec & (vec - 1)) || ((long long)n * item) % vec || ((long long)d * item) % vec ||
      reinterpret_cast<uintptr_t>(x) % vec || reinterpret_cast<uintptr_t>(w) % vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_softmax<float>(x, w, out, part, part_m, part_l, tickets, d, n, row_blocks, splits,
                                        split_chunks, n_tiles, vec, s);
    case 1:
      return (int)launch_softmax<__nv_bfloat16>(x, w, out, part, part_m, part_l, tickets, d, n, row_blocks, splits,
                                                split_chunks, n_tiles, vec, s);
    default:
      return (int)launch_softmax<__half>(x, w, out, part, part_m, part_l, tickets, d, n, row_blocks, splits,
                                         split_chunks, n_tiles, vec, s);
  }
}

// The dynamic shared memory a logits block of `dtype` asks for, in bytes
// (the ring, the logits tile, the row reductions, the join's flag).
extern "C" int block_matmul_softmax_smem(int dtype) {
  return dtype == 0 ? Ring<float>::kBytes : Ring<__nv_bfloat16>::kBytes;
}

// cudaFuncGetAttributes of kernel `which` (f32 instances: 0 the logits pass
// of block_matmul_softmax with 16-byte copies, 1 its normalise pass, 2
// block_accumulate): out[0] sharedSizeBytes (static), out[1] numRegs,
// out[2] maxThreadsPerBlock. Returns the cudaError_t.
extern "C" int reference_kernels_func_attributes(int which, int* out) {
  const void* fn = which == 0   ? (const void*)matmul_softmax_logits<float, 16>
                   : which == 1 ? (const void*)matmul_softmax_normalise
                   : which == 2 ? (const void*)accumulate_kernel<float>
                                : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  out[0] = (int)attr.sharedSizeBytes;
  out[1] = attr.numRegs;
  out[2] = attr.maxThreadsPerBlock;
  return 0;
}

// acc and delta: `count` elements of one dtype (codes as above), both
// 16-byte aligned. `blocks` x `threads` is the caller's launch declaration
// (kernels/reference.py): threads must be the kernel's 256 and blocks one
// for every 256 16-byte vectors, the tail's included. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int block_accumulate(void* acc, const void* delta, int dtype, long long count, int blocks, int threads,
                                void* stream) {
  const long long chunk = (long long)kAccThreads * (dtype == 0 ? 4 : 8);  // elements a block
  if (count <= 0 || threads != kAccThreads || blocks != (count + chunk - 1) / chunk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_accumulate<float>(acc, delta, count, blocks, s);
    case 1:
      return (int)launch_accumulate<__nv_bfloat16>(acc, delta, count, blocks, s);
    case 2:
      return (int)launch_accumulate<__half>(acc, delta, count, blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
