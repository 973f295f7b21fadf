// Paged decode attention for Hopper (sm_90a).
//
// Replaces accelerate_tpu/ops/pallas_paged_attention.py::_kernel, the
// Pallas TPU kernel launched by paged_decode_attention there. One decode
// step of attention for every row against its own pages of a shared
// K/V pool:
//
//   q [B, H, D], key/value pools [NB, bs, Hkv, D], block_table [B, MB]
//   int32, cur [B] int32  ->  out [B, H, D] in q's type.
//
// Row b attends to the keys at positions (cur[b] - W, cur[b]] (W = the
// optional sliding window), position p living at
// pool[block_table[b, p / bs], p % bs]. Softmax and both products run
// in f32; the output is acc / max(l, 1), so a row with no live key gives
// 0 and not NaN.
//
// What bounds it: the HBM bytes of the live K/V pages, each read once;
// q and the output are small. At the serving slice's shapes (8 rows, 4
// kv heads, a few hundred live keys a row) one call moves well under a
// megabyte, so latency, not bandwidth, sets its time: how many pages one
// block walks in a row, and the two launches.
//
// What the design does about it. The TPU grid walks (row, table entry)
// in order and carries the online softmax in VMEM scratch; here blocks
// run in parallel and carry nothing between them, so the call has two
// passes:
//  1. split pass, grid (B * Hkv, splits): each block takes one kv head of
//     one row and one split of its live pages (split_pages pages, counted
//     from the first in-band page up to cur / bs; the TPU grid visits every
//     table entry and skips the dead ones). It reads its own table entries
//     (no scalar prefetch on this card), loads whole pages of K and V for
//     its head in tiles of about 64 keys with 16-byte loads, so a tile's
//     loads are in flight together (part of a page where a wide head and a
//     big page would not fit the block's shared memory), and keeps the G =
//     H / Hkv query rows of its group in shared memory as f32: GQA never
//     repeats K/V. Scores,
//     masking, the running max/sum (one warp a query row) and the [G, D]
//     accumulator follow the Pallas kernel step for step, and the split's
//     (m, l, acc) go to f32 scratch.
//  2. combine pass, one block a query row: rescale each live split by
//     exp(m_s - max m) and divide by max(sum l, 1).
// Head dims: every multiple of 16 from 16 to 256 (the Pallas kernel takes
// the whole head dim as its block), in one build that reads D at run time
// (its rows of 16 bytes are whole for any multiple of 8). It allocates nothing
// (the caller passes the scratch) and launches on the caller's stream.
// Taking launch latency off the decode step (CUDA graphs, one persistent
// launch for all layers) is work for a later change.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 64;  // a tile holds max(1, kTileKeys / bs) whole pages, if they fit

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

// one 16-byte load of 16 / sizeof(T) elements, widened to f32
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) dst[i] = to_f32(e[i]);
}

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

// Live pages of a row: [first, last]; none when first > last.
__device__ __forceinline__ void live_pages(int cur, int bs, int max_blocks, int window, int* first, int* last) {
  *first = window > 0 ? max(0, cur - window + 1) / bs : 0;  // first in-band page
  *last = min(cur / bs, max_blocks - 1);                    // frontier page, clamped to the table
}

inline int tile_pages(int bs) { return bs >= kTileKeys ? 1 : kTileKeys / bs; }

// Shared memory of the split pass, in floats: q [G][D+1], k [TK][D+1],
// v [TK][D], s [G][TK], acc [G][D], m/l/alpha [G] each (TK = keys a
// tile). The +1 pads the rows the score loop reads across, so
// neighbouring threads fall in different banks.
inline size_t smem_floats(int g, int d, int tk) {
  return (size_t)g * (d + 1) + (size_t)tk * (d + 1) + (size_t)tk * d + (size_t)g * tk + (size_t)g * d + 3 * (size_t)g;
}

// Keys a tile of the split pass holds: split_pages pages or kTileKeys keys
// of whole pages, whichever is fewer, halved until the block's shared
// memory fits the card (a wide head and a big page: then a tile is part of
// a page). Past what even one key needs, the launch is refused and its error
// returned.
int tile_keys(int g, int d, int bs, int split_pages) {
  static const int limit = [] {
    int dev = 0, bytes = 48 * 1024;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return bytes;
  }();
  int tk = min(tile_pages(bs), split_pages) * bs;
  while (tk > 1 && smem_floats(g, d, tk) * sizeof(float) > (size_t)limit) tk = (tk + 1) / 2;
  return tk;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_split(
    const T* __restrict__ q, const T* __restrict__ kpool, const T* __restrict__ vpool,
    const int32_t* __restrict__ table, const int32_t* __restrict__ cur_arr, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int heads, int kv_heads, int D, int num_blocks, int bs,
    int max_blocks, int split_pages, int num_splits, int tk, float scale, int window) {
  const int b = blockIdx.x / kv_heads;
  const int h = blockIdx.x % kv_heads;
  const int split = blockIdx.y;
  const int g_count = heads / kv_heads;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const int cur = cur_arr[b];
  int first, last;
  live_pages(cur, bs, max_blocks, window, &first, &last);
  const int j_begin = first + split * split_pages;
  if (j_begin > last) return;  // the whole block leaves: this split holds no live page
  const int j_end = min(j_begin + split_pages - 1, last);

  extern __shared__ float smem[];
  float* q_s = smem;                     // [G][D+1]
  float* k_s = q_s + g_count * (D + 1);  // [TK][D+1]
  float* v_s = k_s + tk * (D + 1);       // [TK][D]
  float* s_s = v_s + tk * D;             // [G][TK]
  float* acc_s = s_s + g_count * tk;     // [G][D]
  float* m_s = acc_s + g_count * D;      // [G]
  float* l_s = m_s + g_count;            // [G]
  float* alpha_s = l_s + g_count;        // [G]

  // query heads h*G .. h*G+G-1 share kv head h (the JAX reshape [Hkv, G, D])
  const T* q_row = q + ((size_t)b * heads + (size_t)h * g_count) * D;
  for (int i = tid; i < g_count * D; i += kThreads) {
    q_s[(i / D) * (D + 1) + (i % D)] = to_f32(q_row[i]);
    acc_s[i] = 0.f;
  }
  for (int i = tid; i < g_count; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  __syncthreads();

  constexpr int kVec = 16 / sizeof(T);
  const int kVecsPerRow = D / kVec;
  const size_t row_stride = (size_t)kv_heads * D;  // between two positions of one page
  // The split's keys j_begin * bs .. (j_end + 1) * bs - 1 in tiles of tk.
  // The tile's key count comes from a running remainder: written as
  // min(tk, end - lo), the optimised build computed it as -tk for the
  // first tile of a one-page split (right under -G).
  int remaining = (j_end - j_begin + 1) * bs;
  for (int lo = j_begin * bs; remaining > 0; lo += tk) {
    const int nk = remaining < tk ? remaining : tk;  // keys in this tile
    remaining -= nk;
    for (int i = tid; i < nk * kVecsPerRow; i += kThreads) {
      const int kk = i / kVecsPerRow, c = (i % kVecsPerRow) * kVec, pos = lo + kk;
      int blk = table[(size_t)b * max_blocks + pos / bs];
      blk = min(max(blk, 0), num_blocks - 1);
      const size_t off = ((size_t)blk * bs + pos % bs) * row_stride + (size_t)h * D + c;
      load16(kpool + off, k_s + kk * (D + 1) + c);
      load16(vpool + off, v_s + kk * D + c);
    }
    __syncthreads();

    // scores [G, nk], masked to (cur - W, cur]
    for (int i = tid; i < g_count * nk; i += kThreads) {
      const int g = i / nk, kk = i % nk;
      const float* qv = q_s + g * (D + 1);
      const float* kv = k_s + kk * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dot += qv[c] * kv[c];
      const int pos = lo + kk;
      bool live = pos <= cur;
      if (window > 0) live = live && pos > cur - window;
      s_s[g * tk + kk] = live ? dot * scale : -INFINITY;
    }
    __syncthreads();

    // online softmax: one warp a query row
    for (int g = warp; g < g_count; g += kWarps) {
      float* srow = s_s + g * tk;
      float mx = -INFINITY;
      for (int kk = lane; kk < nk; kk += 32) mx = fmaxf(mx, srow[kk]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(mx));
      // -inf only while every key so far is masked, which a tile of part of
      // a page can be: exp against 0 then, so p and alpha are 0, not NaN
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int kk = lane; kk < nk; kk += 32) {
        const float p = expf(srow[kk] - m_safe);
        srow[kk] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_safe);  // 0 while m was -inf
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc [G, D] = acc * alpha + p @ v
    for (int i = tid; i < g_count * D; i += kThreads) {
      const int g = i / D, c = i % D;
      const float* prow = s_s + g * tk;
      float pv = 0.f;
      for (int kk = 0; kk < nk; ++kk) pv += prow[kk] * v_s[kk * D + c];
      acc_s[i] = acc_s[i] * alpha_s[g] + pv;
    }
    __syncthreads();
  }

  const size_t row0 = (size_t)b * heads + (size_t)h * g_count;  // first query head of the group
  for (int i = tid; i < g_count * D; i += kThreads) {
    part_acc[((row0 + i / D) * num_splits + split) * D + i % D] = acc_s[i];
  }
  for (int g = tid; g < g_count; g += kThreads) {
    part_m[(row0 + g) * num_splits + split] = m_s[g];
    part_l[(row0 + g) * num_splits + split] = l_s[g];
  }
}

// One block a query row (b, head), one thread a channel.
template <typename T>
__global__ void paged_decode_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
                                     const float* __restrict__ part_acc, const int32_t* __restrict__ cur_arr,
                                     T* __restrict__ out, int heads, int dim, int bs, int max_blocks,
                                     int split_pages, int num_splits, int window) {
  const size_t row = blockIdx.x;
  const int c = threadIdx.x;
  int first, last;
  live_pages(cur_arr[row / heads], bs, max_blocks, window, &first, &last);
  const int n_live = last >= first ? (last - first) / split_pages + 1 : 0;
  const float* m = part_m + row * num_splits;
  float m_max = -INFINITY;
  for (int s = 0; s < n_live; ++s) m_max = fmaxf(m_max, m[s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float w = expf(m[s] - m_max);
    l += w * part_l[row * num_splits + s];
    acc += w * part_acc[(row * num_splits + s) * dim + c];
  }
  out[row * dim + c] = from_f32<T>(acc / fmaxf(l, 1.f));  // no live split: 0 / 1
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int32_t* table, const int32_t* cur,
                   void* out, float* part_m, float* part_l, float* part_acc, int batch, int heads, int kv_heads,
                   int dim, int num_blocks, int bs, int max_blocks, int split_pages, int num_splits, float scale,
                   int window, cudaStream_t stream) {
  const int tk = tile_keys(heads / kv_heads, dim, bs, split_pages);
  const size_t smem = smem_floats(heads / kv_heads, dim, tk) * sizeof(float);
  auto split_kernel = paged_decode_split<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  split_kernel<<<dim3(batch * kv_heads, num_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table, cur, part_m, part_l,
      part_acc, heads, kv_heads, dim, num_blocks, bs, max_blocks, split_pages, num_splits, tk, scale, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine<T><<<batch * heads, dim, 0, stream>>>(part_m, part_l, part_acc, cur, static_cast<T*>(out),
                                                             heads, dim, bs, max_blocks, split_pages, num_splits,
                                                             window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. window <= 0: no band.
// Scratch (f32): part_m and part_l [B * H * num_splits], part_acc
// [B * H * num_splits * head_dim], with num_splits >= ceil(max_blocks /
// split_pages). Every pointer 16-byte aligned. Returns the cudaError_t of
// the launches (0 on success).
extern "C" int paged_decode_attention(const void* q, const void* key_pool, const void* value_pool,
                                      const int32_t* block_table, const int32_t* cur, void* out, float* part_m,
                                      float* part_l, float* part_acc, int dtype, int batch, int heads, int kv_heads,
                                      int head_dim, int num_blocks, int block_size, int max_blocks, int split_pages,
                                      int num_splits, float scale, int window, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || block_size <= 0 || max_blocks <= 0 ||
      num_blocks <= 0 || split_pages <= 0 || (long long)num_splits * split_pages < max_blocks || dtype < 0 ||
      dtype > 2 || head_dim % 16 != 0 || head_dim < 16 || head_dim > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = dtype == 0 ? launch<float> : dtype == 1 ? launch<__nv_bfloat16> : launch<__half>;
  return (int)run(q, key_pool, value_pool, block_table, cur, out, part_m, part_l, part_acc, batch, heads, kv_heads,
                  head_dim, num_blocks, block_size, max_blocks, split_pages, num_splits, scale, window, s);
}
