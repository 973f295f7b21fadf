// The two contract-bearing reference kernels for Hopper (sm_90a).
//
// Replace accelerate_tpu/kernels/reference.py::block_matmul_softmax_kernel
// and ::block_accumulate_kernel, the Pallas TPU kernels launched by
// block_matmul_softmax and block_accumulate there.
//
// block_matmul_softmax: x [B, D], w [D, N] (both f32, bf16 or fp16)
//   ->  out [B, N] f32 = softmax(x @ w, axis=-1), products and sums in f32
//   (f32 inputs multiply in full f32 on the CUDA cores: no TF32).
// The TPU kernel gives every grid step 8 rows of x and all of w, and
// holds the 8 x N logits in VMEM. A block here has 227 KB of shared memory
// at most, and 8 rows of 32,000 f32 logits are 1 MB, so N is tiled and the
// call has two passes:
//  1. logits pass, grid (ceil(N / 128), B / 8): a block owns 128 columns
//     (one a thread) and 8 rows. x streams through shared memory 512
//     contraction rows at a time; a thread walks its column of w (loads
//     coalesced across the block, 8 in flight a thread) and keeps 8
//     accumulators. The logits go to out, and the tile's row maximum and
//     sum of exp(logit - maximum) to f32 scratch.
//  2. normalise pass, grid (ceil(N / 1024), B): joins the row's tile maxima
//     and sums (M = max m_t, L = sum l_t exp(m_t - M), in tile order), then
//     out = exp(logit - M) / L in place.
// What bounds it: the bytes of w, read once for every 8 rows; at the
// decode-logits shape (8 x 2048 @ 2048 x 32000) 262 MB in f32.
//
// block_accumulate: acc [B, N] += delta [B, N] in place (one type: f32,
// bf16 or fp16; the sum is formed in f32 and rounded once). Bound by
// bytes: two reads and one write an element. 16-byte loads, a grid-stride
// loop, a scalar tail.
//
// Neither allocates (the caller passes the scratch); both launch on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;            // rows of x a logits block owns
constexpr int kLogitThreads = 128;  // = columns a logits block owns
constexpr int kLogitWarps = kLogitThreads / 32;
constexpr int kDChunk = 512;  // contraction rows of x staged at a time
constexpr int kNormThreads = 256;
constexpr int kNormCols = 4 * kNormThreads;  // columns a normalise block owns

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

template <typename T>
__global__ void __launch_bounds__(kLogitThreads)
    matmul_softmax_logits(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ out,
                          float* __restrict__ part_m, float* __restrict__ part_l, int d, int n, int n_tiles) {
  __shared__ __align__(16) float xs[kDChunk][kRows];
  __shared__ float red[kRows][kLogitWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x, row0 = blockIdx.y * kRows;
  const int col = tile * kLogitThreads + tid;
  const bool live = col < n;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kDChunk) {
    const int dc = min(kDChunk, d - d0);
    __syncthreads();  // the last chunk's readers are done
    for (int i = tid; i < dc * kRows; i += kLogitThreads) {
      const int r = i / dc, dd = i % dc;
      xs[dd][r] = to_f32(x[(size_t)(row0 + r) * d + d0 + dd]);
    }
    __syncthreads();
    if (live) {
      const T* wp = w + (size_t)d0 * n + col;
      int dd = 0;
      for (; dd + 8 <= dc; dd += 8) {
        float wv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) wv[u] = to_f32(wp[(size_t)(dd + u) * n]);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 xa = *reinterpret_cast<const float4*>(&xs[dd + u][0]);
          const float4 xb = *reinterpret_cast<const float4*>(&xs[dd + u][4]);
          acc[0] += xa.x * wv[u], acc[1] += xa.y * wv[u], acc[2] += xa.z * wv[u], acc[3] += xa.w * wv[u];
          acc[4] += xb.x * wv[u], acc[5] += xb.y * wv[u], acc[6] += xb.z * wv[u], acc[7] += xb.w * wv[u];
        }
      }
      for (; dd < dc; ++dd) {
        const float wv = to_f32(wp[(size_t)dd * n]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += xs[dd][r] * wv;
      }
    }
  }

  if (live) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[(size_t)(row0 + r) * n + col] = acc[r];
  }
  // the tile's maximum a row, then its sum of exp(logit - maximum)
  float m_row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float v = warp_max(live ? acc[r] : -INFINITY);
    if (lane == 0) red[r][warp] = v;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v = red[r][0];
#pragma unroll
    for (int wi = 1; wi < kLogitWarps; ++wi) v = fmaxf(v, red[r][wi]);
    m_row[r] = v;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float v = warp_sum(live ? expf(acc[r] - m_row[r]) : 0.f);
    if (lane == 0) red[r][warp] = v;
  }
  __syncthreads();
  if (tid < kRows) {
    float l = red[tid][0];
#pragma unroll
    for (int wi = 1; wi < kLogitWarps; ++wi) l += red[tid][wi];
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

template <typename T>
cudaError_t launch_softmax(const void* x, const void* w, float* out, float* part_m, float* part_l, int d, int n,
                           int n_tiles, int row_blocks, cudaStream_t stream) {
  matmul_softmax_logits<T><<<dim3(n_tiles, row_blocks), kLogitThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), out, part_m, part_l, d, n, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  matmul_softmax_normalise<<<dim3((n + kNormCols - 1) / kNormCols, row_blocks * kRows), kNormThreads, 0, stream>>>(
      out, part_m, part_l, n, n_tiles);
  return cudaGetLastError();
}

// acc += delta: `vecs` 16-byte vectors, then the `count - vecs * V` last elements
template <typename T>
__global__ void __launch_bounds__(256)
    accumulate_kernel(T* __restrict__ acc, const T* __restrict__ delta, size_t count) {
  constexpr int V = 16 / sizeof(T);
  const size_t vecs = count / V;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (size_t i = first; i < vecs; i += stride) {
    uint4 a = reinterpret_cast<const uint4*>(acc)[i];
    const uint4 dl = reinterpret_cast<const uint4*>(delta)[i];
    T* ae = reinterpret_cast<T*>(&a);
    const T* de = reinterpret_cast<const T*>(&dl);
#pragma unroll
    for (int e = 0; e < V; ++e) ae[e] = from_f32<T>(to_f32(ae[e]) + to_f32(de[e]));
    reinterpret_cast<uint4*>(acc)[i] = a;
  }
  const size_t tail = vecs * V + first;
  if (tail < count) acc[tail] = from_f32<T>(to_f32(acc[tail]) + to_f32(delta[tail]));
}

template <typename T>
cudaError_t launch_accumulate(void* acc, const void* delta, long long count, int blocks, int threads,
                              cudaStream_t stream) {
  accumulate_kernel<T><<<blocks, threads, 0, stream>>>(static_cast<T*>(acc), static_cast<const T*>(delta),
                                                       (size_t)count);
  return cudaGetLastError();
}

}  // namespace

// dtype of x and w: 0 = float32, 1 = bfloat16, 2 = float16; out is f32.
// The logits pass's grid and threads are the caller's launch declaration
// (kernels/reference.py): grid (n_tiles, row_blocks) of 128 threads, one
// 128-column tile and 8 rows a block. A declaration that does not tile
// [b, n] exactly so is refused. Scratch (f32): part_m and part_l
// [b, n_tiles]. Returns the cudaError_t of the launches (0 on success).
extern "C" int block_matmul_softmax(const void* x, const void* w, float* out, float* part_m, float* part_l,
                                    int dtype, int b, int d, int n, int n_tiles, int row_blocks, int threads,
                                    void* stream) {
  if (d <= 0 || n <= 0 || threads != kLogitThreads || row_blocks <= 0 || row_blocks > 65535 / kRows ||
      b != row_blocks * kRows || n_tiles <= 0 || (long long)(n_tiles - 1) * kLogitThreads >= n ||
      (long long)n_tiles * kLogitThreads < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_softmax<float>(x, w, out, part_m, part_l, d, n, n_tiles, row_blocks, s);
    case 1:
      return (int)launch_softmax<__nv_bfloat16>(x, w, out, part_m, part_l, d, n, n_tiles, row_blocks, s);
    case 2:
      return (int)launch_softmax<__half>(x, w, out, part_m, part_l, d, n, n_tiles, row_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// cudaFuncGetAttributes of kernel `which` (f32 instances: 0 the logits pass
// of block_matmul_softmax, 1 its normalise pass, 2 block_accumulate):
// out[0] sharedSizeBytes (static), out[1] numRegs, out[2]
// maxThreadsPerBlock. Returns the cudaError_t.
extern "C" int reference_kernels_func_attributes(int which, int* out) {
  const void* fn = which == 0   ? (const void*)matmul_softmax_logits<float>
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
// (kernels/reference.py); the grid-stride loop covers any such grid, and
// threads must be a whole number of warps up to the kernel's 256. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int block_accumulate(void* acc, const void* delta, int dtype, long long count, int blocks, int threads,
                                void* stream) {
  if (count <= 0 || blocks <= 0 || threads <= 0 || threads > 256 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_accumulate<float>(acc, delta, count, blocks, threads, s);
    case 1:
      return (int)launch_accumulate<__nv_bfloat16>(acc, delta, count, blocks, threads, s);
    case 2:
      return (int)launch_accumulate<__half>(acc, delta, count, blocks, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
