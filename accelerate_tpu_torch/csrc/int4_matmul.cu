// Fused int4 dequantize + matmul for Hopper (sm_90a).
//
// Replaces accelerate_tpu/ops/pallas_qmatmul.py::_int4_matmul_kernel, the
// Pallas TPU kernel launched by int4_matmul there:
//
//   x [M, K] (f32, bf16 or fp16), packed [K/g, g/2, N] uint8, scale
//   [K/g, 1, N] f32  ->  out [M, N] in x's type,
//   out = sum_grp scale_grp * (x_grp @ code_grp - 8 * sum(x_grp)).
//
// Byte row r of a group holds code 2r in its low nibble and code 2r + 1
// in its high one, so packed is a [K/2, N] byte matrix whose rows are
// contiguous in N. Rounding points are the Pallas kernel's: x rounded to
// bf16, the raw codes 0..15 as exact bf16 operands, f32 accumulation, the
// zero-point term 8 * sum(x_grp) from the rounded x in f32, the f32 scale
// applied to each group's f32 partial sum, groups summed in f32, one cast at
// the end. (The Pallas kernel adds its even and odd halves of x in bf16
// before that sum; the rounding only adds error, XLA elides it on the CPU
// under its excess-precision default, and it is left out here.)
//
// What bounds it: at decode (M <= 8) the HBM bytes of the codes, read once
// (half a byte a weight, a quarter of bf16's); at prefill widths (M 64-256)
// still the bytes, the tensor-core work being small beside them.
//
// What the design does about it. The Pallas kernel splits x into even and
// odd columns on the host and multiplies the two nibble planes separately,
// because the TPU cannot interleave rows cheaply. Here one byte is exactly
// one 32-bit B-operand register of mma.sync m16n8k16 (rows 2r and 2r + 1
// of one column), so nothing is split or shuffled:
//  * a block of 4 warps owns 128 output columns, 16 * MT rows of x and a
//    slice of whole groups of the contraction; grid (N / 128, splits,
//    row tiles). The contraction is split only until the grid fills the
//    card, and a second pass sums the splits' f32 partial results in split
//    order, so the sum never depends on an atomics order;
//  * the codes stream through shared memory in chunks of KC = 128 (or 64)
//    contraction rows with 16-byte cp.async loads, coalesced along N, two
//    stages, so the next chunk's bytes are in flight while this one is
//    multiplied; x's chunk rides along (cp.async when it is bf16 already,
//    converted on the way otherwise; rows past M are zero);
//  * a warp owns 32 columns as four 8-column mma tiles interleaved by 4
//    (tile j holds columns 4 c + j), so one 32-bit shared-memory word gives
//    a thread its byte for all four tiles, its 8 accumulator columns are
//    contiguous, and the 160-byte row pitch keeps the word reads free of
//    bank conflicts;
//  * at a group's end the f32 accumulator, less 8 times the group's x sum,
//    times the group's scales joins the running total, all in registers.
// It allocates nothing (the caller passes the splits' scratch) and launches
// on the caller's stream. wgmma, TMA and a fused q/k/v or gate/up launch
// are work for a later change.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNTile = 128;        // output columns a block owns (32 a warp)
constexpr int kPackedPitch = 160;  // bytes between staged byte rows: 128 of data, padded
constexpr int kXPad = 8;           // bf16 elements of padding a staged x row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// 16 bytes global -> shared; zero-fills when !valid (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One packed byte -> the bf16 pair (code 2r in the low half, code 2r + 1 in
// the high half): rows 2r and 2r + 1 of a column, as the B operand wants them.
__device__ __forceinline__ unsigned codes_to_bf16x2(unsigned byte) {
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)(byte & 0xFu), (float)(byte >> 4));
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8]) {
  __nv_bfloat162 p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void store8(__half* dst, const float (&v)[8]) {
  __half2 p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(p);
}

constexpr size_t smem_bytes(int mt, int kc) {
  return (size_t)2 * (kc / 2) * kPackedPitch + (size_t)2 * 16 * mt * (kc + kXPad) * 2 + (size_t)2 * 16 * mt * 4;
}

// grid (N / 128, splits, ceil(M / (16 MT))). With splits == 1 the block
// writes out; otherwise its f32 partial result goes to partial[split].
template <typename T, int MT, int KC>
__global__ void __launch_bounds__(kThreads)
    int4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed, const float* __restrict__ scale,
                       T* __restrict__ out, float* __restrict__ partial, int m, int k, int n, int g,
                       int groups_per_split, int splits) {
  constexpr int kRows = 16 * MT;
  constexpr int kXPitch = KC + kXPad;
  constexpr int kStagePacked = (KC / 2) * kPackedPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ps = smem;                                                      // [2][KC / 2][kPackedPitch]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * kStagePacked);  // [2][kRows][kXPitch]
  float* xsum = reinterpret_cast<float*>(xs + 2 * kRows * kXPitch);               // [2][kRows]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kNTile;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kRows;
  const int n_groups = k / g;
  const int chunks_per_group = g / KC;
  const int g_begin = split * groups_per_split;
  const int g_end = min(n_groups, g_begin + groups_per_split);
  const int c_begin = g_begin * chunks_per_group, c_end = g_end * chunks_per_group;

  auto stage_in = [&](int c, int s) {
    const int k0 = c * KC;
    unsigned char* pdst = ps + s * kStagePacked;
    const uint8_t* psrc = packed + (size_t)(k0 / 2) * n + n0;
    for (int i = tid; i < (KC / 2) * 8; i += kThreads) {
      const int r = i >> 3, seg = i & 7;
      cp_async16(pdst + r * kPackedPitch + seg * 16, psrc + (size_t)r * n + seg * 16, true);
    }
    __nv_bfloat16* xdst = xs + s * kRows * kXPitch;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      constexpr int kSegs = KC / 8;
      for (int i = tid; i < kRows * kSegs; i += kThreads) {
        const int r = i / kSegs, seg = i % kSegs;
        const bool valid = m0 + r < m;
        const T* src = x + (size_t)(valid ? m0 + r : 0) * k + k0 + seg * 8;
        cp_async16(xdst + r * kXPitch + seg * 8, src, valid);
      }
    } else {
      for (int i = tid; i < kRows * KC; i += kThreads) {
        const int r = i / KC, col = i % KC;
        const float v = (m0 + r < m) ? to_f32(x[(size_t)(m0 + r) * k + k0 + col]) : 0.f;
        xdst[r * kXPitch + col] = __float2bfloat16(v);
      }
    }
  };

  float acc[MT][4][4], total[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = total[mt][j][e] = 0.f;
  float sv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  if (c_begin < c_end) stage_in(c_begin, 0);
  cp_async_commit();
  for (int c = c_begin; c < c_end; ++c) {
    const int s = (c - c_begin) & 1;
    if (c + 1 < c_end) stage_in(c + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the newest group: chunk c has landed
    __syncthreads();

    const int grp = c / chunks_per_group;
    const bool first = (c % chunks_per_group) == 0, last = ((c + 1) % chunks_per_group) == 0;
    float* xsum_g = xsum + (grp & 1) * kRows;
    const __nv_bfloat16* xc = xs + s * kRows * kXPitch;
    if (first) {  // this thread's 8 scales of the group, in flight while the chunk multiplies
      const float* sc = scale + (size_t)grp * n + n0 + warp * 32 + 8 * t;
      const float4 s0 = *reinterpret_cast<const float4*>(sc), s1 = *reinterpret_cast<const float4*>(sc + 4);
      sv[0] = s0.x, sv[1] = s0.y, sv[2] = s0.z, sv[3] = s0.w, sv[4] = s1.x, sv[5] = s1.y, sv[6] = s1.z, sv[7] = s1.w;
    }
    // the group's f32 sum of the rounded x a row; a row belongs to one warp
    for (int r = warp; r < kRows; r += kWarps) {
      float part = 0.f;
      for (int p = lane; p < KC / 2; p += 32) {
        const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(xc + r * kXPitch + 2 * p);
        part += __bfloat162float(pr.x) + __bfloat162float(pr.y);
      }
      part = warp_sum(part);
      if (lane == 0) xsum_g[r] = first ? part : xsum_g[r] + part;
    }

    const unsigned char* pc = ps + s * kStagePacked + warp * 32 + 4 * q;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const unsigned w0 = *reinterpret_cast<const unsigned*>(pc + (ks * 8 + t) * kPackedPitch);
      const unsigned w1 = *reinterpret_cast<const unsigned*>(pc + (ks * 8 + t + 4) * kPackedPitch);
      unsigned b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = codes_to_bf16x2((w0 >> (8 * j)) & 0xFFu);
        b[j][1] = codes_to_bf16x2((w1 >> (8 * j)) & 0xFFu);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xr = xc + (mt * 16 + q) * kXPitch + ks * 16 + 2 * t;
        unsigned a[4];
        a[0] = *reinterpret_cast<const unsigned*>(xr);
        a[1] = *reinterpret_cast<const unsigned*>(xr + 8 * kXPitch);
        a[2] = *reinterpret_cast<const unsigned*>(xr + 8);
        a[3] = *reinterpret_cast<const unsigned*>(xr + 8 * kXPitch + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, b[j][0], b[j][1]);
      }
    }

    if (last) {
      __syncthreads();  // the group's x sums are written
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float z0 = 8.f * xsum_g[mt * 16 + q], z1 = 8.f * xsum_g[mt * 16 + q + 8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          total[mt][j][0] += (acc[mt][j][0] - z0) * sv[j];
          total[mt][j][1] += (acc[mt][j][1] - z0) * sv[4 + j];
          total[mt][j][2] += (acc[mt][j][2] - z1) * sv[j];
          total[mt][j][3] += (acc[mt][j][3] - z1) * sv[4 + j];
          acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
        }
      }
    }
    __syncthreads();  // every warp is done with stage s before the next iteration refills it
  }

  // tile j's accumulator columns 2t and 2t + 1 are output columns 8t + j and 8t + 4 + j
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + mt * 16 + q + 8 * half;
      if (row >= m) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = total[mt][j][2 * half];
        v[4 + j] = total[mt][j][2 * half + 1];
      }
      const size_t off = (size_t)row * n + n0 + warp * 32 + 8 * t;
      if (splits > 1) {
        store8(partial + (size_t)split * m * n + off, v);
      } else {
        store8(out + off, v);
      }
    }
  }
}

// out = sum over splits of partial[split], in split order; 4 elements a thread
template <typename T>
__global__ void __launch_bounds__(256) int4_matmul_combine(const float* __restrict__ partial, T* __restrict__ out,
                                                           size_t mn, int splits) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= mn) return;
  float4 a = *reinterpret_cast<const float4*>(partial + i);
  for (int s = 1; s < splits; ++s) {
    const float4 b = *reinterpret_cast<const float4*>(partial + (size_t)s * mn + i);
    a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
  }
  const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (std::is_same<T, float>::value) {
      out[i + e] = v[e];
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      out[i + e] = __float2bfloat16(v[e]);
    } else {
      out[i + e] = __float2half(v[e]);
    }
  }
}

template <typename T, int MT, int KC>
cudaError_t launch(const void* x, const void* packed, const void* scale, void* out, void* scratch, int m, int k,
                   int n, int g, int groups_per_split, int splits, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(MT, KC);
  auto kernel = int4_matmul_kernel<T, MT, KC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n / kNTile, splits, (m + 16 * MT - 1) / (16 * MT));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
                                           static_cast<const float*>(scale), static_cast<T*>(out),
                                           static_cast<float*>(scratch), m, k, n, g, groups_per_split, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)m * n;
  int4_matmul_combine<T><<<(unsigned)((mn / 4 + 255) / 256), 256, 0, stream>>>(static_cast<const float*>(scratch),
                                                                             static_cast<T*>(out), mn, splits);
  return cudaGetLastError();
}

template <typename T, int KC>
cudaError_t dispatch_rows(int m_tiles, const void* x, const void* packed, const void* scale, void* out, void* scratch,
                          int m, int k, int n, int g, int groups_per_split, int splits, cudaStream_t stream) {
  switch (m_tiles) {
    case 1:
      return launch<T, 1, KC>(x, packed, scale, out, scratch, m, k, n, g, groups_per_split, splits, stream);
    case 2:
      return launch<T, 2, KC>(x, packed, scale, out, scratch, m, k, n, g, groups_per_split, splits, stream);
    case 4:
      return launch<T, 4, KC>(x, packed, scale, out, scratch, m, k, n, g, groups_per_split, splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_chunk(int m_tiles, const void* x, const void* packed, const void* scale, void* out,
                           void* scratch, int m, int k, int n, int g, int groups_per_split, int splits,
                           cudaStream_t stream) {
  if (g % 128 == 0)
    return dispatch_rows<T, 128>(m_tiles, x, packed, scale, out, scratch, m, k, n, g, groups_per_split, splits, stream);
  return dispatch_rows<T, 64>(m_tiles, x, packed, scale, out, scratch, m, k, n, g, groups_per_split, splits, stream);
}

}  // namespace

// dtype of x and out: 0 = float32, 1 = bfloat16, 2 = float16. m_tiles (1, 2
// or 4): 16-row tiles of x a block owns. The contraction's k / g groups are
// cut into `splits` slices of groups_per_split groups; with splits > 1,
// scratch holds [splits, m, n] f32. Every pointer 16-byte aligned. Returns
// the cudaError_t of the launches (0 on success).
extern "C" int int4_matmul(const void* x, const void* packed, const void* scale, void* out, void* scratch, int dtype,
                           int m, int k, int n, int g, int m_tiles, int groups_per_split, int splits, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || g <= 0 || g % 64 != 0 || k % g != 0 || n % kNTile != 0 ||
      groups_per_split <= 0 || splits <= 0 || (long long)splits * groups_per_split < k / g ||
      (long long)(splits - 1) * groups_per_split >= k / g || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_chunk<float>(m_tiles, x, packed, scale, out, scratch, m, k, n, g, groups_per_split,
                                        splits, s);
    case 1:
      return (int)dispatch_chunk<__nv_bfloat16>(m_tiles, x, packed, scale, out, scratch, m, k, n, g,
                                                groups_per_split, splits, s);
    case 2:
      return (int)dispatch_chunk<__half>(m_tiles, x, packed, scale, out, scratch, m, k, n, g, groups_per_split,
                                         splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
