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
// What bounds it: the HBM bytes of the codes, read once (half a byte a
// weight, a quarter of bf16's). At decode (M <= 16) a projection of
// TinyLlama moves 0.26 to 5.8 MB, 0.1 to 1.7 us at 3.35 TB/s, so latency
// sets the time: the launch, and the round trips one warp's loads and the
// join of the splits wait on; at prefill widths (M 64-256) still the bytes,
// the tensor-core work being small beside them.
//
// What the design does about it. The Pallas kernel splits x into even and
// odd columns on the host and multiplies the two nibble planes separately,
// because the TPU cannot interleave rows cheaply. Here one byte is exactly
// the two bf16 B-operand values of mma.sync m16n8k16 that a thread holds
// (rows 2r and 2r + 1 of one column), so nothing is split or shuffled. A
// warp's 8 J columns are J 8-column mma tiles interleaved by J (tile j
// holds columns J c + j), so one J-byte shared-memory read gives a thread
// its byte for all J tiles, and its 2 J accumulator columns are
// contiguous. At a group's end the f32 accumulator, less 8 times the
// group's x sum, times the group's scales joins the running total, all in
// registers. Two kernels:
//  * decode, M <= 16 (int4_matmul_decode): a block owns 8 J = 16 or 32
//    output columns and a split of whole groups of the contraction; grid
//    (N / 8 J, splits). A warp takes one group, so a block has as many
//    warps as its split has groups, at most 4. The wrapper picks the
//    columns and groups a split from the shapes alone (32 columns and 4
//    groups where that gives at least 132 blocks, else fewer groups, then
//    16 columns; every TinyLlama projection runs 256 or more blocks). A warp
//    streams its group in chunks of 64 contraction rows (the codes, 32 rows
//    of 8 J bytes, the group's scales with its first chunk, and x's M rows
//    of the chunk, rounded to bf16) through its own cp.async ring, deep
//    enough to hold all of them: a warp's bytes are in flight at once, and
//    it waits on nothing but its own loads (no block barrier in the loop).
//    x is read once a block. x's group sums come from the mma A fragments
//    the threads already hold (a quad shuffle at the group's end). The
//    warps' totals are summed in warp order in shared memory. One group a
//    warp keeps each warp's chain of round trips short: the time goes to
//    round trips, not to bytes;
//  * prefill, M > 16 (int4_matmul_kernel): a block of 4 warps owns 128
//    columns (J = 4), 16 MT rows of x and a split of whole groups; grid
//    (N / 128, splits, row tiles); the codes stream through shared memory
//    in chunks of KC = 128 (or 64) rows with 16-byte cp.async loads, two
//    stages, x's chunk riding along;
//  * decode joins its splits in the same launch: with more than one, each
//    block writes its f32 partial result to scratch, publishes it with a
//    __threadfence() and takes a ticket from its column tile's counter;
//    the block that takes the last ticket sums the partials in split order,
//    casts once, writes the output and puts the counter back to 0. So the
//    sum never depends on the order the blocks ran in. Prefill keeps its
//    second pass (int4_matmul_combine, the whole grid summing the splits in
//    split order): one block joining a 16 MT x 128 tile of up to 8 splits
//    was slower on the card than the extra launch.
// It allocates nothing (the caller passes the scratch and the counters)
// and launches on the caller's stream. wgmma, TMA and a fused q/k/v or
// gate/up launch are work for a later change.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;      // a prefill block
constexpr int kWarps = kThreads / 32;
constexpr int kNTile = 128;        // output columns a prefill block owns (32 a warp)
constexpr int kPackedPitch = 160;  // bytes between staged byte rows: 128 of data, padded
constexpr int kXPad = 8;           // bf16 elements of padding a staged x row
constexpr int kDecodeRows = 16;    // rows of x the decode kernel takes: one mma row tile
constexpr int kDecodeKC = 64;      // contraction rows a decode chunk
constexpr int kDecodeMaxStages = 12;  // a decode warp's ring: every chunk of the warp in flight where it fits

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
// the same with N known at run time, 0 to kDecodeMaxStages - 2
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    default: cp_async_wait<10>(); break;
  }
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

// the f32 sum of a bf16 pair
__device__ __forceinline__ float pair_sum(unsigned v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return f.x + f.y;
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

int smem_limit() {
  static const int limit = [] {
    int dev = 0, bytes = 48 * 1024;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return bytes;
  }();
  return limit;
}

// ---------------------------------------------------------------------------
// decode, M <= 16
// ---------------------------------------------------------------------------

// Bytes between a decode stage's code rows: 8 J (16 or 32), unpadded: the
// J-byte reads of a warp's 8 columns x 4 rows fall in distinct banks.
__host__ __device__ constexpr int decode_pitch(int j) { return 8 * j; }

// A decode stage: 32 code rows (64 contraction rows), the group's 8 j
// scales (loaded with a group's first chunk), then x's m rows of the chunk
// in bf16.
__host__ __device__ constexpr int decode_stage_bytes(int j, int m) {
  return ((kDecodeKC / 2) * decode_pitch(j) + 8 * j * 4 + m * (kDecodeKC + kXPad) * 2 + 15) / 16 * 16;
}

// J bytes of a code row at p (J = 2 or 4), as a 32-bit word
template <int J>
__device__ __forceinline__ unsigned read_codes(const unsigned char* p) {
  if constexpr (J == 2) {
    return *reinterpret_cast<const unsigned short*>(p);
  } else {
    return *reinterpret_cast<const unsigned*>(p);
  }
}

// grid (N / 8 J, splits), 32 * warps threads. Warp w of a block walks the
// split's groups w, w + warps, ...; with splits > 1 the block's f32 result
// goes to partial[split] and the last block of the column tile joins them.
template <typename T, int J>
__global__ void __launch_bounds__(kThreads)
    int4_matmul_decode(const T* __restrict__ x, const uint8_t* __restrict__ packed, const float* __restrict__ scale,
                       T* __restrict__ out, float* __restrict__ partial, int* __restrict__ tickets, int m, int k,
                       int n, int g, int groups_per_split, int splits, int stages) {
  constexpr int NT = 8 * J;  // output columns of the block (and of each warp)
  constexpr int kPitch = decode_pitch(J);
  constexpr int kXPitch = kDecodeKC + kXPad;
  constexpr int kCodeBytes = (kDecodeKC / 2) * kPitch;
  const int stage_bytes = decode_stage_bytes(J, m);
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * NT;
  const int split = blockIdx.y;
  const int g_begin = split * groups_per_split;
  const int g_count = min(k / g, g_begin + groups_per_split) - g_begin;
  const int cpg = g / kDecodeKC;  // chunks a group
  const int n_chunks = (g_count > warp ? (g_count - warp + warps - 1) / warps : 0) * cpg;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + warp * stages * stage_bytes;
  int& last_block = *reinterpret_cast<int*>(smem + warps * stages * stage_bytes);  // past every ring

  auto group_of = [&](int c) { return g_begin + warp + (c / cpg) * warps; };
  auto stage_in = [&](int c) {
    unsigned char* st = ring + (c % stages) * stage_bytes;
    const int k0 = group_of(c) * g + (c % cpg) * kDecodeKC;
    constexpr int kSegs = NT / 16;  // 16-byte pieces of a code row
    const uint8_t* src = packed + (size_t)(k0 / 2) * n + n0;
#pragma unroll
    for (int i = lane; i < (kDecodeKC / 2) * kSegs; i += 32) {
      const int r = i / kSegs, seg = i % kSegs;
      cp_async16(st + r * kPitch + seg * 16, src + (size_t)r * n + seg * 16, true);
    }
    if (c % cpg == 0) {  // the group's scales of the block's columns ride with its first chunk
      const float* ssrc = scale + (size_t)group_of(c) * n + n0;
      for (int i = lane; i < NT / 4; i += 32) cp_async16(st + kCodeBytes + i * 16, ssrc + i * 4, true);
    }
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + kCodeBytes + NT * 4);
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      for (int i = lane; i < m * (kDecodeKC / 8); i += 32) {
        const int r = i >> 3, seg = i & 7;
        cp_async16(xs + r * kXPitch + seg * 8, x + (size_t)r * k + k0 + seg * 8, true);
      }
    } else {  // rounded to bf16 on the way
      for (int i = lane; i < m * kDecodeKC; i += 32) {
        const int r = i / kDecodeKC, col = i % kDecodeKC;
        xs[r * kXPitch + col] = __float2bfloat16(to_f32(x[(size_t)r * k + k0 + col]));
      }
    }
  };

  float acc[J][4], total[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = total[j][e] = 0.f;
  float sv[2 * J];
#pragma unroll
  for (int i = 0; i < 2 * J; ++i) sv[i] = 0.f;
  float xsum0 = 0.f, xsum1 = 0.f;  // this thread's share of rows q and q + 8's x sums over the group so far
  const bool row0_ok = q < m, row1_ok = q + 8 < m;

  for (int c = 0; c < stages - 1; ++c) {
    if (c < n_chunks) stage_in(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_n(stages - 2);  // this lane's pieces of chunk c have landed
    __syncwarp();                 // every lane's have; every lane is done with chunk c - 1
    if (c + stages - 1 < n_chunks) stage_in(c + stages - 1);  // into chunk c - 1's stage
    cp_async_commit();

    const unsigned char* st = ring + (c % stages) * stage_bytes;
    const __nv_bfloat16* xc = reinterpret_cast<const __nv_bfloat16*>(st + kCodeBytes + NT * 4);
    if (c % cpg == 0) {  // this thread's 2 J scales of the group
      const float* sc = reinterpret_cast<const float*>(st + kCodeBytes) + 2 * J * t;
#pragma unroll
      for (int i = 0; i < 2 * J; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(sc + i);
        sv[i] = v.x, sv[i + 1] = v.y, sv[i + 2] = v.z, sv[i + 3] = v.w;
      }
    }
    const unsigned char* pc = st + J * q;
#pragma unroll
    for (int ks = 0; ks < kDecodeKC / 16; ++ks) {
      const unsigned w0 = read_codes<J>(pc + (ks * 8 + t) * kPitch);
      const unsigned w1 = read_codes<J>(pc + (ks * 8 + t + 4) * kPitch);
      const __nv_bfloat16* xr = xc + q * kXPitch + ks * 16 + 2 * t;
      unsigned a[4];
      a[0] = row0_ok ? *reinterpret_cast<const unsigned*>(xr) : 0u;
      a[1] = row1_ok ? *reinterpret_cast<const unsigned*>(xr + 8 * kXPitch) : 0u;
      a[2] = row0_ok ? *reinterpret_cast<const unsigned*>(xr + 8) : 0u;
      a[3] = row1_ok ? *reinterpret_cast<const unsigned*>(xr + 8 * kXPitch + 8) : 0u;
      xsum0 += pair_sum(a[0]) + pair_sum(a[2]);
      xsum1 += pair_sum(a[1]) + pair_sum(a[3]);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const unsigned b0 = codes_to_bf16x2((w0 >> (8 * j)) & 0xFFu);
        const unsigned b1 = codes_to_bf16x2((w1 >> (8 * j)) & 0xFFu);
        mma_bf16(acc[j], a, b0, b1);
      }
    }
    if ((c + 1) % cpg == 0) {  // the group's end: the quad holds rows q and q + 8 whole
      xsum0 += __shfl_xor_sync(0xffffffffu, xsum0, 1);
      xsum0 += __shfl_xor_sync(0xffffffffu, xsum0, 2);
      xsum1 += __shfl_xor_sync(0xffffffffu, xsum1, 1);
      xsum1 += __shfl_xor_sync(0xffffffffu, xsum1, 2);
      const float z0 = 8.f * xsum0, z1 = 8.f * xsum1;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        total[j][0] += (acc[j][0] - z0) * sv[j];
        total[j][1] += (acc[j][1] - z0) * sv[J + j];
        total[j][2] += (acc[j][2] - z1) * sv[j];
        total[j][3] += (acc[j][3] - z1) * sv[J + j];
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
      xsum0 = xsum1 = 0.f;
    }
  }

  // the warps' totals, summed in warp order: tile j's accumulator columns 2t
  // and 2t + 1 are the block's columns 2 J t + j and 2 J t + J + j
  __syncthreads();  // every warp is done with its ring: the space is reused
  const int mn = m * NT;
  float* red = reinterpret_cast<float*>(smem);  // [warps][m][NT]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q + 8 * half;
    if (row < m) {
      float* dst = red + (size_t)warp * mn + row * NT + 2 * J * t;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        dst[j] = total[j][2 * half];
        dst[J + j] = total[j][2 * half + 1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < mn; i += blockDim.x) {
    float v = red[i];
    for (int w = 1; w < warps; ++w) v += red[w * mn + i];
    const size_t off = (size_t)(i / NT) * n + n0 + i % NT;
    if (splits == 1) {
      out[off] = from_f32<T>(v);
    } else {
      partial[(size_t)split * m * n + off] = v;
    }
  }
  if (splits == 1) return;

  // publish, take a ticket; the column tile's last block joins the splits in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(tickets + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int i = tid; i < mn; i += blockDim.x) {
    const size_t off = (size_t)(i / NT) * n + n0 + i % NT;
    float v = 0.f;
    for (int s0 = 0; s0 < splits; s0 += 8) {  // eight splits' loads in flight at once, summed in split order
      float p[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) p[u] = s0 + u < splits ? __ldcg(partial + (size_t)(s0 + u) * m * n + off) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (s0 + u < splits) v += p[u];
      }
    }
    out[off] = from_f32<T>(v);
  }
  if (tid == 0) tickets[blockIdx.x] = 0;  // every block of the tile has taken its ticket
}

// ---------------------------------------------------------------------------
// prefill, M > 16
// ---------------------------------------------------------------------------

constexpr size_t smem_bytes(int mt, int kc) {
  return (size_t)2 * (kc / 2) * kPackedPitch + (size_t)2 * 16 * mt * (kc + kXPad) * 2 + (size_t)2 * 16 * mt * 4;
}

// grid (N / 128, splits, ceil(M / (16 MT))). With splits == 1 the block
// writes out; otherwise its f32 partial result goes to partial[split], and
// int4_matmul_combine joins them.
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
  static const cudaError_t attr =  // once an instantiation, not every call
      smem > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                       : cudaSuccess;
  if (attr != cudaSuccess) return attr;
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

template <typename T, int J>
cudaError_t launch_decode(const void* x, const void* packed, const void* scale, void* out, void* scratch,
                          int* tickets, int m, int k, int n, int g, int warps, int groups_per_split, int splits,
                          cudaStream_t stream) {
  auto kernel = int4_matmul_decode<T, J>;
  static const cudaError_t attr =  // once an instantiation: the card's whole shared memory
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit());
  if (attr != cudaSuccess) return attr;
  // a ring deep enough for every chunk of the busiest warp, where shared memory allows
  const int stage = decode_stage_bytes(J, m);
  const int chunks = (groups_per_split + warps - 1) / warps * (g / kDecodeKC);
  int stages = chunks + 1 < kDecodeMaxStages ? chunks + 1 : kDecodeMaxStages;
  while (stages > 2 && warps * stages * stage + 16 > smem_limit()) --stages;
  const size_t red = (size_t)warps * m * 8 * J * sizeof(float);  // never more than two stages
  const size_t ring = (size_t)warps * stages * stage;
  const size_t smem = (ring > red ? ring : red) + 16;
  kernel<<<dim3(n / (8 * J), splits), 32 * warps, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed), static_cast<const float*>(scale),
      static_cast<T*>(out), static_cast<float*>(scratch), tickets, m, k, n, g, groups_per_split, splits, stages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int m_tiles, int columns, int warps, const void* x, const void* packed, const void* scale,
                     void* out, void* scratch, int* tickets, int m, int k, int n, int g, int groups_per_split,
                     int splits, cudaStream_t stream) {
  if (m <= kDecodeRows) {
    switch (columns) {
      case 16:
        return launch_decode<T, 2>(x, packed, scale, out, scratch, tickets, m, k, n, g, warps, groups_per_split,
                                   splits, stream);
      case 32:
        return launch_decode<T, 4>(x, packed, scale, out, scratch, tickets, m, k, n, g, warps, groups_per_split,
                                   splits, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (g % 128 == 0)
    return dispatch_rows<T, 128>(m_tiles, x, packed, scale, out, scratch, m, k, n, g, groups_per_split, splits,
                                 stream);
  return dispatch_rows<T, 64>(m_tiles, x, packed, scale, out, scratch, m, k, n, g, groups_per_split, splits, stream);
}

}  // namespace

// dtype of x and out: 0 = float32, 1 = bfloat16, 2 = float16. The
// contraction's k / g groups are cut into `splits` slices of
// groups_per_split groups. m <= 16 runs the decode kernel: `columns` (16
// or 32) output columns and `warps` (1 to 4) warps a block. m > 16 runs
// the prefill kernel: `columns` 128, `warps` 4, `m_tiles` (1, 2 or 4)
// 16-row tiles of x a block. With splits > 1, scratch holds [splits, m, n]
// f32; decode joins the splits in its launch through `tickets` (one int a
// column tile, 0 on entry and left 0), prefill in a second launch. Every
// pointer 16-byte aligned. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int int4_matmul(const void* x, const void* packed, const void* scale, void* out, void* scratch,
                           int* tickets, int dtype, int m, int k, int n, int g, int m_tiles, int columns, int warps,
                           int groups_per_split, int splits, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || g <= 0 || g % 64 != 0 || k % g != 0 || groups_per_split <= 0 || splits <= 0 ||
      (long long)splits * groups_per_split < k / g || (long long)(splits - 1) * groups_per_split >= k / g ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (m <= kDecodeRows ? (columns != 16 && columns != 32) || warps < 1 || warps > 4
                       : columns != kNTile || warps != kWarps)
    return (int)cudaErrorInvalidValue;
  if (n % columns != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(m_tiles, columns, warps, x, packed, scale, out, scratch, tickets, m, k, n, g,
                                  groups_per_split, splits, s);
    case 1:
      return (int)dispatch<__nv_bfloat16>(m_tiles, columns, warps, x, packed, scale, out, scratch, tickets, m, k, n,
                                          g, groups_per_split, splits, s);
    case 2:
      return (int)dispatch<__half>(m_tiles, columns, warps, x, packed, scale, out, scratch, tickets, m, k, n, g,
                                   groups_per_split, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
