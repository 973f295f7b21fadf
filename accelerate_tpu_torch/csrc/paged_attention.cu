// Paged decode attention for Hopper (sm_90a): one launch a call.
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
// pool[block_table[b, p / bs], p % bs] (table entries clamped into the
// pool, the frontier clamped to the table's last entry). Scores, the
// online softmax and P.V run in f32, P kept in f32; the output is
// acc / max(l, 1), so a row with no live key gives 0 and not NaN.
//
// What bounds it: the HBM bytes of the live K/V keys, each read once; q
// and the output are small. At the serving slice's shapes (8 rows, 4 kv
// heads, 100 to 2,000 live keys a row) one call moves a few megabytes at
// most, so latency sets its time: the launch, how long one block waits on
// its loads, and how many blocks share the work.
//
// What the design does about it. The TPU grid walks (row, table entry)
// in order and carries the online softmax in VMEM scratch; here blocks run
// in parallel and carry nothing between them:
//  * grid (row x kv head x chunk of at most 16 query heads, split): the
//    wrapper sets the number of splits from the shapes alone (B, Hkv, the
//    table width, the card's 132 SMs: about two blocks an SM), never from
//    cur, so the host never waits on the card. Each block cuts its row's
//    live range into that many equal runs of keys on the card, so every
//    block has work, short rows and long alike, and a long row's run is
//    many tiles deep. The G = H / Hkv query heads of a kv head share one
//    block: GQA never repeats K/V;
//  * a block first reads cur, its q rows and its row of the table (into
//    shared memory) together, one round trip; K and V then stay in their
//    own type in shared memory, in stages of keys that stream through a
//    ring of up to five stages with 16-byte cp.async (each key row found
//    through its own table entry, rows padded by 16 bytes so the reads
//    across rows are free of bank conflicts): while one stage is
//    multiplied, the next ones are in flight. Only live keys are loaded;
//  * 16 bits at D <= 128 (paged_decode_mma, the serving path): both
//    products on the tensor cores. A stage holds 64 keys, a warp takes 16
//    of them with its own online softmax and accumulator in registers (one
//    block-wide barrier a stage); S = Q K^T is mma.sync m16n8k16 on the raw
//    16-bit q and K (exact products, f32 sums); P stays f32 by being split
//    into three pieces of q's type whose sum is P (bf16: the whole f32
//    mantissa; fp16: all but what falls below its smallest subnormal,
//    6e-8), each piece times V an exact mma product summed in f32, V read
//    with ldmatrix.trans. The four warps' (m, l, acc) are merged in warp
//    order. At these shapes the scalar version below spends its time
//    issuing instructions, not moving bytes;
//  * f32, and 16 bits at D > 128 (paged_decode_kernel): scores on the CUDA
//    cores, a warp taking one query head and a stage's 32 keys, a key a
//    lane, each 16-byte K load widened in registers for every head it owns
//    (q f32 in shared memory, a broadcast read); the warp then holds all of
//    the head's scores, so the running max and sum take shuffles. P.V reads
//    P (f32) and V (widened), two output channels a thread. Two block-wide
//    barriers a stage;
//  * the splits of one (row, kv head, chunk) are joined in the same launch:
//    each block writes its (m, l, acc) to f32 scratch, publishes it with a
//    __threadfence() and takes a ticket from a per-stream counter (a block
//    with no key, in a row shorter than the split count, takes one too);
//    the block that takes the last ticket rescales the live splits by
//    exp(m_s - max m) in split order, divides by max(sum l, 1), writes the
//    output and puts the counter back to 0. The sums do not depend on the
//    order the blocks ran in: two calls on the same inputs are bit-equal.
// Every dtype (f32, bf16, fp16) and every head dim that is a multiple of 16
// from 16 to 256 run through one build, D read at run time; a call launches
// one of the two kernels. The ring has up to five stages (the tensor-core
// kernel about 72 KB of them) and never fewer than two (f32 at D 256 with 16
// query heads a block). It allocates nothing (the caller passes the
// scratch and the counters) and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 32;                   // keys a stage holds: a key a lane in the score loop
constexpr int kMaxGroup = 16;                   // query heads a block serves; a larger group takes more blocks
constexpr int kHeadsPerWarp = kMaxGroup / kWarps;
constexpr int kMaxStages = 5;  // four tiles in flight while one is multiplied
constexpr int kMaxSplits = 256;
constexpr int kPPitch = kTileKeys + 1;          // floats a row of P: the P.V loop reads across rows

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

// two neighbouring elements widened to f32
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// 16 bytes global -> shared; zero-fills when !valid (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most n of this thread's committed groups are pending (n = stages - 2: 0 to 3)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 3) {
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  } else if (n == 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
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

// Live keys of a row: [first, last]; none when first > last.
__device__ __forceinline__ void live_keys(int cur, int window, int table_keys, int* first, int* last) {
  *first = window > 0 ? max(0, cur - window + 1) : 0;  // first in-band position
  *last = min(cur, table_keys - 1);                     // the frontier, clamped to the table
}

// The end of every block of both kernels. Every block, live or not, has
// written its partial result (if any); it publishes it and takes its ticket;
// the block that takes the last ticket of its (row, kv head, chunk) joins
// the n_live splits that hold keys (the first ones) in split order: w_s
// (2 n_live gc floats of shared memory) and l_s (gc) are its scratch.
template <typename T>
__device__ __forceinline__ void join_splits(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                                            int* __restrict__ tickets, T* __restrict__ out, float* w_s, float* l_s,
                                            int* flag, int pair, int num_splits, int n_live, int gc, int D,
                                            size_t row0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(tickets + pair, 1) == num_splits - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  for (int g = warp; g < gc; g += kWarps) {  // w_s [n_live][gc]: exp(m_s - max m), then l_s times that
    const float* ml = part_ml + (row0 + g) * num_splits * 2;
    float mx = -INFINITY;
    for (int s = lane; s < n_live; s += 32) mx = fmaxf(mx, __ldcg(ml + 2 * s));
    mx = warp_max(mx);
    const float m_safe = mx == -INFINITY ? 0.f : mx;
    for (int s = lane; s < n_live; s += 32) {  // every split's loads at once, a split a lane
      const float2 v = __ldcg(reinterpret_cast<const float2*>(ml + 2 * s));
      const float w = expf(v.x - m_safe);
      w_s[s * gc + g] = w;
      w_s[(n_live + s) * gc + g] = w * v.y;
    }
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
      for (int s = 0; s < n_live; ++s) l += w_s[(n_live + s) * gc + g];  // split order
      l_s[g] = l;
    }
  }
  __syncthreads();
  for (int i = 4 * tid; i < gc * D; i += 4 * kThreads) {  // four channels a thread
    const int g = i / D, c = i % D;
    const float* a = part_acc + (row0 + g) * num_splits * D + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_live; s0 += 8) {  // eight splits' loads in flight at once, summed in split order
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = s0 + u < n_live ? __ldcg(reinterpret_cast<const float4*>(a + (size_t)(s0 + u) * D))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (s0 + u < n_live) {
          const float w = w_s[(s0 + u) * gc + g];
          acc.x += w * v[u].x, acc.y += w * v[u].y, acc.z += w * v[u].z, acc.w += w * v[u].w;
        }
      }
    }
    const float l = fmaxf(l_s[g], 1.f);  // no live key: 0 / 1
    T* o = out + (row0 + g) * D + c;
    o[0] = from_f32<T>(acc.x / l), o[1] = from_f32<T>(acc.y / l), o[2] = from_f32<T>(acc.z / l),
    o[3] = from_f32<T>(acc.w / l);
  }
  if (tid == 0) tickets[pair] = 0;  // every block of this pair has taken its ticket
}

// Shared memory of one block, in bytes: the ring (or, once the block's
// split is done, the combine's weights), then q and acc [gmax][D] f32, P
// [gmax][kPPitch], alpha and l [gmax], the row's table [mb] int32, one flag.
struct Layout {
  int pitch, stage_bytes, ring_bytes, q_off, acc_off, p_off, alpha_off, l_off, tbl_off, flag_off, total;
};

__host__ __device__ inline Layout layout(int elt, int d, int gmax, int stages, int splits, int mb) {
  Layout s;
  s.pitch = d * elt + 16;  // bytes between two staged key rows
  s.stage_bytes = 2 * kTileKeys * s.pitch;
  const int combine = ((2 * splits * gmax * 4) + 15) / 16 * 16;
  s.ring_bytes = stages * s.stage_bytes > combine ? stages * s.stage_bytes : combine;
  s.q_off = s.ring_bytes;
  s.acc_off = s.q_off + gmax * d * 4;
  s.p_off = s.acc_off + gmax * d * 4;
  s.alpha_off = s.p_off + gmax * kPPitch * 4;
  s.l_off = s.alpha_off + gmax * 4;
  s.tbl_off = s.l_off + gmax * 4;
  s.flag_off = s.tbl_off + mb * 4;
  s.total = s.flag_off + 16;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kpool, const T* __restrict__ vpool,
    const int32_t* __restrict__ table, const int32_t* __restrict__ cur_arr, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int batch, int heads, int kv_heads, int D, int num_blocks,
    int bs, int max_blocks, int num_splits, int stages, float scale, int window) {
  const int G = heads / kv_heads;
  const int chunks = (G + kMaxGroup - 1) / kMaxGroup;
  const int gmax = min(G, kMaxGroup);
  const int pair = blockIdx.x;  // (row, kv head, chunk of the group)
  const int split = blockIdx.y;
  const int chunk = pair % chunks, bh = pair / chunks;
  const int b = bh / kv_heads, h = bh % kv_heads;
  const int g0 = chunk * kMaxGroup, gc = min(kMaxGroup, G - g0);  // this block's query heads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout lay = layout(sizeof(T), D, gmax, stages, num_splits, max_blocks);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + lay.q_off);          // [gc][D]
  float* acc_s = reinterpret_cast<float*>(smem + lay.acc_off);      // [gc][D]
  float* p_s = reinterpret_cast<float*>(smem + lay.p_off);          // [gc][kPPitch]
  float* alpha_s = reinterpret_cast<float*>(smem + lay.alpha_off);  // [gc]
  float* l_s = reinterpret_cast<float*>(smem + lay.l_off);          // [gc]
  int* tbl_s = reinterpret_cast<int*>(smem + lay.tbl_off);         // [max_blocks]
  int* flag = reinterpret_cast<int*>(smem + lay.flag_off);

  const int rows = batch * heads;
  float* part_acc = part;                                 // [rows][splits][D]
  float* part_ml = part + (size_t)rows * num_splits * D;  // [rows][splits][2]: m, l
  const size_t row0 = (size_t)b * heads + (size_t)h * G + g0;  // the block's first query row (b, head)

  // cur, q and the row's table entries do not wait on each other: one round trip
  const int cur = cur_arr[b];
  const T* q_row = q + row0 * D;
  for (int i = tid; i < gc * D; i += kThreads) {
    q_s[i] = to_f32(q_row[i]);
    acc_s[i] = 0.f;
  }
  const int32_t* trow = table + (size_t)b * max_blocks;
  for (int j = tid; j < max_blocks; j += kThreads) tbl_s[j] = min(max(trow[j], 0), num_blocks - 1);
  __syncthreads();
  int first, last;
  live_keys(cur, window, max_blocks * bs, &first, &last);
  const int n_keys = max(0, last - first + 1);
  const int run = (n_keys + num_splits - 1) / num_splits;  // keys a split
  const int k_begin = first + split * run;
  const int k_end = min(k_begin + run - 1, last);  // every key in [k_begin, k_end] is live

  if (k_begin <= k_end) {
    constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte load
    const int pieces = D / kVec;          // 16-byte pieces a key row
    const size_t row_stride = (size_t)kv_heads * D;
    const int n_tiles = (k_end - k_begin) / kTileKeys + 1;

    auto load_tile = [&](int t) {
      unsigned char* st = ring + (t % stages) * lay.stage_bytes;
      const int lo = k_begin + t * kTileKeys;
      for (int i = tid; i < kTileKeys * pieces; i += kThreads) {
        const int kk = i / pieces, c = i % pieces, pos = lo + kk;
        const bool live = pos <= k_end;
        size_t off = 0;
        if (live) {
          const int blk = tbl_s[pos / bs];
          off = ((size_t)blk * bs + pos % bs) * row_stride + (size_t)h * D + c * kVec;
        }
        cp_async16(st + kk * lay.pitch + c * 16, kpool + off, live);
        cp_async16(st + (kTileKeys + kk) * lay.pitch + c * 16, vpool + off, live);
      }
    };

    for (int t = 0; t < stages - 1; ++t) {
      if (t < n_tiles) load_tile(t);
      cp_async_commit();
    }
    float m_run[kHeadsPerWarp], l_run[kHeadsPerWarp];  // of heads warp, warp + 4, ...: every lane keeps them
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) m_run[j] = -INFINITY, l_run[j] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait(stages - 2);  // this thread's pieces of tile t have landed
      __syncthreads();            // everyone's have, and every thread is done with tile t - 1's stage and P
      if (t + stages - 1 < n_tiles) load_tile(t + stages - 1);  // into tile t - 1's stage
      cp_async_commit();

      const unsigned char* st = ring + (t % stages) * lay.stage_bytes;
      // This lane's key is live. No key count is kept: with the P.V loop
      // bounded by min(32, keys left), the optimised build summed one key a
      // tile though shared memory held the right K, V and P; P.V walks the
      // whole tile instead, whose keys past the split are zero-filled, P 0.
      const bool key_live = k_begin + t * kTileKeys + lane <= k_end;

      // scores: this lane's key against each of the warp's heads
      float dot[kHeadsPerWarp];
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j) dot[j] = 0.f;
      const unsigned char* krow = st + lane * lay.pitch;
      for (int c = 0; c < D; c += kVec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * sizeof(T));
        const T* e = reinterpret_cast<const T*>(&raw);
        float kf[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) kf[u] = to_f32(e[u]);
#pragma unroll
        for (int j = 0; j < kHeadsPerWarp; ++j) {
          const int g = warp + kWarps * j;
          if (g < gc) {
            const float* qv = q_s + g * D + c;
#pragma unroll
            for (int u = 0; u < kVec; u += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qv + u);
              dot[j] += q4.x * kf[u] + q4.y * kf[u + 1] + q4.z * kf[u + 2] + q4.w * kf[u + 3];
            }
          }
        }
      }
      // online softmax, one head a warp: the warp holds the tile's scores
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j) {
        const int g = warp + kWarps * j;
        if (g < gc) {
          const float s = key_live ? dot[j] * scale : -INFINITY;
          const float m_new = fmaxf(m_run[j], warp_max(s));
          const float m_safe = m_new == -INFINITY ? 0.f : m_new;  // cannot happen with a live key; kept safe
          const float p = expf(s - m_safe);
          const float alpha = expf(m_run[j] - m_safe);  // 0 while m was -inf
          l_run[j] = l_run[j] * alpha + warp_sum(p);
          m_run[j] = m_new;
          p_s[g * kPPitch + lane] = p;
          if (lane == 0) alpha_s[g] = alpha;
        }
      }
      __syncthreads();

      // acc [gc, D] = acc * alpha + P @ V, two channels a thread, P in f32
      const unsigned char* vtile = st + kTileKeys * lay.pitch;
      const int half_d = D / 2;
      for (int i = tid; i < gc * half_d; i += kThreads) {
        const int g = i / half_d, c = 2 * (i % half_d);
        const float* prow = p_s + g * kPPitch;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < kTileKeys; ++kk) {
          const float2 v = load2(reinterpret_cast<const T*>(vtile + kk * lay.pitch) + c);
          a0 += prow[kk] * v.x;
          a1 += prow[kk] * v.y;
        }
        const float alpha = alpha_s[g];
        float2* acc = reinterpret_cast<float2*>(acc_s + g * D + c);
        const float2 old = *acc;
        *acc = make_float2(old.x * alpha + a0, old.y * alpha + a1);
      }
    }
    __syncthreads();  // acc is whole

    for (int i = 4 * tid; i < gc * D; i += 4 * kThreads) {
      *reinterpret_cast<float4*>(part_acc + ((row0 + i / D) * num_splits + split) * D + i % D) =
          *reinterpret_cast<const float4*>(acc_s + i);
    }
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + kWarps * j;
      if (g < gc && lane == 0) {
        float* ml = part_ml + ((row0 + g) * num_splits + split) * 2;
        ml[0] = m_run[j];
        ml[1] = l_run[j];
      }
    }
  }

  join_splits<T>(part_acc, part_ml, tickets, out, reinterpret_cast<float*>(ring), l_s, flag, pair, num_splits,
                 n_keys > 0 ? (n_keys + run - 1) / run : 0, gc, D, row0);
}

// ---------------------------------------------------------------------------
// 16 bits at D <= 128: both products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaMaxD = 128;
constexpr int kWarpKeys = 16;                     // keys a warp takes from a stage: one k16 step of P.V
constexpr int kStageKeys = kWarps * kWarpKeys;    // 64
constexpr int kMmaRingBudget = 72 * 1024;         // bytes of ring a block aims for

// Shared memory of one block of the tensor-core kernel, in bytes: the ring
// (after the loop, the warps' (m, l, acc) and then the combine's weights),
// l [16], the row's table [mb] int32, one flag.
struct MmaLayout {
  int pitch, stage_bytes, ring_bytes, l_off, tbl_off, flag_off, total;
};

__host__ __device__ inline MmaLayout mma_layout(int d, int stages, int splits, int mb) {
  MmaLayout s;
  s.pitch = 2 * d + 16;  // bytes between two staged key rows, padded as in the CUDA-core kernel
  s.stage_bytes = 2 * kStageKeys * s.pitch;
  const int merge = kWarps * kMaxGroup * (d + 2) * 4;
  const int combine = 2 * splits * kMaxGroup * 4;
  const int extra = ((merge > combine ? merge : combine) + 15) / 16 * 16;
  s.ring_bytes = stages * s.stage_bytes > extra ? stages * s.stage_bytes : extra;
  s.l_off = s.ring_bytes;
  s.tbl_off = s.l_off + kMaxGroup * 4;
  s.flag_off = s.tbl_off + mb * 4;
  s.total = s.flag_off + 16;
  return s;
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

// m16n8k16 with f32 accumulators in T, and the rounding of an f32 pair to T
// (low half x) that leaves in (x, y) what the rounding lost
template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned round_pair(float& x, float& y) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    const float2 f = __bfloat1622float2(v);
    x -= f.x, y -= f.y;
    return *reinterpret_cast<const unsigned*>(&v);
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned round_pair(float& x, float& y) {
    const __half2 v = __floats2half2_rn(x, y);
    const float2 f = __half22float2(v);
    x -= f.x, y -= f.y;
    return *reinterpret_cast<const unsigned*>(&v);
  }
};

// The same function as paged_decode_kernel, for 16-bit K/V at D <= 128. A
// stage holds 64 keys; warp w takes keys 16 w .. 16 w + 15 of every stage
// with its own online softmax (rows: the block's up to 16 query heads) and
// its own accumulator, all in registers, so a stage costs one block-wide
// barrier. S = Q K^T is m16n8k16 on the raw 16-bit q and K (exact products,
// f32 sums). P stays f32: it is split into three pieces of T, hi + mid + lo
// (bf16: 8 + 8 + 8 mantissa bits, the whole f32 mantissa; fp16: 11 + 11 +
// 11, exact but for what falls below fp16's smallest subnormal, 6e-8), and
// P.V is three m16n8k16 products on V read with ldmatrix.trans, each
// product exact, summed in f32. After the run the four warps' (m, l, acc)
// are merged in warp order into the block's partial result.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_mma(
    const T* __restrict__ q, const T* __restrict__ kpool, const T* __restrict__ vpool,
    const int32_t* __restrict__ table, const int32_t* __restrict__ cur_arr, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int batch, int heads, int kv_heads, int D, int num_blocks,
    int bs, int max_blocks, int num_splits, int stages, float scale, int window) {
  const int G = heads / kv_heads;
  const int chunks = (G + kMaxGroup - 1) / kMaxGroup;
  const int pair = blockIdx.x, split = blockIdx.y;
  const int chunk = pair % chunks, bh = pair / chunks;
  const int b = bh / kv_heads, h = bh % kv_heads;
  const int g0 = chunk * kMaxGroup, gc = min(kMaxGroup, G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, qd = lane >> 2, t4 = lane & 3;
  const MmaLayout lay = mma_layout(D, stages, num_splits, max_blocks);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* l_s = reinterpret_cast<float*>(smem + lay.l_off);
  int* tbl_s = reinterpret_cast<int*>(smem + lay.tbl_off);
  int* flag = reinterpret_cast<int*>(smem + lay.flag_off);

  const int rows = batch * heads;
  float* part_acc = part;                                 // [rows][splits][D]
  float* part_ml = part + (size_t)rows * num_splits * D;  // [rows][splits][2]: m, l
  const size_t row0 = (size_t)b * heads + (size_t)h * G + g0;
  const int ksteps = D / 16;

  // cur, the q fragments and the row's table entries do not wait on each other: one round trip
  const int cur = cur_arr[b];
  unsigned qf[kMmaMaxD / 16][4];  // A fragments of Q [16 heads, D]; heads past gc are 0
  {
    const bool ok0 = qd < gc, ok1 = qd + 8 < gc;
    const T* q0 = q + (row0 + qd) * D + 2 * t4;
    const T* q1 = q0 + 8 * (size_t)D;
#pragma unroll
    for (int ks = 0; ks < kMmaMaxD / 16; ++ks) {
      const bool in = ks < ksteps;
      qf[ks][0] = in && ok0 ? *reinterpret_cast<const unsigned*>(q0 + 16 * ks) : 0u;
      qf[ks][1] = in && ok1 ? *reinterpret_cast<const unsigned*>(q1 + 16 * ks) : 0u;
      qf[ks][2] = in && ok0 ? *reinterpret_cast<const unsigned*>(q0 + 16 * ks + 8) : 0u;
      qf[ks][3] = in && ok1 ? *reinterpret_cast<const unsigned*>(q1 + 16 * ks + 8) : 0u;
    }
  }
  const int32_t* trow = table + (size_t)b * max_blocks;
  for (int j = tid; j < max_blocks; j += kThreads) tbl_s[j] = min(max(trow[j], 0), num_blocks - 1);
  __syncthreads();

  int first, last;
  live_keys(cur, window, max_blocks * bs, &first, &last);
  const int n_keys = max(0, last - first + 1);
  const int run = (n_keys + num_splits - 1) / num_splits;  // keys a split
  const int k_begin = first + split * run;
  const int k_end = min(k_begin + run - 1, last);

  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};  // rows qd and qd + 8
  float acc[kMmaMaxD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMmaMaxD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  if (k_begin <= k_end) {
    const int pieces = D / 8;  // 16-byte pieces a key row
    const size_t row_stride = (size_t)kv_heads * D;
    const int n_tiles = (k_end - k_begin) / kStageKeys + 1;

    auto load_tile = [&](int t) {
      unsigned char* st = ring + (t % stages) * lay.stage_bytes;
      const int lo = k_begin + t * kStageKeys;
      for (int i = tid; i < kStageKeys * pieces; i += kThreads) {
        const int kk = i / pieces, c = i % pieces, pos = lo + kk;
        const bool live = pos <= k_end;
        size_t off = 0;
        if (live) off = ((size_t)tbl_s[pos / bs] * bs + pos % bs) * row_stride + (size_t)h * D + c * 8;
        cp_async16(st + kk * lay.pitch + c * 16, kpool + off, live);
        cp_async16(st + (kStageKeys + kk) * lay.pitch + c * 16, vpool + off, live);
      }
    };

    for (int t = 0; t < stages - 1; ++t) {
      if (t < n_tiles) load_tile(t);
      cp_async_commit();
    }
    const int vrow = (lane & 7) + 8 * ((lane >> 3) & 1), vcol = 8 * (lane >> 4);  // ldmatrix row of this lane
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait(stages - 2);  // this thread's pieces of stage t have landed
      __syncthreads();            // everyone's have, and every warp is done with stage t - 1
      if (t + stages - 1 < n_tiles) load_tile(t + stages - 1);  // into stage t - 1's slot
      cp_async_commit();

      const int key0 = k_begin + t * kStageKeys + warp * kWarpKeys;  // this warp's first key
      if (key0 > k_end) continue;
      const unsigned char* kb = ring + (t % stages) * lay.stage_bytes + warp * kWarpKeys * lay.pitch;
      const unsigned char* vb = kb + kStageKeys * lay.pitch;

      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // [key tile of 8][row qd: 0, 1; qd + 8: 2, 3]
#pragma unroll
      for (int ks = 0; ks < kMmaMaxD / 16; ++ks) {
        if (ks < ksteps) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const unsigned char* kr = kb + (nt * 8 + qd) * lay.pitch + (ks * 16 + 2 * t4) * 2;
            Mma<T>::mma(s[nt], qf[ks], *reinterpret_cast<const unsigned*>(kr),
                        *reinterpret_cast<const unsigned*>(kr + 16));
          }
        }
      }

      // online softmax of rows qd and qd + 8 over the warp's 16 keys: a quad holds a row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool live = key0 + nt * 8 + 2 * t4 + e <= k_end;
            s[nt][2 * r + e] = live ? s[nt][2 * r + e] * scale : -INFINITY;
            mx = fmaxf(mx, s[nt][2 * r + e]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[r], mx);  // finite: the warp's first key is live
        const float alpha = expf(m_r[r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[nt][2 * r + e] = expf(s[nt][2 * r + e] - m_new);
            sum += s[nt][2 * r + e];
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_r[r] = l_r[r] * alpha + sum;
        m_r[r] = m_new;
#pragma unroll
        for (int nt = 0; nt < kMmaMaxD / 8; ++nt) acc[nt][2 * r] *= alpha, acc[nt][2 * r + 1] *= alpha;
      }

      // P [16 rows, 16 keys] as A fragments in three pieces: the accumulator layout of the two key
      // tiles is the A layout of one k16 step (a0: row qd, keys 2 t4..; a1: row qd + 8; a2, a3: keys + 8)
      unsigned pa[3][4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        float x = s[f >> 1][(f & 1) * 2], y = s[f >> 1][(f & 1) * 2 + 1];
#pragma unroll
        for (int piece = 0; piece < 3; ++piece) pa[piece][f] = Mma<T>::round_pair(x, y);
      }
#pragma unroll
      for (int np = 0; np < kMmaMaxD / 16; ++np) {  // 16 channels a step
        if (np < ksteps) {
          unsigned b0, b1, b2, b3;
          ldmatrix_x4_trans(b0, b1, b2, b3, vb + vrow * lay.pitch + (np * 16 + vcol) * 2);
#pragma unroll
          for (int piece = 0; piece < 3; ++piece) {
            Mma<T>::mma(acc[2 * np], pa[piece], b0, b1);
            Mma<T>::mma(acc[2 * np + 1], pa[piece], b2, b3);
          }
        }
      }
    }
  }

  // the four warps' (m, l, acc), merged in warp order into the block's partial result
  __syncthreads();  // the ring is free
  float* m_w = reinterpret_cast<float*>(ring);  // [warp][16]
  float* l_w = m_w + kWarps * kMaxGroup;         // [warp][16]
  float* acc_w = l_w + kWarps * kMaxGroup;       // [warp][16][D]
  if (t4 == 0) {
    m_w[warp * kMaxGroup + qd] = m_r[0], m_w[warp * kMaxGroup + qd + 8] = m_r[1];
    l_w[warp * kMaxGroup + qd] = l_r[0], l_w[warp * kMaxGroup + qd + 8] = l_r[1];
  }
#pragma unroll
  for (int nt = 0; nt < kMmaMaxD / 8; ++nt) {
    if (nt < D / 8) {
      float* a = acc_w + (warp * kMaxGroup + qd) * D + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(a) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(a + 8 * D) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();
  if (k_begin <= k_end) {
    for (int i = tid; i < gc * D; i += kThreads) {
      const int g = i / D, c = i % D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w * kMaxGroup + g]);  // finite: warp 0 has keys
      float l = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(m_w[w * kMaxGroup + g] - mx);  // 0 for a warp without keys
        l += e * l_w[w * kMaxGroup + g];
        a += e * acc_w[(w * kMaxGroup + g) * D + c];
      }
      part_acc[((row0 + g) * num_splits + split) * D + c] = a;
      if (c == 0) {
        float* ml = part_ml + ((row0 + g) * num_splits + split) * 2;
        ml[0] = mx, ml[1] = l;
      }
    }
  }
  __syncthreads();  // the merge is read before the combine's weights overwrite the ring
  join_splits<T>(part_acc, part_ml, tickets, out, reinterpret_cast<float*>(ring), l_s, flag, pair, num_splits,
                 n_keys > 0 ? (n_keys + run - 1) / run : 0, gc, D, row0);
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

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int32_t* table, const int32_t* cur,
                   void* out, float* part, int* tickets, int batch, int heads, int kv_heads, int dim,
                   int num_blocks, int bs, int max_blocks, int num_splits, float scale, int window,
                   cudaStream_t stream) {
  const int chunks = (heads / kv_heads + kMaxGroup - 1) / kMaxGroup;
  const dim3 grid(batch * kv_heads * chunks, num_splits);
  if constexpr (!std::is_same<T, float>::value) {
    if (dim <= kMmaMaxD) {  // 16 bits at D <= 128: the tensor-core kernel
      auto kernel = paged_decode_mma<T>;
      static const cudaError_t attr =  // once a dtype: let the kernel take the card's whole shared memory
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit());
      if (attr != cudaSuccess) return attr;
      const int stage_bytes = mma_layout(dim, 1, 0, 0).stage_bytes;
      int stages = min(kMaxStages, max(2, kMmaRingBudget / stage_bytes));
      while (stages > 2 && mma_layout(dim, stages, num_splits, max_blocks).total > smem_limit()) --stages;
      const int smem = mma_layout(dim, stages, num_splits, max_blocks).total;
      if (smem > smem_limit()) return cudaErrorInvalidValue;
      kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(kp),
                                               static_cast<const T*>(vp), table, cur, static_cast<T*>(out), part,
                                               tickets, batch, heads, kv_heads, dim, num_blocks, bs, max_blocks,
                                               num_splits, stages, scale, window);
      return cudaGetLastError();
    }
  }
  auto kernel = paged_decode_kernel<T>;
  static const cudaError_t attr =  // once a dtype: let the kernel take the card's whole shared memory
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit());
  if (attr != cudaSuccess) return attr;
  const int gmax = min(heads / kv_heads, kMaxGroup);
  int stages = kMaxStages;
  while (stages > 2 && layout(sizeof(T), dim, gmax, stages, num_splits, max_blocks).total > smem_limit()) --stages;
  const Layout lay = layout(sizeof(T), dim, gmax, stages, num_splits, max_blocks);
  if (lay.total > smem_limit()) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, lay.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table, cur,
      static_cast<T*>(out), part, tickets, batch, heads, kv_heads, dim, num_blocks, bs, max_blocks, num_splits,
      stages, scale, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. window <= 0: no band.
// Grid (batch * kv_heads * ceil(G / 16), num_splits), G = heads / kv_heads:
// each row's live keys are cut into num_splits equal runs. Scratch (f32):
// acc [batch * heads * num_splits * head_dim], then (m, l) [batch * heads *
// num_splits * 2]. tickets: batch * kv_heads * ceil(G / 16) ints, 0 on entry
// and left 0. Every pointer 16-byte aligned. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int paged_decode_attention(const void* q, const void* key_pool, const void* value_pool,
                                      const int32_t* block_table, const int32_t* cur, void* out, float* scratch,
                                      int* tickets, int dtype, int batch, int heads, int kv_heads, int head_dim,
                                      int num_blocks, int block_size, int max_blocks, int num_splits, float scale,
                                      int window, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || block_size <= 0 || max_blocks <= 0 ||
      num_blocks <= 0 || num_splits <= 0 || num_splits > kMaxSplits || dtype < 0 || dtype > 2 ||
      head_dim % 16 != 0 || head_dim < 16 || head_dim > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = dtype == 0 ? launch<float> : dtype == 1 ? launch<__nv_bfloat16> : launch<__half>;
  return (int)run(q, key_pool, value_pool, block_table, cur, out, scratch, tickets, batch, heads, kv_heads,
                  head_dim, num_blocks, block_size, max_blocks, num_splits, scale, window, s);
}
