// K1 for Hopper (sm_90a) in bf16 and fp16: the flash attention forward on
// TMA, wgmma and warp specialisation.
//
// Replaces the 16-bit path of the Pallas TPU kernel
// accelerate_tpu/ops/pallas_attention.py::_fwd_kernel (:89): out =
// softmax(q k^T * scale) v and the row log-sum-exp lse, online softmax in
// f32. f32 keeps flash_attention.cu's kernel (wgmma on f32 is TF32, which
// would change its numbers); K2 and K3 (flash_bwd_sm90.cu) read this
// kernel's out and lse. The Hopper primitives (mbarriers, TMA, wgmma, the
// masks) are sm90_common.cuh's, shared with K2 and K3.
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
// Head dims. The kernel is built at the widths D 64, 128 and 256; a head dim
// d (a multiple of 8) runs at the least of them that holds it. Its tensor
// maps are d columns wide, so TMA reads the columns past d as zeros (Q K^T
// stays exact, and the columns of O past d stay 0) and the stores stop at d:
// each thread stores column pairs of 8-column tiles, so a d of 40 (Stable
// Diffusion's) ends on a tile's edge, and its rows of 80 bytes keep the
// 16-byte alignment a tensor map's strides need.
//
// What the design does about it. A block is a producer warpgroup and one
// consumer warpgroup for each 64 query rows (three at D 64, two at D 128 and
// 256; see Smem). The producer gives up registers (setmaxnreg); one of its threads
// loads Q once and then the K tiles of 128 keys (64 at D 256), another the
// V tiles, each
// through its own ring of two stages with a full and an empty mbarrier a
// stage, all as TMA loads. TMA swizzles each 64-column box 128 bytes wide (D
// 128: two boxes a row, D 256 four) and zero-fills rows past S and columns
// past d, so no thread computes an
// address or masks a load. The consumers take the producer's registers: S =
// Q K^T is one wgmma.mma_async m64n128k16 (m64n64k16 at D 256) chain with
// both operands read from
// shared memory through descriptors (Q and K are K-major as stored); P,
// rounded to v's type, stays in registers as the A operand of O += P V (the
// m64 accumulator and the A fragment line up; at D 256 O is two halves of
// 128 columns, each its own m64n128k16 chain), and V is read MN-major
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
// 64-key tiles at D 64, and persistent blocks.

#include "sm90_common.cuh"

#include <type_traits>

namespace {

constexpr int kStages = 2;  // K and V tiles in flight

// A block: warpgroup 0 produces, the others consume, 64 query rows each.
// D 64: three consumers (192 rows), so each K and V tile serves more rows and
// each scheduler has three warps whose softmax hides the others' latency;
// D 128: two, which the registers allow; D 256 two as well, on K and V tiles
// of 64 keys, since O alone is 128 f32 a thread and Q with four stages of
// 128-key tiles would be 320 KB. Warpgroups trade registers with
// setmaxnreg: producer x 128 + consumer x 128 x consumers = 65,536, so the
// kernel must start with at least 65,536 / threads registers a thread.
//
// Shared memory (D 256: 193 KB): Q [D / 64][kRows][64], then K and V
// [kStages][D / 64][kKeys][64], each 64-column box 128-byte swizzled and
// 1024-byte aligned; then the mbarriers. 1024 bytes of slack align the base.
template <int D>
struct Smem {
  static constexpr int kKeys = D > 128 ? 64 : 128;  // keys of a K or V tile
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
  void* out;   // [B, Sq, H, d] contiguous, q's type
  float* lse;  // [B, H, Sq]
  int h, hkv, sq, sk, d;  // d: the head dim, at most the built width
  float scale;
  int causal, window;  // window 0: no band
};

// The built width a head dim runs at.
int width_of(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

int rows_of(int d) { return width_of(d) == 64 ? Smem<64>::kRows : Smem<128>::kRows; }

dim3 grid_of(int b, int h, int sq, int d) { return dim3(b * h, (sq + rows_of(d) - 1) / rows_of(d)); }

// ---------------------------------------------------------------------------
// a consumer warpgroup's steps
// ---------------------------------------------------------------------------

// The online softmax of one tile of scores, in the log2 domain: s becomes P,
// the row max m and row sum l move on, corr is what O must be scaled by.
// `row` is the thread's first row (its second is row + 8), `col` its first
// column of the tile (then + 1, and each 8-column tile on).
template <int kKeys>
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

// The producer: lane 0 of warp 0 loads Q once, then it streams the K tiles
// of the live key tiles lo .. lo + n - 1 and lane 0 of warp 1 the V tiles
// (stream_kv).
template <int D>
__device__ __forceinline__ void produce(const Ring<D>& ring, const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int q0, int h, int hk, int b, int lo, int n) {
  if (threadIdx.x == 0) {
    mbar_expect_tx(ring.q_full(), Smem<D>::kQ);
    for (int c = 0; c < D / kBoxCols; ++c)
      tma_load(ring.q + c * Smem<D>::kRows * kRowBytes, tq, ring.q_full(), c * kBoxCols, q0, h, b);
  }
  stream_kv<kStages, D>(ring, tk, tv, hk, b, lo, n, Smem<D>::kKeys, Smem<D>::kKV);
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
  constexpr int kKeys = Smem<D>::kKeys;
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const bool leader = (tid & 127) == 0;
  const int r0 = q0 + cw * 64, row = r0 + warp * 16 + g;
  const uint32_t q_tile = ring.q + cw * 64 * kRowBytes;
  int clo, chi;
  live_key_tiles(r0, 64, kKeys, p, &clo, &chi);
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
  for (int i = 0; i < i0; ++i) release_kv<kStages>(ring, i, leader);
  if (i1 > i0) {
    // tile i0: S, then its softmax
    const int st0 = i0 % kStages, k00 = (lo + i0) * kKeys;
    mbar_wait(ring.k_full(st0), (i0 / kStages) & 1);
    issue_ss<T, D, kKeys>(s, q_tile, Smem<D>::kRows, ring.k_tile(st0), kKeys);  // S = Q K^T
    wgmma_wait_all();
    pin(s);
    mbar_arrive_if(ring.k_empty(st0), leader);
    softmax_step<kKeys>(s, m, l, corr, row, k00 + 2 * t, tile_full(r0, 64, k00, kKeys, p), sl2, p);
    acc_to_afrags<T, kKeys / 16>(pf, s);  // P, rounded to v's type
    for (int i = i0 + 1; i < i1; ++i) {  // tile i's S, then tile i - 1's P V behind it
      const int st = i % kStages, pst = (i - 1) % kStages, k0 = (lo + i) * kKeys;
      mbar_wait(ring.k_full(st), (i / kStages) & 1);
      mbar_wait(ring.v_full(pst), ((i - 1) / kStages) & 1);
      issue_ss<T, D, kKeys>(s, q_tile, Smem<D>::kRows, ring.k_tile(st), kKeys);
      issue_rs<T, D, kKeys / 16>(o, pf, ring.v_tile(pst), kKeys);  // O += P V
      wgmma_wait<1>();  // S done, P V in flight
      pin(s);
      mbar_arrive_if(ring.k_empty(st), leader);
      softmax_step<kKeys>(s, m, l, corr, row, k0 + 2 * t, tile_full(r0, 64, k0, kKeys, p), sl2, p);
      wgmma_wait_all();
      pin(o);
      pin(pf);
      mbar_arrive_if(ring.v_empty(pst), leader);
      scale_rows<D>(o, corr);
      acc_to_afrags<T, kKeys / 16>(pf, s);
    }
    const int pst = (i1 - 1) % kStages;  // the last tile's P V
    mbar_wait(ring.v_full(pst), ((i1 - 1) / kStages) & 1);
    issue_rs<T, D, kKeys / 16>(o, pf, ring.v_tile(pst), kKeys);
    wgmma_wait_all();
    pin(o);
    pin(pf);
    mbar_arrive_if(ring.v_empty(pst), leader);
  }
  for (int i = i1; i < n; ++i) release_kv<kStages>(ring, i, leader);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= p.sq) continue;
    const float lv = fmaxf(l[r], 1e-37f);
    T* orow = static_cast<T*>(p.out) + (((long long)b * p.sq + rr) * p.h + h) * p.d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j * 8 < p.d) store2(orow + j * 8 + 2 * t, o[j][2 * r] / lv, o[j][2 * r + 1] / lv);
    }
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
  live_key_tiles(q0, Smem<D>::kRows, Smem<D>::kKeys, p, &lo, &hi);
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
// host: the launch
// ---------------------------------------------------------------------------

// The producer/consumer register split fits what the kernel starts with
// (sm90_common.cuh), checked once per instantiation.
template <typename T, int D>
cudaError_t regs_ok() {
  using S = Smem<D>;
  static const cudaError_t ok = registers_suffice(reinterpret_cast<const void*>(flash_fwd_wgmma<T, D>), S::kThreads,
                                                  S::kProducerRegs, S::kConsumers, S::kConsumerRegs);
  return ok;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const Args& a, int b, int sq, int sk,
           const long long* strides, cudaStream_t stream) {
  constexpr CUtensorMapDataType type =
      std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  CUresult r = encode(&tq, type, q, b, sq, a.h, a.d, strides, Smem<D>::kRows);
  if (r == CUDA_SUCCESS) r = encode(&tk, type, k, b, sk, a.hkv, a.d, strides + 3, Smem<D>::kKeys);
  if (r == CUDA_SUCCESS) r = encode(&tv, type, v, b, sk, a.hkv, a.d, strides + 6, Smem<D>::kKeys);
  if (r != CUDA_SUCCESS) return -(int)r;  // a CUresult of cuTensorMapEncodeTiled, negated
  cudaError_t err = regs_ok<T, D>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wgmma<T, D><<<grid_of(b, a.h, sq, D), Smem<D>::kThreads, Smem<D>::kBytes, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

bool bad_config(int dtype, int b, int h, int sq, int d) {
  return (dtype != 1 && dtype != 2) || d < 16 || d > 256 || d % 8 != 0 || b <= 0 || h <= 0 || sq <= 0 ||
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
  const Args a = {out, lse, h, hkv, sq, sk, d, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = width_of(d);
  if (dtype == 1) {
    if (w == 64) return launch<__nv_bfloat16, 64>(q, k, v, a, b, sq, sk, strides, s);
    if (w == 128) return launch<__nv_bfloat16, 128>(q, k, v, a, b, sq, sk, strides, s);
    return launch<__nv_bfloat16, 256>(q, k, v, a, b, sq, sk, strides, s);
  }
  if (w == 64) return launch<__half, 64>(q, k, v, a, b, sq, sk, strides, s);
  if (w == 128) return launch<__half, 128>(q, k, v, a, b, sq, sk, strides, s);
  return launch<__half, 256>(q, k, v, a, b, sq, sk, strides, s);
}

// What flash_fwd_sm90 launches for these shapes: out[0..1] grid x, y,
// out[2] threads a block, out[3] dynamic shared memory bytes.
extern "C" int flash_fwd_sm90_config(int dtype, int b, int h, int sq, int d, int* out) {
  if (bad_config(dtype, b, h, sq, d)) return (int)cudaErrorInvalidValue;
  const dim3 g = grid_of(b, h, sq, d);
  out[0] = (int)g.x;
  out[1] = (int)g.y;
  const int w = width_of(d);
  out[2] = w == 64 ? Smem<64>::kThreads : w == 128 ? Smem<128>::kThreads : Smem<256>::kThreads;
  out[3] = w == 64 ? Smem<64>::kBytes : w == 128 ? Smem<128>::kBytes : Smem<256>::kBytes;
  return 0;
}
