// K2 and K3 for Hopper (sm_90a) in bf16 and fp16: the flash attention
// backward on TMA, wgmma and warp specialisation.
//
// Replaces the 16-bit paths of the Pallas TPU kernels
// accelerate_tpu/ops/pallas_attention.py::_dq_kernel (:177), here K2
// flash_dq_wgmma: dq = sum_k dS k, and ::_dkv_kernel (:210), here K3
// flash_dkv_wgmma: dv = sum_q P^T dO, dk = sum_q dS^T q, the query heads of a
// kv group summed. P = exp(s - lse) is recomputed from K1's lse, dS = P (dP -
// delta) scale with dP = dO v^T and delta = rowsum(dO * out). f32 keeps
// flash_attention.cu's kernels (wgmma on f32 is TF32, which would change
// their numbers). Layout, masks and rounding points are flash_attention.cu's:
// q/dO [B, Sq, H, D] and k/v [B, Sk, Hkv, D] read through their strides (dO
// contiguous), lse/delta [B, H, Sq] f32, dq [B, Sq, H, D] f32, dk/dv [B, Sk,
// Hkv, D] f32; causal aligned bottom-right, the band keeps keys > i + Sk - Sq
// - window, a dead row (lse -inf) gives P = 0; P is rounded to dO's type
// before P^T dO, dS to k's type before dS k and to q's type before dS^T q,
// and every product accumulates in f32.
//
// What bounds it. At the training shape (B 8, H 32, Hkv 4, S 2048, D 64,
// causal) K2's three products are about 206 GFLOP and K3's four 275, against
// well under 200 MB of HBM traffic each: the tensor cores bound both (0.21
// and 0.28 ms at 989 TFLOP/s). Each computes one exp2 a live (query, key)
// pair against 6 D (K2) or 8 D (K3) tensor-core FLOPs.
//
// What the design does about it: K1's (flash_fwd_sm90.cu), whose primitives
// sm90_common.cuh shares. A block is a producer warpgroup and consumer
// warpgroups of 64 rows each; the producer gives up registers (setmaxnreg)
// and loads every tile by TMA (128-byte swizzle, rows past S read as zeros)
// into rings of two stages with a full and an empty mbarrier a stage; every
// product is a wgmma chain with no operand copied by hand.
//  K2, consumers own query rows (three at D 64, two at D 128): one producer
//   thread loads the block's Q and dO once and then the K tiles of 64 keys,
//   another the V tiles. S = Q K^T and dP = dO V^T read both operands K-major
//   from shared memory; P and dS are computed in registers from each row's
//   lse and delta (read once), and dS, rounded to k's type, is the A operand
//   of dQ += dS K, K read MN-major through the descriptor's transpose bit.
//  K3, consumers own key rows (two: 128 f32 of dK and dV a thread at D 128):
//   the block's K and V are loaded once; one producer thread streams the Q
//   and dO tiles of 64 queries over groups x live query tiles, and one
//   producer warp writes each tile's lse (in the log2 domain) and delta beside
//   them. In the transposed orientation S^T = K Q^T and dP^T = V dO^T read
//   both operands K-major; P^T and dS^T, rounded in registers, are the A
//   operands of dV += P^T dO and dK += dS^T Q, dO and Q read MN-major: one
//   TMA-loaded tile serves both ways, as K1's K and V do. The G query heads
//   of a kv group are summed in registers: no [B, H, Sk, D] intermediate and
//   no atomics, so results repeat bit for bit from run to run.
// Within a consumer a tile's products run in order, each group retired
// before the next tile; the consumers run out of step, so one's exp2 and
// rounding overlap another's products. Issuing the last tile's dQ (dK)
// behind the next tile's S and dP, so that it runs during the next tile's
// exp2, was slower at every shape measured, dQ as an SS product through
// shared memory slower still, and three stages or three K3 consumers no
// faster at the training shape (PERF.md). Each consumer walks only the
// tiles live for its own 64 rows and releases the others unread, the
// per-element mask runs only on tiles that are not full, and blocks take
// the heaviest causal tiles first. It allocates nothing and launches on the
// caller's stream.

#include "sm90_common.cuh"

#include <type_traits>

namespace {

constexpr int kTile = 64;   // keys of a K2 K or V tile; queries of a K3 Q or dO tile
constexpr int kStages = 2;  // tiles in flight

struct Args {
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  float* dq;           // [B, Sq, H, D]
  float* dk;           // [B, Sk, Hkv, D]
  float* dv;           // [B, Sk, Hkv, D]
  int h, hkv, sq, sk;
  float scale;
  int causal, window;  // window 0: no band
};

// K2's block: warpgroup 0 produces, the others consume, 64 query rows each;
// the register split is K1's (producer x 128 + consumer x 128 x consumers =
// 65,536). At D 64 two consumers were 19% slower than three, and 128-key
// tiles (two consumers) 25% slower than 64 (PERF.md). Shared memory: Q and dO [D / 64][kRows][64] each, then K and V
// [kStages][D / 64][kTile][64], each 64-column box 128-byte swizzled and
// 1024-byte aligned; then the mbarriers. 1024 bytes of slack align the base.
template <int D>
struct DqSmem {
  static constexpr int kConsumers = D == 64 ? 3 : 2;
  static constexpr int kRows = 64 * kConsumers;  // query rows a block owns
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = kConsumers == 2 ? 24 : 32;
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
  static constexpr int kQ = kRows * D * 2;   // Q (or dO) of the block
  static constexpr int kKV = kTile * D * 2;  // one stage of K (or V)
  static constexpr int kBars = 2 * kQ + 2 * kStages * kKV;
  static constexpr int kBytes = 1024 + kBars + (1 + 4 * kStages) * 8;
};

// K3's block: two consumers, 64 key rows each (128 f32 of dK and dV a thread
// at D 128 beside S^T and dP^T: 240 registers). Shared memory: K and V
// [D / 64][kRows][64] each, then Q and dO [kStages][D / 64][kTile][64], then
// lse and delta [kStages][2][kTile] f32, then the mbarriers.
template <int D>
struct DkvSmem {
  static constexpr int kConsumers = 2;
  static constexpr int kRows = 64 * kConsumers;  // key rows a block owns
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kK = kRows * D * 2;      // K (or V) of the block
  static constexpr int kQ = kTile * D * 2;      // one stage of Q (or dO)
  static constexpr int kStats = 2 * kTile * 4;  // one stage of lse and delta
  static constexpr int kStatsAt = 2 * kK + 2 * kStages * kQ;
  static constexpr int kBars = kStatsAt + kStages * kStats;
  static constexpr int kBytes = 1024 + kBars + (1 + 2 * kStages) * 8;
};

int dq_rows(int d) { return d == 64 ? DqSmem<64>::kRows : DqSmem<128>::kRows; }
dim3 dq_grid(int b, int h, int sq, int d) { return dim3(b * h, (sq + dq_rows(d) - 1) / dq_rows(d)); }
dim3 dkv_grid(int b, int hkv, int sk) { return dim3(b * hkv, (sk + DkvSmem<64>::kRows - 1) / DkvSmem<64>::kRows); }

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------

template <int D>
struct DqRing {
  using S = DqSmem<D>;
  uint32_t q, dout, k, v, bars;
  __device__ explicit DqRing(uint32_t base)
      : q(base), dout(base + S::kQ), k(base + 2 * S::kQ), v(base + 2 * S::kQ + kStages * S::kKV), bars(base + S::kBars) {}
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t k_full(int st) const { return bars + 8 * (1 + st); }
  __device__ uint32_t k_empty(int st) const { return bars + 8 * (1 + kStages + st); }
  __device__ uint32_t v_full(int st) const { return bars + 8 * (1 + 2 * kStages + st); }
  __device__ uint32_t v_empty(int st) const { return bars + 8 * (1 + 3 * kStages + st); }
  __device__ uint32_t k_tile(int st) const { return k + st * S::kKV; }
  __device__ uint32_t v_tile(int st) const { return v + st * S::kKV; }
};

// The producer: lane 0 of warp 0 loads Q and dO once, then it streams the K
// tiles of the live key tiles lo .. lo + n - 1 and lane 0 of warp 1 the V
// tiles (stream_kv, as K1's).
template <int D>
__device__ __forceinline__ void dq_produce(const DqRing<D>& ring, const CUtensorMap* tq, const CUtensorMap* tdo,
                                           const CUtensorMap* tk, const CUtensorMap* tv, int q0, int h, int hk, int b,
                                           int lo, int n) {
  using S = DqSmem<D>;
  if (threadIdx.x == 0) {
    mbar_expect_tx(ring.q_full(), 2 * S::kQ);
    for (int c = 0; c < D / kBoxCols; ++c) {
      tma_load(ring.q + c * S::kRows * kRowBytes, tq, ring.q_full(), c * kBoxCols, q0, h, b);
      tma_load(ring.dout + c * S::kRows * kRowBytes, tdo, ring.q_full(), c * kBoxCols, q0, h, b);
    }
  }
  stream_kv<kStages, D>(ring, tk, tv, hk, b, lo, n, kTile, S::kKV);
}

// A consumer warpgroup: query rows r0 = q0 + 64 cw .. + 63. The block loads
// its n live key tiles from lo; the consumer computes those live for its own
// rows and releases the others unread. Per tile: S and dP issued as two
// groups; P from lse while dP is on the tensor cores; dS, rounded to k's
// type, into dQ += dS K. V is released once dP is done, K once dQ is. Every
// group is retired before the loop's back edge: an accumulator in flight
// across it made ptxas serialise every wgmma.
template <typename T, int D>
__device__ __forceinline__ void dq_consume(const DqRing<D>& ring, const Args& p, int cw, int q0, int b, int h, int lo,
                                           int n) {
  using S = DqSmem<D>;
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const bool leader = (tid & 127) == 0;
  const int r0 = q0 + cw * 64, row = r0 + warp * 16 + g;
  const uint32_t q_tile = ring.q + cw * 64 * kRowBytes, do_tile = ring.dout + cw * 64 * kRowBytes;
  int clo, chi;
  live_key_tiles(r0, 64, kTile, p, &clo, &chi);
  if (r0 >= p.sq) chi = clo - 1;  // rows past Sq: nothing to compute, nothing stored
  const int i0 = min(max(clo - lo, 0), n), i1 = min(max(chi - lo + 1, i0), n);  // its tiles: block tiles i0 .. i1 - 1

  float lse2[2], dlt[2];  // per row: lse in the log2 domain (-inf: dead row), delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    const long long at = ((long long)b * p.h + h) * p.sq + rr;
    lse2[r] = rr < p.sq ? p.lse[at] * kLog2e : -INFINITY;
    dlt[r] = rr < p.sq ? p.delta[at] : 0.f;
  }
  float dq[D / 8][4], s[kTile / 8][4], dp[kTile / 8][4];
  unsigned dsf[kTile / 16][4] = {};
  zero(dq);
  const float sl2 = p.scale * kLog2e;

  mbar_wait(ring.q_full(), 0);
  for (int i = 0; i < i0; ++i) release_kv<kStages>(ring, i, leader);
  for (int i = i0; i < i1; ++i) {
    const int st = i % kStages, ph = (i / kStages) & 1, k0 = (lo + i) * kTile;
    mbar_wait(ring.k_full(st), ph);
    issue_ss<T, D, kTile>(s, q_tile, S::kRows, ring.k_tile(st), kTile);  // S = Q K^T
    mbar_wait(ring.v_full(st), ph);
    issue_ss<T, D, kTile>(dp, do_tile, S::kRows, ring.v_tile(st), kTile);  // dP = dO V^T
    wgmma_wait<1>();  // S done, dP in flight
    pin(s);
    const bool full = tile_full(r0, 64, k0, kTile, p);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = lse2[r] != -INFINITY && (full || is_valid(row + 8 * r, k0 + j * 8 + 2 * t + (e & 1), p));
        s[j][e] = ok ? fast_exp2(s[j][e] * sl2 - lse2[r]) : 0.f;  // P
      }
    }
    wgmma_wait<0>();
    pin(dp);
    mbar_arrive_if(ring.v_empty(st), leader);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dlt[e >> 1]) * p.scale;  // dS
    }
    acc_to_afrags<T, kTile / 16>(dsf, dp);                         // rounded to k's type
    issue_rs<T, D, kTile / 16>(dq, dsf, ring.k_tile(st), kTile);  // dQ += dS K
    wgmma_wait<0>();
    pin(dq);
    pin(dsf);
    mbar_arrive_if(ring.k_empty(st), leader);
  }
  for (int i = i1; i < n; ++i) release_kv<kStages>(ring, i, leader);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= p.sq) continue;
    float* drow = p.dq + (((long long)b * p.sq + rr) * p.h + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(drow + j * 8 + 2 * t, dq[j][2 * r], dq[j][2 * r + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(DqSmem<D>::kThreads, 1)
    flash_dq_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv, const Args p) {
  using S = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const DqRing<D> ring((smem_u32(smem_raw) + 1023u) & ~1023u);
  // the role as a warp-uniform value: ptxas then sees each warpgroup's path as
  // convergent, keeps the wgmma ops asynchronous and honours setmaxnreg
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int b = blockIdx.x / p.h, h = blockIdx.x % p.h, hk = h / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * S::kRows;  // heaviest causal tiles first
  int lo, hi;
  live_key_tiles(q0, S::kRows, kTile, p, &lo, &hi);
  const int n = max(hi - lo + 1, 0);  // 0: no live key for any row of the block

  if (threadIdx.x == 0) {
    mbar_init(ring.q_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(ring.k_full(st), 1);
      mbar_init(ring.v_full(st), 1);
      mbar_init(ring.k_empty(st), S::kConsumers);  // one arrival from each consumer releases a stage
      mbar_init(ring.v_empty(st), S::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: two threads issue every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    dq_produce<D>(ring, &tq, &tdo, &tk, &tv, q0, h, hk, b, lo, n);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
    dq_consume<T, D>(ring, p, wg - 1, q0, b, h, lo, n);
  }
}

// ---------------------------------------------------------------------------
// K3: dk, dv
// ---------------------------------------------------------------------------

template <int D>
struct DkvRing {
  using S = DkvSmem<D>;
  uint32_t k, v, q, dout, bars;
  float* stats;  // the same shared memory as a generic pointer: [kStages][lse, delta][kTile]
  __device__ DkvRing(uint32_t base, unsigned char* base_ptr)
      : k(base), v(base + S::kK), q(base + 2 * S::kK), dout(base + 2 * S::kK + kStages * S::kQ),
        bars(base + S::kBars), stats(reinterpret_cast<float*>(base_ptr + S::kStatsAt)) {}
  __device__ uint32_t kv_full() const { return bars; }
  __device__ uint32_t full(int st) const { return bars + 8 * (1 + st); }
  __device__ uint32_t empty(int st) const { return bars + 8 * (1 + kStages + st); }
  __device__ uint32_t q_tile(int st) const { return q + st * S::kQ; }
  __device__ uint32_t do_tile(int st) const { return dout + st * S::kQ; }
  __device__ float* lse2(int st) const { return stats + st * 2 * kTile; }
  __device__ float* delta(int st) const { return stats + st * 2 * kTile + kTile; }
};

// The producer: lane 0 of warp 0 loads the block's K and V once, then for
// each of groups x n_q iterations (query head hk * groups + it / n_q, query
// tile lo + it % n_q) the Q and dO tiles into stage it % kStages; warp 1
// writes that tile's lse (times log2 e; -inf past Sq) and delta (0 past Sq)
// into the same stage, each lane arriving on its full barrier.
template <int D>
__device__ __forceinline__ void dkv_produce(const DkvRing<D>& ring, const CUtensorMap* tk, const CUtensorMap* tv,
                                            const CUtensorMap* tq, const CUtensorMap* tdo, const Args& p, int k0,
                                            int hk, int b, int lo, int n_q) {
  using S = DkvSmem<D>;
  constexpr int kChunks = D / kBoxCols;
  const int tid = threadIdx.x, groups = p.h / p.hkv, n_iter = groups * n_q;
  if (tid == 0) {
    mbar_expect_tx(ring.kv_full(), 2 * S::kK);
    for (int c = 0; c < kChunks; ++c) {
      tma_load(ring.k + c * S::kRows * kRowBytes, tk, ring.kv_full(), c * kBoxCols, k0, hk, b);
      tma_load(ring.v + c * S::kRows * kRowBytes, tv, ring.kv_full(), c * kBoxCols, k0, hk, b);
    }
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % kStages, hh = hk * groups + it / n_q, q0 = (lo + it % n_q) * kTile;
      mbar_wait(ring.empty(st), ((it / kStages) & 1) ^ 1);  // the first round passes
      mbar_expect_tx(ring.full(st), 2 * S::kQ);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(ring.q_tile(st) + c * kTile * kRowBytes, tq, ring.full(st), c * kBoxCols, q0, hh, b);
        tma_load(ring.do_tile(st) + c * kTile * kRowBytes, tdo, ring.full(st), c * kBoxCols, q0, hh, b);
      }
    }
  } else if (tid >= 32 && tid < 64) {
    for (int it = 0; it < n_iter; ++it) {
      const int st = it % kStages, hh = hk * groups + it / n_q, q0 = (lo + it % n_q) * kTile;
      mbar_wait(ring.empty(st), ((it / kStages) & 1) ^ 1);
      for (int r = tid - 32; r < kTile; r += 32) {
        const int qr = q0 + r;
        const long long at = ((long long)b * p.h + hh) * p.sq + qr;
        ring.lse2(st)[r] = qr < p.sq ? p.lse[at] * kLog2e : -INFINITY;
        ring.delta(st)[r] = qr < p.sq ? p.delta[at] : 0.f;
      }
      mbar_arrive_if(ring.full(st), true);  // release: the consumers' wait sees these writes
    }
  }
}

// A consumer warpgroup: key rows kc = k0 + 64 cw .. + 63. Of each group's
// query tiles lo .. lo + n_q - 1 it computes those live for its own keys and
// releases the others unread. Per tile: S^T and dP^T issued as two groups;
// P^T from lse into dV += P^T dO while dP^T finishes; then dS^T into dK +=
// dS^T Q. The stage is released once its dV and dK are done.
template <typename T, int D>
__device__ __forceinline__ void dkv_consume(const DkvRing<D>& ring, const Args& p, int cw, int k0, int b, int hk,
                                            int lo, int n_q) {
  using S = DkvSmem<D>;
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const bool leader = (tid & 127) == 0;
  const int kc = k0 + cw * 64, key = kc + warp * 16 + g, n_iter = (p.h / p.hkv) * n_q;
  const uint32_t k_tile = ring.k + cw * 64 * kRowBytes, v_tile = ring.v + cw * 64 * kRowBytes;
  int clo = lo, chi = lo + n_q - 1;  // its live query tiles
  if (kc >= p.sk) chi = clo - 1;     // keys past Sk: nothing to compute, nothing stored
  const int kn = min(64, p.sk - kc);
  while (clo <= chi && !tile_live(clo * kTile, kTile, kc, kn, p)) ++clo;
  while (chi >= clo && !tile_live(chi * kTile, kTile, kc, kn, p)) --chi;

  float dk[D / 8][4], dv[D / 8][4], s[kTile / 8][4], dp[kTile / 8][4];
  unsigned pf[kTile / 16][4] = {}, dsf[kTile / 16][4] = {};
  zero(dk);
  zero(dv);
  const float sl2 = p.scale * kLog2e;
  mbar_wait(ring.kv_full(), 0);
  for (int it = 0; it < n_iter; ++it) {
    const int qt = lo + it % n_q, st = it % kStages, ph = (it / kStages) & 1;
    mbar_wait(ring.full(st), ph);
    if (qt < clo || qt > chi) {  // not live for its keys: release the stage unread
      mbar_arrive_if(ring.empty(st), leader);
      continue;
    }
    const int q0 = qt * kTile;
    issue_ss<T, D, kTile>(s, k_tile, S::kRows, ring.q_tile(st), kTile);    // S^T = K Q^T
    issue_ss<T, D, kTile>(dp, v_tile, S::kRows, ring.do_tile(st), kTile);  // dP^T = V dO^T
    wgmma_wait<1>();  // S^T done, dP^T in flight
    pin(s);
    const float* ls = ring.lse2(st);
    const float* dl = ring.delta(st);
    const bool full = tile_full(q0, kTile, kc, 64, p);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const float l2 = ls[c];
        const bool ok = l2 != -INFINITY && (full || is_valid(q0 + c, key + 8 * (e >> 1), p));
        s[j][e] = ok ? fast_exp2(s[j][e] * sl2 - l2) : 0.f;  // P^T
      }
    }
    acc_to_afrags<T, kTile / 16>(pf, s);                          // rounded to dO's type
    issue_rs<T, D, kTile / 16>(dv, pf, ring.do_tile(st), kTile);  // dV += P^T dO
    wgmma_wait<1>();                                              // dP^T done, dV in flight
    pin(dp);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dl[j * 8 + 2 * t + (e & 1)]) * p.scale;  // dS^T
    }
    acc_to_afrags<T, kTile / 16>(dsf, dp);                        // rounded to q's type
    issue_rs<T, D, kTile / 16>(dk, dsf, ring.q_tile(st), kTile);  // dK += dS^T Q
    wgmma_wait<0>();
    pin(dk);
    pin(dv);
    pin(pf);
    pin(dsf);
    mbar_arrive_if(ring.empty(st), leader);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = key + 8 * r;
    if (kr >= p.sk) continue;
    const long long at = (((long long)b * p.sk + kr) * p.hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(p.dk + at + j * 8 + 2 * t, dk[j][2 * r], dk[j][2 * r + 1]);
      store2(p.dv + at + j * 8 + 2 * t, dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvSmem<D>::kThreads, 1)
    flash_dkv_wgmma(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo, const Args p) {
  using S = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023u) & ~1023u;
  const DkvRing<D> ring(base, smem_raw + (base - raw));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int b = blockIdx.x / p.hkv, hk = blockIdx.x % p.hkv;
  const int k0 = blockIdx.y * S::kRows;  // low keys see the most queries under causal: first
  // the query tiles live for some key of the block
  const int kn = min(S::kRows, p.sk - k0);
  int lo = 0, hi = (p.sq + kTile - 1) / kTile - 1;
  while (lo <= hi && !tile_live(lo * kTile, kTile, k0, kn, p)) ++lo;
  while (hi >= lo && !tile_live(hi * kTile, kTile, k0, kn, p)) --hi;
  const int n_q = max(hi - lo + 1, 0);

  if (threadIdx.x == 0) {
    mbar_init(ring.kv_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(ring.full(st), 1 + 32);  // the TMA thread's expect_tx and the stats warp's 32 lanes
      mbar_init(ring.empty(st), S::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues every load, one warp writes lse and delta
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    dkv_produce<D>(ring, &tk, &tv, &tq, &tdo, p, k0, hk, b, lo, n_q);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
    dkv_consume<T, D>(ring, p, wg - 1, k0, b, hk, lo, n_q);
  }
}

// ---------------------------------------------------------------------------
// host: the launches
// ---------------------------------------------------------------------------

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
}

// The four tensor maps of a launch: q, k and v through their strides (q and
// dO boxes `q_rows` deep, k and v `k_rows`), dO contiguous.
template <typename T, int D>
CUresult encode_all(CUtensorMap* tq, CUtensorMap* tdo, CUtensorMap* tk, CUtensorMap* tv, const void* q,
                    const void* k, const void* v, const void* dout, const Args& a, int b, const long long* strides,
                    int q_rows, int k_rows) {
  const long long do_strides[3] = {(long long)a.sq * a.h * D, (long long)a.h * D, D};
  CUresult r = encode(tq, map_type<T>(), q, b, a.sq, a.h, D, strides, q_rows);
  if (r == CUDA_SUCCESS) r = encode(tdo, map_type<T>(), dout, b, a.sq, a.h, D, do_strides, q_rows);
  if (r == CUDA_SUCCESS) r = encode(tk, map_type<T>(), k, b, a.sk, a.hkv, D, strides + 3, k_rows);
  if (r == CUDA_SUCCESS) r = encode(tv, map_type<T>(), v, b, a.sk, a.hkv, D, strides + 6, k_rows);
  return r;
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const Args& a, int b,
              const long long* strides, cudaStream_t stream) {
  using S = DqSmem<D>;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tdo, tk, tv;
  const CUresult r = encode_all<T, D>(&tq, &tdo, &tk, &tv, q, k, v, dout, a, b, strides, S::kRows, kTile);
  if (r != CUDA_SUCCESS) return -(int)r;  // a CUresult of cuTensorMapEncodeTiled, negated
  static const cudaError_t regs = registers_suffice(reinterpret_cast<const void*>(flash_dq_wgmma<T, D>), S::kThreads,
                                                    S::kProducerRegs, S::kConsumers, S::kConsumerRegs);
  cudaError_t err = regs;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_dq_wgmma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return (int)err;
  flash_dq_wgmma<T, D><<<dq_grid(b, a.h, a.sq, D), S::kThreads, S::kBytes, stream>>>(tq, tdo, tk, tv, a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const Args& a, int b,
               const long long* strides, cudaStream_t stream) {
  using S = DkvSmem<D>;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tdo, tk, tv;
  const CUresult r = encode_all<T, D>(&tq, &tdo, &tk, &tv, q, k, v, dout, a, b, strides, kTile, S::kRows);
  if (r != CUDA_SUCCESS) return -(int)r;
  static const cudaError_t regs = registers_suffice(reinterpret_cast<const void*>(flash_dkv_wgmma<T, D>), S::kThreads,
                                                    S::kProducerRegs, S::kConsumers, S::kConsumerRegs);
  cudaError_t err = regs;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_dkv_wgmma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_wgmma<T, D><<<dkv_grid(b, a.hkv, a.sk), S::kThreads, S::kBytes, stream>>>(tk, tv, tq, tdo, a);
  return (int)cudaGetLastError();
}

bool bad_config(int dtype, int b, int h, int hkv, int sq, int sk, int d) {
  return (dtype != 1 && dtype != 2) || (d != 64 && d != 128) || b <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 ||
         sq <= 0 || sk <= 0 || dq_grid(b, h, sq, d).y > 65535 || dkv_grid(b, hkv, sk).y > 65535;
}

enum Kind { kDq = 0, kDkv = 1 };

int run(Kind kind, const void* q, const void* k, const void* v, const void* dout, const Args& a, int dtype, int b,
        int d, const long long* strides, void* stream) {
  if (bad_config(dtype, b, a.h, a.hkv, a.sq, a.sk, d) || a.window < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kDq) {
    if (dtype == 1) return d == 64 ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, a, b, strides, s)
                                   : launch_dq<__nv_bfloat16, 128>(q, k, v, dout, a, b, strides, s);
    return d == 64 ? launch_dq<__half, 64>(q, k, v, dout, a, b, strides, s)
                   : launch_dq<__half, 128>(q, k, v, dout, a, b, strides, s);
  }
  if (dtype == 1) return d == 64 ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, a, b, strides, s)
                                 : launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, a, b, strides, s);
  return d == 64 ? launch_dkv<__half, 64>(q, k, v, dout, a, b, strides, s)
                 : launch_dkv<__half, 128>(q, k, v, dout, a, b, strides, s);
}

}  // namespace

// dtype 1 bf16, 2 f16 (f32 runs flash_attention.cu's flash_attention_dq and
// _dkv, with the same arguments); strides: 9 element strides (batch, seq,
// head) of q, k and v; dout, lse and delta contiguous. Each returns the
// launch's cudaError_t, or minus the CUresult when a tensor map cannot be
// encoded.
extern "C" int flash_dq_sm90(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                             const float* delta, float* dq, int dtype, int b, int h, int hkv, int sq, int sk, int d,
                             const long long* strides, float scale, int causal, int window, void* stream) {
  const Args a = {lse, delta, dq, nullptr, nullptr, h, hkv, sq, sk, scale, causal, window};
  return run(kDq, q, k, v, dout, a, dtype, b, d, strides, stream);
}

extern "C" int flash_dkv_sm90(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                              const float* delta, float* dk, float* dv, int dtype, int b, int h, int hkv, int sq,
                              int sk, int d, const long long* strides, float scale, int causal, int window,
                              void* stream) {
  const Args a = {lse, delta, nullptr, dk, dv, h, hkv, sq, sk, scale, causal, window};
  return run(kDkv, q, k, v, dout, a, dtype, b, d, strides, stream);
}

// What flash_dq_sm90 / flash_dkv_sm90 launch for these shapes: out[0..1]
// grid x, y, out[2] threads a block, out[3] dynamic shared memory bytes.
extern "C" int flash_dq_sm90_config(int dtype, int b, int h, int hkv, int sq, int sk, int d, int* out) {
  if (bad_config(dtype, b, h, hkv, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const dim3 g = dq_grid(b, h, sq, d);
  out[0] = (int)g.x;
  out[1] = (int)g.y;
  out[2] = d == 64 ? DqSmem<64>::kThreads : DqSmem<128>::kThreads;
  out[3] = d == 64 ? DqSmem<64>::kBytes : DqSmem<128>::kBytes;
  return 0;
}

extern "C" int flash_dkv_sm90_config(int dtype, int b, int h, int hkv, int sq, int sk, int d, int* out) {
  if (bad_config(dtype, b, h, hkv, sq, sk, d)) return (int)cudaErrorInvalidValue;
  const dim3 g = dkv_grid(b, hkv, sk);
  out[0] = (int)g.x;
  out[1] = (int)g.y;
  out[2] = d == 64 ? DkvSmem<64>::kThreads : DkvSmem<128>::kThreads;
  out[3] = d == 64 ? DkvSmem<64>::kBytes : DkvSmem<128>::kBytes;
  return 0;
}
