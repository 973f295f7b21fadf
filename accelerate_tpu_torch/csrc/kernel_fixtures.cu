// K8 for Hopper (sm_90a): the tile-walk kernels behind the kernel
// analyzer's seeded-defect fixtures.
//
// Replace the Pallas kernel bodies of
// accelerate_tpu/analysis/selfcheck.py::_kernel_fixtures (copy_kernel :1156,
// add_kernel :1159, _drifty_spec_kernel :1235), which its six fixtures
// (:1165-:1226) launch with deliberately defective BlockSpecs.
//
// A Pallas call evaluates its index maps at every grid step itself. Here
// the wrapper (kernels/fixtures.py) evaluates the declared maps once on the
// host into a table of tile origins, int32 [blocks][operands][2] (row and
// column of each tile's first element), and every block reads its tiles
// from that table: the card runs exactly the maps the analyzer judged,
// defects included. The table travels in the launch's own parameters (an
// Origins struct of kMaxBlocks x 3 x 2 int32 passed by value as
// __grid_constant__): no device buffer and no copy to the card, so a call is
// one operation on the stream, as a library call is. kMaxBlocks is 8 (192
// bytes; the fixtures launch 2 blocks): on the card tile_copy and tile_scale
// took about 10% longer with a table of 128 blocks (3,072 bytes; PERF.md).
// A tile that reaches past its tensor's edge is cut there
// (reads past it give 0, writes past it are dropped). All tensors f32,
// row-major [rows, cols].
//
//  tile_copy:  out tile = in tile, staged through dynamic shared memory: the
//              declaration's `stages` buffers each hold one in tile and one
//              out tile, stages x 2 x tile bytes a block (what TPU1001
//              reads). A block owns one tile, so it fills buffer 0. A request
//              over the card's per-block maximum is refused by
//              cudaFuncSetAttribute (or by the launch); that error is
//              returned and cleared from the last-error slot, so a later
//              launch is not failed by it.
//  tile_add:   out tile = a tile + d tile, in registers. `out` may be `a`
//              (the aliased fixture): blocks whose maps disagree then race.
//  tile_scale: out tile = 2 x in tile, in registers.
//
// What bounds them: launch latency. The fixtures move 16 KiB to 4 MiB a
// call; one block of 256 threads owns a tile, and nothing is overlapped.
// So the design keeps each call to one launch and nothing else.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8;  // blocks a launch's table holds
constexpr int kPer = 4;  // elements a thread of tile_add / tile_scale loads before it stores any

// int32 [blocks][operands][2] for up to kMaxBlocks blocks: tile_copy and tile_scale 2 operands a block, tile_add 3
struct Origins {
  int v[kMaxBlocks * 3 * 2];
};

__device__ __forceinline__ bool inside(int r, int c, int rows, int cols) {
  return r >= 0 && c >= 0 && r < rows && c < cols;
}

__global__ void __launch_bounds__(kThreads)
    tile_copy_kernel(const float* __restrict__ x, float* __restrict__ out, const __grid_constant__ Origins origins,
                     int rows, int cols, int tr, int tc) {
  extern __shared__ __align__(16) float staged[];
  const int n = tr * tc;
  float* in_buf = staged;       // buffer 0: the in tile
  float* out_buf = staged + n;  // buffer 0: the out tile
  const int* o = origins.v + blockIdx.x * 4;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = o[0] + i / tc, c = o[1] + i % tc;
    in_buf[i] = inside(r, c, rows, cols) ? x[(size_t)r * cols + c] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) out_buf[i] = in_buf[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = o[2] + i / tc, c = o[3] + i % tc;
    if (inside(r, c, rows, cols)) out[(size_t)r * cols + c] = out_buf[i];
  }
}

// no __restrict__ on a and out: the aliased fixture passes one buffer as both.
// A thread loads its kPer elements before it stores any: with out and a
// possibly one buffer, a store may not pass the next element's loads, so
// element by element each would wait a round trip to memory.
__global__ void __launch_bounds__(kThreads)
    tile_add_kernel(const float* a, const float* __restrict__ d, float* out, const __grid_constant__ Origins origins,
                    int rows, int cols, int tr, int tc) {
  const int* o = origins.v + blockIdx.x * 6;
  const int n = tr * tc;
  for (int base = threadIdx.x; base < n; base += kThreads * kPer) {
    float v[kPer];
    long long at[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = base + u * kThreads, dr = i / tc, dc = i % tc;
      const int r = o[4] + dr, c = o[5] + dc;
      at[u] = i < n && inside(r, c, rows, cols) ? (long long)r * cols + c : -1;
      const int ar = o[0] + dr, ac = o[1] + dc, er = o[2] + dr, ec = o[3] + dc;
      const float av = at[u] >= 0 && inside(ar, ac, rows, cols) ? a[(size_t)ar * cols + ac] : 0.f;
      const float dv = at[u] >= 0 && inside(er, ec, rows, cols) ? d[(size_t)er * cols + ec] : 0.f;
      v[u] = av + dv;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (at[u] >= 0) out[at[u]] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    tile_scale_kernel(const float* __restrict__ x, float* __restrict__ out, const __grid_constant__ Origins origins,
                      int rows, int cols, int tr, int tc) {
  const int* o = origins.v + blockIdx.x * 4;
  const int n = tr * tc;
  for (int base = threadIdx.x; base < n; base += kThreads * kPer) {
    float v[kPer];
    long long at[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = base + u * kThreads, dr = i / tc, dc = i % tc;
      const int r = o[2] + dr, c = o[3] + dc, xr = o[0] + dr, xc = o[1] + dc;
      at[u] = i < n && inside(r, c, rows, cols) ? (long long)r * cols + c : -1;
      v[u] = at[u] >= 0 && inside(xr, xc, rows, cols) ? 2.f * x[(size_t)xr * cols + xc] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (at[u] >= 0) out[at[u]] = v[u];
    }
  }
}

bool bad_geometry(int blocks, int rows, int cols, int tr, int tc) {
  return blocks <= 0 || blocks > kMaxBlocks || rows <= 0 || cols <= 0 || tr <= 0 || tc <= 0 ||
         (long long)tr * tc > (1LL << 30);
}

// The host table (int32 [blocks][operands][2], blocks <= kMaxBlocks) as the launch's parameter.
Origins pack(const int* table, int blocks, int operands) {
  Origins o = {};
  for (int i = 0; i < blocks * operands * 2; ++i) o.v[i] = table[i];
  return o;
}

}  // namespace

// out = in through shared memory. `origins`: int32 [blocks][2][2] in host
// memory (in tile, out tile), blocks <= kMaxBlocks. Writes the dynamic
// shared memory it asks for to *smem_requested, launched or not. Returns the
// cudaError_t (0 on success); a refused request is returned and cleared.
extern "C" int tile_copy(const float* x, float* out, const int* origins, int blocks, int rows, int cols, int tr, int tc,
                         int stages, long long* smem_requested, void* stream) {
  if (bad_geometry(blocks, rows, cols, tr, tc) || stages < 1) return (int)cudaErrorInvalidValue;
  const long long smem = (long long)stages * 2 * tr * tc * (long long)sizeof(float);
  *smem_requested = smem;
  if (smem > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tile_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the refusal from the last-error slot
    return (int)err;
  }
  tile_copy_kernel<<<blocks, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, pack(origins, blocks, 2), rows, cols, tr, tc);
  return (int)cudaGetLastError();
}

// out = a + d. `origins`: int32 [blocks][3][2] in host memory (a tile, d
// tile, out tile). `out` may equal `a`.
extern "C" int tile_add(const float* a, const float* d, float* out, const int* origins, int blocks, int rows, int cols,
                        int tr, int tc, void* stream) {
  if (bad_geometry(blocks, rows, cols, tr, tc)) return (int)cudaErrorInvalidValue;
  tile_add_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, d, out, pack(origins, blocks, 3), rows,
                                                                             cols, tr, tc);
  return (int)cudaGetLastError();
}

// out = 2 x. `origins`: int32 [blocks][2][2] in host memory (in tile, out
// tile).
extern "C" int tile_scale(const float* x, float* out, const int* origins, int blocks, int rows, int cols, int tr,
                          int tc, void* stream) {
  if (bad_geometry(blocks, rows, cols, tr, tc)) return (int)cudaErrorInvalidValue;
  tile_scale_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, pack(origins, blocks, 2), rows,
                                                                               cols, tr, tc);
  return (int)cudaGetLastError();
}

// cudaFuncGetAttributes of kernel `which` (0 tile_copy, 1 tile_add,
// 2 tile_scale): out[0] sharedSizeBytes (static), out[1] numRegs, out[2]
// maxThreadsPerBlock. Returns the cudaError_t.
extern "C" int kernel_fixtures_func_attributes(int which, int* out) {
  const void* fn = which == 0   ? (const void*)tile_copy_kernel
                   : which == 1 ? (const void*)tile_add_kernel
                   : which == 2 ? (const void*)tile_scale_kernel
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
