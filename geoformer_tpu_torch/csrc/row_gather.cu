// Row gather out[r, :] = x[idx[r], :] (kernel K3).
//
// Replaces the TPU probe kernels of tools/pallas_gather_probe.py
// (_take_axis0, _takealong_axis0, _fori_dynslice, _onehot_matmul, all run by
// run_probe). Those four are candidate Mosaic lowerings of one function, the
// row gather from a [P, Q] f32 table by N int32 row ids; the one-hot matmul
// is a workaround for a missing TPU gather, not different work. A GPU thread
// computes its own address, so one kernel is the counterpart of all four.
// A gather moves bits: the result equals the plain version
// (geoformer_tpu_torch/kernels/row_gather.py, x[idx]) exactly, NaN payloads
// and -0.0 included, because values are copied as 32-bit words or 16-byte
// vectors and never pass through arithmetic. Indices in [0, P) are a
// precondition.
//
// Bound on an H100: bytes. Each distinct gathered row is read once, each
// output row written once and each id read once, at 3.35 TB/s (the probe
// shape, N = 256, Q = 128: under 0.26 MB, 0.08 us, so a launch's latency is
// all there is; the forward's foreground gather, N = 131072, Q = 16: 17 MB,
// 5 us; one block's slab of the geodesic fine sweep, N = 4096 ids into a
// [131073, 128] table: at most 4.2 MB, and far less read where neighbours
// repeat). There are no operations beside the addresses.
//
// What holds a gather back is the chain of two dependent loads a row (the
// id, then the row it names), not the bytes: with one unit in flight a
// thread (the first design, kept as the per-unit kernel), the card runs out
// of loads in flight before it runs out of bandwidth. The design (rows in
// flight):
// - Copy unit: 16-byte vectors when Q is a multiple of 4 and both tables are
//   16-byte aligned, else single words (the same kernel, another unit). A
//   row is `vpr` units.
// - A group of G lanes (G the power of two >= vpr, at most 32) covers one
//   row; a warp covers 32 / G rows at a time, so narrow rows share a warp
//   and neighbouring lanes touch neighbouring addresses. A row of 33 to 64
//   units takes U = 2 units a lane, both loads in flight together.
// - Each thread takes R rows, unrolled: first its R ids, then its R x U row
//   units, then its stores, so R x U independent loads are in flight. A
//   warp's R x (32 / G) rows are contiguous in the output, and each of its
//   stores writes (32 / G) whole neighbouring rows.
// - Row and column come from the thread's coordinates by shifts (G, R and U
//   are template constants): no division on the address path. Within a row
//   the arithmetic is 32-bit; row offsets are 64-bit ((int64_t)id * vpr),
//   so tables of more than 2^31 words stay correct.
// - Rows are read through the read-only path (__ldg: rows repeat in the
//   sweep's slabs). Streaming hints on the ids and the output (__ldcs,
//   __stcs) measured no faster with the L2 flushed and 11 % slower with it
//   warm on the sweep's slab, whose consumer reads the output next, so ids
//   and output take the default policy.
// - The grid is one wave: the blocks the occupancy calculator allows on
//   every SM, fewer when there are fewer rows, and a grid-stride loop covers
//   the rest. R = 4 where that still gives half the SMs a block, else
//   R = 1 (a launch-sized gather, spread over as many SMs as it fills); R = 1
//   also where a warp already covers 32 rows a slot (G = 1), measured faster.
// - Rows wider than 64 units take the per-unit kernel, which measured
//   faster there (a block's warps read one wide row's neighbouring units
//   together).
//
// row_gather_per_unit_launch runs the per-unit kernel at every width: the
// yardstick the design is timed against (tools/k3_sources.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWideUnits = 2;  // units in flight a lane, rows over 32 units

// V is the copy unit: uint4 (16 bytes) or uint32_t (one f32 as bits).
// U: units of a row a lane has in flight, 1 where a row fits its group
// (vpr <= G), kWideUnits for wider rows (a loop of U units a lane).
template <typename V, int G, int R, int U>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ x, const int32_t* __restrict__ idx,
                   V* __restrict__ out, int n, int vpr) {
  constexpr int kSub = 32 / G;      // rows a warp covers in one slot
  constexpr int kChunk = kSub * R;  // rows a warp covers in one iteration
  const int lane = threadIdx.x & 31;
  const int col = lane % G;
  const int64_t stride = (int64_t)gridDim.x * kWarps * kChunk;
  for (int64_t base = ((int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kChunk + lane / G;
       base < n; base += stride) {
    const V* src[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      src[r] = x + (int64_t)(base + r * kSub < n ? idx[base + r * kSub] : 0) * vpr;
    // a row's units from c0 on: U of them a lane, R rows, all loads first
    for (int c0 = col; c0 < vpr; c0 += G * U) {
      V v[R][U];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (base + r * kSub < n && c0 + u * G < vpr) v[r][u] = __ldg(src[r] + c0 + u * G);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (base + r * kSub < n && c0 + u * G < vpr)
            out[(base + r * kSub) * vpr + c0 + u * G] = v[r][u];
      if (G < 32 || U == 1) break;  // the row fits its group: one unit a lane
    }
  }
}

// The per-unit kernel (the first design): thread t copies unit t % per_row
// of row t / per_row.
template <typename V>
__global__ void __launch_bounds__(kThreads)
per_unit_kernel(const V* __restrict__ x, const int32_t* __restrict__ idx,
                V* __restrict__ out, int64_t total, int per_row) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < total; t += stride) {
    const int64_t r = t / per_row;
    const int c = (int)(t - r * per_row);
    out[t] = x[(int64_t)idx[r] * per_row + c];
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <typename V, int G, int R, int U>
int launch_rows(const void* x, const void* idx, void* out, int n, int vpr, cudaStream_t stream) {
  // resident blocks an SM, asked once for each instantiation
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, gather_rows_kernel<V, G, R, U>, kThreads, 0);
    return b > 0 ? b : 1;
  }();
  constexpr int kRowsPerBlock = kWarps * (32 / G) * R;
  int64_t blocks = ((int64_t)n + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t wave = (int64_t)sm_count() * per_sm;
  if (blocks > wave) blocks = wave;
  gather_rows_kernel<V, G, R, U><<<(int)blocks, kThreads, 0, stream>>>(
      (const V*)x, (const int32_t*)idx, (V*)out, n, vpr);
  return (int)cudaGetLastError();
}

template <typename V, int R>
int launch_width(const void* x, const void* idx, void* out, int n, int vpr, cudaStream_t s) {
  if (vpr <= 1) return launch_rows<V, 1, 1, 1>(x, idx, out, n, vpr, s);  // R = 1 at G = 1
  if (vpr <= 2) return launch_rows<V, 2, R, 1>(x, idx, out, n, vpr, s);
  if (vpr <= 4) return launch_rows<V, 4, R, 1>(x, idx, out, n, vpr, s);
  if (vpr <= 8) return launch_rows<V, 8, R, 1>(x, idx, out, n, vpr, s);
  if (vpr <= 16) return launch_rows<V, 16, R, 1>(x, idx, out, n, vpr, s);
  if (vpr <= 32) return launch_rows<V, 32, R, 1>(x, idx, out, n, vpr, s);
  return launch_rows<V, 32, R, kWideUnits>(x, idx, out, n, vpr, s);
}

template <typename V>
int launch_per_unit(const void* x, const void* idx, void* out, int64_t total, int per_row,
                    cudaStream_t stream) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // a few waves of the card's 132 SMs
  per_unit_kernel<V><<<(int)blocks, kThreads, 0, stream>>>(
      (const V*)x, (const int32_t*)idx, (V*)out, total, per_row);
  return (int)cudaGetLastError();
}

template <typename V>
int launch(const void* x, const void* idx, void* out, int n, int vpr, bool per_unit,
           cudaStream_t s) {
  // rows wider than 64 units: the per-unit kernel, measured faster there
  if (per_unit || vpr > 2 * 32) return launch_per_unit<V>(x, idx, out, (int64_t)n * vpr, vpr, s);
  // R = 4 where half the SMs or more still get a block (G = 1 always
  // takes R = 1: a warp already covers 32 rows a slot)
  const int g = vpr >= 32 ? 32 : vpr <= 1 ? 1 : 1 << (32 - __builtin_clz(vpr - 1));
  const int64_t warps = ((int64_t)n * g + 31) / 32;  // at R = 1
  if (2 * warps >= 4LL * kWarps * sm_count()) return launch_width<V, 4>(x, idx, out, n, vpr, s);
  return launch_width<V, 1>(x, idx, out, n, vpr, s);
}

int gather(const void* x, const void* idx, void* out, int n, int q, bool per_unit,
           cudaStream_t s) {
  if (n < 1 || q < 1) return (int)cudaErrorInvalidValue;
  const bool vec = q % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec) return launch<uint4>(x, idx, out, n, q / 4, per_unit, s);
  return launch<uint32_t>(x, idx, out, n, q, per_unit, s);
}

}  // namespace

// x [P, q] f32, idx [n] i32 (each in [0, P)), out [n, q] f32, all contiguous.
extern "C" int row_gather_launch(const void* x, const void* idx, void* out, int n, int q,
                                 void* stream) {
  return gather(x, idx, out, n, q, false, (cudaStream_t)stream);
}

// The same gather by the per-unit kernel (one unit a thread) at any width.
extern "C" int row_gather_per_unit_launch(const void* x, const void* idx, void* out, int n,
                                          int q, void* stream) {
  return gather(x, idx, out, n, q, true, (cudaStream_t)stream);
}
