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
// and -0.0 included, because values are copied as 32-bit words and never
// pass through arithmetic. Indices in [0, P) are a precondition.
//
// Bound on an H100: bytes. Each gathered row is read once and written once
// and each id read once, N*(2*Q*4 + 4) bytes at 3.35 TB/s (the probe shape,
// N = 256, Q = 128: 0.26 MB, 0.08 us, so a launch's latency is all there
// is; the forward's foreground gather, N = 131072, Q = 16: 17 MB, 5 us).
// There are no operations beside the addresses.
//
// Design (simple first): the output is cut into 16-byte vectors when Q is a
// multiple of 4 and both tables are 16-byte aligned, else into single
// words. One thread copies one vector: thread t serves row t / vecs_per_row,
// column t % vecs_per_row, so neighbouring threads write neighbouring
// addresses and read neighbouring addresses within a row, whatever Q is.
// A grid-stride loop covers outputs beyond one wave of blocks. Later work:
// several vectors in flight per thread for rows far apart in memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // a few waves of the card's 132 SMs

// V is the copy unit: uint4 (16 bytes) or uint32_t (one f32 as bits).
template <typename V>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const V* __restrict__ x, const int32_t* __restrict__ idx,
                  V* __restrict__ out, int64_t total, int per_row) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < total; t += stride) {
    const int64_t r = t / per_row;
    const int c = (int)(t - r * per_row);
    out[t] = x[(int64_t)idx[r] * per_row + c];
  }
}

template <typename V>
int launch(const void* x, const void* idx, void* out, int64_t total, int per_row,
           cudaStream_t stream) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  row_gather_kernel<V><<<(int)blocks, kThreads, 0, stream>>>(
      (const V*)x, (const int32_t*)idx, (V*)out, total, per_row);
  return (int)cudaGetLastError();
}

}  // namespace

// x [P, q] f32, idx [n] i32 (each in [0, P)), out [n, q] f32, all contiguous.
extern "C" int row_gather_launch(const void* x, const void* idx, void* out, int n, int q,
                                 void* stream) {
  if (n < 1 || q < 1) return (int)cudaErrorInvalidValue;
  const bool vec = q % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec) return launch<uint4>(x, idx, out, (int64_t)n * (q / 4), q / 4, (cudaStream_t)stream);
  return launch<uint32_t>(x, idx, out, (int64_t)n * q, q, (cudaStream_t)stream);
}
