// k-smallest selection over the radius-graph candidate table (kernel K1).
//
// Replaces the TPU kernel geoformer_tpu/ops/knn_select_pallas.py
// (_select_kernel, called through select_min_k_cand): per row of
// d2 [N, W] f32 and cand [N, W] i32, emit the k smallest values in ascending
// order and the candidate ids at their lanes, ties to the lowest lane.
// The result is bit-identical to the plain version in
// geoformer_tpu_torch/kernels/knn_select.py: torch.sort(d2, stable=True),
// first k, then gather cand. A row with fewer than k live lanes takes the
// lowest-lane remaining (1e30) lanes, as the stable sort does; NaN sorts
// after every number, as in torch.sort.
//
// Bound on an H100 (main path: N = 131072, W = 648, k = 16): d2 is read
// once (N*W*4 B = 0.34 GB), only the k picked ids of cand are read
// (N*k*4 B = 8 MB) and the picks written once (N*k*8 B = 17 MB), ~0.36 GB
// at 3.35 TB/s = 0.11 ms: memory-bound. The work is k*W compares per row,
// far below the card's rate.
//
// Design (simple first): one warp per row. Each thread keeps its
// ceil(W/32) values in registers (lane j lives in thread j % 32, slot
// j / 32), so the row is read from memory once, coalesced. Each of the k
// rounds is a register scan plus a 5-step warp-shuffle argmin over
// (value, lane); the picked lane is marked in a per-thread bitmask, so
// values never change and ties resolve exactly as the stable sort does.
// Only the k picked candidate ids are read from cand. Later work: wider rows
// per warp and fewer shuffle rounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerThread = 32;  // W <= 1024
constexpr int kNone = 0x7fffffff;
constexpr int kWarpsPerBlock = 8;

// (v, l) sorts before (bv, bl): ascending value, NaN last, then lowest lane.
__device__ __forceinline__ bool before(float v, int l, float bv, int bl) {
  if (l == kNone) return false;
  if (bl == kNone) return true;
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return (vn && bn) ? (l < bl) : bn;
  return v < bv || (v == bv && l < bl);
}

__global__ void knn_select_kernel(const float* __restrict__ d2,
                                  const int32_t* __restrict__ cand,
                                  float* __restrict__ vals,
                                  int32_t* __restrict__ idx,
                                  int n, int w, int k) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // whole warp leaves together
  const float* drow = d2 + (int64_t)row * w;

  float v[kMaxPerThread];
#pragma unroll
  for (int s = 0; s < kMaxPerThread; ++s) {
    const int j = s * kWarp + lane;
    v[s] = (j < w) ? drow[j] : 0.0f;
  }
  uint32_t taken = 0;

  for (int r = 0; r < k; ++r) {
    float bv = 0.0f;
    int bl = kNone;
#pragma unroll
    for (int s = 0; s < kMaxPerThread; ++s) {
      const int j = s * kWarp + lane;
      if (j < w && !((taken >> s) & 1u) && before(v[s], j, bv, bl)) {
        bv = v[s];
        bl = j;
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
      if (before(ov, ol, bv, bl)) {
        bv = ov;
        bl = ol;
      }
    }
    // every lane now holds the same (bv, bl); the owner marks it taken
    if (bl % kWarp == lane) taken |= 1u << (bl / kWarp);
    if (lane == 0) {
      vals[(int64_t)row * k + r] = bv;
      idx[(int64_t)row * k + r] = cand[(int64_t)row * w + bl];
    }
  }
}

}  // namespace

extern "C" int knn_select_launch(const void* d2, const void* cand, void* vals, void* idx,
                                 int n, int w, int k, void* stream) {
  if (w > kWarp * kMaxPerThread || k > w || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  knn_select_kernel<<<blocks, kWarpsPerBlock * kWarp, 0, (cudaStream_t)stream>>>(
      (const float*)d2, (const int32_t*)cand, (float*)vals, (int32_t*)idx, n, w, k);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
