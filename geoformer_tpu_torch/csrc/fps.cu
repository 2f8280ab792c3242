// Furthest point sampling, one scene per CTA (kernel K2).
//
// Replaces the TPU kernel geoformer_tpu/ops/fps_pallas.py (_fps_kernel,
// called through fps_pallas_scene / fps_pallas), whose semantics are
// geoformer_tpu/ops/fps.py:_fps_scene: pick 0 is index 0; each of the next
// n-1 picks updates the running min squared distance to the last pick
// (invalid points stay -1) and takes the lowest index attaining the max. A
// scene with no valid point repeats index 0. The result is bit-identical to
// the plain version in geoformer_tpu_torch/kernels/fps.py: the distance is
// (dx*dx + dy*dy) + dz*dz with every product and sum rounded on its own
// (__fmul_rn / __fadd_rn, and the library builds with --fmad=false), because
// an FMA would round differently and near-ties would pick other points; the
// first 256 picks are the decoder's queries, so pick order is load-bearing.
//
// Bound on an H100 (main path: P = 50000, n = 2048): the operations are
// ~(n-1)*P*9 = 0.92 GFLOP f32, 14 us at 67 TFLOP/s; the bytes (points and
// mask read once, picks written once) are 0.85 MB, 0.25 us at 3.35 TB/s.
// In practice neither binds: the n-1 picks are dependent, and each ends in a
// block-wide (max, lowest index) reduction, so the kernel is latency-bound
// on one SM per scene.
//
// Design (simple first): one CTA of 1024 threads per scene. The running
// min distance lives in shared memory (P floats: 200 KB at P = 50000, under
// the 227 KB a block may opt into); a negative entry marks an invalid point,
// so the mask is read once. Coordinates are re-read from L2 at every pick.
// Each pick ends in a warp-shuffle reduction, one slot per warp in shared
// memory, and a final warp reduction. Later work: a cluster that spreads the
// scene over several SMs' shared memory (DSMEM) with a cluster-wide argmax.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // bytes a block may opt into on sm_90
constexpr int kReserved = 1024;     // reduction slots + the broadcast pick

// (v, i) beats (bv, bi): larger value, then lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask,
           int32_t* __restrict__ out, int p, int n_samples) {
  extern __shared__ float smem[];
  float* dist = smem;                      // [p]
  float* red_v = smem + p;                 // [kWarps]
  int* red_i = (int*)(red_v + kWarps);     // [kWarps]
  int* pick = red_i + kWarps;              // [1]

  const int scene = blockIdx.x;
  const float* pts = points + (int64_t)scene * p * 3;
  const uint8_t* msk = mask + (int64_t)scene * p;
  int32_t* o = out + (int64_t)scene * n_samples;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int j = tid; j < p; j += kThreads) dist[j] = msk[j] ? 1e10f : -1.0f;
  if (tid == 0) {
    o[0] = 0;
    *pick = 0;
  }
  __syncthreads();

  for (int s = 1; s < n_samples; ++s) {
    const int last = *pick;
    const float lx = pts[last * 3 + 0], ly = pts[last * 3 + 1], lz = pts[last * 3 + 2];
    float bv = -3.0e38f;
    int bi = 0x7fffffff;
    for (int j = tid; j < p; j += kThreads) {
      float nd = dist[j];
      if (nd >= 0.0f) {  // valid point
        const float dx = __fadd_rn(pts[j * 3 + 0], -lx);
        const float dy = __fadd_rn(pts[j * 3 + 1], -ly);
        const float dz = __fadd_rn(pts[j * 3 + 2], -lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        nd = fminf(nd, d);
        dist[j] = nd;
      }
      if (nd > bv) {  // strict: the lowest index wins within a thread
        bv = nd;
        bi = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];
      bi = red_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        *pick = bi;
        o[s] = bi;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int fps_max_points() {
  return (kSmemLimit - kReserved) / (int)sizeof(float);
}

extern "C" int fps_launch(const void* points, const void* mask, void* out, int b, int p,
                          int n_samples, void* stream) {
  if (p < 1 || p > fps_max_points() || n_samples < 1) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const int smem = p * (int)sizeof(float) + kReserved;
  cudaError_t err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)points, (const uint8_t*)mask, (int32_t*)out, p, n_samples);
  return (int)cudaGetLastError();
}
