// Furthest point sampling, one thread-block cluster per scene (kernel K2).
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
// Neither binds: the n-1 picks are dependent, and each ends in a reduction
// of (max, lowest index) over the whole scene and a broadcast of the winner
// to every SM that holds a part of it. That chain is the floor: on an H100
// the kernel takes ~1.4 us a pick on an all-invalid scene of 50,000 points,
// where no distance is updated (chip_smoke.py's kernel_edges phase), so
// ~2.8 ms of its ~3.2 ms for 2,047 picks on a full scene.
//
// Design: one cluster of C CTAs per scene, C the smallest power of two that
// keeps a CTA at or below 2,048 points (capped at 16, which needs the
// non-portable cluster size). CTA r owns the contiguous chunk
// [r*chunk, (r+1)*chunk) and keeps its x, y, z (SoA) and running min in its
// own shared memory, 16 B a point, loaded once; after that no pick reads
// device memory or L2. The running min is negative for an invalid point, so
// the mask is read once. Per pick each CTA updates its chunk and reduces it
// to its (max, lowest index): two warp reductions (__reduce_max_sync on an
// order-preserving key, then __reduce_min_sync on the index among the lanes
// holding the max), one slot per warp, and the same two reductions in warp
// 0. Lane r of warp 0 then pushes that candidate with the winner's
// coordinates into CTA r's shared memory (st.shared::cluster) and arrives
// on CTA r's mbarrier (release, cluster scope). Every CTA waits on its own
// mbarrier for the C arrivals and reduces the C slots, now local, the same
// way in every warp: the reduction is a total order (larger distance, then
// lower index), so all CTAs agree on the pick, and chunks are contiguous,
// so the lowest index wins ties across CTAs as it does within one. The
// slots and mbarriers are double-buffered by the pick's parity, so one
// exchange a pick suffices: a CTA pushes pick s + 2 only after every CTA
// has pushed pick s + 1, which each does after reading pick s's slots. The
// winner's coordinates arrive with its slot, so the next pick starts with no
// further read. Pushing and waiting on a local mbarrier, rather than a
// cluster barrier followed by reads of the other CTAs' shared memory, takes
// one cross-SM trip a pick instead of two. Shared memory bounds a scene at
// 16 chunks of 14,400 points.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;    // non-portable above 8
constexpr int kTargetChunk = 2048; // points a CTA should hold at most
constexpr int kSmemLimit = 232448; // bytes a block may opt into on sm_90
constexpr int kReserved = 2048;    // slots, barriers and warp slots, ahead of the chunk
constexpr int kMaxDevices = 64;
constexpr uint32_t kNone = 0xffffffffu;
constexpr unsigned kFull = 0xffffffffu;

// One CTA's candidate for a pick, pushed into every CTA of the cluster.
struct alignas(16) Slot {
  uint32_t key, idx;
  float x, y, z, pad[3];
};

// Order-preserving key of a running min: an invalid point (-1) maps to 0,
// a valid distance d >= 0 to its bit pattern + 1 (monotone for d >= 0).
__device__ __forceinline__ uint32_t dist_key(float nd) {
  return nd >= 0.0f ? __float_as_uint(nd) + 1u : 0u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of the same shared-memory object in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Write a slot into a CTA of the cluster, then arrive on its barrier: the
// arrive's release orders the stores before it.
__device__ __forceinline__ void push_slot(uint32_t slot, uint32_t bar, uint32_t key,
                                          uint32_t idx, float x, float y, float z) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "r"(slot), "r"(key), "r"(idx), "r"(__float_as_uint(x)),
                  "r"(__float_as_uint(y)) : "memory");
  asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(slot + 16), "f"(z) : "memory");
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Wait until the barrier completes the phase of the given parity.
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ points, const uint8_t* __restrict__ mask,
           int32_t* __restrict__ out, int p, int n_samples, int chunk) {
  extern __shared__ float4 smem4[];
  Slot* slots = reinterpret_cast<Slot*>(smem4);  // [2][kMaxCluster], by pick parity
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + 2 * kMaxCluster);  // [2]
  uint32_t* wkey = reinterpret_cast<uint32_t*>(bars + 2);                 // [kWarps]
  uint32_t* widx = wkey + kWarps;                                         // [kWarps]
  float* xs = reinterpret_cast<float*>(smem4) + kReserved / 4;
  float* ys = xs + chunk;
  float* zs = ys + chunk;
  float* dist = zs + chunk;

  cg::cluster_group cluster = cg::this_cluster();
  const int n_ctas = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int scene = blockIdx.x / n_ctas;
  const int base = rank * chunk;
  const int cnt = max(0, min(chunk, p - base));
  const float* pts = points + (int64_t)scene * p * 3;
  const uint8_t* msk = mask + (int64_t)scene * p + base;
  int32_t* o = out + (int64_t)scene * n_samples;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // the chunk, once: coalesced 4-byte reads of [cnt, 3], written as SoA
  const float* cp = pts + (int64_t)base * 3;
  for (int e = tid; e < cnt * 3; e += kThreads) {
    const int q = e / 3, c = e - q * 3;
    (c == 0 ? xs : c == 1 ? ys : zs)[q] = cp[e];
  }
  for (int q = tid; q < cnt; q += kThreads) dist[q] = msk[q] ? 1e10f : -1.0f;
  if (tid < 2) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bars + tid)), "r"(n_ctas) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  float lx = pts[0], ly = pts[1], lz = pts[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  cluster.sync();  // every barrier is initialised before any CTA arrives on it

  for (int s = 1; s < n_samples; ++s) {
    uint32_t bk = 0, bi = kNone;
    for (int q = tid; q < cnt; q += kThreads) {
      float nd = dist[q];
      if (nd >= 0.0f) {  // valid point
        const float dx = __fadd_rn(xs[q], -lx);
        const float dy = __fadd_rn(ys[q], -ly);
        const float dz = __fadd_rn(zs[q], -lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        nd = fminf(nd, d);
        dist[q] = nd;
      }
      const uint32_t key = dist_key(nd);
      if (key > bk || bi == kNone) {  // strict: the lowest index wins within a thread
        bk = key;
        bi = (uint32_t)(base + q);
      }
    }
    uint32_t mk = __reduce_max_sync(kFull, bk);
    uint32_t mi = __reduce_min_sync(kFull, bk == mk ? bi : kNone);
    if (lane == 0) {
      wkey[warp] = mk;
      widx[warp] = mi;
    }
    __syncthreads();
    const int par = s & 1;
    if (warp == 0) {
      const uint32_t k2 = lane < kWarps ? wkey[lane] : 0u;
      const uint32_t i2 = lane < kWarps ? widx[lane] : kNone;
      mk = __reduce_max_sync(kFull, k2);
      mi = __reduce_min_sync(kFull, k2 == mk ? i2 : kNone);
      if (lane < n_ctas) {  // lane r pushes this CTA's candidate into CTA r
        const int q = mi == kNone ? 0 : (int)mi - base;
        push_slot(map_rank(smem_addr(slots + par * kMaxCluster + rank), lane),
                  map_rank(smem_addr(bars + par), lane), mk, mi, xs[q], ys[q], zs[q]);
      }
    }
    // bars[par] serves the picks par, par + 2, ...: pick s is its use (s - 1) / 2
    wait_parity(smem_addr(bars + par), ((s - 1) >> 1) & 1);

    uint32_t rk = 0, ri = kNone;
    float rx = 0.0f, ry = 0.0f, rz = 0.0f;
    if (lane < n_ctas) {
      const Slot& sl = slots[par * kMaxCluster + lane];
      rk = sl.key;
      ri = sl.idx;
      rx = sl.x;
      ry = sl.y;
      rz = sl.z;
    }
    mk = __reduce_max_sync(kFull, rk);
    mi = __reduce_min_sync(kFull, rk == mk ? ri : kNone);
    const int src = __ffs(__ballot_sync(kFull, ri == mi)) - 1;
    lx = __shfl_sync(kFull, rx, src);
    ly = __shfl_sync(kFull, ry, src);
    lz = __shfl_sync(kFull, rz, src);
    if (rank == 0 && tid == 0) o[s] = (int32_t)mi;
  }
  cluster.sync();  // no CTA leaves while another may still write to it
}

int chunk_of(int p, int c) { return (p + c - 1) / c; }

}  // namespace

// CTAs in the cluster that samples a scene of p points.
extern "C" int fps_cluster_size(int p) {
  int c = 1;
  while (c < kMaxCluster && chunk_of(p, c) > kTargetChunk) c <<= 1;
  return c;
}

extern "C" int fps_max_points() {
  return kMaxCluster * ((kSmemLimit - kReserved) / (4 * (int)sizeof(float)));
}

extern "C" int fps_launch(const void* points, const void* mask, void* out, int b, int p,
                          int n_samples, void* stream) {
  if (p < 1 || p > fps_max_points() || n_samples < 1) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const int c = fps_cluster_size(p);
  const int chunk = chunk_of(p, c);
  const int smem = kReserved + chunk * 4 * (int)sizeof(float);
  // the opt-ins a launch of any size needs, set once per device: each call
  // to cudaFuncSetAttribute costs microseconds of host time
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fps_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)b * c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_kernel, (const float*)points, (const uint8_t*)mask,
                           (int32_t*)out, p, n_samples, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
