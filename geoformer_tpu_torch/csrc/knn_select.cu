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
// Bound on an H100: d2 is read once (N*W*4 B), only the k picked ids of cand
// are read (N*k*4 B) and the picks written once (N*k*8 B). At N = 131072,
// W = 648 that is 0.36 GB at k = 16 (the main path) and 0.44 GB at k = 64
// (the exact geodesic solver's graph), 0.109 and 0.131 ms at 3.35 TB/s:
// memory-bound. The work is a few compares per element and a few hundred
// shuffles per row, far below the card's rate, as long as it is not a chain
// of k dependent rounds per warp.
//
// Design: threshold, then sort. One warp per row; lane l holds the elements
// j = 32*s + l (coalesced reads, the row read once) as order-preserving
// 32-bit keys (-0.0 equal to +0.0, every NaN after every number and equal
// to every other NaN). Each element's sort key is the 64-bit composite
// (key << 32 | j): unique, and its order is the stable sort's. Per row:
//   1. a threshold tau with at least k elements at or below it, so that the
//      k smallest of the row are all <= tau:
//      k <= 32: the k-th smallest of the 32 lane minima (a warp bitonic
//        sort); each of the k smallest lane minima is one such element;
//      32 < k <= 64: the k-th smallest of the 64 pair values, each lane's
//        two smallest composites (the lanes' firsts sorted ascending and
//        their seconds descending across the warp, the larger of the two
//        in each lane, then a bitonic merge: the upper 32 of the 64 in
//        order); the k smallest pair values are k distinct elements;
//   2. the c elements <= tau are counted (__reduce_add_sync); if c <= 64
//      (k <= 32) or c <= 128 (32 < k <= 64), they are compacted (warp
//      prefix sum, one 64- or 128-slot buffer per warp in shared memory),
//      loaded one to four a lane and sorted across the warp (32-wide
//      bitonic sorts and merges; of 128, only the lower 64 are merged), and
//      the lanes write ranks lane and lane + 32 below k;
//   3. otherwise (many elements below the threshold: a row live in many
//      lanes, or its smallest values packed in a few lanes), or if k > 64,
//      the row takes the kernel's exact path: k rounds of a lane-local min
//      over the composites above the last pick and two warp reductions
//      (__reduce_min_sync on the key, then on the lane among the lanes
//      holding that key).
// The exact geodesic solver's rows (k = 64, at most a few tens of lanes in
// radius, 1e30 elsewhere) all take the sort: with L < 64 live lanes, a
// lane's pair holds a dead lane only when the lane holds at most one live
// one, and that dead lane is then its slot 0 or 1 (j <= 63); so tau is live,
// or dead with j <= 63, and c <= L + 64 < 128.
// Both paths read only the k picked ids of cand and copy the picked values'
// own bits from d2 (the keys are not inverted). With a non-null counter the
// kernel adds the rows that took the exact path. What bounds the kernel in
// practice is latency and shuffle throughput, not bytes: a warp's row is a
// chain of dependent shuffles, so the SM needs many warps in flight. The
// kernel is instantiated for S = 1, 2, 4, 8, 16, 21 and 32 slots a lane
// (the fewest that hold the row: 21 at W = 648), which keeps the row's keys
// in registers at no more than 80 a thread, three or more blocks of eight
// warps an SM (the 32 < k <= 64 kernel at 32 slots: 102 registers, two
// blocks), and once for k <= 32 or k > 64 and once for 32 < k <= 64 (Wide),
// so that the other kernel keeps its registers and its 4 KB of shared
// memory a block (8 KB with Wide). A Wide row that takes the exact path
// runs it under Wide's registers and occupancy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerThread = 32;  // W <= 1024
constexpr int kWarpsPerBlock = 8;
constexpr int kMinBlocks = 3;  // blocks an SM should hold: caps registers at 80
// the 32 < k <= 64 kernel at 32 slots a lane (W > 672) takes 102
// registers: two blocks an SM
constexpr int kMinBlocksWide32 = 2;
constexpr uint64_t kMax64 = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving key of a float: ascending numbers, -0.0 == +0.0, NaN last.
__device__ __forceinline__ uint32_t f2key(float f) {
  uint32_t u = __float_as_uint(f);
  if (f != f) return 0xffffffffu;
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t min64(uint64_t a, uint64_t b) { return a < b ? a : b; }
__device__ __forceinline__ uint64_t max64(uint64_t a, uint64_t b) { return a < b ? b : a; }

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t x, int m) {
  const uint32_t lo = __shfl_xor_sync(kFull, (uint32_t)x, m);
  const uint32_t hi = __shfl_xor_sync(kFull, (uint32_t)(x >> 32), m);
  return ((uint64_t)hi << 32) | lo;
}

__device__ __forceinline__ uint64_t shfl64(uint64_t x, int src) {
  const uint32_t lo = __shfl_sync(kFull, (uint32_t)x, src);
  const uint32_t hi = __shfl_sync(kFull, (uint32_t)(x >> 32), src);
  return ((uint64_t)hi << 32) | lo;
}

// One compare-exchange stage of a warp bitonic network: lane keeps the
// min of its pair when it is the lower lane of an ascending block.
__device__ __forceinline__ uint64_t bitonic_step(uint64_t x, int lane, int stride, bool up) {
  const uint64_t o = shfl_xor64(x, stride);
  const bool keep_min = ((lane & stride) == 0) == up;
  return keep_min ? min64(x, o) : max64(x, o);
}

// Sort 32 values (one a lane) across the warp, ascending or descending.
__device__ __forceinline__ uint64_t bitonic_sort32(uint64_t x, int lane, bool ascending) {
#pragma unroll
  for (int size = 2; size <= kWarp; size <<= 1) {
    const bool up = (size == kWarp) ? ascending : (((lane & size) == 0) == ascending);
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) x = bitonic_step(x, lane, stride, up);
  }
  return x;
}

// Put a bitonic sequence of 32 (one a lane) in order.
__device__ __forceinline__ uint64_t bitonic_merge32(uint64_t x, int lane, bool ascending) {
#pragma unroll
  for (int stride = kWarp / 2; stride > 0; stride >>= 1) x = bitonic_step(x, lane, stride, ascending);
  return x;
}

// Put a bitonic sequence of 64 in order: x0 holds its first 32 (one a
// lane), x1 its last 32; on return x0 holds ranks 0..31 and x1 ranks 32..63.
__device__ __forceinline__ void bitonic_merge64(uint64_t& x0, uint64_t& x1, int lane,
                                                bool ascending) {
  const uint64_t lo = min64(x0, x1), hi = max64(x0, x1);
  x0 = bitonic_merge32(ascending ? lo : hi, lane, ascending);
  x1 = bitonic_merge32(ascending ? hi : lo, lane, ascending);
}

// Sort 64 values (x0 and x1, one each a lane) across the warp.
__device__ __forceinline__ void bitonic_sort64(uint64_t& x0, uint64_t& x1, int lane,
                                               bool ascending) {
  x0 = bitonic_sort32(x0, lane, true);
  x1 = bitonic_sort32(x1, lane, false);
  bitonic_merge64(x0, x1, lane, ascending);
}

// S: slots a lane holds (W <= 32 * S), a compile-time size so that the
// row's keys stay in registers. Wide: the kernel for 32 < k <= 64.
template <int S, bool Wide>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp,
                                  Wide && S == kMaxPerThread ? kMinBlocksWide32 : kMinBlocks)
knn_select_kernel(const float* __restrict__ d2, const int32_t* __restrict__ cand,
                  float* __restrict__ vals, int32_t* __restrict__ idx, int n, int w, int k,
                  int32_t* __restrict__ exact_rows) {
  constexpr int kSortCap = (Wide ? 4 : 2) * kWarp;  // elements the sort path takes
  __shared__ uint64_t buf[kWarpsPerBlock][kSortCap];
  const int lane = threadIdx.x % kWarp;
  const int wib = threadIdx.x / kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + wib;
  if (row >= n) return;  // whole warp leaves together
  const float* drow = d2 + (int64_t)row * w;
  const int32_t* crow = cand + (int64_t)row * w;

  // keys; slots past the row's end get the largest key, and since their
  // lane index j >= w their composite is above every element's
  uint32_t key[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = s * kWarp + lane;
    key[s] = (j < w) ? f2key(drow[j]) : 0xffffffffu;
  }
  // (key[s], j) <= (tk, tj) for the composite order, in 32-bit compares
  auto at_most = [&](int s, uint32_t tk, uint32_t tj) {
    return key[s] < tk || (key[s] == tk && (uint32_t)(s * kWarp + lane) <= tj);
  };
  auto emit = [&](int r, uint32_t j) {
    vals[(int64_t)row * k + r] = drow[j];
    idx[(int64_t)row * k + r] = crow[j];
  };

  if (k <= kSortCap / 2) {
    // 1: tau
    uint64_t tau;
    if constexpr (Wide) {
      // each lane's two smallest composites (a later slot wins no tie);
      // with S == 1 (never launched: k > 32 needs W > 32) the second is a
      // slot past the row's end
      uint32_t k0 = key[0], k1 = 0xffffffffu;
      int s0 = 0, s1 = S;
      if constexpr (S > 1) {
        if (key[1] < k0) {
          k1 = k0;
          s1 = 0;
          k0 = key[1];
          s0 = 1;
        } else {
          k1 = key[1];
          s1 = 1;
        }
      }
#pragma unroll
      for (int s = 2; s < S; ++s) {
        if (key[s] < k0) {
          k1 = k0;
          s1 = s0;
          k0 = key[s];
          s0 = s;
        } else if (key[s] < k1) {
          k1 = key[s];
          s1 = s;
        }
      }
      const uint64_t m0 = ((uint64_t)k0 << 32) | (uint32_t)(s0 * kWarp + lane);
      const uint64_t m1 = ((uint64_t)k1 << 32) | (uint32_t)(s1 * kWarp + lane);
      // the 64 pair values: firsts ascending, seconds descending (together
      // bitonic); the larger of each lane's two are the upper 32, bitonic,
      // put in order: lane r holds rank 32 + r. tau is read through the
      // warp's buffer (76 registers at S = 21; through shuffles, 80 and
      // 4 % slower)
      buf[wib][lane] = bitonic_merge32(
          max64(bitonic_sort32(m0, lane, true), bitonic_sort32(m1, lane, false)), lane, true);
      __syncwarp();
      tau = buf[wib][k - 1 - kWarp];
      __syncwarp();  // every lane has read tau before the buffer is reused
    } else {
      // the k-th smallest lane minimum (the first slot wins a tie, which is
      // the lowest j)
      uint32_t mk = key[0];
      int ms = 0;
#pragma unroll
      for (int s = 1; s < S; ++s)
        if (key[s] < mk) {
          mk = key[s];
          ms = s;
        }
      const uint64_t m = ((uint64_t)mk << 32) | (uint32_t)(ms * kWarp + lane);
      tau = shfl64(bitonic_sort32(m, lane, true), k - 1);
    }
    // 2: count and, when few, compact and sort
    const uint32_t tk = (uint32_t)(tau >> 32), tj = (uint32_t)tau;
    int cnt = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) cnt += at_most(s, tk, tj);
    const int c = (int)__reduce_add_sync(kFull, (unsigned)cnt);
    if (c <= kSortCap) {
      int off = cnt;  // inclusive prefix sum over lanes
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        const int o = __shfl_up_sync(kFull, off, d);
        if (lane >= d) off += o;
      }
      off -= cnt;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (at_most(s, tk, tj))
          buf[wib][off++] = ((uint64_t)key[s] << 32) | (uint32_t)(s * kWarp + lane);
      __syncwarp();
      uint64_t a = lane < c ? buf[wib][lane] : kMax64;
      uint64_t b = lane + kWarp < c ? buf[wib][lane + kWarp] : kMax64;
      if constexpr (Wide) {
        // c > 32 (c >= k); the 64 smallest of up to 128 in order: the
        // first 64 ascending, the rest descending (together bitonic), the
        // smaller of each pair of ranks (the lower 64, bitonic), a merge
        if (c <= 2 * kWarp) {
          bitonic_sort64(a, b, lane, true);
        } else {
          uint64_t e = lane + 2 * kWarp < c ? buf[wib][lane + 2 * kWarp] : kMax64;
          uint64_t f = lane + 3 * kWarp < c ? buf[wib][lane + 3 * kWarp] : kMax64;
          bitonic_sort64(a, b, lane, true);
          bitonic_sort64(e, f, lane, false);
          a = min64(a, e);
          b = min64(b, f);
          bitonic_merge64(a, b, lane, true);
        }
        if (lane < k) emit(lane, (uint32_t)a);
        if (lane + kWarp < k) emit(lane + kWarp, (uint32_t)b);
      } else {
        if (c > kWarp) {
          // the 32 smallest of 64: ascending a, descending b, elementwise
          // min (a bitonic sequence), then a bitonic merge
          a = bitonic_merge32(
              min64(bitonic_sort32(a, lane, true), bitonic_sort32(b, lane, false)), lane, true);
        } else {
          a = bitonic_sort32(a, lane, true);
        }
        if (lane < k) emit(lane, (uint32_t)a);
      }
      return;
    }
  }

  // 3: the exact path, k rounds, each the smallest composite above the last
  if (exact_rows != nullptr && lane == 0) atomicAdd(exact_rows, 1);
  uint32_t pk = 0, pj = 0;
  for (int r = 0; r < k; ++r) {
    uint32_t mk = 0xffffffffu, mj = 0xffffffffu;
    bool found = false;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if ((r == 0 || !at_most(s, pk, pj)) && (!found || key[s] < mk)) {
        mk = key[s];
        mj = (uint32_t)(s * kWarp + lane);
        found = true;
      }
    pk = __reduce_min_sync(kFull, mk);
    pj = __reduce_min_sync(kFull, mk == pk ? mj : 0xffffffffu);
    if (lane == (r % kWarp)) emit(r, pj);
  }
}

// Launches the instantiation with the fewest slots that hold a row of w.
template <bool Wide, int S, int... Rest>
cudaError_t launch_slots(int blocks, cudaStream_t stream, const float* d2, const int32_t* cand,
                         float* vals, int32_t* idx, int n, int w, int k, int32_t* exact_rows) {
  if constexpr (sizeof...(Rest) > 0) {
    if (w > S * kWarp)
      return launch_slots<Wide, Rest...>(blocks, stream, d2, cand, vals, idx, n, w, k,
                                         exact_rows);
  }
  knn_select_kernel<S, Wide><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      d2, cand, vals, idx, n, w, k, exact_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_select_launch(const void* d2, const void* cand, void* vals, void* idx,
                                 int n, int w, int k, void* exact_rows, void* stream) {
  if (w > kWarp * kMaxPerThread || k > w || k < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const auto launch = k > kWarp && k <= 2 * kWarp ? launch_slots<true, 1, 2, 4, 8, 16, 21, 32>
                                                  : launch_slots<false, 1, 2, 4, 8, 16, 21, 32>;
  return (int)launch(blocks, (cudaStream_t)stream, (const float*)d2, (const int32_t*)cand,
                     (float*)vals, (int32_t*)idx, n, w, k, (int32_t*)exact_rows);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
