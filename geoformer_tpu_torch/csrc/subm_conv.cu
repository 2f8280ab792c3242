// Submanifold 3x3x3 sparse convolution as gather-GEMMs (kernel K4): the
// forward, the input gradient and the weight gradient.
//
// Replaces no TPU kernel: the JAX package computes this op with XLA gathers
// and a dot (geoformer_tpu/ops/sparse_conv.py:subm_conv). The port's plain
// form of it (geoformer_tpu_torch/ops/sparse_conv.py:subm_conv_plain, the CPU
// path) writes each chunk of offsets' gathered rows to device memory ([B, V,
// c, Cin] in the operand type, then a float32 copy), multiplies them in a
// float32 GEMM and adds the chunks; its backward adds every read's gradient
// into its row with float atomics. On the card those pieces took ~1.9 s of a
// 2.95 s training step (tens of thousands of launches a step, gigabytes of
// gathered rows a conv). Here a block owns a tile of output rows and walks
// the 27 offsets itself: the gathered rows live only in shared memory.
//
// Layouts: X [B, V, Cin] f32; map [B, V, 27] i32 (the row of the same scene
// read through each offset, V for none: a pad read, which is zeros and reads
// no memory); n_voxels [B] i32 or null (rows at or past n_voxels[b] neither
// read nor are read: their tiles write zeros and read nothing); W [27, Cin,
// Cout] f32; out [B, V, Cout] f32. Offset k = (dz+1)*9 + (dy+1)*3 + (dx+1).
//
// Precision: `narrow` rounds X and W to bf16 (the configuration's
// tpu_compute_dtype: bfloat16) as they are loaded, which the plain version
// does with a copy; the products of bf16 values are exact in float32, and
// every sum is float32. TF32 is never used. The library builds with
// --fmad=false, so the f32 products are written as __fmaf_rn.
//
// - Forward, bf16 (subm_fwd_mma_kernel): tensor cores, mma.sync m16n8k16
//   (bf16 operands, f32 accumulate). A block of 4 warps owns 64 output rows
//   and all of Cout (up to 14 n-tiles of 8 in registers); the neighbour rows
//   and W[k] are copied to shared memory in f32 by cp.async (pads and ragged
//   edges zero-filled), double-buffered across stages of (offset, 16 or 32
//   input channels), and rounded to bf16 as the fragments are built.
// - Forward, f32, and input gradient (simt_kernel): float32 FMA, 4x4 outputs
//   a thread, the tile's A rows gathered through the map into shared memory
//   in chunks of 16 columns. The input gradient is the same gather-GEMM over
//   the transposed map: dX[i] = sum_k round(dY[nbr_t[i, k]] @ W[k]^T), each
//   read's gradient (one offset's product) rounded to the operand type
//   before its float32 sum, and the sum rounded too (the rounding points of
//   the plain version's autograd); dY stays a float32 operand. Each (i, k)
//   has at most one reader, so no atomics.
// - Weight gradient (wgrad_kernel, wgrad_reduce_kernel): dW[k] = sum_o
//   X[nbr[o, k]]^T dY[o] in float32. Blocks take (offset, a slice of row
//   tiles, a 16/32-wide tile of dW[k]); each writes its partial sums, and a
//   second kernel adds the slices in a fixed order and rounds to the
//   operand type: deterministic, no float atomics.
//
// Bound on an H100: at the training step's level-0 shape (B = 8, V = 262,144,
// Cin = Cout = 16), bytes: the int32 map (226 MB), the feature rows (134 MB
// in f32) and the output (134 MB) each once at 3.35 TB/s is 0.15 ms, against
// 2 x rows x 27 x Cin x Cout = 29 GFLOP at 989 TFLOP/s (bf16) = 0.03 ms or
// 67 TFLOP/s (f32) = 0.43 ms. What holds a tile back is the gathered rows'
// latency (one dependent load a (row, offset) after its map entry) and, at
// these widths (16-112 columns), the few products per byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOffsets = 27;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The tile's map rows (rows of it; the rest read as pads) into ids[r * 27 +
// k], and the offsets that any row reads through into *live (bit k).
template <int BM, int THREADS>
__device__ __forceinline__ void load_ids(const int* __restrict__ map, int rows, int v,
                                         int* ids, unsigned* live) {
  unsigned mine = 0;
  const int n = rows * kOffsets;
  for (int i = threadIdx.x; i < BM * kOffsets; i += THREADS) {
    const int id = i < n ? map[i] : v;
    ids[i] = id;
    if (id < v) mine |= 1u << (i % kOffsets);
  }
  mine = __reduce_or_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicOr(live, mine);
}

__device__ __forceinline__ int next_live(unsigned live, int k) {
  const unsigned rest = k + 1 >= 32 ? 0u : live >> (k + 1);
  return rest ? k + __ffs(rest) : kOffsets;
}

// ---------------- tensor-core forward (bf16 operands) ----------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int src = valid ? BYTES : 0;  // 0: fill the destination with zeros
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
                 "n"(BYTES), "r"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kMmaThreads = 128;  // 4 warps, 16 rows each
constexpr int kMmaRows = 64;

// Shared-memory row strides (floats): LDA = 8 mod 16 keeps a warp's float2
// A-fragment loads, LDB = 4 mod 8 its scalar B-fragment loads, on distinct
// banks; both keep rows 16-byte aligned for cp.async.
template <int KCH, int NT>
struct MmaSmem {
  static constexpr int LDA = KCH + 8, LDB = NT * 8 + 4;
  static constexpr int A_SIZE = kMmaRows * LDA, B_SIZE = KCH * LDB;
  static constexpr int BYTES = 2 * (A_SIZE + B_SIZE) * 4 + kMmaRows * kOffsets * 4 + 16;
};

// KCH input channels a stage (16 or 32), NT n-tiles of 8 output channels
// (NT * 8 >= Cout), VEC floats a cp.async (4 where Cin and Cout allow it).
template <int KCH, int NT, int VEC>
__global__ void __launch_bounds__(kMmaThreads)
subm_fwd_mma_kernel(const float* __restrict__ x, const int* __restrict__ map,
                    const int* __restrict__ nvox, const float* __restrict__ w,
                    float* __restrict__ out, int v, int cin, int cout) {
  using L = MmaSmem<KCH, NT>;
  constexpr int LDA = L::LDA, LDB = L::LDB, A_SIZE = L::A_SIZE, B_SIZE = L::B_SIZE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);  // [2][kMmaRows][LDA]
  float* bs = as + 2 * A_SIZE;                     // [2][KCH][LDB]
  int* ids = reinterpret_cast<int*>(bs + 2 * B_SIZE);
  unsigned* live = reinterpret_cast<unsigned*>(ids + kMmaRows * kOffsets);

  const int b = blockIdx.y, m0 = blockIdx.x * kMmaRows;
  const int n_b = nvox ? min(nvox[b], v) : v;
  const int64_t row0 = (int64_t)b * v;
  const int rows_out = min(kMmaRows, v - m0);
  if (m0 >= n_b) {  // no row of the tile reads or is read: zeros, nothing read
    for (int i = threadIdx.x; i < rows_out * cout; i += kMmaThreads)
      out[(row0 + m0) * cout + i] = 0.0f;
    return;
  }
  if (threadIdx.x == 0) *live = 0u;
  __syncthreads();
  load_ids<kMmaRows, kMmaThreads>(map + (row0 + m0) * kOffsets, min(kMmaRows, n_b - m0), v,
                                  ids, live);
  __syncthreads();
  const unsigned live_k = *live;

  // stage (k, kc) into buffer buf: the tile's neighbour rows' columns
  // [kc, kc + KCH) and rows [kc, kc + KCH) of W[k], zeros past the edges
  auto issue = [&](int buf, int k, int kc) {
    float* a = as + buf * A_SIZE;
    constexpr int AU = KCH / VEC;
    for (int i = threadIdx.x; i < kMmaRows * AU; i += kMmaThreads) {
      const int r = i / AU, c = (i % AU) * VEC;
      const int id = ids[r * kOffsets + k];
      const bool ok = id < v && kc + c < cin;
      const float* src = ok ? x + (row0 + id) * cin + kc + c : x;
      cp_async<VEC * 4>(a + r * LDA + c, src, ok);
    }
    float* bb = bs + buf * B_SIZE;
    constexpr int BU = NT * 8 / VEC;
    for (int i = threadIdx.x; i < KCH * BU; i += kMmaThreads) {
      const int r = i / BU, c = (i % BU) * VEC;
      const bool ok = kc + r < cin && c < cout;
      const float* src = ok ? w + ((int64_t)k * cin + kc + r) * cout + c : w;
      cp_async<VEC * 4>(bb + r * LDB + c, src, ok);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g;  // this thread's A rows: ra and ra + 8
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  int k = next_live(live_k, -1), kc = 0, buf = 0;
  if (k < kOffsets) issue(0, k, 0);
  cp_async_commit();
  while (k < kOffsets) {
    int nk = k, nkc = kc + KCH;
    if (nkc >= cin) {
      nkc = 0;
      nk = next_live(live_k, k);
    }
    if (nk < kOffsets) issue(buf ^ 1, nk, nkc);
    cp_async_commit();
    cp_async_wait_one();  // this stage's copies have landed
    __syncthreads();
    const float* a = as + buf * A_SIZE;
    const float* bb = bs + buf * B_SIZE;
#pragma unroll
    for (int kk = 0; kk < KCH; kk += 16) {
      uint32_t af[4];
      const float2 a0 = *reinterpret_cast<const float2*>(a + ra * LDA + kk + 2 * t);
      const float2 a1 = *reinterpret_cast<const float2*>(a + (ra + 8) * LDA + kk + 2 * t);
      const float2 a2 = *reinterpret_cast<const float2*>(a + ra * LDA + kk + 8 + 2 * t);
      const float2 a3 = *reinterpret_cast<const float2*>(a + (ra + 8) * LDA + kk + 8 + 2 * t);
      af[0] = pack_bf16(a0.x, a0.y);
      af[1] = pack_bf16(a1.x, a1.y);
      af[2] = pack_bf16(a2.x, a2.y);
      af[3] = pack_bf16(a3.x, a3.y);
      const float* b_lo = bb + (kk + 2 * t) * LDB + g;
      const float* b_hi = bb + (kk + 8 + 2 * t) * LDB + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint32_t b0 = pack_bf16(b_lo[n * 8], b_lo[n * 8 + LDB]);
        const uint32_t b1 = pack_bf16(b_hi[n * 8], b_hi[n * 8 + LDB]);
        mma_bf16(acc[n], af, b0, b1);
      }
    }
    __syncthreads();  // the buffer is free for the stage after next
    k = nk;
    kc = nkc;
    buf ^= 1;
  }

  // rows ra, ra + 8; columns n * 8 + 2t, + 1
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + h * 8;
      if (r >= rows_out) continue;
      float* o = out + (row0 + m0 + r) * cout;
      const int c = n * 8 + 2 * t;
      if (c < cout) o[c] = acc[n][2 * h];
      if (c + 1 < cout) o[c + 1] = acc[n][2 * h + 1];
    }
  }
}

// ---------------- float32 FMA gather-GEMM: forward and input gradient ----------------

constexpr int kSimtThreads = 128;
constexpr int kSimtChunk = 16;  // reduction columns staged at a time

// Forward (float32 operands): A = X (K = Cin), B_k = W[k] (N = Cout), map =
// nbr. Input gradient: A = dY (K = Cout), B_k = W[k]^T (N = Cin), map =
// nbr_t; NARROW rounds W to bf16 as it is loaded, and each offset's product
// before it is added, and the sum.
template <int BN, bool DGRAD, bool NARROW>
__global__ void __launch_bounds__(kSimtThreads)
simt_kernel(const float* __restrict__ a_rows, const int* __restrict__ map,
            const int* __restrict__ nvox, const float* __restrict__ w,
            float* __restrict__ out, int v, int kdim, int ndim) {
  constexpr int TM = 4, TN = 4;
  constexpr int TX = BN / TN, TY = kSimtThreads / TX, BM = TY * TM;
  constexpr int KC = kSimtChunk;
  __shared__ int ids[BM * kOffsets];
  __shared__ float as[BM][KC + 1];
  __shared__ __align__(16) float bs[KC][BN];
  __shared__ unsigned live;

  const int b = blockIdx.y, m0 = blockIdx.x * BM, n0 = blockIdx.z * BN;
  const int n_b = nvox ? min(nvox[b], v) : v;
  const int64_t row0 = (int64_t)b * v;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[TM][TN] = {};
  float part[TM][TN] = {};
  if (m0 < n_b) {
    if (threadIdx.x == 0) live = 0u;
    __syncthreads();
    load_ids<BM, kSimtThreads>(map + (row0 + m0) * kOffsets, min(BM, n_b - m0), v, ids, &live);
    __syncthreads();
    const unsigned live_k = live;
    for (int k = next_live(live_k, -1); k < kOffsets; k = next_live(live_k, k)) {
      for (int kc = 0; kc < kdim; kc += KC) {
        for (int i = threadIdx.x; i < BM * KC; i += kSimtThreads) {
          const int r = i / KC, c = i % KC;
          const int id = ids[r * kOffsets + k];
          float val = 0.0f;
          if (id < v && kc + c < kdim) val = a_rows[(row0 + id) * kdim + kc + c];
          as[r][c] = val;
        }
        for (int i = threadIdx.x; i < KC * BN; i += kSimtThreads) {
          const int c = i / BN, j = i % BN;
          float val = 0.0f;
          if (kc + c < kdim && n0 + j < ndim)
            val = DGRAD ? w[((int64_t)k * ndim + n0 + j) * kdim + kc + c]
                        : w[((int64_t)k * kdim + kc + c) * ndim + n0 + j];
          if (NARROW) val = round_bf16(val);
          bs[c][j] = val;
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          float av[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = as[ty * TM + i][c];
          const float4 bv = *reinterpret_cast<const float4*>(&bs[c][tx * TN]);
          const float bw[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              if (DGRAD) part[i][j] = __fmaf_rn(av[i], bw[j], part[i][j]);
              else acc[i][j] = __fmaf_rn(av[i], bw[j], acc[i][j]);
            }
        }
        __syncthreads();
      }
      if (DGRAD) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[i][j] = __fadd_rn(acc[i][j], NARROW ? round_bf16(part[i][j]) : part[i][j]);
            part[i][j] = 0.0f;
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= v) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c < ndim) out[(row0 + r) * ndim + c] = DGRAD && NARROW ? round_bf16(acc[i][j]) : acc[i][j];
    }
  }
}

// ---------------- weight gradient ----------------

constexpr int kWgradThreads = 256;
constexpr int kWgradRows = 64;  // rows a tile

// partial[slice][k][ci][co] over the row tiles t = slice, slice + slices, ...
// of all scenes: each thread keeps 4x4 of an MC x NC tile of dW[k] over its
// row lane (rows lane, lane + LANES, ... of each tile); the lanes' sums are
// added in lane order at the end.
template <int MC, int NC, bool NARROW>
__global__ void __launch_bounds__(kWgradThreads)
wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
             const int* __restrict__ map, const int* __restrict__ nvox,
             float* __restrict__ partial, int nb, int v, int cin, int cout, int slices) {
  constexpr int TXC = NC / 4, TYC = MC / 4, GROUP = TXC * TYC;
  constexpr int LANES = kWgradThreads / GROUP;
  constexpr int R = kWgradRows;
  __shared__ __align__(16) float xs[R][MC];
  __shared__ __align__(16) float ys[R][NC];
  __shared__ float red[LANES][GROUP * 16];
  __shared__ int ids[R];

  const int k = blockIdx.x, slice = blockIdx.y;
  const int tiles_n = (cout + NC - 1) / NC;
  const int ci0 = (blockIdx.z / tiles_n) * MC, co0 = (blockIdx.z % tiles_n) * NC;
  const int lane = threadIdx.x / GROUP, tt = threadIdx.x % GROUP;
  const int tx = tt % TXC, ty = tt / TXC;
  float acc[4][4] = {};
  const int per_scene = (v + R - 1) / R;
  const int64_t tiles = (int64_t)nb * per_scene;
  for (int64_t tile = slice; tile < tiles; tile += slices) {
    const int b = (int)(tile / per_scene), m0 = (int)(tile % per_scene) * R;
    const int n_b = nvox ? min(nvox[b], v) : v;
    if (m0 >= n_b) continue;
    const int rows = min(R, n_b - m0);
    const int64_t row0 = (int64_t)b * v + m0;
    int id = v;
    if (threadIdx.x < R && threadIdx.x < rows) id = map[(row0 + threadIdx.x) * kOffsets + k];
    if (threadIdx.x < R) ids[threadIdx.x] = id;
    if (!__syncthreads_or(id < v)) continue;  // no row reads through k here
    for (int i = threadIdx.x; i < R * MC; i += kWgradThreads) {
      const int r = i / MC, c = i % MC;
      const int nid = ids[r];
      float val = 0.0f;
      if (nid < v && ci0 + c < cin) val = x[((int64_t)b * v + nid) * cin + ci0 + c];
      xs[r][c] = NARROW ? round_bf16(val) : val;
    }
    for (int i = threadIdx.x; i < R * NC; i += kWgradThreads) {
      const int r = i / NC, c = i % NC;
      ys[r][c] = r < rows && co0 + c < cout ? dy[(row0 + r) * cout + co0 + c] : 0.0f;
    }
    __syncthreads();
    for (int r = lane; r < R; r += LANES) {
      const float4 a4 = *reinterpret_cast<const float4*>(&xs[r][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&ys[r][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[lane][tt * 16 + i * 4 + j] = acc[i][j];
  __syncthreads();
  for (int e = threadIdx.x; e < MC * NC; e += kWgradThreads) {
    const int ci = e / NC, co = e % NC;
    const int owner = (ci / 4) * TXC + co / 4, slot = owner * 16 + (ci % 4) * 4 + co % 4;
    float s = 0.0f;
    for (int l = 0; l < LANES; ++l) s = __fadd_rn(s, red[l][slot]);
    if (ci0 + ci < cin && co0 + co < cout)
      partial[(((int64_t)slice * kOffsets + k) * cin + ci0 + ci) * cout + co0 + co] = s;
  }
}

template <bool NARROW>
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                    int slices, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int j = 0; j < slices; ++j) s = __fadd_rn(s, partial[(int64_t)j * n + i]);
  dw[i] = NARROW ? round_bf16(s) : s;
}

// ---------------- launchers ----------------

int blocks_of(int n, int per) { return (n + per - 1) / per; }

template <int KCH, int NT, int VEC>
int launch_mma(const float* x, const int* map, const int* nvox, const float* w, float* out,
               int nb, int v, int cin, int cout, cudaStream_t s) {
  constexpr int bytes = MmaSmem<KCH, NT>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      subm_fwd_mma_kernel<KCH, NT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(blocks_of(v, kMmaRows), nb);
  subm_fwd_mma_kernel<KCH, NT, VEC><<<grid, kMmaThreads, bytes, s>>>(x, map, nvox, w, out, v,
                                                                      cin, cout);
  return (int)cudaGetLastError();
}

template <int KCH, int VEC>
int launch_mma_nt(const float* x, const int* map, const int* nvox, const float* w, float* out,
                  int nb, int v, int cin, int cout, cudaStream_t s) {
  const int nt = blocks_of(cout, 8);
#define GF_MMA(N) \
  if (nt <= N) return launch_mma<KCH, N, VEC>(x, map, nvox, w, out, nb, v, cin, cout, s);
  GF_MMA(2) GF_MMA(4) GF_MMA(6) GF_MMA(8) GF_MMA(10) GF_MMA(12) GF_MMA(14)
#undef GF_MMA
  return (int)cudaErrorInvalidValue;  // Cout > 112: the wrapper refuses it first
}

template <int VEC>
int launch_mma_k(const float* x, const int* map, const int* nvox, const float* w, float* out,
                 int nb, int v, int cin, int cout, cudaStream_t s) {
  if (cin <= 16) return launch_mma_nt<16, VEC>(x, map, nvox, w, out, nb, v, cin, cout, s);
  return launch_mma_nt<32, VEC>(x, map, nvox, w, out, nb, v, cin, cout, s);
}

template <bool DGRAD, bool NARROW>
int launch_simt(const float* a, const int* map, const int* nvox, const float* w, float* out,
                int nb, int v, int kdim, int ndim, cudaStream_t s) {
#define GF_SIMT(BN)                                                                       \
  {                                                                                       \
    constexpr int bm = kSimtThreads / (BN / 4) * 4;                                       \
    const dim3 grid(blocks_of(v, bm), nb, blocks_of(ndim, BN));                           \
    simt_kernel<BN, DGRAD, NARROW><<<grid, kSimtThreads, 0, s>>>(a, map, nvox, w, out, v, \
                                                                 kdim, ndim);             \
    return (int)cudaGetLastError();                                                       \
  }
  if (ndim <= 16) GF_SIMT(16)
  if (ndim <= 32) GF_SIMT(32)
  GF_SIMT(64)
#undef GF_SIMT
}

template <int MC, int NC, bool NARROW>
int launch_wgrad_tile(const float* x, const float* dy, const int* map, const int* nvox,
                      float* partial, float* dw, int nb, int v, int cin, int cout, int slices,
                      cudaStream_t s) {
  const dim3 grid(kOffsets, slices, blocks_of(cin, MC) * blocks_of(cout, NC));
  wgrad_kernel<MC, NC, NARROW><<<grid, kWgradThreads, 0, s>>>(x, dy, map, nvox, partial, nb, v,
                                                              cin, cout, slices);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)kOffsets * cin * cout;
  wgrad_reduce_kernel<NARROW><<<(int)((n + 255) / 256), 256, 0, s>>>(partial, dw, slices, n);
  return (int)cudaGetLastError();
}

template <bool NARROW>
int launch_wgrad(const float* x, const float* dy, const int* map, const int* nvox,
                 float* partial, float* dw, int nb, int v, int cin, int cout, int slices,
                 cudaStream_t s) {
  if (cin <= 16 && cout <= 16)
    return launch_wgrad_tile<16, 16, NARROW>(x, dy, map, nvox, partial, dw, nb, v, cin, cout,
                                             slices, s);
  if (cin <= 16)
    return launch_wgrad_tile<16, 32, NARROW>(x, dy, map, nvox, partial, dw, nb, v, cin, cout,
                                             slices, s);
  if (cout <= 16)
    return launch_wgrad_tile<32, 16, NARROW>(x, dy, map, nvox, partial, dw, nb, v, cin, cout,
                                             slices, s);
  return launch_wgrad_tile<32, 32, NARROW>(x, dy, map, nvox, partial, dw, nb, v, cin, cout,
                                           slices, s);
}

bool bad_shape(int nb, int v, int cin, int cout) {
  return nb < 1 || v < 1 || cin < 1 || cout < 1;
}

}  // namespace

// x [nb, v, cin] f32, map [nb, v, 27] i32 in [0, v], nvox [nb] i32 or null,
// w [27, cin, cout] f32, out [nb, v, cout] f32, all contiguous. narrow: bf16
// operands on tensor cores (cout <= 112), else float32 FMA.
extern "C" int subm_conv_fwd_launch(const void* x, const void* map, const void* nvox,
                                    const void* w, void* out, int nb, int v, int cin, int cout,
                                    int narrow, void* stream) {
  if (bad_shape(nb, v, cin, cout)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  const int* m = (const int*)map;
  const int* n = (const int*)nvox;
  float* o = (float*)out;
  if (!narrow) return launch_simt<false, false>(xf, m, n, wf, o, nb, v, cin, cout, s);
  const bool vec = cin % 4 == 0 && cout % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  if (vec) return launch_mma_k<4>(xf, m, n, wf, o, nb, v, cin, cout, s);
  return launch_mma_k<1>(xf, m, n, wf, o, nb, v, cin, cout, s);
}

// dy [nb, v, cout] f32, map_t [nb, v, 27] i32 (the transposed map), w as
// above, dx [nb, v, cin] f32.
extern "C" int subm_conv_dgrad_launch(const void* dy, const void* map_t, const void* nvox,
                                      const void* w, void* dx, int nb, int v, int cin, int cout,
                                      int narrow, void* stream) {
  if (bad_shape(nb, v, cin, cout)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (narrow)
    return launch_simt<true, true>((const float*)dy, (const int*)map_t, (const int*)nvox,
                                   (const float*)w, (float*)dx, nb, v, cout, cin, s);
  return launch_simt<true, false>((const float*)dy, (const int*)map_t, (const int*)nvox,
                                  (const float*)w, (float*)dx, nb, v, cout, cin, s);
}

// x, dy, map as above; partial [slices, 27, cin, cout] f32 scratch, dw [27,
// cin, cout] f32 (rounded to bf16 values where narrow).
extern "C" int subm_conv_wgrad_launch(const void* x, const void* dy, const void* map,
                                      const void* nvox, void* partial, void* dw, int nb, int v,
                                      int cin, int cout, int slices, int narrow, void* stream) {
  if (bad_shape(nb, v, cin, cout) || slices < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (narrow)
    return launch_wgrad<true>((const float*)x, (const float*)dy, (const int*)map,
                              (const int*)nvox, (float*)partial, (float*)dw, nb, v, cin, cout,
                              slices, s);
  return launch_wgrad<false>((const float*)x, (const float*)dy, (const int*)map,
                             (const int*)nvox, (float*)partial, (float*)dw, nb, v, cin, cout,
                             slices, s);
}
