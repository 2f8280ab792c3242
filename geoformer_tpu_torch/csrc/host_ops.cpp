// Native host ops of the data pipeline (the port's copy of
// geoformer_tpu/native/host_ops.cpp, built with the same flags by
// geoformer_tpu_torch/native.py, so that both packages compute the same
// floats). The reference's host-side C++ components:
//  - voxelize_idx: builds the point<->voxel rulebook (reference
//    lib/pointgroup_ops/src/voxelize/voxelize.cpp:10-152 uses a
//    google::dense_hash_map; we sort packed 64-bit keys — same output
//    contract: input_map [N] point->voxel id, output_map rulebook
//    [M x (1+maxActive)] listing the points of each voxel).
//  - elastic_blur3 + trilinear_gather: the two hot loops of the elastic
//    distortion augmentation (reference datasets/scannetv2_inst.py:142-161,
//    scipy convolve + RegularGridInterpolator), run per scene per epoch in
//    the dataloader workers.
//
// Built with g++ as a plain shared library and bound with ctypes. All
// functions use the C ABI.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Sort-based voxel dedup.
//  coords: [n x 3] int32 (non-negative), batch: [n] int32 (or nullptr)
//  out_input_map: [n] int32 point -> voxel id
//  out_voxel_coords: [n x 3] int32 (first maxM rows valid)
//  out_counts: [n] int32 points per voxel
// Returns M = number of voxels.
int32_t voxelize_idx(const int32_t* coords, const int32_t* batch, int64_t n,
                     int32_t spatial, int32_t* out_input_map,
                     int32_t* out_voxel_coords, int32_t* out_counts) {
  if (n <= 0) return 0;
  const int64_t s = spatial;
  std::vector<std::pair<int64_t, int64_t>> keyed(n);  // (key, point idx)
  for (int64_t i = 0; i < n; ++i) {
    int64_t b = batch ? batch[i] : 0;
    int64_t key = ((b * s + coords[i * 3 + 2]) * s + coords[i * 3 + 1]) * s +
                  coords[i * 3 + 0];
    keyed[i] = {key, i};
  }
  std::sort(keyed.begin(), keyed.end());
  int32_t m = -1;
  int64_t prev = -1;
  for (int64_t r = 0; r < n; ++r) {
    if (keyed[r].first != prev) {
      prev = keyed[r].first;
      ++m;
      const int64_t src = keyed[r].second;
      out_voxel_coords[(int64_t)m * 3 + 0] = coords[src * 3 + 0];
      out_voxel_coords[(int64_t)m * 3 + 1] = coords[src * 3 + 1];
      out_voxel_coords[(int64_t)m * 3 + 2] = coords[src * 3 + 2];
      out_counts[m] = 0;
    }
    out_input_map[keyed[r].second] = m;
    ++out_counts[m];
  }
  return m + 1;
}

// Rulebook: voxel -> its points, padded to max_active with -1.
// input_map: [n], out_output_map: [m x (1+max_active)] where column 0 is
// the count (clamped to max_active) — the reference's output_map layout
// (voxelize.cpp:107-151).
void voxel_rulebook(const int32_t* input_map, int64_t n, int32_t m,
                    int32_t max_active, int32_t* out_output_map) {
  const int64_t row = 1 + (int64_t)max_active;
  for (int64_t v = 0; v < m; ++v) {
    out_output_map[v * row] = 0;
    for (int64_t k = 1; k < row; ++k) out_output_map[v * row + k] = -1;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t v = input_map[i];
    int32_t& cnt = out_output_map[v * row];
    if (cnt < max_active) out_output_map[v * row + 1 + cnt] = (int32_t)i;
    ++cnt;
  }
  for (int64_t v = 0; v < m; ++v) {
    int32_t& cnt = out_output_map[v * row];
    if (cnt > max_active) cnt = max_active;
  }
}

// Six passes of the separable 3-tap box blur the reference applies to the
// elastic noise grids (blur0/blur1/blur2 twice, scannetv2_inst.py:146-152).
// noise: [3 x dx x dy x dz] float32, blurred in place via a scratch copy.
void elastic_blur3(float* noise, int32_t dx, int32_t dy, int32_t dz) {
  const int64_t sz = (int64_t)dx * dy * dz;
  std::vector<float> tmp(sz);
  const float k = 1.0f / 3.0f;
  for (int c = 0; c < 3; ++c) {
    float* g = noise + (int64_t)c * sz;
    for (int pass = 0; pass < 2; ++pass) {
      // axis 0
      std::memcpy(tmp.data(), g, sz * sizeof(float));
      for (int64_t x = 0; x < dx; ++x)
        for (int64_t y = 0; y < dy; ++y)
          for (int64_t z = 0; z < dz; ++z) {
            float acc = tmp[(x * dy + y) * dz + z];
            if (x > 0) acc += tmp[((x - 1) * dy + y) * dz + z];
            if (x + 1 < dx) acc += tmp[((x + 1) * dy + y) * dz + z];
            g[(x * dy + y) * dz + z] = acc * k;
          }
      // axis 1
      std::memcpy(tmp.data(), g, sz * sizeof(float));
      for (int64_t x = 0; x < dx; ++x)
        for (int64_t y = 0; y < dy; ++y)
          for (int64_t z = 0; z < dz; ++z) {
            float acc = tmp[(x * dy + y) * dz + z];
            if (y > 0) acc += tmp[(x * dy + y - 1) * dz + z];
            if (y + 1 < dy) acc += tmp[(x * dy + y + 1) * dz + z];
            g[(x * dy + y) * dz + z] = acc * k;
          }
      // axis 2
      std::memcpy(tmp.data(), g, sz * sizeof(float));
      for (int64_t x = 0; x < dx; ++x)
        for (int64_t y = 0; y < dy; ++y)
          for (int64_t z = 0; z < dz; ++z) {
            float acc = tmp[(x * dy + y) * dz + z];
            if (z > 0) acc += tmp[(x * dy + y) * dz + z - 1];
            if (z + 1 < dz) acc += tmp[(x * dy + y) * dz + z + 1];
            g[(x * dy + y) * dz + z] = acc * k;
          }
    }
  }
}

// Trilinear interpolation of the 3 blurred noise grids at point coords.
// Grid axis i spans [-(d_i-1)*gran, +(d_i-1)*gran] with d_i samples
// (reference ax/interp, scannetv2_inst.py:153-158); out of bounds -> 0.
// pts: [n x 3] float32 (the |mag|-scaled displacement is applied by caller).
void trilinear_gather(const float* noise, int32_t dx, int32_t dy, int32_t dz,
                      float gran, const float* pts, int64_t n, float* out) {
  const int64_t sz = (int64_t)dx * dy * dz;
  const int32_t d[3] = {dx, dy, dz};
  for (int64_t i = 0; i < n; ++i) {
    float u[3], fl[3];
    int32_t i0[3];
    bool oob = false;
    for (int a = 0; a < 3; ++a) {
      // map world coord to grid index: x_grid = (x + (d-1)*gran) / (2*gran)
      // spacing between samples is 2*gran
      const float span = (d[a] - 1) * gran;
      const float g = (pts[i * 3 + a] + span) / (2.0f * gran);
      if (g < 0.0f || g > (float)(d[a] - 1)) { oob = true; break; }
      i0[a] = (int32_t)g;
      if (i0[a] >= d[a] - 1) i0[a] = d[a] - 2 < 0 ? 0 : d[a] - 2;
      fl[a] = g - i0[a];
      u[a] = fl[a];
    }
    if (oob) {
      out[i * 3 + 0] = out[i * 3 + 1] = out[i * 3 + 2] = 0.0f;
      continue;
    }
    for (int c = 0; c < 3; ++c) {
      const float* g = noise + (int64_t)c * sz;
      float acc = 0.0f;
      for (int corner = 0; corner < 8; ++corner) {
        const int ox = (corner >> 0) & 1, oy = (corner >> 1) & 1,
                  oz = (corner >> 2) & 1;
        int32_t x = i0[0] + ox, y = i0[1] + oy, z = i0[2] + oz;
        if (x >= d[0]) x = d[0] - 1;
        if (y >= d[1]) y = d[1] - 1;
        if (z >= d[2]) z = d[2] - 1;
        const float w = (ox ? u[0] : 1 - u[0]) * (oy ? u[1] : 1 - u[1]) *
                        (oz ? u[2] : 1 - u[2]);
        acc += w * g[((int64_t)x * d[1] + y) * d[2] + z];
      }
      out[i * 3 + c] = acc;
    }
  }
}

}  // extern "C"
