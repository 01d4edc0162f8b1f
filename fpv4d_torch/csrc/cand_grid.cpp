// Voxel candidate tables of the contact nearest-neighbour grid
// (ops/nn.py VoxelGrid), built on the host: the port's copy of the
// reference's native builder (fpv4d_cand_grid_plan and
// fpv4d_cand_grid_fill of native/fpv4d_native.cpp:440-610).
//
// Per cell, the <= K points of its 3x3x3 neighbourhood nearest the cell
// centre; point order within a cell is the input order. The NumPy loop
// of ops/nn.py builds the same tables in seconds at 1e5 points; this
// takes a fraction of that.
//
// C interface, loaded with ctypes (io/native.py); built by
// ops/cuda_build.py with the host compiler into fpv4d_torch/_build/.
// The arithmetic is the reference's, statement for statement, and is
// compiled with FMA contraction as the reference's -march=native build
// is, so the overflow ranking (distance to the cell centre) and thus the
// tables are the reference's at near-ties too.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// Phase 1: choose the grid box. Coarsens h by 1.5x until the cell
// count fits max_cells. Writes origin[3], dims[3], h_out[1]; returns
// the cell count, or -1 for no points, a non-positive h, a non-finite
// coordinate or an extent whose cell count would overflow.
long cand_grid_plan(const float *pts, long n, double h, long max_cells,
                    float *origin, long *dims, double *h_out) {
  if (n <= 0 || h <= 0) return -1;
  float mins[3] = {1e30f, 1e30f, 1e30f};
  float maxs[3] = {-1e30f, -1e30f, -1e30f};
  bool finite = true;
  for (long i = 0; i < n; i++)
    for (int a = 0; a < 3; a++) {
      float v = pts[3 * i + a];
      finite &= std::isfinite(v);
      mins[a] = std::min(mins[a], v);
      maxs[a] = std::max(maxs[a], v);
    }
  if (!finite) return -1;
  for (int a = 0; a < 3; a++)
    if ((double)maxs[a] - (double)mins[a] > 1e12) return -1;
  for (int a = 0; a < 3; a++) {
    mins[a] -= h;
    maxs[a] += h;
  }
  long d[3];
  for (;;) {
    long prod = 1;
    for (int a = 0; a < 3; a++) {
      // float division, as the NumPy builder divides f32 arrays by h
      double cells = std::ceil((double)(float)((maxs[a] - mins[a])
                                               / (float)h));
      if (!(cells >= 1)) cells = 1;
      if (cells > 1e15) return -1;
      d[a] = (long)cells;
      if (prod > max_cells / std::max(1L, d[a]) + 1) {
        prod = max_cells + 1;
        break;
      }
      prod *= d[a];
    }
    if (prod <= max_cells) break;
    h *= 1.5;  // double, as the NumPy builder coarsens
  }
  for (int a = 0; a < 3; a++) {
    origin[a] = mins[a];
    dims[a] = d[a];
  }
  *h_out = h;
  return d[0] * d[1] * d[2];
}

// Phase 2: fill cand_pts [num_cells*K*3] f32 and cand_idx
// [num_cells*K] i32 (-1 = empty slot). Returns 0, or -1 for bad
// arguments.
long cand_grid_fill(const float *pts, long n, const float *origin,
                    const long *dims, double h, long K, float *cand_pts,
                    int *cand_idx) {
  if (n <= 0 || h <= 0 || K <= 0) return -1;
  const long dx = dims[0], dy = dims[1], dz = dims[2];
  const long num_cells = dx * dy * dz;
  memset(cand_pts, 0, sizeof(float) * num_cells * K * 3);
  for (long i = 0; i < num_cells * K; i++) cand_idx[i] = -1;

  // counting sort of the points by flat cell id (stable: input order
  // within a cell)
  std::vector<long> cell_of(n);
  std::vector<long> counts(num_cells + 1, 0);
  const float hf = (float)h;
  for (long i = 0; i < n; i++) {
    long c[3];
    for (int a = 0; a < 3; a++) {
      // f32 subtract and divide, as NumPy's floor((pts - mins) / h)
      long v = (long)std::floor((pts[3 * i + a] - origin[a]) / hf);
      c[a] = std::min(std::max(v, 0L), dims[a] - 1);
    }
    cell_of[i] = (c[0] * dy + c[1]) * dz + c[2];
    counts[cell_of[i] + 1]++;
  }
  std::vector<long> starts(num_cells + 1);
  starts[0] = 0;
  for (long c = 0; c < num_cells; c++)
    starts[c + 1] = starts[c] + counts[c + 1];
  std::vector<long> order(n);
  {
    std::vector<long> cursor(starts.begin(), starts.end() - 1);
    for (long i = 0; i < n; i++) order[cursor[cell_of[i]]++] = i;
  }

  // active cells: the union of the occupied cells' 3x3x3 neighbourhoods
  std::vector<char> active(num_cells, 0);
  for (long c = 0; c < num_cells; c++) {
    if (starts[c + 1] == starts[c]) continue;
    long cx = c / (dy * dz), cy = (c / dz) % dy, cz = c % dz;
    for (long ox = -1; ox <= 1; ox++) {
      long nx = cx + ox;
      if (nx < 0 || nx >= dx) continue;
      for (long oy = -1; oy <= 1; oy++) {
        long ny = cy + oy;
        if (ny < 0 || ny >= dy) continue;
        for (long oz = -1; oz <= 1; oz++) {
          long nz = cz + oz;
          if (nz < 0 || nz >= dz) continue;
          active[(nx * dy + ny) * dz + nz] = 1;
        }
      }
    }
  }

  std::vector<long> gathered;
  std::vector<std::pair<float, long>> byd;
  for (long c = 0; c < num_cells; c++) {
    if (!active[c]) continue;
    long cx = c / (dy * dz), cy = (c / dz) % dy, cz = c % dz;
    gathered.clear();
    for (long ox = -1; ox <= 1; ox++) {
      long nx = cx + ox;
      if (nx < 0 || nx >= dx) continue;
      for (long oy = -1; oy <= 1; oy++) {
        long ny = cy + oy;
        if (ny < 0 || ny >= dy) continue;
        for (long oz = -1; oz <= 1; oz++) {
          long nz = cz + oz;
          if (nz < 0 || nz >= dz) continue;
          long nc = (nx * dy + ny) * dz + nz;
          for (long k = starts[nc]; k < starts[nc + 1]; k++)
            gathered.push_back(order[k]);
        }
      }
    }
    if (gathered.empty()) continue;
    if ((long)gathered.size() > K) {
      float ctr[3] = {origin[0] + (cx + 0.5f) * h,
                      origin[1] + (cy + 0.5f) * h,
                      origin[2] + (cz + 0.5f) * h};
      byd.clear();
      byd.reserve(gathered.size());
      for (long gi : gathered) {
        float ddx = pts[3 * gi] - ctr[0], ddy = pts[3 * gi + 1] - ctr[1],
              ddz = pts[3 * gi + 2] - ctr[2];
        byd.emplace_back(ddx * ddx + ddy * ddy + ddz * ddz, gi);
      }
      // the K nearest in ascending order (partial_sort, as the
      // reference: exact ties may order differently from NumPy's
      // argsort)
      std::partial_sort(byd.begin(), byd.begin() + K, byd.end(),
                        [](const std::pair<float, long> &a,
                           const std::pair<float, long> &b) {
                          return a.first < b.first;
                        });
      gathered.clear();
      for (long k = 0; k < K; k++) gathered.push_back(byd[k].second);
    }
    for (size_t k = 0; k < gathered.size(); k++) {
      long gi = gathered[k];
      cand_idx[c * K + (long)k] = (int)gi;
      memcpy(&cand_pts[(c * K + (long)k) * 3], &pts[3 * gi], 12);
    }
  }
  return 0;
}

}  // extern "C"
