// The port's host data plane beside the voxel-grid builder: the PLY
// vertex reader, the voxel downsample and a KD-tree nearest-neighbour
// search. A copy of the reference's native/fpv4d_native.cpp (the PLY
// parser with its header validation, fpv4d_voxel_downsample, the
// median-split KD-tree with 16-point leaves), the entry points named
// without the fpv4d_ prefix.
//
// C interface, loaded with ctypes (io/native.py); built by
// ops/cuda_build.py with the host compiler into fpv4d_torch/_build/.
// A file the parser declines (-1, or fewer vertices than declared) is
// read by the port's Python reader (io/ply.py), as the reference reads
// it with its own.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PlyHeader {
  long vertex_count = 0;
  bool binary = false;
  bool big_endian = false;
  long header_bytes = 0;
  // per-vertex property sizes in bytes; x/y/z offsets within a record
  long record_size = 0;
  long x_off = -1, y_off = -1, z_off = -1;
  // field ordinals of x/y/z among the vertex properties (ascii rows)
  int x_idx = -1, y_idx = -1, z_idx = -1;
  int coord_size = 4;  // float32 or float64
  long x_size = 0, y_size = 0, z_size = 0;
};

long type_size(const std::string &t) {
  if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
  if (t == "short" || t == "ushort" || t == "int16" || t == "uint16")
    return 2;
  if (t == "int" || t == "uint" || t == "int32" || t == "uint32" ||
      t == "float" || t == "float32")
    return 4;
  if (t == "double" || t == "float64") return 8;
  return 0;
}

// Parse + VALIDATE the header of an untrusted PLY file. Returns false
// (the caller reads the file with io/ply.py, which raises a clean
// ValueError where the file is bad) on: non-PLY magic, overlong header lines, negative or
// lying vertex counts (declared count exceeding what the file's bytes
// can back — the OOM vector: the Python side allocates
// vertex_count*12 bytes), mixed x/y/z coordinate sizes, offsets
// running past the record, or list properties on vertices.
bool parse_header(FILE *f, PlyHeader *h) {
  char line[1024];
  if (!fgets(line, sizeof line, f)) return false;
  if (strncmp(line, "ply", 3) != 0) return false;
  std::string cur_element;
  bool vertex_seen = false;
  long prop_off = 0;
  int prop_idx = 0;
  while (fgets(line, sizeof line, f)) {
    if (!strchr(line, '\n') && strlen(line) == sizeof line - 1)
      return false;  // header line longer than the buffer: reject
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r'))
      s.pop_back();
    if (s.rfind("format", 0) == 0) {
      h->binary = s.find("binary") != std::string::npos;
      h->big_endian = s.find("big_endian") != std::string::npos;
    } else if (s.rfind("element", 0) == 0) {
      char name[256];
      long count;
      if (sscanf(s.c_str(), "element %255s %ld", name, &count) == 2) {
        if (count < 0) return false;
        cur_element = name;
        if (cur_element == "vertex") {
          h->vertex_count = count;
          vertex_seen = true;
        } else if (!vertex_seen && count > 0) {
          // a non-empty element declared BEFORE the vertex element
          // stores its data first in the file; this reader assumes
          // vertex records start at end_header, so bail to the
          // Python reader instead of silently parsing that
          // element's bytes as vertices
          return false;
        }
        prop_off = 0;
        prop_idx = 0;
      }
    } else if (s.rfind("property", 0) == 0 && cur_element == "vertex") {
      char t[64], n[64];
      if (sscanf(s.c_str(), "property %63s %63s", t, n) == 2) {
        long sz = type_size(t);
        if (sz == 0) return false;  // list property on vertices: bail
        if (strcmp(n, "x") == 0) {
          h->x_off = prop_off;
          h->x_idx = prop_idx;
          h->x_size = sz;
          h->coord_size = (int)sz;
        } else if (strcmp(n, "y") == 0) {
          h->y_off = prop_off;
          h->y_idx = prop_idx;
          h->y_size = sz;
        } else if (strcmp(n, "z") == 0) {
          h->z_off = prop_off;
          h->z_idx = prop_idx;
          h->z_size = sz;
        }
        prop_off += sz;
        prop_idx++;
        h->record_size = prop_off;
      }
    } else if (s == "end_header") {
      h->header_bytes = ftell(f);
      if (h->x_off < 0 || h->y_off < 0 || h->z_off < 0) return false;
      // mixed-size coordinates would read past the record buffer at
      // the widest offset; demand uniform x/y/z and in-bounds offsets
      if (h->x_size != h->y_size || h->y_size != h->z_size)
        return false;
      if (h->record_size <= 0 ||
          h->x_off + h->coord_size > h->record_size ||
          h->y_off + h->coord_size > h->record_size ||
          h->z_off + h->coord_size > h->record_size)
        return false;
      // the declared count must be backed by actual file bytes
      // (binary: full records; ascii: >= 2 bytes per row is the
      // loosest possible line)
      long data_start = h->header_bytes;
      if (fseek(f, 0, SEEK_END) != 0) return false;
      long file_end = ftell(f);
      if (fseek(f, data_start, SEEK_SET) != 0) return false;
      if (file_end < data_start) return false;
      long avail = file_end - data_start;
      if (h->binary) {
        if (h->vertex_count > avail / h->record_size) return false;
      } else {
        if (h->vertex_count > 0 && h->vertex_count > avail / 2)
          return false;
      }
      return true;
    }
  }
  return false;
}

float read_coord(const unsigned char *p, int size, bool big_endian) {
  if (size == 4) {
    uint32_t v;
    memcpy(&v, p, 4);
    if (big_endian) v = __builtin_bswap32(v);
    float out;
    memcpy(&out, &v, 4);
    return out;
  }
  uint64_t v;
  memcpy(&v, p, 8);
  if (big_endian) v = __builtin_bswap64(v);
  double out;
  memcpy(&out, &v, 8);
  return (float)out;
}

}  // namespace

extern "C" {

// Number of vertices in a PLY file, or -1 on parse failure.
long ply_vertex_count(const char *path) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  PlyHeader h;
  bool ok = parse_header(f, &h);
  fclose(f);
  return ok ? h.vertex_count : -1;
}

// Read up to max_pts vertices into out[3*i..3*i+2]. Returns the number
// read, or -1 on failure.
long ply_read_vertices(const char *path, float *out, long max_pts) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  PlyHeader h;
  if (!parse_header(f, &h)) {
    fclose(f);
    return -1;
  }
  long n = std::min(h.vertex_count, max_pts);
  if (h.binary) {
    std::vector<unsigned char> buf(h.record_size);
    for (long i = 0; i < n; i++) {
      if (fread(buf.data(), 1, h.record_size, f) != (size_t)h.record_size) {
        fclose(f);
        return i;
      }
      out[3 * i + 0] =
          read_coord(buf.data() + h.x_off, h.coord_size, h.big_endian);
      out[3 * i + 1] =
          read_coord(buf.data() + h.y_off, h.coord_size, h.big_endian);
      out[3 * i + 2] =
          read_coord(buf.data() + h.z_off, h.coord_size, h.big_endian);
    }
  } else {
    // ascii: x/y/z are whitespace-separated fields at their property
    // ORDINALS (a file with e.g. nx ny nz before x y z must not read
    // the normals as coordinates)
    char line[4096];
    for (long i = 0; i < n; i++) {
      if (!fgets(line, sizeof line, f)) {
        fclose(f);
        return i;
      }
      if (!strchr(line, '\n') && strlen(line) == sizeof line - 1) {
        // row longer than the buffer: the remainder would be parsed
        // as the NEXT row (silent coordinate corruption when its
        // fields happen to line up numerically) — bail to the
        // Python reader instead
        fclose(f);
        return i;
      }
      double v[3] = {0, 0, 0};
      int found = 0, field = 0;
      char *save = nullptr;
      for (char *tok = strtok_r(line, " \t\r\n", &save); tok;
           tok = strtok_r(nullptr, " \t\r\n", &save), field++) {
        char *end = nullptr;
        double d = strtod(tok, &end);
        if (end == tok) {  // non-numeric field where a number belongs
          if (field == h.x_idx || field == h.y_idx || field == h.z_idx) {
            fclose(f);
            return i;
          }
          continue;
        }
        if (field == h.x_idx) { v[0] = d; found++; }
        else if (field == h.y_idx) { v[1] = d; found++; }
        else if (field == h.z_idx) { v[2] = d; found++; }
      }
      if (found != 3) {
        fclose(f);
        return i;
      }
      out[3 * i + 0] = (float)v[0];
      out[3 * i + 1] = (float)v[1];
      out[3 * i + 2] = (float)v[2];
    }
  }
  fclose(f);
  return n;
}

// Voxel-grid downsample: average points within each voxel of size
// `voxel`. Returns the number of output points written to out (caller
// allocates >= n points). Order is unspecified but deterministic for a
// given input.
long voxel_downsample(const float *pts, long n, float voxel,
                            float *out) {
  if (voxel <= 0 || n <= 0) return -1;
  struct Acc {
    double x = 0, y = 0, z = 0;
    long cnt = 0;
    long order = 0;
  };
  std::unordered_map<uint64_t, Acc> cells;
  cells.reserve((size_t)n / 4 + 8);
  const double inv = 1.0 / voxel;
  long order = 0;
  for (long i = 0; i < n; i++) {
    int64_t cx = (int64_t)llround(std::floor(pts[3 * i + 0] * inv));
    int64_t cy = (int64_t)llround(std::floor(pts[3 * i + 1] * inv));
    int64_t cz = (int64_t)llround(std::floor(pts[3 * i + 2] * inv));
    uint64_t key = ((uint64_t)(cx & 0x1FFFFF) << 42) |
                   ((uint64_t)(cy & 0x1FFFFF) << 21) |
                   ((uint64_t)(cz & 0x1FFFFF));
    Acc &a = cells[key];
    if (a.cnt == 0) a.order = order++;
    a.x += pts[3 * i];
    a.y += pts[3 * i + 1];
    a.z += pts[3 * i + 2];
    a.cnt++;
  }
  std::vector<const Acc *> sorted(cells.size());
  size_t k = 0;
  for (auto &kv : cells) sorted[k++] = &kv.second;
  std::sort(sorted.begin(), sorted.end(),
            [](const Acc *a, const Acc *b) { return a->order < b->order; });
  long m = 0;
  for (const Acc *a : sorted) {
    out[3 * m + 0] = (float)(a->x / a->cnt);
    out[3 * m + 1] = (float)(a->y / a->cnt);
    out[3 * m + 2] = (float)(a->z / a->cnt);
    m++;
  }
  return m;
}

// ---------------------------------------------------------------------------
// KD-tree (3-d, median split, array-backed)
// ---------------------------------------------------------------------------

struct KdTree {
  std::vector<float> pts;    // [n*3], reordered
  std::vector<long> index;   // original index per reordered point
  std::vector<int> axis;     // split axis per node (-1 = leaf range)
  long n = 0;
  static const long LEAF = 16;

  struct Node {
    long lo, hi;     // point range [lo, hi)
    long left, right;  // child node ids or -1
    int ax;
    float split;
  };
  std::vector<Node> nodes;

  long build(long lo, long hi, float *mins, float *maxs) {
    Node nd;
    nd.lo = lo;
    nd.hi = hi;
    nd.left = nd.right = -1;
    nd.ax = -1;
    nd.split = 0;
    long id = (long)nodes.size();
    nodes.push_back(nd);
    if (hi - lo <= LEAF) return id;
    // widest axis
    float ext[3] = {maxs[0] - mins[0], maxs[1] - mins[1],
                    maxs[2] - mins[2]};
    int ax = 0;
    if (ext[1] > ext[ax]) ax = 1;
    if (ext[2] > ext[ax]) ax = 2;
    long mid = (lo + hi) / 2;
    // median split via nth_element over interleaved storage
    std::vector<long> ids(hi - lo);
    for (long i = lo; i < hi; i++) ids[i - lo] = i;
    std::nth_element(ids.begin(), ids.begin() + (mid - lo), ids.end(),
                     [&](long a, long b) {
                       return pts[3 * a + ax] < pts[3 * b + ax];
                     });
    // apply permutation
    std::vector<float> tmp(3 * (hi - lo));
    std::vector<long> tidx(hi - lo);
    for (long i = 0; i < hi - lo; i++) {
      memcpy(&tmp[3 * i], &pts[3 * ids[i]], 12);
      tidx[i] = index[ids[i]];
    }
    memcpy(&pts[3 * lo], tmp.data(), tmp.size() * 4);
    memcpy(&index[lo], tidx.data(), tidx.size() * 8);

    float split = pts[3 * mid + ax];
    float save_max = maxs[ax], save_min = mins[ax];
    maxs[ax] = split;
    long l = build(lo, mid, mins, maxs);
    maxs[ax] = save_max;
    mins[ax] = split;
    long r = build(mid, hi, mins, maxs);
    mins[ax] = save_min;
    nodes[id].ax = ax;
    nodes[id].split = split;
    nodes[id].left = l;
    nodes[id].right = r;
    return id;
  }

  void query(const float *q, float *best_d, long *best_i, long node) const {
    const Node &nd = nodes[node];
    if (nd.ax < 0) {
      for (long i = nd.lo; i < nd.hi; i++) {
        float dx = q[0] - pts[3 * i], dy = q[1] - pts[3 * i + 1],
              dz = q[2] - pts[3 * i + 2];
        float d = dx * dx + dy * dy + dz * dz;
        if (d < *best_d) {
          *best_d = d;
          *best_i = index[i];
        }
      }
      return;
    }
    float diff = q[nd.ax] - nd.split;
    long near = diff < 0 ? nd.left : nd.right;
    long far = diff < 0 ? nd.right : nd.left;
    query(q, best_d, best_i, near);
    if (diff * diff < *best_d) query(q, best_d, best_i, far);
  }
};

void *kdtree_build(const float *pts, long n) {
  if (n <= 0) return nullptr;
  KdTree *t = new KdTree();
  t->n = n;
  t->pts.assign(pts, pts + 3 * n);
  t->index.resize(n);
  for (long i = 0; i < n; i++) t->index[i] = i;
  float mins[3] = {1e30f, 1e30f, 1e30f}, maxs[3] = {-1e30f, -1e30f, -1e30f};
  for (long i = 0; i < n; i++)
    for (int a = 0; a < 3; a++) {
      mins[a] = std::min(mins[a], pts[3 * i + a]);
      maxs[a] = std::max(maxs[a], pts[3 * i + a]);
    }
  t->build(0, n, mins, maxs);
  return t;
}

void kdtree_free(void *tree) { delete (KdTree *)tree; }

// Nearest neighbor for nq query points: fills dist_sq[nq], idx[nq].
void kdtree_query(const void *tree, const float *q, long nq,
                        float *dist_sq, long *idx) {
  const KdTree *t = (const KdTree *)tree;
  for (long i = 0; i < nq; i++) {
    float best = 1e30f;
    long bi = -1;
    t->query(q + 3 * i, &best, &bi, 0);
    dist_sq[i] = best;
    idx[i] = bi;
  }
}

}  // extern "C"
