// Host mesh code in C++: the port's own copy of the JAX package's native
// mesh backend (csrc/mesh_native.cpp): marching tetrahedra with its
// growing edge map (surs_marching_tetrahedra), the OBJ writer and reader
// (surs_write_obj, surs_read_obj), the colored OBJ writer
// (surs_write_obj_color) and surs_free. Host code, not a kernel.
// Built with g++ at first use by ops/cuda_build.py and bound with ctypes
// by recon/native.py; a plain C interface.
//
// Marching tetrahedra is recon/tetra.py's algorithm cell by cell: each
// cell splits into 6 tetrahedra around the main diagonal, each tet's sign
// case emits 0-2 triangles, and vertices are interpolated on global edges
// and welded through an open-addressing hash on the edge key. Vertices
// come out in first-appearance order, faces cell by cell.
//
// The byte format is the reference's save_obj_mesh: vertices "v x y z" with
// four decimals, each value rounded as |v| * 1e4 + 0.5 truncated with the
// sign written first (so a tie rounds away from zero and a small negative
// writes -0.0000), faces "f v0 v2 v1", 1-based. recon/mesh_io.py's
// save_obj_mesh_ref is the same format in numpy.
//
// The colored writer is the JAX package's save_obj_mesh_with_color, which
// formats in Python: "v x y z r g b" with each value printed as '%.4f'
// prints it (the double's exact value rounded to 4 decimals, a tie to
// even, the sign of a negative value or of -0.0 kept), faces as above.
// recon/mesh_io.py's save_obj_mesh_with_color_ref is its plain version.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

// cube corners; tets around the diagonal 0-6; tet edges by local vertex
const int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};

const int kTets[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6}};

const int kTetEdges[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// case (bit i: tet vertex i inside) -> up to 2 triangles of tet-edge ids
const int kCaseTris[16][2][3] = {
    {{-1, -1, -1}, {-1, -1, -1}},  // 0
    {{0, 1, 2}, {-1, -1, -1}},     // 1
    {{0, 4, 3}, {-1, -1, -1}},     // 2
    {{1, 2, 4}, {1, 4, 3}},        // 3
    {{1, 3, 5}, {-1, -1, -1}},     // 4
    {{0, 3, 5}, {0, 5, 2}},        // 5
    {{0, 1, 5}, {0, 5, 4}},        // 6
    {{2, 4, 5}, {-1, -1, -1}},     // 7
    {{2, 5, 4}, {-1, -1, -1}},     // 8
    {{0, 5, 4}, {0, 1, 5}},        // 9
    {{0, 5, 3}, {0, 2, 5}},        // 10
    {{1, 5, 3}, {-1, -1, -1}},     // 11
    {{1, 4, 2}, {1, 3, 4}},        // 12
    {{0, 3, 4}, {-1, -1, -1}},     // 13
    {{0, 2, 1}, {-1, -1, -1}},     // 14
    {{-1, -1, -1}, {-1, -1, -1}},  // 15
};

// Open-addressing hash from edge key (lo * X*Y*Z + hi) to vertex id. It
// grows at 70 % load: a fixed table degrades to O(n) probes near full and
// spins forever once full (every slot taken, key absent), which noise-like
// fields with more crossings than the first guess reach.
struct EdgeMap {
  std::vector<uint64_t> keys;
  std::vector<int64_t> vals;
  uint64_t mask;
  size_t used;

  explicit EdgeMap(size_t expected) {
    size_t cap = 64;
    while (cap < expected * 2) cap <<= 1;
    keys.assign(cap, UINT64_MAX);
    vals.assign(cap, -1);
    mask = cap - 1;
    used = 0;
  }

  void grow() {
    std::vector<uint64_t> old_keys(keys.size() * 2, UINT64_MAX);
    std::vector<int64_t> old_vals(vals.size() * 2, -1);
    old_keys.swap(keys);
    old_vals.swap(vals);
    mask = keys.size() - 1;
    for (size_t j = 0; j < old_keys.size(); ++j) {
      if (old_keys[j] == UINT64_MAX) continue;
      uint64_t h = old_keys[j] * 0x9E3779B97F4A7C15ull;
      size_t i = h & mask;
      while (keys[i] != UINT64_MAX) i = (i + 1) & mask;
      keys[i] = old_keys[j];
      vals[i] = old_vals[j];
    }
  }

  // the value slot of key, inserted (-1) if absent
  int64_t* slot(uint64_t key) {
    if (used * 10 >= keys.size() * 7) grow();
    uint64_t h = key * 0x9E3779B97F4A7C15ull;
    size_t i = h & mask;
    while (keys[i] != UINT64_MAX && keys[i] != key) i = (i + 1) & mask;
    if (keys[i] == UINT64_MAX) ++used;
    keys[i] = key;
    return &vals[i];
  }
};

// '%.4f' of v, rounding half away from zero
inline char* fmt_fixed4(char* p, double v) {
  if (v < 0) {
    *p++ = '-';
    v = -v;
  }
  long long scaled = (long long)(v * 10000.0 + 0.5);
  long long ip = scaled / 10000;
  int fp = (int)(scaled % 10000);
  char tmp[24];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + ip % 10);
    ip /= 10;
  } while (ip);
  while (n) *p++ = tmp[--n];
  *p++ = '.';
  *p++ = (char)('0' + fp / 1000);
  *p++ = (char)('0' + (fp / 100) % 10);
  *p++ = (char)('0' + (fp / 10) % 10);
  *p++ = (char)('0' + fp % 10);
  return p;
}

// '%.4f' of v as printf and Python print it. Below 1e5 the scaled value
// |v| * 1e4 is within 6e-8 of the exact product, so its fraction decides
// the rounding unless it lies within 1e-6 of a half; those values, and
// |v| >= 1e5, inf and nan, go through snprintf. Writes at most 400 chars.
inline char* fmt_pct4(char* p, double v) {
  double a = std::fabs(v);
  if (a < 1e5) {
    double y = a * 10000.0;
    double fl = std::floor(y);
    double fr = y - fl;
    if (std::fabs(fr - 0.5) >= 1e-6) {
      long long scaled = (long long)fl + (fr > 0.5 ? 1 : 0);
      if (std::signbit(v)) *p++ = '-';
      long long ip = scaled / 10000;
      int fp = (int)(scaled % 10000);
      char tmp[24];
      int n = 0;
      do {
        tmp[n++] = (char)('0' + ip % 10);
        ip /= 10;
      } while (ip);
      while (n) *p++ = tmp[--n];
      *p++ = '.';
      *p++ = (char)('0' + fp / 1000);
      *p++ = (char)('0' + (fp / 100) % 10);
      *p++ = (char)('0' + (fp / 10) % 10);
      *p++ = (char)('0' + fp % 10);
      return p;
    }
  }
  int n = std::snprintf(p, 400, "%.4f", v);
  return p + (n < 400 ? n : 399);
}

// '%d' of a non-negative v
inline char* fmt_int(char* p, long long v) {
  char tmp[24];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

// Writes nverts lines "v" + vline(p, i) + "\n" (vline writes at most
// vline_max chars at p and returns the end), then the faces as "f v0 v2
// v1", 1-based, through a 4 MB buffer. Returns 0, or 1 when the file
// cannot be opened, 2 when a write fails.
template <class VertexLine>
int write_obj_file(const char* path, int64_t nverts, size_t vline_max,
                   const int64_t* faces, int64_t nfaces, VertexLine vline) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  const size_t CAP = 1 << 22;
  std::vector<char> buf(CAP + 256);
  char* p = buf.data();
  bool ok = true;
  auto flush_if = [&](size_t need) {
    if ((size_t)(p - buf.data()) + need > CAP) {
      size_t len = (size_t)(p - buf.data());
      ok = ok && std::fwrite(buf.data(), 1, len, f) == len;
      p = buf.data();
    }
  };
  for (int64_t i = 0; i < nverts; ++i) {
    flush_if(vline_max + 2);
    *p++ = 'v';
    p = vline(p, i);
    *p++ = '\n';
  }
  for (int64_t i = 0; i < nfaces; ++i) {
    flush_if(80);
    *p++ = 'f';
    *p++ = ' ';
    p = fmt_int(p, (long long)(faces[3 * i] + 1));
    *p++ = ' ';
    p = fmt_int(p, (long long)(faces[3 * i + 2] + 1));
    *p++ = ' ';
    p = fmt_int(p, (long long)(faces[3 * i + 1] + 1));
    *p++ = '\n';
  }
  size_t len = (size_t)(p - buf.data());
  ok = ok && std::fwrite(buf.data(), 1, len, f) == len;
  ok = (std::fclose(f) == 0) && ok;
  return ok ? 0 : 2;
}

}  // namespace

extern "C" {

void surs_free(void* p) { std::free(p); }

// The level set vol == level of the field vol [X, Y, Z] (C order), inside
// where a value > level: *out_verts [*out_nverts, 3] float32 grid
// coordinates and *out_faces [*out_nfaces, 3] int64, malloc'd, to be freed
// with surs_free. Returns 0, or 1 when an allocation fails.
int surs_marching_tetrahedra(const float* vol, int64_t X, int64_t Y,
                             int64_t Z, float level, float** out_verts,
                             int64_t* out_nverts, int64_t** out_faces,
                             int64_t* out_nfaces) {
  const int64_t YZ = Y * Z;
  std::vector<float> verts;
  std::vector<int64_t> faces;
  verts.reserve(1 << 20);
  faces.reserve(1 << 20);
  EdgeMap emap(1 << 20);

  // the id of the vertex on edge (ga, gb), interpolated at first sight
  auto interp_vertex = [&](int64_t ga, int64_t gb) -> int64_t {
    uint64_t lo = (uint64_t)(ga < gb ? ga : gb);
    uint64_t hi = (uint64_t)(ga < gb ? gb : ga);
    uint64_t key = lo * (uint64_t)(X * YZ) + hi;
    int64_t* v = emap.slot(key);
    if (*v >= 0) return *v;
    double va = vol[ga], vb = vol[gb];
    double denom = vb - va;
    if (std::fabs(denom) < 1e-12) denom = 1e-12;
    double t = (level - va) / denom;
    t = t < 0.0 ? 0.0 : (t > 1.0 ? 1.0 : t);
    double ax = (double)(ga / YZ), ay = (double)((ga / Z) % Y),
           az = (double)(ga % Z);
    double bx = (double)(gb / YZ), by = (double)((gb / Z) % Y),
           bz = (double)(gb % Z);
    int64_t id = (int64_t)(verts.size() / 3);
    verts.push_back((float)(ax + t * (bx - ax)));
    verts.push_back((float)(ay + t * (by - ay)));
    verts.push_back((float)(az + t * (bz - az)));
    *v = id;
    return id;
  };

  for (int64_t x = 0; x + 1 < X; ++x) {
    for (int64_t y = 0; y + 1 < Y; ++y) {
      for (int64_t z = 0; z + 1 < Z; ++z) {
        float cv[8];
        int64_t gids[8];
        float vmin = 0.0f, vmax = 0.0f;
        for (int c = 0; c < 8; ++c) {
          gids[c] = (x + kCorner[c][0]) * YZ + (y + kCorner[c][1]) * Z +
                    (z + kCorner[c][2]);
          cv[c] = vol[gids[c]];
          vmin = (c == 0 || cv[c] < vmin) ? cv[c] : vmin;
          vmax = (c == 0 || cv[c] > vmax) ? cv[c] : vmax;
        }
        if (!(vmin <= level && vmax > level)) continue;
        for (int t = 0; t < 6; ++t) {
          int cs = 0;
          for (int c = 0; c < 4; ++c)
            if (cv[kTets[t][c]] > level) cs |= 1 << c;
          for (int s = 0; s < 2; ++s) {
            const int* tri = kCaseTris[cs][s];
            if (tri[0] < 0) continue;
            int64_t ids[3];
            for (int c = 0; c < 3; ++c) {
              int ea = kTetEdges[tri[c]][0], eb = kTetEdges[tri[c]][1];
              ids[c] = interp_vertex(gids[kTets[t][ea]], gids[kTets[t][eb]]);
            }
            if (ids[0] == ids[1] || ids[1] == ids[2] || ids[0] == ids[2])
              continue;
            faces.insert(faces.end(), ids, ids + 3);
          }
        }
      }
    }
  }

  *out_nverts = (int64_t)(verts.size() / 3);
  *out_nfaces = (int64_t)(faces.size() / 3);
  // malloc(0) may return null: allocate at least one element
  *out_verts = (float*)std::malloc((verts.size() + 1) * sizeof(float));
  *out_faces = (int64_t*)std::malloc((faces.size() + 1) * sizeof(int64_t));
  if (!*out_verts || !*out_faces) {
    std::free(*out_verts);
    std::free(*out_faces);
    *out_verts = nullptr;
    *out_faces = nullptr;
    return 1;
  }
  if (!verts.empty())
    std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
  if (!faces.empty())
    std::memcpy(*out_faces, faces.data(), faces.size() * sizeof(int64_t));
  return 0;
}

// verts [nverts, 3] float64, faces [nfaces, 3] int64 (0-based) -> an OBJ
// file at path. Returns 0, or 1 when the file cannot be opened, 2 when a
// write fails.
int surs_write_obj(const char* path, const double* verts, int64_t nverts,
                   const int64_t* faces, int64_t nfaces) {
  return write_obj_file(path, nverts, 96, faces, nfaces,
                        [&](char* p, int64_t i) {
                          for (int k = 0; k < 3; ++k) {
                            *p++ = ' ';
                            p = fmt_fixed4(p, verts[3 * i + k]);
                          }
                          return p;
                        });
}

// verts [nverts, 3] and colors [nverts, 3] float64, faces [nfaces, 3]
// int64 (0-based) -> the colored OBJ file at path ("v x y z r g b" lines
// in '%.4f', then "f v0 v2 v1", 1-based). Returns as surs_write_obj.
int surs_write_obj_color(const char* path, const double* verts,
                         const double* colors, int64_t nverts,
                         const int64_t* faces, int64_t nfaces) {
  return write_obj_file(path, nverts, 6 * 401 + 8, faces, nfaces,
                        [&](char* p, int64_t i) {
                          for (int k = 0; k < 6; ++k) {
                            *p++ = ' ';
                            p = fmt_pct4(p, k < 3 ? verts[3 * i + k]
                                                  : colors[3 * i + k - 3]);
                          }
                          return p;
                        });
}

// Reads the "v" and "f" lines of an OBJ file: polygons fan-triangulated,
// indices 1-based or negative (relative to the vertices read so far), the
// /vt/vn parts of a face token skipped. Two calls: with null buffers it
// sets *nverts and *nfaces to the counts; with buffers of at least those
// sizes (verts [nverts, 3] float32, faces [nfaces, 3] int64) it fills
// them. Returns 0, 1 when the file cannot be opened, 2 when a buffer is too
// small.
int surs_read_obj(const char* path, float* verts, int64_t* nverts,
                  int64_t* faces, int64_t* nfaces) {
  FILE* f = std::fopen(path, "r");
  if (!f) return 1;
  std::vector<float> vs;
  std::vector<int64_t> fs;
  char line[4096];
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      double a, b, c;
      if (std::sscanf(line + 2, "%lf %lf %lf", &a, &b, &c) == 3) {
        vs.push_back((float)a);
        vs.push_back((float)b);
        vs.push_back((float)c);
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      int64_t idx[64];
      int n = 0;
      char* p = line + 2;
      while (*p && n < 64) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\n' || *p == '\r' || !*p) break;
        long long v = std::strtoll(p, &p, 10);
        if (v == 0) break;
        int64_t nv = (int64_t)(vs.size() / 3);
        idx[n++] = v > 0 ? v - 1 : nv + v;
        while (*p && *p != ' ' && *p != '\t' && *p != '\n') ++p;
      }
      for (int k = 1; k + 1 < n; ++k) {
        fs.push_back(idx[0]);
        fs.push_back(idx[k]);
        fs.push_back(idx[k + 1]);
      }
    }
  }
  std::fclose(f);
  if (verts == nullptr || faces == nullptr) {
    *nverts = (int64_t)(vs.size() / 3);
    *nfaces = (int64_t)(fs.size() / 3);
    return 0;
  }
  if (*nverts < (int64_t)(vs.size() / 3) ||
      *nfaces < (int64_t)(fs.size() / 3))
    return 2;
  if (!vs.empty()) std::memcpy(verts, vs.data(), vs.size() * sizeof(float));
  if (!fs.empty()) std::memcpy(faces, fs.data(), fs.size() * sizeof(int64_t));
  *nverts = (int64_t)(vs.size() / 3);
  *nfaces = (int64_t)(fs.size() / 3);
  return 0;
}

}  // extern "C"
