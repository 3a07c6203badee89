// OBJ mesh I/O on the host, in C++: the port's own copy of the writer and
// reader of the JAX package's native mesh backend (its surs_write_obj,
// surs_read_obj and surs_free). Host code, not a kernel: it formats and
// parses text. Built with g++ at first use by ops/cuda_build.py and bound
// with ctypes by recon/native.py; a plain C interface.
//
// The byte format is the reference's save_obj_mesh: vertices "v x y z" with
// four decimals, each value rounded as |v| * 1e4 + 0.5 truncated with the
// sign written first (so a tie rounds away from zero and a small negative
// writes -0.0000), faces "f v0 v2 v1", 1-based. recon/mesh_io.py's
// save_obj_mesh_ref is the same format in numpy.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

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

}  // namespace

extern "C" {

void surs_free(void* p) { std::free(p); }

// verts [nverts, 3] float64, faces [nfaces, 3] int64 (0-based) -> an OBJ
// file at path. Returns 0, or 1 when the file cannot be opened, 2 when a
// write fails.
int surs_write_obj(const char* path, const double* verts, int64_t nverts,
                   const int64_t* faces, int64_t nfaces) {
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
    flush_if(96);
    *p++ = 'v';
    *p++ = ' ';
    p = fmt_fixed4(p, verts[3 * i]);
    *p++ = ' ';
    p = fmt_fixed4(p, verts[3 * i + 1]);
    *p++ = ' ';
    p = fmt_fixed4(p, verts[3 * i + 2]);
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
