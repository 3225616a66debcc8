// raytpu native asset loaders (C++17, no external deps).
//
// Native fast path for the host-side asset pipeline. The reference
// implements these as C parsers (OBJ: /root/reference/mesh.h:96-218,
// four fscanf passes; ASCII P3 PPM: /root/reference/texture.h:114-173,
// one fscanf per sample) — for big ASCII textures and meshes the Python
// loaders dominate scene startup, so this library re-implements the
// same grammar as single-pass buffer scans. Semantics match
// raytpu.io.obj.parse_obj / raytpu.io.ppm.read_ppm exactly (tested
// against each other in tests/test_native.py); the Python
// implementations remain the portable fallback.
//
// ABI: plain C functions via ctypes, two-call protocol: *_count sizes
// the output, *_fill writes into caller-allocated numpy buffers.
// Parsed state is cached between the two calls keyed by an opaque
// handle, so each file is read and tokenized once.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> vertices;   // x,y,z triples
  std::vector<float> uvs;        // u,v pairs
  std::vector<int32_t> face_v;   // 3 per face, 0-based
  std::vector<int32_t> face_t;   // 3 per face, 0-based (-1 = none)
  std::vector<int32_t> face_mat; // per face material slot (-1 before any usemtl)
  std::string mat_names;         // '\n'-joined usemtl names (dups preserved)
  int32_t n_mats = 0;
};

struct PpmData {
  int32_t w = 0, h = 0;
  std::vector<float> rgb;  // h*w*3, normalized by maxval, file row order
};

std::mutex g_lock;
std::map<int64_t, ObjData> g_objs;
std::map<int64_t, PpmData> g_ppms;
int64_t g_next = 1;

bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(n);
  size_t got = std::fread(out->data(), 1, n, f);
  std::fclose(f);
  out->resize(got);
  return true;
}

// fan-triangulate one face line: tokens like "v", "v/t", "v/t/n", "v//n"
void parse_face(const char* p, const char* end, int cur_mat, ObjData* d) {
  struct VT { int v, t; };
  std::vector<VT> idx;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    if (p >= end) break;
    char* q;
    long v = std::strtol(p, &q, 10);
    if (q == p) break;
    p = q;
    long t = 0;
    if (p < end && *p == '/') {
      p++;
      if (p < end && *p != '/') {
        t = std::strtol(p, &q, 10);
        p = q;
      }
      if (p < end && *p == '/') {
        p++;
        std::strtol(p, &q, 10);  // normal index: parsed, unused (mesh.h:169)
        p = q;
      }
    }
    idx.push_back({(int)(v - 1), (int)(t - 1)});
  }
  for (size_t k = 1; k + 1 < idx.size(); k++) {
    d->face_v.insert(d->face_v.end(), {idx[0].v, idx[k].v, idx[k + 1].v});
    d->face_t.insert(d->face_t.end(), {idx[0].t, idx[k].t, idx[k + 1].t});
    d->face_mat.push_back(cur_mat);
  }
}

}  // namespace

extern "C" {

// ---- OBJ ----------------------------------------------------------------
// returns handle > 0 on success; fills counts[6]:
//   {n_vertices, n_uvs, n_faces, n_mats, mat_names_bytes, 0}
int64_t obj_parse(const char* path, int64_t* counts) {
  std::string buf;
  if (!read_file(path, &buf)) return 0;
  ObjData d;
  int cur_mat = -1;
  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end) {
    const char* eol = (const char*)memchr(p, '\n', end - p);
    if (!eol) eol = end;
    if (p + 1 < eol && p[0] == 'v' && p[1] == ' ') {
      char* q;
      float x = std::strtof(p + 2, &q);
      float y = std::strtof(q, &q);
      float z = std::strtof(q, &q);
      d.vertices.insert(d.vertices.end(), {x, y, z});
    } else if (p + 2 < eol && p[0] == 'v' && p[1] == 't') {
      char* q;
      float u = std::strtof(p + 2, &q);
      float v = std::strtof(q, &q);
      d.uvs.insert(d.uvs.end(), {u, v});
    } else if (p + 6 < eol && std::strncmp(p, "usemtl", 6) == 0) {
      const char* s = p + 6;
      while (s < eol && (*s == ' ' || *s == '\t')) s++;
      const char* e = eol;
      while (e > s && (e[-1] == ' ' || e[-1] == '\r' || e[-1] == '\t')) e--;
      if (!d.mat_names.empty()) d.mat_names += '\n';
      d.mat_names.append(s, e - s);
      d.n_mats++;
      cur_mat++;
    } else if (p + 1 < eol && p[0] == 'f' && p[1] == ' ') {
      parse_face(p + 2, eol, cur_mat, &d);
    }
    p = eol + 1;
  }
  counts[0] = (int64_t)d.vertices.size() / 3;
  counts[1] = (int64_t)d.uvs.size() / 2;
  counts[2] = (int64_t)d.face_mat.size();
  counts[3] = d.n_mats;
  counts[4] = (int64_t)d.mat_names.size();
  counts[5] = 0;
  std::lock_guard<std::mutex> g(g_lock);
  int64_t h = g_next++;
  g_objs[h] = std::move(d);
  return h;
}

void obj_fill(int64_t handle, float* vertices, float* uvs,
              int32_t* face_v, int32_t* face_t, int32_t* face_mat,
              char* mat_names) {
  std::lock_guard<std::mutex> g(g_lock);
  auto it = g_objs.find(handle);
  if (it == g_objs.end()) return;
  ObjData& d = it->second;
  std::memcpy(vertices, d.vertices.data(), d.vertices.size() * 4);
  std::memcpy(uvs, d.uvs.data(), d.uvs.size() * 4);
  std::memcpy(face_v, d.face_v.data(), d.face_v.size() * 4);
  std::memcpy(face_t, d.face_t.data(), d.face_t.size() * 4);
  std::memcpy(face_mat, d.face_mat.data(), d.face_mat.size() * 4);
  std::memcpy(mat_names, d.mat_names.data(), d.mat_names.size());
  g_objs.erase(it);
}

// ---- PPM (ASCII P3) -----------------------------------------------------
// returns handle > 0; fills dims[2] = {w, h}
int64_t ppm_parse(const char* path, int64_t* dims) {
  std::string buf;
  if (!read_file(path, &buf)) return 0;
  const char* p = buf.data();
  const char* end = p + buf.size();

  auto skip_ws = [&]() {
    for (;;) {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        p++;
      if (p < end && *p == '#') {  // comments allowed by the PPM spec
        while (p < end && *p != '\n') p++;
      } else {
        return;
      }
    }
  };

  skip_ws();
  if (end - p < 2 || p[0] != 'P' || p[1] != '3') return 0;
  p += 2;
  char* q;
  skip_ws();
  long w = std::strtol(p, &q, 10);
  p = q;
  skip_ws();
  long h = std::strtol(p, &q, 10);
  p = q;
  skip_ws();
  long maxval = std::strtol(p, &q, 10);
  p = q;
  if (w <= 0 || h <= 0 || maxval <= 0) return 0;

  PpmData d;
  d.w = (int32_t)w;
  d.h = (int32_t)h;
  d.rgb.resize((size_t)w * h * 3);
  // n * f32(1/maxval): the repo-wide quantization convention (see
  // raytpu/io/image.py). The reciprocal goes through double first to
  // match numpy's f64-then-f32 rounding bit-for-bit.
  float inv = (float)(1.0 / (double)maxval);
  for (size_t i = 0; i < d.rgb.size(); i++) {
    long v = std::strtol(p, &q, 10);
    if (q == p) return 0;  // short file
    p = q;
    d.rgb[i] = (float)v * inv;
  }
  dims[0] = w;
  dims[1] = h;
  std::lock_guard<std::mutex> g(g_lock);
  int64_t hd = g_next++;
  g_ppms[hd] = std::move(d);
  return hd;
}

void ppm_fill(int64_t handle, float* rgb) {
  std::lock_guard<std::mutex> g(g_lock);
  auto it = g_ppms.find(handle);
  if (it == g_ppms.end()) return;
  std::memcpy(rgb, it->second.rgb.data(), it->second.rgb.size() * 4);
  g_ppms.erase(it);
}

}  // extern "C"
