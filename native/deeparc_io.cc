// Native high-throughput parsers for .deeparc and BAL problem files.
//
// The host-side (non-device-compute) native component of the framework: the
// reference's DeepArcManager::read tokenizes with iostream extraction
// (src/DeepArcManager.cc:26-164), which is the slowest possible path for the
// multi-hundred-MB BAL problems the distributed configs use. This parser
// reads the whole file once and tokenizes with a hand-rolled float scanner
// (~100x iostream), exposing flat arrays over a C ABI consumed from Python
// via ctypes (deeparc_tpu/io/native.py). No third-party dependencies.
//
// Build: see native/build.sh (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Fast whitespace-delimited double scanner. Handles the ASCII numeric
// formats these files actually contain (fixed decimals, exponents).
struct Tokenizer {
  const char* p;
  const char* end;

  explicit Tokenizer(const char* data, size_t len) : p(data), end(data + len) {}

  bool next(double* out) {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) {
      ++p;
    }
    if (p >= end) return false;
    char* after = nullptr;
    *out = strtod(p, &after);
    if (after == p) return false;
    p = after;
    return true;
  }
};

struct Arrays {
  std::vector<double> doubles;
  std::vector<int32_t> ints;
};

}  // namespace

extern "C" {

// Parsed .deeparc payload. All buffers are owned by the handle and freed by
// deeparc_free(). Layout documented field by field for the ctypes mirror.
typedef struct {
  int32_t ok;            // 1 on success
  double version;
  int32_t n_obs, n_intrinsic, n_arc, n_ring, n_point, n_extrinsic;
  int32_t share_extrinsic;
  // observations
  int32_t* obs_arc;      // [n_obs]
  int32_t* obs_ring;     // [n_obs]
  int32_t* obs_point;    // [n_obs]
  double* obs_xy;        // [n_obs * 2]
  // intrinsics (padded to 2)
  double* center;        // [n_intrinsic * 2]
  double* focal;         // [n_intrinsic * 2]
  int32_t* focal_size;   // [n_intrinsic]
  double* dist;          // [n_intrinsic * 2]
  int32_t* dist_size;    // [n_intrinsic]
  // extrinsics: rotation is emitted raw with its arity; conversion to
  // angle-axis happens in Python (quaternion / column-major matrix cases)
  double* ext_trans;     // [n_extrinsic * 3]
  double* ext_rot_raw;   // [n_extrinsic * 9] zero-padded
  int32_t* ext_rot_size; // [n_extrinsic] in {3, 4, 9}
  // points
  double* points;        // [n_point * 3]
  int32_t* colors;       // [n_point * 3]
  char error[256];
} DeepArcParsed;

// BAL payload (cameras: angle-axis(3) t(3) f k1 k2).
typedef struct {
  int32_t ok;
  int32_t n_cameras, n_points, n_obs;
  int32_t* obs_cam;      // [n_obs]
  int32_t* obs_point;    // [n_obs]
  double* obs_xy;        // [n_obs * 2]
  double* cameras;       // [n_cameras * 9]
  double* points;        // [n_points * 3]
  char error[256];
} BalParsed;

static char* read_file(const char* path, size_t* len_out, char* err) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    snprintf(err, 256, "cannot open %s", path);
    return nullptr;
  }
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(malloc(len + 1));
  if (!buf || fread(buf, 1, len, f) != static_cast<size_t>(len)) {
    snprintf(err, 256, "short read on %s", path);
    fclose(f);
    free(buf);
    return nullptr;
  }
  fclose(f);
  buf[len] = '\0';
  *len_out = static_cast<size_t>(len);
  return buf;
}

#define TAKE(var)                                        \
  if (!tok.next(&(var))) {                               \
    snprintf(out->error, 256, "truncated file at %s",    \
             #var);                                      \
    free(buf);                                           \
    return out;                                          \
  }

DeepArcParsed* deeparc_parse(const char* path) {
  DeepArcParsed* out =
      static_cast<DeepArcParsed*>(calloc(1, sizeof(DeepArcParsed)));
  size_t len = 0;
  char* buf = read_file(path, &len, out->error);
  if (!buf) return out;
  Tokenizer tok(buf, len);

  double v, a, b, c, d, e, f6;
  TAKE(v);
  out->version = v;
  TAKE(a) TAKE(b) TAKE(c) TAKE(d) TAKE(e);
  out->n_obs = static_cast<int32_t>(a);
  out->n_intrinsic = static_cast<int32_t>(b);
  out->n_arc = static_cast<int32_t>(c);
  out->n_ring = static_cast<int32_t>(d);
  out->n_point = static_cast<int32_t>(e);
  out->share_extrinsic = out->n_ring != 0;
  out->n_extrinsic =
      out->share_extrinsic ? out->n_arc + out->n_ring - 1 : out->n_arc;

  out->obs_arc = static_cast<int32_t*>(malloc(sizeof(int32_t) * out->n_obs));
  out->obs_ring = static_cast<int32_t*>(malloc(sizeof(int32_t) * out->n_obs));
  out->obs_point = static_cast<int32_t*>(malloc(sizeof(int32_t) * out->n_obs));
  out->obs_xy = static_cast<double*>(malloc(sizeof(double) * out->n_obs * 2));
  for (int32_t i = 0; i < out->n_obs; ++i) {
    TAKE(a) TAKE(b) TAKE(c) TAKE(d) TAKE(e);
    out->obs_arc[i] = static_cast<int32_t>(a);
    out->obs_ring[i] = static_cast<int32_t>(b);
    out->obs_point[i] = static_cast<int32_t>(c);
    out->obs_xy[2 * i] = d;
    out->obs_xy[2 * i + 1] = e;
  }

  out->center = static_cast<double*>(calloc(out->n_intrinsic * 2, sizeof(double)));
  out->focal = static_cast<double*>(calloc(out->n_intrinsic * 2, sizeof(double)));
  out->dist = static_cast<double*>(calloc(out->n_intrinsic * 2, sizeof(double)));
  out->focal_size =
      static_cast<int32_t*>(calloc(out->n_intrinsic, sizeof(int32_t)));
  out->dist_size =
      static_cast<int32_t*>(calloc(out->n_intrinsic, sizeof(int32_t)));
  for (int32_t i = 0; i < out->n_intrinsic; ++i) {
    TAKE(a) TAKE(b);
    out->center[2 * i] = a;
    out->center[2 * i + 1] = b;
    TAKE(c);
    int nf = static_cast<int>(c);
    out->focal_size[i] = nf;
    for (int j = 0; j < nf; ++j) {
      TAKE(d);
      if (j < 2) out->focal[2 * i + j] = d;
    }
    TAKE(c);
    int nd = static_cast<int>(c);
    out->dist_size[i] = nd;
    for (int j = 0; j < nd; ++j) {
      TAKE(d);
      if (j < 2) out->dist[2 * i + j] = d;
    }
  }

  out->ext_trans =
      static_cast<double*>(calloc(out->n_extrinsic * 3, sizeof(double)));
  out->ext_rot_raw =
      static_cast<double*>(calloc(out->n_extrinsic * 9, sizeof(double)));
  out->ext_rot_size =
      static_cast<int32_t*>(calloc(out->n_extrinsic, sizeof(int32_t)));
  for (int32_t i = 0; i < out->n_extrinsic; ++i) {
    TAKE(a) TAKE(b) TAKE(c);
    out->ext_trans[3 * i] = a;
    out->ext_trans[3 * i + 1] = b;
    out->ext_trans[3 * i + 2] = c;
    TAKE(d);
    int nr = static_cast<int>(d);
    if (nr != 3 && nr != 4 && nr != 9) {
      snprintf(out->error, 256, "bad rotation arity %d", nr);
      free(buf);
      return out;
    }
    out->ext_rot_size[i] = nr;
    for (int j = 0; j < nr; ++j) {
      TAKE(e);
      out->ext_rot_raw[9 * i + j] = e;
    }
  }

  out->points = static_cast<double*>(malloc(sizeof(double) * out->n_point * 3));
  out->colors = static_cast<int32_t*>(malloc(sizeof(int32_t) * out->n_point * 3));
  for (int32_t i = 0; i < out->n_point; ++i) {
    TAKE(a) TAKE(b) TAKE(c) TAKE(d) TAKE(e) TAKE(f6);
    out->points[3 * i] = a;
    out->points[3 * i + 1] = b;
    out->points[3 * i + 2] = c;
    // double -> int truncation, exactly as Point3d's int ctor args
    // (src/Point/Point3d.hh:7)
    out->colors[3 * i] = static_cast<int32_t>(d);
    out->colors[3 * i + 1] = static_cast<int32_t>(e);
    out->colors[3 * i + 2] = static_cast<int32_t>(f6);
  }

  free(buf);
  out->ok = 1;
  return out;
}

void deeparc_free(DeepArcParsed* p) {
  if (!p) return;
  free(p->obs_arc); free(p->obs_ring); free(p->obs_point); free(p->obs_xy);
  free(p->center); free(p->focal); free(p->focal_size);
  free(p->dist); free(p->dist_size);
  free(p->ext_trans); free(p->ext_rot_raw); free(p->ext_rot_size);
  free(p->points); free(p->colors);
  free(p);
}

#undef TAKE
#define TAKE_B(var)                                      \
  if (!tok.next(&(var))) {                               \
    snprintf(out->error, 256, "truncated BAL file");     \
    free(buf);                                           \
    return out;                                          \
  }

BalParsed* bal_parse(const char* path) {
  BalParsed* out = static_cast<BalParsed*>(calloc(1, sizeof(BalParsed)));
  size_t len = 0;
  char* buf = read_file(path, &len, out->error);
  if (!buf) return out;
  Tokenizer tok(buf, len);
  double a, b, c, d;
  TAKE_B(a) TAKE_B(b) TAKE_B(c);
  out->n_cameras = static_cast<int32_t>(a);
  out->n_points = static_cast<int32_t>(b);
  out->n_obs = static_cast<int32_t>(c);
  out->obs_cam = static_cast<int32_t*>(malloc(sizeof(int32_t) * out->n_obs));
  out->obs_point = static_cast<int32_t*>(malloc(sizeof(int32_t) * out->n_obs));
  out->obs_xy = static_cast<double*>(malloc(sizeof(double) * out->n_obs * 2));
  for (int32_t i = 0; i < out->n_obs; ++i) {
    TAKE_B(a) TAKE_B(b) TAKE_B(c) TAKE_B(d);
    out->obs_cam[i] = static_cast<int32_t>(a);
    out->obs_point[i] = static_cast<int32_t>(b);
    out->obs_xy[2 * i] = c;
    out->obs_xy[2 * i + 1] = d;
  }
  out->cameras =
      static_cast<double*>(malloc(sizeof(double) * out->n_cameras * 9));
  for (int32_t i = 0; i < out->n_cameras * 9; ++i) TAKE_B(out->cameras[i]);
  out->points =
      static_cast<double*>(malloc(sizeof(double) * out->n_points * 3));
  for (int32_t i = 0; i < out->n_points * 3; ++i) TAKE_B(out->points[i]);
  free(buf);
  out->ok = 1;
  return out;
}

void bal_free(BalParsed* p) {
  if (!p) return;
  free(p->obs_cam); free(p->obs_point); free(p->obs_xy);
  free(p->cameras); free(p->points);
  free(p);
}

}  // extern "C"
