// Native host runtime for the JAX path tracing framework.
//
// The reference's host runtime is C++ (scene loading `src/scene.cpp`, BVH
// construction `src/pathtrace.cu:23-111`, PNG encoding via vendored stb).
// This library provides the framework's equivalents behind a C ABI
// consumed via ctypes (native/runtime.py); every entry point has a pure
// Python fallback, so the build is an optimization, not a requirement.
//
// Build: native/build.sh  (g++ -O2 -shared -fPIC, links zlib)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

#include <zlib.h>

extern "C" {

// ─────────────────────────── PNG writer ───────────────────────────
// Minimal PNG encoder (8-bit RGB/RGBA, filter 0), zlib-compressed — the
// stb_image_write replacement for `image::savePNG` (src/image.cpp:22-39).

static void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back(v & 0xff);
}

static void put_chunk(std::vector<uint8_t>& out, const char tag[4],
                      const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t tag_pos = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out.data() + tag_pos, (uInt)(4 + len));
  put_be32(out, crc);
}

int pt_write_png(const char* path, const uint8_t* pixels, int width,
                 int height, int channels) {
  if (channels != 3 && channels != 4) return 1;
  const size_t stride = (size_t)width * channels;
  std::vector<uint8_t> raw((stride + 1) * height);
  for (int y = 0; y < height; ++y) {
    raw[y * (stride + 1)] = 0;  // filter: None
    std::memcpy(&raw[y * (stride + 1) + 1], pixels + y * stride, stride);
  }
  uLongf bound = compressBound((uLong)raw.size());
  std::vector<uint8_t> compressed(bound);
  if (compress2(compressed.data(), &bound, raw.data(), (uLong)raw.size(), 6) !=
      Z_OK)
    return 2;
  compressed.resize(bound);

  std::vector<uint8_t> out;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (width >> 24) & 0xff;
  ihdr[1] = (width >> 16) & 0xff;
  ihdr[2] = (width >> 8) & 0xff;
  ihdr[3] = width & 0xff;
  ihdr[4] = (height >> 24) & 0xff;
  ihdr[5] = (height >> 16) & 0xff;
  ihdr[6] = (height >> 8) & 0xff;
  ihdr[7] = height & 0xff;
  ihdr[8] = 8;                               // bit depth
  ihdr[9] = channels == 3 ? 2 : 6;           // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;        // compression/filter/interlace
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", compressed.data(), compressed.size());
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return 3;
  size_t written = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return written == out.size() ? 0 : 4;
}

// ─────────────────────────── PNG defilter ───────────────────────────
// Reverses PNG scanline filtering in place (8-bit samples). `raw` is the
// zlib-decompressed stream laid out as height rows of (1 filter byte +
// stride payload bytes); bpp = bytes per pixel. Returns 0, or 1 on an
// unknown filter type. Replaces the per-pixel Python defilter loops for
// Sub/Average/Paeth rows (io/png.py).

int pt_png_defilter(uint8_t* raw, int height, int stride, int bpp) {
  std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prev = zero.data();
  for (int y = 0; y < height; ++y) {
    uint8_t* row = raw + (size_t)y * (stride + 1);
    const int f = row[0];
    uint8_t* line = row + 1;
    switch (f) {
      case 0:
        break;
      case 1:  // Sub
        for (int x = bpp; x < stride; ++x) line[x] += line[x - bpp];
        break;
      case 2:  // Up
        for (int x = 0; x < stride; ++x) line[x] += prev[x];
        break;
      case 3:  // Average
        for (int x = 0; x < bpp; ++x) line[x] += prev[x] >> 1;
        for (int x = bpp; x < stride; ++x)
          line[x] += (uint8_t)(((int)line[x - bpp] + prev[x]) >> 1);
        break;
      case 4: {  // Paeth
        for (int x = 0; x < bpp; ++x) line[x] += prev[x];
        for (int x = bpp; x < stride; ++x) {
          const int a = line[x - bpp], b = prev[x], c = prev[x - bpp];
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc) ? b : c;
          line[x] += (uint8_t)pred;
        }
        break;
      }
      default:
        return 1;
    }
    prev = line;
  }
  return 0;
}

// ─────────────────────────── BVH builder ───────────────────────────
// Median split on the longest centroid axis, preorder node emission —
// the reference algorithm (`buildBVHRecursive`, pathtrace.cu:52-99)
// generalized with a leaf size and threaded with subtree-end links for
// stackless traversal (see ops/bvh.py).

struct BvhBuilder {
  const float* mins;
  const float* maxs;
  std::vector<float> cent;
  int leaf_size;
  float* node_bounds;  // [max_nodes, 6]
  int32_t* node_meta;  // [max_nodes, 4]: left, subtree_end, start, count
  int32_t* order;      // [n]
  int node_count = 0;
  int order_count = 0;

  int build(std::vector<int32_t>& idx, int lo, int hi) {
    int node = node_count++;
    float* b = node_bounds + node * 6;
    int32_t* m = node_meta + node * 4;
    if (hi - lo <= leaf_size) {
      b[0] = b[1] = b[2] = 3.4e38f;
      b[3] = b[4] = b[5] = -3.4e38f;
      m[0] = -1;
      m[2] = order_count;
      m[3] = hi - lo;
      for (int i = lo; i < hi; ++i) {
        int p = idx[i];
        order[order_count++] = p;
        for (int a = 0; a < 3; ++a) {
          b[a] = std::min(b[a], mins[p * 3 + a]);
          b[3 + a] = std::max(b[3 + a], maxs[p * 3 + a]);
        }
      }
      m[1] = node + 1;  // subtree end
      return node;
    }
    float cmin[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float cmax[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int i = lo; i < hi; ++i) {
      for (int a = 0; a < 3; ++a) {
        float c = cent[idx[i] * 3 + a];
        cmin[a] = std::min(cmin[a], c);
        cmax[a] = std::max(cmax[a], c);
      }
    }
    float ext[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1], cmax[2] - cmin[2]};
    int axis = (ext[0] > ext[1] && ext[0] > ext[2]) ? 0 : (ext[1] > ext[2]) ? 1 : 2;
    std::stable_sort(idx.begin() + lo, idx.begin() + hi,
                     [&](int a_, int b_) {
                       return cent[a_ * 3 + axis] < cent[b_ * 3 + axis];
                     });
    int mid = lo + (hi - lo) / 2;
    int left = build(idx, lo, mid);
    int right = build(idx, mid, hi);
    const float* bl = node_bounds + left * 6;
    const float* br = node_bounds + right * 6;
    for (int a = 0; a < 3; ++a) {
      b[a] = std::min(bl[a], br[a]);
      b[3 + a] = std::max(bl[3 + a], br[3 + a]);
    }
    m[0] = left;
    m[1] = node_meta[right * 4 + 1];  // subtree end = right child's end
    m[2] = -1;
    m[3] = 0;
    return node;
  }
};

int pt_build_bvh(const float* mins, const float* maxs, int n, int leaf_size,
                 float* node_bounds, int32_t* node_meta, int32_t* order) {
  if (n <= 0) return 0;
  if (leaf_size < 1) leaf_size = 1;
  BvhBuilder b;
  b.mins = mins;
  b.maxs = maxs;
  b.leaf_size = leaf_size;
  b.node_bounds = node_bounds;
  b.node_meta = node_meta;
  b.order = order;
  b.cent.resize((size_t)n * 3);
  for (int i = 0; i < n * 3; ++i) b.cent[i] = 0.5f * (mins[i] + maxs[i]);
  std::vector<int32_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  b.build(idx, 0, n);
  return b.node_count;
}

// ─────────────────────────── alias table ───────────────────────────
// Vose's O(n) alias-table construction for environment-map importance
// sampling (ops/envmap.py). The build is inherently sequential (each step
// mutates one large cell's remaining weight), so a production-size
// 2048×4096 HDR (~8.4M texels) belongs here rather than in a Python loop.
// `p` must sum to 1; outputs are the per-cell stay probability and alias
// partner index.

int pt_build_alias(const double* p, int64_t n, double* prob, int32_t* alias) {
  if (n <= 0 || n > INT32_MAX) return 1;
  std::vector<double> scaled(n);
  std::vector<int32_t> small_stack, large_stack;
  small_stack.reserve(n);
  large_stack.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    scaled[i] = p[i] * (double)n;
    prob[i] = 1.0;
    alias[i] = (int32_t)i;
    (scaled[i] < 1.0 ? small_stack : large_stack).push_back((int32_t)i);
  }
  while (!small_stack.empty() && !large_stack.empty()) {
    int32_t s = small_stack.back();
    small_stack.pop_back();
    int32_t l = large_stack.back();
    large_stack.pop_back();
    prob[s] = scaled[s];
    alias[s] = l;
    scaled[l] = (scaled[l] + scaled[s]) - 1.0;
    (scaled[l] < 1.0 ? small_stack : large_stack).push_back(l);
  }
  return 0;
}

// ─────────────────────────── OBJ loader ───────────────────────────
// Fast triangle-soup loader for large meshes ('v' and 'f' records, fan
// triangulation) — the Python loader is fine for small files but a
// million-triangle OBJ deserves native parsing.

int pt_count_obj(const char* path, int64_t* out_verts, int64_t* out_tris) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  char line[1024];
  int64_t nv = 0, nt = 0;
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      ++nv;
    } else if (line[0] == 'f') {
      int corners = 0;
      char* s = line + 1;
      while (*s) {
        while (*s == ' ' || *s == '\t') ++s;
        if (*s == 0 || *s == '\n' || *s == '\r') break;
        ++corners;
        while (*s && *s != ' ' && *s != '\t' && *s != '\n' && *s != '\r') ++s;
      }
      if (corners >= 3) nt += corners - 2;
    }
  }
  std::fclose(f);
  *out_verts = nv;
  *out_tris = nt;
  return 0;
}

int pt_load_obj(const char* path, float* tri_verts /* [tris,3,3] */,
                int64_t max_tris) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<float> verts;
  std::vector<int64_t> face;
  int64_t tris = 0;
  char line[1024];
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      float x, y, z;
      if (std::sscanf(line + 1, "%f %f %f", &x, &y, &z) == 3) {
        verts.push_back(x);
        verts.push_back(y);
        verts.push_back(z);
      }
    } else if (line[0] == 'f') {
      face.clear();
      char* s = line + 1;
      while (*s) {
        while (*s == ' ' || *s == '\t') ++s;
        if (*s == 0 || *s == '\n' || *s == '\r') break;
        long v = std::strtol(s, &s, 10);
        int64_t nverts = (int64_t)verts.size() / 3;
        face.push_back(v > 0 ? v - 1 : nverts + v);
        while (*s && *s != ' ' && *s != '\t' && *s != '\n' && *s != '\r') ++s;
      }
      const int64_t nverts = (int64_t)verts.size() / 3;
      for (size_t k = 1; k + 1 < face.size(); ++k) {
        if (tris >= max_tris) {
          std::fclose(f);
          return -2;
        }
        int64_t ids[3] = {face[0], face[k], face[k + 1]};
        // A malformed/adversarial OBJ can reference vertices that don't
        // exist (or resolve a negative index below 0): skip the face rather
        // than read out of bounds (mirrors the Python loader's check).
        bool in_range = true;
        for (int c = 0; c < 3; ++c)
          if (ids[c] < 0 || ids[c] >= nverts) in_range = false;
        if (!in_range) continue;
        for (int c = 0; c < 3; ++c)
          for (int a = 0; a < 3; ++a)
            tri_verts[(tris * 3 + c) * 3 + a] = verts[ids[c] * 3 + a];
        ++tris;
      }
    }
  }
  std::fclose(f);
  return (int)tris;
}

}  // extern "C"
