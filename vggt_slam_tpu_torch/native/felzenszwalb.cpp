// Felzenszwalb-Huttenlocher graph-based image segmentation (IJCV 2004), the
// port's copy of vggt_slam_tpu/native/felzenszwalb.cpp: a weight-free mask
// proposer for the dense semantic embedder (semantic/embedder.py), built
// with g++ at first use (native/felzenszwalb.py).
//
// 8-connected grid graph over the gaussian-smoothed image, edge weight the
// Euclidean colour distance; edges in ascending order join components when
// the weight is within both components' Int(C) + k/|C|; a second pass
// absorbs components smaller than min_size into a neighbour.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Edge {
  float w;
  int32_t a, b;
};

struct DSU {
  std::vector<int32_t> parent;
  std::vector<int32_t> size;
  std::vector<float> thresh;  // Int(C) + k/|C|
  explicit DSU(int32_t n, float k)
      : parent(n), size(n, 1), thresh(n, k) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }
  int32_t find(int32_t x) {
    int32_t r = x;
    while (parent[r] != r) r = parent[r];
    while (parent[x] != r) {
      int32_t nx = parent[x];
      parent[x] = r;
      x = nx;
    }
    return r;
  }
  int32_t join(int32_t a, int32_t b) {
    if (size[a] < size[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
    return a;
  }
};

// Separable gaussian blur, reflect boundary. img is H*W*C planar-last
// (row-major H, W, C).
void gaussian_blur(std::vector<float>& img, int H, int W, int C,
                   float sigma) {
  if (sigma <= 0.f) return;
  int radius = std::max(1, (int)std::ceil(sigma * 3.f));
  std::vector<float> kern(2 * radius + 1);
  float s = 0.f;
  for (int i = -radius; i <= radius; ++i) {
    kern[i + radius] = std::exp(-(float)(i * i) / (2.f * sigma * sigma));
    s += kern[i + radius];
  }
  for (auto& v : kern) v /= s;
  std::vector<float> tmp(img.size());
  auto reflect = [](int i, int n) {
    if (i < 0) return -i - 1;
    if (i >= n) return 2 * n - i - 1;
    return i;
  };
  // horizontal
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x)
      for (int c = 0; c < C; ++c) {
        float acc = 0.f;
        for (int i = -radius; i <= radius; ++i)
          acc += kern[i + radius] *
                 img[((size_t)y * W + reflect(x + i, W)) * C + c];
        tmp[((size_t)y * W + x) * C + c] = acc;
      }
  // vertical
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x)
      for (int c = 0; c < C; ++c) {
        float acc = 0.f;
        for (int i = -radius; i <= radius; ++i)
          acc += kern[i + radius] *
                 tmp[((size_t)reflect(y + i, H) * W + x) * C + c];
        img[((size_t)y * W + x) * C + c] = acc;
      }
}

inline float dist(const float* img, int C, size_t a, size_t b) {
  float d = 0.f;
  for (int c = 0; c < C; ++c) {
    float v = img[a * C + c] - img[b * C + c];
    d += v * v;
  }
  return std::sqrt(d);
}

}  // namespace

extern "C" {

// labels_out: H*W int32, compact component ids 0..n-1 (row-major).
// Returns the number of components (or -1 on bad input).
int32_t felzenszwalb_segment(const float* image, int32_t H, int32_t W,
                             int32_t C, float k, int32_t min_size,
                             float sigma, int32_t* labels_out) {
  if (H <= 0 || W <= 0 || C <= 0) return -1;
  const size_t n = (size_t)H * W;
  std::vector<float> img(image, image + n * C);
  gaussian_blur(img, H, W, C, sigma);

  std::vector<Edge> edges;
  edges.reserve(n * 4);
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x) {
      size_t p = (size_t)y * W + x;
      if (x + 1 < W)
        edges.push_back({dist(img.data(), C, p, p + 1), (int32_t)p,
                         (int32_t)(p + 1)});
      if (y + 1 < H)
        edges.push_back({dist(img.data(), C, p, p + W), (int32_t)p,
                         (int32_t)(p + W)});
      if (x + 1 < W && y + 1 < H)
        edges.push_back({dist(img.data(), C, p, p + W + 1), (int32_t)p,
                         (int32_t)(p + W + 1)});
      if (x > 0 && y + 1 < H)
        edges.push_back({dist(img.data(), C, p, p + W - 1), (int32_t)p,
                         (int32_t)(p + W - 1)});
    }
  std::sort(edges.begin(), edges.end(),
            [](const Edge& a, const Edge& b) { return a.w < b.w; });

  DSU dsu((int32_t)n, k);
  for (const Edge& e : edges) {
    int32_t a = dsu.find(e.a), b = dsu.find(e.b);
    if (a == b) continue;
    if (e.w <= dsu.thresh[a] && e.w <= dsu.thresh[b]) {
      int32_t r = dsu.join(a, b);
      dsu.thresh[r] = e.w + k / (float)dsu.size[r];
    }
  }
  // absorb small components (second ascending-weight pass)
  if (min_size > 1)
    for (const Edge& e : edges) {
      int32_t a = dsu.find(e.a), b = dsu.find(e.b);
      if (a != b && (dsu.size[a] < min_size || dsu.size[b] < min_size))
        dsu.join(a, b);
    }

  // compact ids
  std::vector<int32_t> remap(n, -1);
  int32_t next = 0;
  for (size_t i = 0; i < n; ++i) {
    int32_t r = dsu.find((int32_t)i);
    if (remap[r] < 0) remap[r] = next++;
    labels_out[i] = remap[r];
  }
  return next;
}

}  // extern "C"
