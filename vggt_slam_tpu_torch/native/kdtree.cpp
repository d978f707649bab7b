// Minimal 3-D KD-tree: build + nearest-neighbour queries, the port's copy
// of vggt_slam_tpu/native/kdtree.cpp (the dense geometry eval's host
// index). C ABI, loaded with ctypes by native/kdtree.py, which builds it
// with: g++ -O3 -shared -fPIC kdtree.cpp -o libkdtree.so
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Node {
    float point[3];
    int32_t index;     // original point index
    int32_t left;      // node array offsets; -1 = leaf end
    int32_t right;
    uint8_t axis;
};

struct Tree {
    std::vector<Node> nodes;
    int32_t root = -1;
};

int32_t build_recursive(Tree& t, std::vector<int32_t>& ids,
                        const float* pts, int lo, int hi, int depth) {
    if (lo >= hi) return -1;
    int axis = depth % 3;
    int mid = (lo + hi) / 2;
    std::nth_element(ids.begin() + lo, ids.begin() + mid, ids.begin() + hi,
                     [&](int32_t a, int32_t b) {
                         return pts[3 * a + axis] < pts[3 * b + axis];
                     });
    int32_t id = ids[mid];
    Node n;
    std::memcpy(n.point, pts + 3 * id, 3 * sizeof(float));
    n.index = id;
    n.axis = static_cast<uint8_t>(axis);
    int32_t self = static_cast<int32_t>(t.nodes.size());
    t.nodes.push_back(n);
    int32_t l = build_recursive(t, ids, pts, lo, mid, depth + 1);
    int32_t r = build_recursive(t, ids, pts, mid + 1, hi, depth + 1);
    t.nodes[self].left = l;
    t.nodes[self].right = r;
    return self;
}

inline float sqdist(const float* a, const float* b) {
    float dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
    return dx * dx + dy * dy + dz * dz;
}

void query_recursive(const Tree& t, int32_t ni, const float* q,
                     float& best_d2, int32_t& best_idx) {
    if (ni < 0) return;
    const Node& n = t.nodes[ni];
    float d2 = sqdist(n.point, q);
    if (d2 < best_d2) {
        best_d2 = d2;
        best_idx = n.index;
    }
    float diff = q[n.axis] - n.point[n.axis];
    int32_t near = diff <= 0 ? n.left : n.right;
    int32_t far = diff <= 0 ? n.right : n.left;
    query_recursive(t, near, q, best_d2, best_idx);
    if (diff * diff < best_d2)
        query_recursive(t, far, q, best_d2, best_idx);
}

}  // namespace

extern "C" {

void* kdtree_build(const float* points, int32_t n) {
    Tree* t = new Tree();
    t->nodes.reserve(n);
    std::vector<int32_t> ids(n);
    for (int32_t i = 0; i < n; ++i) ids[i] = i;
    t->root = build_recursive(*t, ids, points, 0, n, 0);
    return t;
}

void kdtree_query(const void* handle, const float* queries, int32_t m,
                  float* out_dists, int32_t* out_idx) {
    const Tree* t = static_cast<const Tree*>(handle);
    for (int32_t i = 0; i < m; ++i) {
        float best = INFINITY;
        int32_t idx = -1;
        if (t->root >= 0) query_recursive(*t, t->root, queries + 3 * i, best, idx);
        out_dists[i] = std::sqrt(best);
        out_idx[i] = idx;
    }
}

void kdtree_free(void* handle) { delete static_cast<Tree*>(handle); }

}  // extern "C"
