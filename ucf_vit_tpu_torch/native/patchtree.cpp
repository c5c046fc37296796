// Native adaptive-patching kernels: greedy quadtree/octree build and 3D
// leaf resampling. The host-side hot loop of the data engine (SURVEY.md
// §3.3: per-sample tree build + per-leaf resize is what feeds the TPUs).
// Bit-exact with the numpy implementation in data/quadtree.py / octree.py:
// summed-area/volume tables for O(1) region sums, a lazy max-heap with
// insertion-order tie-breaking, children expanded in place (DFS order).
//
// Built with: g++ -O3 -march=native -shared -fPIC (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Node {
    int32_t coord[6];  // x1,x2,y1,y2[,z1,z2]
    int64_t value;
    int32_t children[8];
    int8_t n_children;
};

typedef std::pair<std::pair<int64_t, int64_t>, int32_t> HeapEntry;
// ((value, -serial), node_index): max-heap -> value desc, serial asc.

}  // namespace

extern "C" {

// edges: [h, w] uint8. out_boxes: [fixed_length, 4] int32 (x1,x2,y1,y2).
// Returns number of leaves written.
int quadtree_build(const uint8_t* edges, int h, int w, int fixed_length,
                   int32_t* out_boxes, int64_t* out_values) {
    // summed-area table with zero border
    std::vector<int64_t> sat((size_t)(h + 1) * (w + 1), 0);
    for (int y = 0; y < h; ++y) {
        int64_t row = 0;
        for (int x = 0; x < w; ++x) {
            row += edges[(size_t)y * w + x];
            sat[(size_t)(y + 1) * (w + 1) + (x + 1)] =
                sat[(size_t)y * (w + 1) + (x + 1)] + row;
        }
    }
    auto rect_val = [&](int x1, int x2, int y1, int y2) -> int64_t {
        int64_t raw = sat[(size_t)y2 * (w + 1) + x2] -
                      sat[(size_t)y1 * (w + 1) + x2] -
                      sat[(size_t)y2 * (w + 1) + x1] +
                      sat[(size_t)y1 * (w + 1) + x1];
        return raw / 255;
    };

    std::vector<Node> arena;
    arena.reserve(2 * fixed_length + 8);
    Node root;
    root.coord[0] = 0; root.coord[1] = w; root.coord[2] = 0; root.coord[3] = h;
    root.value = rect_val(0, w, 0, h);
    root.n_children = 0;
    arena.push_back(root);

    std::priority_queue<HeapEntry> heap;
    heap.push({{arena[0].value, 0}, 0});
    int64_t serial = 1;
    int count = 1;

    while (count < fixed_length && !heap.empty()) {
        int32_t idx = heap.top().second;
        heap.pop();
        Node& nd = arena[idx];
        int x1 = nd.coord[0], x2 = nd.coord[1], y1 = nd.coord[2], y2 = nd.coord[3];
        if (x2 - x1 == 2) break;  // min leaf side (quadtree.py:124)
        int xm = (x1 + x2) / 2, ym = (y1 + y2) / 2;
        int quads[4][4] = {
            {x1, xm, ym, y2}, {xm, x2, ym, y2}, {x1, xm, y1, ym}, {xm, x2, y1, ym}};
        nd.n_children = 4;
        for (int c = 0; c < 4; ++c) {
            Node ch;
            std::memcpy(ch.coord, quads[c], 4 * sizeof(int32_t));
            ch.value = rect_val(quads[c][0], quads[c][1], quads[c][2], quads[c][3]);
            ch.n_children = 0;
            int32_t ci = (int32_t)arena.size();
            arena[idx].children[c] = ci;
            arena.push_back(ch);
            heap.push({{ch.value, -serial}, ci});
            ++serial;
        }
        count += 3;
    }

    // DFS flatten (children replace parent in place)
    std::vector<int32_t> stack;
    stack.push_back(0);
    int out = 0;
    while (!stack.empty()) {
        int32_t i = stack.back();
        stack.pop_back();
        const Node& nd = arena[i];
        if (nd.n_children == 0) {
            std::memcpy(out_boxes + (size_t)out * 4, nd.coord, 4 * sizeof(int32_t));
            out_values[out] = nd.value;
            ++out;
        } else {
            for (int c = nd.n_children - 1; c >= 0; --c)
                stack.push_back(nd.children[c]);
        }
    }
    return out;
}

// edges: [d0, d1, d2] uint8 (cubic). out_boxes: [fixed_length, 6]
// (x1,x2,y1,y2,z1,z2) — reference axis convention (octree.py:77).
int octree_build(const uint8_t* edges, int n, int64_t norm_factor,
                 int fixed_length, int32_t* out_boxes, int64_t* out_values) {
    const int s1 = n + 1;
    std::vector<int64_t> svt((size_t)s1 * s1 * s1, 0);
    for (int z = 0; z < n; ++z)
        for (int y = 0; y < n; ++y) {
            int64_t row = 0;
            for (int x = 0; x < n; ++x) {
                row += edges[((size_t)z * n + y) * n + x];
                // svt[z+1][y+1][x+1] = svt[z][y+1][x+1] + svt[z+1][y][x+1]
                //                    - svt[z][y][x+1] + rowsum
                svt[(((size_t)z + 1) * s1 + y + 1) * s1 + x + 1] =
                    svt[((size_t)z * s1 + y + 1) * s1 + x + 1] +
                    svt[(((size_t)z + 1) * s1 + y) * s1 + x + 1] -
                    svt[((size_t)z * s1 + y) * s1 + x + 1] + row;
            }
        }
    auto at = [&](int z, int y, int x) -> int64_t {
        return svt[((size_t)z * s1 + y) * s1 + x];
    };
    auto cube_val = [&](const int32_t* c) -> int64_t {
        int x1 = c[0], x2 = c[1], y1 = c[2], y2 = c[3], z1 = c[4], z2 = c[5];
        int64_t raw = at(z2, y2, x2) - at(z1, y2, x2) - at(z2, y1, x2) -
                      at(z2, y2, x1) + at(z1, y1, x2) + at(z1, y2, x1) +
                      at(z2, y1, x1) - at(z1, y1, x1);
        return raw / norm_factor;
    };

    std::vector<Node> arena;
    arena.reserve(2 * fixed_length + 16);
    Node root;
    int32_t rc[6] = {0, n, 0, n, 0, n};
    std::memcpy(root.coord, rc, sizeof(rc));
    root.value = cube_val(rc);
    root.n_children = 0;
    arena.push_back(root);

    std::priority_queue<HeapEntry> heap;
    heap.push({{arena[0].value, 0}, 0});
    int64_t serial = 1;
    int count = 1;

    while (count < fixed_length && !heap.empty()) {
        int32_t idx = heap.top().second;
        heap.pop();
        Node& nd = arena[idx];
        int x1 = nd.coord[0], x2 = nd.coord[1], y1 = nd.coord[2],
            y2 = nd.coord[3], z1 = nd.coord[4], z2 = nd.coord[5];
        if (x2 - x1 == 2) break;
        int xm = (x1 + x2) / 2, ym = (y1 + y2) / 2, zm = (z1 + z2) / 2;
        int octs[8][6] = {
            {x1, xm, y1, ym, z1, zm}, {xm, x2, y1, ym, z1, zm},
            {x1, xm, ym, y2, z1, zm}, {xm, x2, ym, y2, z1, zm},
            {x1, xm, y1, ym, zm, z2}, {xm, x2, y1, ym, zm, z2},
            {x1, xm, ym, y2, zm, z2}, {xm, x2, ym, y2, zm, z2}};
        nd.n_children = 8;
        for (int c = 0; c < 8; ++c) {
            Node ch;
            std::memcpy(ch.coord, octs[c], sizeof(octs[c]));
            ch.value = cube_val(octs[c]);
            ch.n_children = 0;
            int32_t ci = (int32_t)arena.size();
            arena[idx].children[c] = ci;
            arena.push_back(ch);
            heap.push({{ch.value, -serial}, ci});
            ++serial;
        }
        count += 7;
    }

    std::vector<int32_t> stack;
    stack.push_back(0);
    int out = 0;
    while (!stack.empty()) {
        int32_t i = stack.back();
        stack.pop_back();
        const Node& nd = arena[i];
        if (nd.n_children == 0) {
            std::memcpy(out_boxes + (size_t)out * 6, nd.coord, 6 * sizeof(int32_t));
            out_values[out] = nd.value;
            ++out;
        } else {
            for (int c = nd.n_children - 1; c >= 0; --c)
                stack.push_back(nd.children[c]);
        }
    }
    return out;
}

// Separable trilinear/nearest resample of [d1,h1,w1,c] f32 -> [m,m,m,c],
// reproducing the reference RegularGridInterpolator grid convention
// (source points linspace(0,n,n), queries linspace(0,n,m)) — octree.py:104+.
// `sstride_z/y/x` are element strides of the (possibly non-contiguous)
// source view; dst is contiguous [m,m,m,c].
static void resize3d_strided(const float* src, int n, int c,
                             size_t sz, size_t sy, size_t sx,
                             float* dst, int m, int nearest) {
    std::vector<int> lo(m);
    std::vector<float> fr(m);
    if (n == 1) {
        for (int i = 0; i < m; ++i) { lo[i] = 0; fr[i] = 0.f; }
    } else {
        double step = (double)n / (n - 1);
        for (int i = 0; i < m; ++i) {
            double q = (double)n * i / (m - 1 == 0 ? 1 : (m - 1));
            if (m == 1) q = 0;
            int idx = (int)(q / step);
            if (idx > n - 2) idx = n - 2;
            double f = (q - idx * step) / step;
            if (nearest) {
                lo[i] = f <= 0.5 ? idx : idx + 1;
                fr[i] = 0.f;
            } else {
                lo[i] = idx;
                fr[i] = (float)f;
            }
        }
    }
    auto S = [&](int z, int y, int x, int ch) -> float {
        return src[(size_t)z * sz + (size_t)y * sy + (size_t)x * sx + ch];
    };
    if (n == m) {  // identity grid: straight strided copy
        for (int z = 0; z < m; ++z)
            for (int y = 0; y < m; ++y)
                for (int x = 0; x < m; ++x)
                    for (int ch = 0; ch < c; ++ch)
                        dst[(((size_t)z * m + y) * m + x) * c + ch] =
                            S(z, y, x, ch);
        return;
    }
    for (int z = 0; z < m; ++z)
        for (int y = 0; y < m; ++y)
            for (int x = 0; x < m; ++x)
                for (int ch = 0; ch < c; ++ch) {
                    int z0 = lo[z], y0 = lo[y], x0 = lo[x];
                    float fz = fr[z], fy = fr[y], fx = fr[x];
                    int z1 = z0 + (fz > 0.f ? 1 : 0);
                    int y1 = y0 + (fy > 0.f ? 1 : 0);
                    int x1 = x0 + (fx > 0.f ? 1 : 0);
                    if (z1 > n - 1) z1 = n - 1;
                    if (y1 > n - 1) y1 = n - 1;
                    if (x1 > n - 1) x1 = n - 1;
                    float c00 = S(z0, y0, x0, ch) * (1 - fx) + S(z0, y0, x1, ch) * fx;
                    float c01 = S(z0, y1, x0, ch) * (1 - fx) + S(z0, y1, x1, ch) * fx;
                    float c10 = S(z1, y0, x0, ch) * (1 - fx) + S(z1, y0, x1, ch) * fx;
                    float c11 = S(z1, y1, x0, ch) * (1 - fx) + S(z1, y1, x1, ch) * fx;
                    float c0 = c00 * (1 - fy) + c01 * fy;
                    float c1 = c10 * (1 - fy) + c11 * fy;
                    dst[(((size_t)z * m + y) * m + x) * c + ch] =
                        c0 * (1 - fz) + c1 * fz;
                }
}

void resize3d(const float* src, int n, int c, float* dst, int m, int nearest) {
    if (n == m) {
        std::memcpy(dst, src, sizeof(float) * (size_t)n * n * n * c);
        return;
    }
    resize3d_strided(src, n, c, (size_t)n * n * c, (size_t)n * c, c,
                     dst, m, nearest);
}

// Batched leaf serialization: the whole octree serialize loop in one call
// (octree.py _serialize — per-leaf slice + trilinear/nearest resample +
// zero/(-1) padding to fixed_length). img: [n,n,n,c] f32 contiguous;
// boxes: [n_boxes, 6] int32 (x1,x2,y1,y2,z1,z2), cube slice convention is
// img[z1:z2, y1:y2, x1:x2, :] (Cube.get_area — x spans the LAST spatial
// dim). Writes dst [fixed_length, m,m,m,c] f32, sizes [fixed_length] i64
// (leaf side, 0-padded), pos [fixed_length, 3] f64 (leaf centers
// (x,y,z)/2, (-1,-1,-1)-padded).
void octree_serialize(const float* img, int n, int c, const int32_t* boxes,
                      int n_boxes, int fixed_length, int m, int nearest,
                      float* dst, int64_t* sizes, double* pos) {
    const size_t sz = (size_t)n * n * c;  // element stride, img dim 0 (z)
    const size_t sy = (size_t)n * c;      // dim 1 (y)
    const size_t sx = c;                  // dim 2 (x)
    const size_t patch_elems = (size_t)m * m * m * c;
    for (int i = 0; i < n_boxes; ++i) {
        const int32_t* b = boxes + (size_t)i * 6;
        int x1 = b[0], x2 = b[1], y1 = b[2], y2 = b[3], z1 = b[4], z2 = b[5];
        int side = x2 - x1;  // leaves are cubic (asserted Python-side)
        const float* src = img + (size_t)z1 * sz + (size_t)y1 * sy +
                           (size_t)x1 * sx;
        resize3d_strided(src, side, c, sz, sy, sx,
                         dst + (size_t)i * patch_elems, m, nearest);
        sizes[i] = side;
        pos[(size_t)i * 3 + 0] = (x1 + x2) / 2.0;
        pos[(size_t)i * 3 + 1] = (y1 + y2) / 2.0;
        pos[(size_t)i * 3 + 2] = (z1 + z2) / 2.0;
    }
    for (int i = n_boxes; i < fixed_length; ++i) {
        std::memset(dst + (size_t)i * patch_elems, 0,
                    patch_elems * sizeof(float));
        sizes[i] = 0;
        pos[(size_t)i * 3 + 0] = -1.0;
        pos[(size_t)i * 3 + 1] = -1.0;
        pos[(size_t)i * 3 + 2] = -1.0;
    }
}

// Separable 3D Gaussian blur on [n0,n1,n2,c] f32, bit-exact with
// scipy.ndimage.gaussian_filter(img, sigma=(s,s,s,0), mode='reflect'):
// per spatial axis, correlate each line with the symmetric kernel
// (center*w0 + sum_k (left+right)*wk) accumulating in double, mirror
// ('reflect'/np-'symmetric') boundary, ROUNDING TO F32 BETWEEN AXIS PASSES
// (scipy applies gaussian_filter1d per axis on the f32 array). `weights`
// is the full [2*radius+1] kernel as scipy computes it (_gaussian_kernel1d).
static inline int mirror_fold(int i, int n) {
    if (n == 1) return 0;
    const int period = 2 * n;
    i %= period;
    if (i < 0) i += period;
    return i < n ? i : period - 1 - i;
}

static void gauss_axis(const float* src, float* dst, int n0, int n1, int n2,
                       int c, int axis, const double* w, int r) {
    // line length and strides (in elements) for the chosen axis
    int len = axis == 0 ? n0 : (axis == 1 ? n1 : n2);
    size_t sa = axis == 0 ? (size_t)n1 * n2 * c
                          : (axis == 1 ? (size_t)n2 * c : (size_t)c);
    const double wc = w[r];
    std::vector<double> line((size_t)len + 2 * r);
    // iterate over all lines: the two non-axis spatial dims x channels
    int d1 = axis == 0 ? n1 : n0;
    int d2 = axis == 2 ? n1 : n2;
    size_t s1 = axis == 0 ? (size_t)n2 * c : (size_t)n1 * n2 * c;
    size_t s2 = axis == 2 ? (size_t)n2 * c : (size_t)c;
    for (int i1 = 0; i1 < d1; ++i1)
        for (int i2 = 0; i2 < d2; ++i2)
            for (int ch = 0; ch < c; ++ch) {
                const float* in = src + (size_t)i1 * s1 + (size_t)i2 * s2 + ch;
                float* out = dst + (size_t)i1 * s1 + (size_t)i2 * s2 + ch;
                for (int i = -r; i < len + r; ++i)
                    line[(size_t)(i + r)] =
                        in[(size_t)mirror_fold(i, len) * sa];
                for (int i = 0; i < len; ++i) {
                    const double* p = line.data() + i + r;
                    double s = p[0] * wc;
                    for (int k = 1; k <= r; ++k)
                        s += (p[-k] + p[k]) * w[r - k];
                    out[(size_t)i * sa] = (float)s;
                }
            }
}

// Cache-friendly variant for the leading axes: view the array as
// [outer, len, inner] with `inner` contiguous, and for each output row
// accumulate whole [inner] slabs (center*wc then k=1..r (left+right)*wk) —
// identical per-element FP sequence to gauss_axis, vectorizable inner loops.
static void gauss_axis_slab(const float* src, float* dst, int outer, int len,
                            size_t inner, const double* w, int r) {
    const double wc = w[r];
    std::vector<double> acc(inner);
    for (int o = 0; o < outer; ++o) {
        const float* in = src + (size_t)o * len * inner;
        float* out = dst + (size_t)o * len * inner;
        for (int i = 0; i < len; ++i) {
            const float* c0 = in + (size_t)i * inner;
            for (size_t t = 0; t < inner; ++t) acc[t] = c0[t] * wc;
            for (int k = 1; k <= r; ++k) {
                const float* lp = in + (size_t)mirror_fold(i - k, len) * inner;
                const float* rp = in + (size_t)mirror_fold(i + k, len) * inner;
                const double wk = w[r - k];
                for (size_t t = 0; t < inner; ++t)
                    acc[t] += ((double)lp[t] + (double)rp[t]) * wk;
            }
            float* od = out + (size_t)i * inner;
            for (size_t t = 0; t < inner; ++t) od[t] = (float)acc[t];
        }
    }
}

extern "C" void gaussian3d(const float* src, int n0, int n1, int n2, int c,
                           const double* weights, int radius, float* dst) {
    const size_t total = (size_t)n0 * n1 * n2 * c;
    std::vector<float> tmp(total);
    gauss_axis_slab(src, tmp.data(), 1, n0, (size_t)n1 * n2 * c,
                    weights, radius);
    gauss_axis_slab(tmp.data(), dst, n0, n1, (size_t)n2 * c,
                    weights, radius);
    std::memcpy(tmp.data(), dst, total * sizeof(float));
    // last axis: elements along it are (near-)contiguous — the padded
    // line-gather form wins when inner == c is tiny
    gauss_axis(tmp.data(), dst, n0, n1, n2, c, 2, weights, radius);
}

}  // extern "C"
