/* nrc_native: host-side native helpers of the PyTorch/CUDA port.
 *
 * The port's own copy of the host functions it needs from
 * nrc_tpu/native/nrc_native.c, unchanged in their arithmetic so that both
 * packages build the same tree and tables on one machine with the same
 * compiler flags:
 *   - bvh_build_binned_sah: 16-bin SAH builder over triangle AABBs, giving a
 *     flat binary tree (ops/bvh.py::build_bvh)
 *   - bvh_collapse_wide: greedy collapse of that tree into wide nodes
 *     (ops/bvh_wide.py::collapse_wide_arrays)
 *   - alias_table_build: Vose's Walker alias table, bit-identical to the
 *     Python loop of scene/lights.py::build_alias_table_loop
 * Loaded with ctypes by native/__init__.py.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <float.h>
#include <math.h>

#ifdef _WIN32
#define EXPORT __declspec(dllexport)
#else
#define EXPORT __attribute__((visibility("default")))
#endif

/* ------------------------------------------------------------------ */
/* Binned SAH BVH builder                                              */
/* ------------------------------------------------------------------ */

typedef struct {
    float lo[3], hi[3];
} AABB;

static void aabb_init(AABB *b)
{
    for (int i = 0; i < 3; i++) { b->lo[i] = FLT_MAX; b->hi[i] = -FLT_MAX; }
}

static void aabb_grow(AABB *b, const AABB *o)
{
    for (int i = 0; i < 3; i++) {
        if (o->lo[i] < b->lo[i]) b->lo[i] = o->lo[i];
        if (o->hi[i] > b->hi[i]) b->hi[i] = o->hi[i];
    }
}

static float aabb_area(const AABB *b)
{
    float d[3];
    for (int i = 0; i < 3; i++) {
        d[i] = b->hi[i] - b->lo[i];
        if (d[i] < 0.f) return 0.f;
    }
    return 2.f * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]);
}

/* Output node layout (SoA-friendly, depth-first):
 *   nodes_lo[n*3], nodes_hi[n*3] : AABB
 *   nodes_left[n]  : index of left child, or first-primitive index for leaf
 *   nodes_count[n] : 0 for inner node, #primitives for leaf
 *   right child is left+? -> we store explicit: nodes_right[n] (inner),
 *   skip links are derived on the Python side.
 */
typedef struct {
    AABB *prim_bounds;     /* [N] */
    float (*centroid)[3];  /* [N] */
    int32_t *prim_order;   /* [N] permutation, leaves reference ranges */
    float *nodes_lo;       /* [maxNodes*3] */
    float *nodes_hi;
    int32_t *nodes_left;
    int32_t *nodes_right;
    int32_t *nodes_start;
    int32_t *nodes_count;
    int32_t num_nodes;
    int32_t max_leaf;
} Builder;

#define NUM_BINS 16

static int32_t build_node(Builder *B, int32_t start, int32_t end)
{
    int32_t node = B->num_nodes++;
    AABB bounds, cbounds;
    aabb_init(&bounds);
    aabb_init(&cbounds);
    for (int32_t i = start; i < end; i++) {
        int32_t p = B->prim_order[i];
        aabb_grow(&bounds, &B->prim_bounds[p]);
        AABB c = { { B->centroid[p][0], B->centroid[p][1], B->centroid[p][2] },
                   { B->centroid[p][0], B->centroid[p][1], B->centroid[p][2] } };
        aabb_grow(&cbounds, &c);
    }
    memcpy(B->nodes_lo + node * 3, bounds.lo, 12);
    memcpy(B->nodes_hi + node * 3, bounds.hi, 12);

    int32_t n = end - start;
    if (n <= B->max_leaf) {
    make_leaf:
        B->nodes_left[node] = -1;
        B->nodes_right[node] = -1;
        B->nodes_start[node] = start;
        B->nodes_count[node] = n;
        return node;
    }

    /* choose split axis = widest centroid extent */
    int axis = 0;
    float ext[3];
    for (int i = 0; i < 3; i++) ext[i] = cbounds.hi[i] - cbounds.lo[i];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 1e-12f) goto make_leaf;

    /* binned SAH */
    AABB bin_bounds[NUM_BINS];
    int32_t bin_count[NUM_BINS];
    for (int b = 0; b < NUM_BINS; b++) { aabb_init(&bin_bounds[b]); bin_count[b] = 0; }
    float k = NUM_BINS * (1.f - 1e-6f) / ext[axis];
    for (int32_t i = start; i < end; i++) {
        int32_t p = B->prim_order[i];
        int b = (int)(k * (B->centroid[p][axis] - cbounds.lo[axis]));
        if (b < 0) b = 0;
        if (b >= NUM_BINS) b = NUM_BINS - 1;
        bin_count[b]++;
        aabb_grow(&bin_bounds[b], &B->prim_bounds[p]);
    }

    /* sweep for best split */
    float right_area[NUM_BINS];
    AABB acc;
    aabb_init(&acc);
    int32_t right_cnt[NUM_BINS];
    int32_t cnt = 0;
    for (int b = NUM_BINS - 1; b > 0; b--) {
        aabb_grow(&acc, &bin_bounds[b]);
        cnt += bin_count[b];
        right_area[b] = aabb_area(&acc);
        right_cnt[b] = cnt;
    }
    aabb_init(&acc);
    cnt = 0;
    float best_cost = FLT_MAX;
    int best_split = -1;
    for (int b = 0; b < NUM_BINS - 1; b++) {
        aabb_grow(&acc, &bin_bounds[b]);
        cnt += bin_count[b];
        if (cnt == 0 || cnt == n) continue;
        float cost = aabb_area(&acc) * cnt + right_area[b + 1] * right_cnt[b + 1];
        if (cost < best_cost) { best_cost = cost; best_split = b; }
    }
    if (best_split < 0) goto make_leaf;

    /* partition prim_order[start:end] by bin <= best_split */
    int32_t mid = start;
    for (int32_t i = start; i < end; i++) {
        int32_t p = B->prim_order[i];
        int b = (int)(k * (B->centroid[p][axis] - cbounds.lo[axis]));
        if (b < 0) b = 0;
        if (b >= NUM_BINS) b = NUM_BINS - 1;
        if (b <= best_split) {
            int32_t t = B->prim_order[i];
            B->prim_order[i] = B->prim_order[mid];
            B->prim_order[mid] = t;
            mid++;
        }
    }
    if (mid == start || mid == end) goto make_leaf;

    B->nodes_start[node] = -1;
    B->nodes_count[node] = 0;
    B->nodes_left[node] = build_node(B, start, mid);
    B->nodes_right[node] = build_node(B, mid, end);
    return node;
}

/* Build a BVH over `num` triangles given flat vertex arrays p0,p1,p2 [num*3].
 * Outputs (caller-allocated, capacity 2*num nodes):
 *   prim_order[num], nodes_lo/hi[2*num*3], nodes_left/right/start/count[2*num]
 * Returns number of nodes. */
EXPORT int32_t bvh_build_binned_sah(
    const float *p0, const float *p1, const float *p2, int32_t num,
    int32_t max_leaf,
    int32_t *prim_order, float *nodes_lo, float *nodes_hi,
    int32_t *nodes_left, int32_t *nodes_right,
    int32_t *nodes_start, int32_t *nodes_count)
{
    if (num <= 0) return 0;
    Builder B;
    B.prim_bounds = (AABB *)malloc(sizeof(AABB) * num);
    B.centroid = (float (*)[3])malloc(sizeof(float) * 3 * num);
    B.prim_order = prim_order;
    B.nodes_lo = nodes_lo;
    B.nodes_hi = nodes_hi;
    B.nodes_left = nodes_left;
    B.nodes_right = nodes_right;
    B.nodes_start = nodes_start;
    B.nodes_count = nodes_count;
    B.num_nodes = 0;
    B.max_leaf = max_leaf > 0 ? max_leaf : 4;

    for (int32_t i = 0; i < num; i++) {
        prim_order[i] = i;
        AABB *b = &B.prim_bounds[i];
        for (int c = 0; c < 3; c++) {
            float a = p0[i * 3 + c], d = p1[i * 3 + c], e = p2[i * 3 + c];
            float lo = a < d ? a : d; if (e < lo) lo = e;
            float hi = a > d ? a : d; if (e > hi) hi = e;
            b->lo[c] = lo;
            b->hi[c] = hi;
            B.centroid[i][c] = (lo + hi) * 0.5f;
        }
    }
    build_node(&B, 0, num);
    free(B.prim_bounds);
    free(B.centroid);
    return B.num_nodes;
}

/* ------------------------------------------------------------------ */
/* Wide (branch-N) BVH collapse                                        */
/* ------------------------------------------------------------------ */

/* Collapse the binary SAH tree into wide nodes for the wide-BVH walk
 * (ops/bvh_wide.py). Child sets grow by greedily expanding the
 * largest-surface-area inner child whose subtree exceeds leaf_size until
 * `branch` slots are used; subtrees fitting leaf_size become leaf
 * children. Mirrors the Python fallback in bvh_wide.collapse_wide.
 *
 * Outputs (caller-allocated; capacities: child_* for n_old wide nodes,
 * leaf_ids for n_old leaves):
 *   child_meta [Wcap*branch]  wide child idx | ~leaf_idx | INT32_MIN empty
 *   child_box  [Wcap*branch*6] child lo3|hi3
 *   leaf_ids   [Lcap*leaf_size] prim ids, -1 padded
 *   out_counts [3] = { W, L, depth_levels }
 * Returns W (number of wide nodes), or -1 on allocation failure. */
EXPORT int32_t bvh_collapse_wide(
    const int32_t *left, const int32_t *right,
    const int32_t *start, const int32_t *count, const int32_t *order,
    const float *lo, const float *hi,
    int32_t n_old, int32_t leaf_size, int32_t branch,
    int32_t *child_meta, float *child_box, int32_t *leaf_ids,
    int32_t *out_counts)
{
    const int32_t NONE_META = (int32_t)0x80000000;
    if (n_old <= 0) return -1;
    int64_t *prims = (int64_t *)malloc(sizeof(int64_t) * (size_t)n_old);
    float *area = (float *)malloc(sizeof(float) * (size_t)n_old);
    int32_t *stk = (int32_t *)malloc(sizeof(int32_t) * 4 * (size_t)n_old + 16);
    if (!prims || !area || !stk) {
        free(prims); free(area); free(stk);
        return -1;
    }
    /* subtree prim counts (post-order) + surface areas */
    int32_t sp = 0;
    stk[sp++] = 0;
    while (sp > 0) {
        int32_t e = stk[--sp];
        int32_t node = e & 0x7FFFFFFF;
        if (e < 0) {
            prims[node] = prims[left[node]] + prims[right[node]];
        } else if (left[node] < 0) {
            prims[node] = count[node];
        } else {
            stk[sp++] = node | (int32_t)0x80000000;
            stk[sp++] = left[node];
            stk[sp++] = right[node];
        }
    }
    for (int32_t i = 0; i < n_old; i++) {
        float ex = hi[i * 3 + 0] - lo[i * 3 + 0];
        float ey = hi[i * 3 + 1] - lo[i * 3 + 1];
        float ez = hi[i * 3 + 2] - lo[i * 3 + 2];
        if (ex < 0) ex = 0; if (ey < 0) ey = 0; if (ez < 0) ez = 0;
        area[i] = 2.0f * (ex * ey + ey * ez + ez * ex);
    }

    int32_t W = 0, L = 0, max_depth = 0, err = 0;
    /* DFS todo: (binary node, wide idx, depth) triples */
    int32_t *todo = stk;  /* reuse; 4*n capacity is plenty (3 per entry) */
    int32_t tp = 0;

/* err -> caller returns -1 and the Python wrapper falls back to the
 * asserting pure-Python collapse: guards leaf_size smaller than the binary
 * tree's max leaf count and pathologically deep leaf subtrees, which would
 * otherwise silently overrun dst / cst. */
#define COLLECT_LEAF(v) do {                                               \
        int32_t li = L++;                                                  \
        int32_t *dst = leaf_ids + (int64_t)li * leaf_size;                 \
        int32_t nfill = 0;                                                 \
        int32_t cst[128]; int32_t csp = 0;                                 \
        cst[csp++] = (v);                                                  \
        while (csp > 0 && !err) {                                          \
            int32_t u2 = cst[--csp];                                       \
            if (left[u2] < 0) {                                            \
                if (nfill + count[u2] > leaf_size) { err = 1; break; }     \
                for (int32_t k = 0; k < count[u2]; k++)                    \
                    dst[nfill++] = order[start[u2] + k];                   \
            } else {                                                       \
                if (csp + 2 > 128) { err = 1; break; }                     \
                cst[csp++] = right[u2];                                    \
                cst[csp++] = left[u2];                                     \
            }                                                              \
        }                                                                  \
        for (int32_t k = nfill; k < leaf_size; k++) dst[k] = -1;           \
    } while (0)

    if (prims[0] <= leaf_size || left[0] < 0) {
        /* degenerate scene: one wide node, one leaf child */
        for (int32_t s = 0; s < branch; s++) {
            child_meta[s] = NONE_META;
            for (int32_t k = 0; k < 6; k++)
                child_box[(int64_t)s * 6 + k] = (k < 3) ? 3.0e38f : -3.0e38f;
        }
        child_meta[0] = ~0;  /* leaf 0 */
        for (int32_t k = 0; k < 3; k++) {
            child_box[k] = lo[k];
            child_box[3 + k] = hi[k];
        }
        COLLECT_LEAF(0);
        W = 1;
        max_depth = 0;
    } else {
        W = 1;
        todo[tp++] = 0;  /* binary node */
        todo[tp++] = 0;  /* wide idx */
        todo[tp++] = 0;  /* depth */
        int32_t slots[64];
        while (tp > 0 && !err) {
            int32_t d = todo[--tp];
            int32_t wi = todo[--tp];
            int32_t v = todo[--tp];
            if (d > max_depth) max_depth = d;
            int32_t ns = 2;
            slots[0] = left[v];
            slots[1] = right[v];
            while (ns < branch) {
                int32_t best = -1;
                float best_a = -1.0f;
                for (int32_t i = 0; i < ns; i++) {
                    int32_t u = slots[i];
                    if (left[u] >= 0 && prims[u] > leaf_size
                        && area[u] > best_a) {
                        best = i;
                        best_a = area[u];
                    }
                }
                if (best < 0) break;
                int32_t u = slots[best];
                slots[best] = slots[--ns];  /* remove: swap with last */
                slots[ns++] = left[u];
                slots[ns++] = right[u];
            }
            int32_t *meta_row = child_meta + (int64_t)wi * branch;
            float *box_row = child_box + (int64_t)wi * branch * 6;
            for (int32_t s = 0; s < branch; s++) {
                meta_row[s] = NONE_META;
                for (int32_t k = 0; k < 6; k++)
                    box_row[(int64_t)s * 6 + k] = (k < 3) ? 3.0e38f : -3.0e38f;
            }
            for (int32_t s = 0; s < ns; s++) {
                int32_t u = slots[s];
                for (int32_t k = 0; k < 3; k++) {
                    box_row[(int64_t)s * 6 + k] = lo[u * 3 + k];
                    box_row[(int64_t)s * 6 + 3 + k] = hi[u * 3 + k];
                }
                if (left[u] < 0 || prims[u] <= leaf_size) {
                    meta_row[s] = ~L;  /* leaf about to be emitted */
                    COLLECT_LEAF(u);
                } else {
                    meta_row[s] = W;
                    todo[tp++] = u;
                    todo[tp++] = W;
                    todo[tp++] = d + 1;
                    W++;
                }
            }
        }
    }
#undef COLLECT_LEAF

    if (err) {
        free(prims); free(area); free(stk);
        return -1;
    }
    out_counts[0] = W;
    out_counts[1] = L;
    out_counts[2] = max_depth + 1;
    free(prims); free(area); free(stk);
    return W;
}

/* ------------------------------------------------------------------ */
/* Walker alias table (Vose O(n))                                      */
/* ------------------------------------------------------------------ */

/* Build prob/alias from already-scaled p (mean 1.0; p[i] = w[i]*n/total).
 * Two index stacks, LIFO as in the Python loop, so the result is the same
 * bits. Returns 0, or -1 on allocation failure. */
EXPORT int32_t alias_table_build(const double *p_in, int64_t n,
                                 float *prob, int32_t *alias)
{
    if (n <= 0) return 0;
    double *p = (double *)malloc(sizeof(double) * (size_t)n);
    int64_t *small = (int64_t *)malloc(sizeof(int64_t) * (size_t)n);
    int64_t *large = (int64_t *)malloc(sizeof(int64_t) * (size_t)n);
    if (!p || !small || !large) {
        free(p); free(small); free(large);
        return -1;
    }
    int64_t ns = 0, nl = 0;
    for (int64_t i = 0; i < n; i++) {
        p[i] = p_in[i];
        prob[i] = 1.0f;
        alias[i] = (int32_t)i;
        if (p[i] < 1.0) small[ns++] = i; else large[nl++] = i;
    }
    while (ns > 0 && nl > 0) {
        int64_t s = small[--ns];
        int64_t l = large[--nl];
        prob[s] = (float)p[s];
        alias[s] = (int32_t)l;
        p[l] = p[l] - (1.0 - p[s]);
        if (p[l] < 1.0) small[ns++] = l; else large[nl++] = l;
    }
    free(p); free(small); free(large);
    return 0;
}
