// K5, the group megakernel, in CUDA C++ for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel raytracing_tpu/ops/megakernel.py
// make_megakernel (pallas_call in its `run`). It traces one phase of up to
// max_depth bounces for every ray. The closest hit of a bounce comes from
// one of two searches:
// * the walk (use_bvh): a stackless preorder walk of the chunked BVH
//   (ops/mega_bvh.py) along its skip links. A box is hit when
//   enter < exit, enter clamped below by T_MIN and exit above by the best
//   hit so far; a hit internal node descends to i + 1, anything else
//   follows its miss link. A hit leaf tests its members: the smallest
//   candidate, the lowest unified column among equal ones, replaces the
//   best hit when strictly nearer;
// * the dense sweep: every unified-table column, spheres then quads. The
//   Pallas kernel takes chunks of 8 with the lowest column winning a
//   chunk's ties and strict < across chunks; a candidate is the nearest
//   root above T_MIN when it lies below the best hit, so that equals one
//   pass with strict <, which is what this kernel does.
// Spheres are tested with the center at the ray's time and roots in t
// space, quads through their plane, w and edges. The shading after the
// hit is K1's (rt_shade.cuh): solid, checker, marble and image textures,
// the last two as template switches, as in K1. K5 has no depth cap.
//
// What bounds it: FP32 ALU work in the walk, and how much of each warp
// does it. Per segment a ray visits some tens of nodes (about 20
// operations each: 6 subtracts, 6 multiplies, 10 min/max, a compare) and
// tests the real members of each leaf it enters (about 30 operations per
// sphere, 45 per quad), then shades (~150). Memory traffic is small: 56 B
// of ray state in and out per ray per phase; the nodes (32 B each) and
// leaves (256 B per sphere chunk) are read many times but stay in L1/L2.
// The rays of a warp walk different paths, so a box or member test runs
// with only part of the warp's lanes.
//
// What the design does about it:
// * one thread traces one ray through the whole phase with its state in
//   registers; the walk keeps one node index, so it needs no stack;
// * the guarded root: a member whose discriminant is negative (most
//   members a ray tests) never reaches sqrtf. Without fast math sqrtf is
//   the correctly rounded sequence MUFU.RSQ + Newton step, which calls a
//   slow-path subroutine for any input that is not a positive normal
//   number; the baseline design took the root of max(disc, 0), so every
//   miss called it. In the SASS (tools/k1_sass.py --kernel k5) a miss now
//   branches past 25 instructions, the call among them. The sweep shares
//   the guard. On an H100 a full-width depth-20 launch of the 4,098-sphere
//   bouncing_spheres_64 took 0.73-0.74 ms without the guard and the split
//   and 0.43 ms with both (tools/time_k5.py, in turns with a checkout
//   that has neither; PERF.md);
// * a leaf tests all 8 slots: a short chunk's pad slots (their gid
//   repeats the first member's, ops/mega_bvh.py) hold zero records whose
//   discriminant, -|d|^2 |o|^2 sin^2 of the angle between them, the guard
//   rejects. Stopping at the first pad breaks the unrolled member loop
//   and measured slower on the card (PERF.md), so K5 does not;
// * the walk is split into a node loop and a leaf loop (Aila & Laine
//   2009, "while-while", without speculative traversal): each lane runs
//   box tests along the skip links until it stands on a leaf whose box it
//   hit, or its walk ends; then the lanes that hold a leaf test its
//   members together, and each resumes at that leaf's miss link. A ray
//   visits the same nodes and members in the same order as in one loop
//   that tests a leaf as soon as it meets it, so the result is the same.
//   Member tests ran with 17% of a warp's lanes in one loop and 29% split,
//   box tests with 30% and 25% (the counting probe, same launch);
// * the node table is staged once per block into shared memory when it
//   fits (NODE_SMEM_BYTES: 1,536 nodes, ~6k primitives); larger trees are
//   read from global memory through the caches;
// * leaf members are 32- or 64-byte records read as float4 through the
//   read-only cache (__ldg), and the winner's fields and image texels
//   likewise; the 6 KB of marble tables stay in global memory, served by
//   L1 (shared memory holds the nodes);
// * a ray leaves the bounce loop as soon as it dies; the trace compacts
//   live rays to the front between phases so warps stay full.
//
// The guard and the split are template switches (Design): rt_trace_group
// runs K5Design; rt_trace_group_probe runs the walk in K5Design or in the
// baseline design (neither switch: the walk as it was before them), each
// timed or as a counting instantiation that adds, at every box and member
// test, one issue and the warp's active lanes (__activemask), for the
// tools and chip_smoke.py. Renders never launch the probe.
//
// Parity: the build uses -fmad=false and no fast math, so every multiply
// and add rounds on its own as in the JAX reference and the plain PyTorch
// version (ops/megakernel_group.py trace_group_torch). A rejected root is
// a miss (BIG) as the baseline's clamped one was; pad sweep columns are
// rejected by r > 0 (spheres) or their zero normal (quads).
//
// Layout: ray_f (14, n) f32 and ray_i (2, n) i32 in, rad (3, n) f32,
// bounces (n,) i32 and optionally the new (14, n) state out, as K1.
// Tables: the unified table (26, P) f32, nodes (K, 8) f32 [bmin xyz,
// bmax xyz, miss, leaf], sphere leaves (LS, 8, 8) f32 [cx cy cz vx vy vz
// r 0] and quad leaves (LQ, 8, 16) f32 [nx ny nz D wx wy wz qx qy qz ux uy
// uz vx vy vz], with the members' unified columns in (LS, 8) and (LQ, 8)
// i32.
//
// The per-ray math also compiles as plain C++ (without __CUDACC__), so its
// arithmetic can be exercised on a host.

#include "rt_shade.cuh"

namespace {

using rt::BIG;
using rt::PARALLEL_EPS;
using rt::T_MIN;

constexpr int LEAF = 8;       // members per leaf chunk
constexpr int NO_GID = 0x7fffffff;
// counts of the walk (walk_hit's `counts`): node visits, sphere and quad
// member tests (real members: a pad slot tested is not counted), then
// box-test issues and their active lanes, member-test issues (pad slots
// included) and their active lanes (the last four on the card only)
constexpr int N_COUNTS = 7;

// The walk's design: the guarded root and the node loop / leaf loop split.
template <bool GUARD_, bool SPLIT_>
struct Design {
  static constexpr bool GUARD = GUARD_, SPLIT = SPLIT_;
};
using K5Design = Design<true, true>;          // what rt_trace_group runs
using BaselineDesign = Design<false, false>;  // one loop, the root of max(disc, 0)

struct GroupParams {
  const float* table;      // (26, P) unified-table rows
  int P;
  int ns_pad;              // first quad column
  const float* nodes;      // (n_nodes, 8)
  int n_nodes;
  const float* sph_leaf;   // (n_sph_chunks, 8, 8)
  const int* sph_gid;      // (n_sph_chunks, 8)
  int n_sph_chunks;
  const float* quad_leaf;  // (n_quad_chunks, 8, 16)
  const int* quad_gid;     // (n_quad_chunks, 8)
  const float* ray_f;      // (N_F, n)
  const int* ray_i;        // (2, n)
  int n;
  float* out_rad;          // (3, n)
  int* out_bc;             // (n,)
  float* out_state;        // (N_F, n) or null
  uint32_t seed;
  uint32_t b_off;
  int max_depth;
  float bg_r, bg_g, bg_b;
  const int* perm;         // (3, 256) marble permutations
  const float* grad;       // (256, 3) marble gradients
  const float* atlas;      // (T, 3) image texels
  long long* counts;       // (N_COUNTS,) summed over rays, or null (the counting probe)
};

struct RayGeom {
  float ox, oy, oz, dx, dy, dz, tm, a, inv_a;
};

// A sphere's nearest root in (T_MIN, tb), or BIG. GUARD: a negative or
// NaN discriminant returns before the square root; every disc >= 0 gets
// the root it got from sqrtf(max(disc, 0)).
template <bool GUARD>
RT_DEVICE float sphere_cand(const RayGeom& g, float cx0, float cy0, float cz0, float vx,
                            float vy, float vz, float r, float tb) {
  const float ocx = g.ox - (cx0 + g.tm * vx);
  const float ocy = g.oy - (cy0 + g.tm * vy);
  const float ocz = g.oz - (cz0 + g.tm * vz);
  const float half_b = ocx * g.dx + ocy * g.dy + ocz * g.dz;
  const float cq = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r;
  const float disc = half_b * half_b - g.a * cq;
  if (GUARD && !(disc >= 0.0f)) return BIG;
  const float sq = sqrtf(GUARD ? disc : fmaxf(disc, 0.0f));
  const float root0 = (-half_b - sq) * g.inv_a;
  const float root1 = (-half_b + sq) * g.inv_a;
  const bool ok0 = root0 > T_MIN && root0 < tb;
  const bool ok1 = root1 > T_MIN && root1 < tb;
  const float root = ok0 ? root0 : root1;
  return (disc >= 0.0f && (ok0 || ok1) && r > 0.0f) ? root : BIG;
}

// A quad's plane hit in (T_MIN, tb) inside its edges, or BIG.
RT_DEVICE float quad_cand(const RayGeom& g, float nx, float ny, float nz, float dd, float wx,
                          float wy, float wz, float qx, float qy, float qz, float ux, float uy,
                          float uz, float vx, float vy, float vz, float tb) {
  const float denom = nx * g.dx + ny * g.dy + nz * g.dz;
  const float safe = fabsf(denom) < PARALLEL_EPS ? 1.0f : denom;
  const float tq = (dd - (nx * g.ox + ny * g.oy + nz * g.oz)) / safe;
  const float px = g.ox + tq * g.dx - qx;
  const float py = g.oy + tq * g.dy - qy;
  const float pz = g.oz + tq * g.dz - qz;
  const float alpha = wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz)
                      + wz * (px * vy - py * vx);
  const float beta = wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz)
                     + wz * (ux * py - uy * px);
  const bool valid = fabsf(denom) >= PARALLEL_EPS && tq > T_MIN && tq < tb && alpha >= 0.0f &&
                     alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f;
  return valid ? tq : BIG;
}

RT_DEVICE RayGeom ray_geom(const rt::Ray& r) {
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  return RayGeom{r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tm, a, 1.0f / a};
}

// Dense closest hit over every unified-table column.
template <class D = K5Design>
RT_DEVICE void sweep_hit(const GroupParams& p, const rt::Ray& r, float& t, int& ib) {
  const RayGeom g = ray_geom(r);
  const float* tab = p.table;
  const int P = p.P;
  float tb = BIG;
  int best = -1;
  for (int j = 0; j < p.ns_pad; ++j) {
    const float* c = tab + j;
    const float cand = sphere_cand<D::GUARD>(
        g, RT_LDG(c + rt::G0 * P), RT_LDG(c + rt::G1 * P), RT_LDG(c + rt::G2 * P),
        RT_LDG(c + rt::G3 * P), RT_LDG(c + rt::G4 * P), RT_LDG(c + rt::G5 * P),
        RT_LDG(c + rt::G6 * P), tb);
    if (cand < tb) {
      tb = cand;
      best = j;
    }
  }
  for (int j = p.ns_pad; j < P; ++j) {
    const float* c = tab + j;
    const float cand = quad_cand(
        g, RT_LDG(c + rt::G0 * P), RT_LDG(c + rt::G1 * P), RT_LDG(c + rt::G2 * P),
        RT_LDG(c + rt::G3 * P), RT_LDG(c + rt::G4 * P), RT_LDG(c + rt::G5 * P),
        RT_LDG(c + rt::G6 * P), RT_LDG(c + rt::QX * P), RT_LDG(c + rt::QY * P),
        RT_LDG(c + rt::QZ * P), RT_LDG(c + rt::UX * P), RT_LDG(c + rt::UY * P),
        RT_LDG(c + rt::UZ * P), RT_LDG(c + rt::VX * P), RT_LDG(c + rt::VY * P),
        RT_LDG(c + rt::VZ * P), tb);
    if (cand < tb) {
      tb = cand;
      best = j;
    }
  }
  t = tb;
  ib = best;
}

// Fold a leaf candidate into the leaf's best (smallest, then lowest gid).
RT_DEVICE void leaf_min(float cand, int gid, float& cm, int& gm) {
  if (cand < cm || (cand == cm && gid < gm)) {
    cm = cand;
    gm = gid;
  }
}

RT_DEVICE float safe_inv(float v) {
  return (v < 0.0f ? -1.0f : 1.0f) / fmaxf(fabsf(v), 1e-20f);
}

// The counting probe's lane accounting: the lowest active lane of the
// warp adds one issue to c[0] and the warp's active lanes to c[1]. A no-op
// off the card.
RT_DEVICE void lane_tick(long long* c) {
#ifdef __CUDACC__
  const unsigned m = __activemask();
  if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
    c[0] += 1;
    c[1] += __popc(m);
  }
#else
  (void)c;
#endif
}

// Fold the members of leaf chunk `leaf` into (cm, gm), the leaf's best.
// A short chunk's pad slots repeat its first gid and hold zero records,
// which never win (r = 0, a zero normal); `counts` counts the real
// members (a pad slot is tested, not counted).
template <class D>
RT_DEVICE void leaf_hit(const GroupParams& p, const RayGeom& g, int leaf, float tb, float& cm,
                        int& gm, long long* counts) {
  if (leaf < p.n_sph_chunks) {
    const float4* rec = reinterpret_cast<const float4*>(p.sph_leaf) + (size_t)leaf * (LEAF * 2);
    const int* gid = p.sph_gid + (size_t)leaf * LEAF;
    for (int s = 0; s < LEAF; ++s) {
      const float4 m0 = RT_LDG(rec + 2 * s), m1 = RT_LDG(rec + 2 * s + 1);
      const int gs = RT_LDG(gid + s);
      if (counts) {
        counts[1] += s == 0 || gs != RT_LDG(gid);
        lane_tick(counts + 5);
      }
      leaf_min(sphere_cand<D::GUARD>(g, m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, tb), gs, cm,
               gm);
    }
  } else {
    const int c = leaf - p.n_sph_chunks;
    const float4* rec = reinterpret_cast<const float4*>(p.quad_leaf) + (size_t)c * (LEAF * 4);
    const int* gid = p.quad_gid + (size_t)c * LEAF;
    for (int s = 0; s < LEAF; ++s) {
      const float4 q0 = RT_LDG(rec + 4 * s), q1 = RT_LDG(rec + 4 * s + 1);
      const float4 q2 = RT_LDG(rec + 4 * s + 2), q3 = RT_LDG(rec + 4 * s + 3);
      const int gs = RT_LDG(gid + s);
      if (counts) {
        counts[2] += s == 0 || gs != RT_LDG(gid);
        lane_tick(counts + 5);
      }
      // q0 = nx ny nz D, q1 = wx wy wz qx, q2 = qy qz ux uy, q3 = uz vx vy vz
      leaf_min(quad_cand(g, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, q2.y, q2.z,
                         q2.w, q3.x, q3.y, q3.z, q3.w, tb),
               gs, cm, gm);
    }
  }
}

// Closest hit by the stackless walk. `nodes` is the node table as float4
// pairs (shared or global memory). With D::SPLIT the node loop runs box
// tests until the lane stands on a hit leaf or its walk ends, and the leaf
// loop after it tests that leaf; without, one loop tests one box and, when
// it is a hit leaf, its members. Either way a ray tests each hit leaf
// before its next box, so the two visit the same nodes and members. Adds
// to `counts` (N_COUNTS) when it is not null.
template <class D = K5Design>
RT_DEVICE void walk_hit(const GroupParams& p, const float4* nodes, const rt::Ray& r, float& t,
                        int& ib, long long* counts) {
  const RayGeom g = ray_geom(r);
  const float ivx = safe_inv(r.dx), ivy = safe_inv(r.dy), ivz = safe_inv(r.dz);
  float tb = BIG;
  int best = -1;
  int node = p.n_nodes > 0 ? 0 : -1;
  while (node >= 0) {
    int leaf = -1;
    do {
      // b0 = bminx bminy bminz bmaxx, b1 = bmaxy bmaxz miss leaf
      const float4 b0 = nodes[2 * node], b1 = nodes[2 * node + 1];
      const float t0x = (b0.x - r.ox) * ivx, t1x = (b0.w - r.ox) * ivx;
      const float t0y = (b0.y - r.oy) * ivy, t1y = (b1.x - r.oy) * ivy;
      const float t0z = (b0.z - r.oz) * ivz, t1z = (b1.y - r.oz) * ivz;
      const float enter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                fmaxf(fminf(t0z, t1z), T_MIN));
      const float exit_ = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                fminf(fmaxf(t0z, t1z), tb));
      const bool boxhit = enter < exit_;
      const int lf = (int)b1.w;
      if (counts) {
        ++counts[0];
        lane_tick(counts + 3);
      }
      if (boxhit && lf >= 0) leaf = lf;
      node = (boxhit && lf < 0) ? node + 1 : (int)b1.z;
    } while (D::SPLIT && leaf < 0 && node >= 0);
    if (leaf < 0) continue;
    float cm = BIG;
    int gm = NO_GID;
    leaf_hit<D>(p, g, leaf, tb, cm, gm, counts);
    if (cm < tb) {
      tb = cm;
      best = gm;
    }
  }
  t = tb;
  ib = best;
}

// Trace ray i through one phase; COUNT sums the walk's counts into
// p.counts.
template <bool BVH, bool NOISE, bool IMAGE, class D = K5Design, bool COUNT = false>
RT_DEVICE void trace_ray_group(const GroupParams& p, const float4* nodes, int i) {
  const int n = p.n;
  rt::Ray r = rt::load_ray(p.ray_f, p.ray_i, n, i);
  const rt::ShadeParams sp{p.table, p.P,    p.ns_pad, p.seed,  p.b_off, p.bg_r,
                           p.bg_g,  p.bg_b, p.perm,   p.grad, p.atlas, 0};
  long long c[N_COUNTS] = {0, 0, 0, 0, 0, 0, 0};
  int bounces = 0;
  for (int b = 0; b < p.max_depth && r.active; ++b) {
    ++bounces;
    float t;
    int ib;
    if (BVH)
      walk_hit<D>(p, nodes, r, t, ib, COUNT ? c : nullptr);
    else
      sweep_hit<D>(p, r, t, ib);
    r.active = rt::shade<NOISE, IMAGE, false>(r, t, ib, b, sp);
  }
  rt::store_ray(r, bounces, p.out_rad, p.out_bc, p.out_state, n, i);
#ifdef __CUDACC__
  if (COUNT)
    for (int k = 0; k < N_COUNTS; ++k)
      atomicAdd(reinterpret_cast<unsigned long long*>(p.counts + k), (unsigned long long)c[k]);
#endif
}

#ifdef __CUDACC__

constexpr int THREADS = 256;
// node tables up to this size are staged in shared memory (the default
// 48 KB of a block, so no opt-in is needed)
constexpr size_t NODE_SMEM_BYTES = 48 * 1024;

template <bool BVH, bool STAGED, bool NOISE, bool IMAGE, class D, bool COUNT>
__global__ void __launch_bounds__(THREADS) k5_trace_group(const GroupParams p) {
  extern __shared__ float4 s_nodes[];
  const float4* nodes = reinterpret_cast<const float4*>(p.nodes);
  if (STAGED) {
    for (int k = threadIdx.x; k < 2 * p.n_nodes; k += blockDim.x) s_nodes[k] = nodes[k];
    __syncthreads();
    nodes = s_nodes;
  }
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < p.n) trace_ray_group<BVH, NOISE, IMAGE, D, COUNT>(p, nodes, i);
}

template <bool BVH, bool STAGED, bool NOISE, bool IMAGE, class D = K5Design, bool COUNT = false>
cudaError_t launch(const GroupParams& p, size_t smem, cudaStream_t stream) {
  const dim3 grid((p.n + THREADS - 1) / THREADS);
  k5_trace_group<BVH, STAGED, NOISE, IMAGE, D, COUNT><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

size_t node_bytes(const GroupParams& p) { return (size_t)p.n_nodes * 8 * sizeof(float); }

// The instantiation for the search and the scene's textures.
template <bool NOISE, bool IMAGE>
cudaError_t launch_search(const GroupParams& p, bool use_bvh, cudaStream_t s) {
  if (!use_bvh) return launch<false, false, NOISE, IMAGE>(p, 0, s);
  if (node_bytes(p) <= NODE_SMEM_BYTES)
    return launch<true, true, NOISE, IMAGE>(p, node_bytes(p), s);
  return launch<true, false, NOISE, IMAGE>(p, 0, s);
}

// The probe's walk for design D: the timed or the counting instantiation.
template <class D>
cudaError_t launch_probe(const GroupParams& p, cudaStream_t s) {
  if (p.counts) return launch<true, true, false, false, D, true>(p, node_bytes(p), s);
  return launch<true, true, false, false, D, false>(p, node_bytes(p), s);
}

}  // namespace

#define RT_GROUP_PARAMS                                                                   \
  const float *table, int P, int ns_pad, const float *nodes, int n_nodes,                 \
      const float *sph_leaf, const int *sph_gid, int n_sph_chunks, const float *quad_leaf, \
      const int *quad_gid, const float *ray_f, const int *ray_i, int n, float *out_rad,    \
      int *out_bc, float *out_state, uint32_t seed, uint32_t b_off, int max_depth,         \
      float bg_r, float bg_g, float bg_b
#define RT_GROUP_INIT(perm, grad, atlas, counts)                                         \
  GroupParams{table,     P,         ns_pad, nodes, n_nodes,   sph_leaf, sph_gid,         \
              n_sph_chunks, quad_leaf, quad_gid, ray_f, ray_i, n,        out_rad,        \
              out_bc,    out_state, seed,   b_off, max_depth, bg_r,     bg_g,            \
              bg_b,      perm,      grad,   atlas, counts}

// C entry point (loaded with ctypes). Launches on `stream`, allocates
// nothing and does not synchronize. Returns a cudaError_t.
extern "C" int rt_trace_group(RT_GROUP_PARAMS, int use_bvh, int noise, int image,
                              const int* perm, const float* grad, const float* atlas,
                              void* stream) {
  if (n <= 0) return 0;
  const GroupParams p = RT_GROUP_INIT(perm, grad, atlas, nullptr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bvh = use_bvh != 0;
  if (noise) return (int)(image ? launch_search<true, true>(p, bvh, s)
                                : launch_search<true, false>(p, bvh, s));
  return (int)(image ? launch_search<false, true>(p, bvh, s)
                     : launch_search<false, false>(p, bvh, s));
}

// The measurement probe (tools/time_k5.py, chip_smoke.py; never a render):
// K5's walk on a scene without marble or image textures whose node table
// shared memory holds, by design (0 the baseline design, 1 K5Design), with
// the same outputs as rt_trace_group. With `counts` (N_COUNTS zeroed
// int64) it runs the counting instantiation. Returns a cudaError_t;
// cudaErrorInvalidValue for what it does not take.
extern "C" int rt_trace_group_probe(RT_GROUP_PARAMS, int design, long long* counts,
                                    void* stream) {
  if (n <= 0) return 0;
  const GroupParams p = RT_GROUP_INIT(nullptr, nullptr, nullptr, counts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (node_bytes(p) > NODE_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (design == 0) return (int)launch_probe<BaselineDesign>(p, s);
  if (design == 1) return (int)launch_probe<K5Design>(p, s);
  return (int)cudaErrorInvalidValue;
}

#else
}  // namespace
#endif
