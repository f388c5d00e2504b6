// The integrator's BVH walk, one thread a ray, in CUDA C++ for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel. It replaces the JAX walk's lax.while_loop
// (raytracing_tpu/ops/traverse.py:133-180 `_traverse`, the loop at :179)
// and the port's plain walk (ops/traverse.py `_traverse`), which steps
// every ray of the batch in lockstep: ~85 PyTorch kernels an iteration and
// a host read every few iterations to learn whether any ray still walks,
// which no captured CUDA graph can hold. A ray's (node, t_best, best_prim)
// changes only from its own inputs and the shared BVH, and once its node
// is -1 further iterations change nothing for it, so one thread walks its
// ray from node 0 until its node is -1: it visits the lockstep walk's
// nodes in the same order and writes its winner and t bit for bit, ties
// included. One launch a bounce, no host read.
//
// The walk of the skip-link BVH (ops/bvh.py): at node ni, the slab test of
// its box against (t_min, t_best) (enter clamped below by t_min, exit above
// by t_best, hit iff enter < exit); on a hit leaf the primitive's candidate
// (a sphere for ids below n_sph, else a quad) clipped to (t_min, t_best)
// replaces the best when strictly nearer; a hit inner node descends to
// ni + 1, anything else follows miss[ni]. Node indices only grow along a
// walk (ni + 1, or a skip link past the subtree), so a walk visits at most
// n_nodes nodes; the loop is capped there, which a well-formed BVH never
// reaches.
//
// Arithmetic: the plain version's, op for op (ops/traverse.py _slab_test,
// _sphere_t, _quad_t), built with -fmad=false and without fast math so the
// card rounds as PyTorch does: three-term dot products add (x + y) + z;
// the centre moves by time * velocity only when the scene has moving
// spheres; the root's sqrt is sqrtf of a positive discriminant, else 0
// (ops/intersect.safe_sqrt_rn; sqrtf rounds correctly without fast math);
// divisions are IEEE divisions; a direction component below 1e-20 in
// magnitude is clamped to +-1e-20 before its reciprocal; the quad's alpha
// and beta sum their three products in the order of traverse.py:92-94; the
// root, slab and interval tests are strict or closed as written there.
// torch.minimum, maximum, amax, amin and clamp propagate NaN and CUDA's
// fminf/fmaxf do not, so the slab test takes its own NaN-propagating
// min/max (minp/maxp): a ray with a NaN component then misses every box,
// as in the plain version.
//
// What bounds it: operations. A ray reads o, d and time (28 bytes) and
// writes t and best_prim (12 bytes); the nodes, links and primitives are
// small (bouncing_spheres' 975 nodes are 31 KB, its 488 spheres 16 KB)
// and stay in the L1/L2 caches, read through the read-only path (__ldg).
// Per visit ~27 FP32 operations (6 sub, 6 mul, 6 min/max a pair, 4 to
// reduce, 2 clamps, the test), per sphere test ~40, per quad test ~62: at
// bouncing_spheres' camera launch that is far more than the bytes. What
// the design does about it: nothing yet beyond one ray a thread (a warp's
// lanes diverge where their walks do). Staging the nodes in shared memory
// and packing them as float4s (as K5 does) is later work.

#include "rt_common.cuh"

namespace {

constexpr int WALK_THREADS = 128;
constexpr float DIR_EPS = 1e-20f;       // ops/traverse.py _DIR_EPS
constexpr float PARALLEL_EPS = 1e-8f;   // ops/intersect.py PARALLEL_EPS

struct WalkScene {
  const float* bmin;   // (K, 3)
  const float* bmax;   // (K, 3)
  const int* prim;     // (K,) leaf primitive id or -1
  const int* miss;     // (K,) skip link or -1
  int n_nodes;
  const float* sph_c;  // (N, 3) centre at time 0
  const float* sph_v;  // (N, 3) velocity
  const float* sph_r;  // (N,)
  int n_sph;
  const float* q_n;    // (M, 3) unit normal (quad_plane_basis)
  const float* q_dc;   // (M,) plane constant
  const float* q_w;    // (M, 3) n / (n . n)
  const unsigned char* q_degen;  // (M,) bool
  const float* q_q;    // (M, 3)
  const float* q_u;    // (M, 3)
  const float* q_v;    // (M, 3)
  float t_min, t_max;
  int moving;
};

// torch.minimum / torch.maximum: NaN when either is NaN.
RT_DEVICE float minp(float a, float b) { return (a < b || a != a) ? a : b; }
RT_DEVICE float maxp(float a, float b) { return (a > b || a != a) ? a : b; }

RT_DEVICE float clamp_dir(float v) {
  return fabsf(v) < DIR_EPS ? (v < 0.0f ? -DIR_EPS : DIR_EPS) : v;
}

// The sphere's candidate t in (t_lo, t_hi): true and t on a hit
// (traverse.py _sphere_t).
RT_DEVICE bool sphere_t(const WalkScene& s, int sid, float ox, float oy, float oz, float dx,
                        float dy, float dz, float a, float tm, float t_lo, float t_hi,
                        float& t) {
  float cx = RT_LDG(s.sph_c + 3 * sid), cy = RT_LDG(s.sph_c + 3 * sid + 1);
  float cz = RT_LDG(s.sph_c + 3 * sid + 2);
  if (s.moving) {
    cx = cx + tm * RT_LDG(s.sph_v + 3 * sid);
    cy = cy + tm * RT_LDG(s.sph_v + 3 * sid + 1);
    cz = cz + tm * RT_LDG(s.sph_v + 3 * sid + 2);
  }
  const float r = RT_LDG(s.sph_r + sid);
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  const float half_b = (ocx * dx + ocy * dy) + ocz * dz;
  const float cq = ((ocx * ocx + ocy * ocy) + ocz * ocz) - r * r;
  const float disc = half_b * half_b - a * cq;
  const float sqrtd = disc > 0.0f ? sqrtf(disc) : 0.0f;
  const float root0 = (-half_b - sqrtd) / a;
  const float root1 = (-half_b + sqrtd) / a;
  const bool ok0 = t_lo < root0 && root0 < t_hi;
  const bool ok1 = t_lo < root1 && root1 < t_hi;
  t = ok0 ? root0 : root1;
  return disc >= 0.0f && (ok0 || ok1) && r > 0.0f;
}

// The quad's candidate t in (t_lo, t_hi): true and t on a hit
// (traverse.py _quad_t).
RT_DEVICE bool quad_t(const WalkScene& s, int qid, float ox, float oy, float oz, float dx,
                      float dy, float dz, float t_lo, float t_hi, float& t) {
  const float* n = s.q_n + 3 * qid;
  const float* w = s.q_w + 3 * qid;
  const float* q = s.q_q + 3 * qid;
  const float* u = s.q_u + 3 * qid;
  const float* v = s.q_v + 3 * qid;
  const float nx = RT_LDG(n), ny = RT_LDG(n + 1), nz = RT_LDG(n + 2);
  const float denom = (nx * dx + ny * dy) + nz * dz;
  const bool parallel = fabsf(denom) < PARALLEL_EPS;
  const float safe_denom = parallel ? 1.0f : denom;
  const float n_dot_o = (nx * ox + ny * oy) + nz * oz;
  t = (RT_LDG(s.q_dc + qid) - n_dot_o) / safe_denom;
  const float px = (ox + t * dx) - RT_LDG(q), py = (oy + t * dy) - RT_LDG(q + 1);
  const float pz = (oz + t * dz) - RT_LDG(q + 2);
  const float ux = RT_LDG(u), uy = RT_LDG(u + 1), uz = RT_LDG(u + 2);
  const float vx = RT_LDG(v), vy = RT_LDG(v + 1), vz = RT_LDG(v + 2);
  const float wx = RT_LDG(w), wy = RT_LDG(w + 1), wz = RT_LDG(w + 2);
  const float alpha =
      (wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz)) + wz * (px * vy - py * vx);
  const float beta =
      (wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz)) + wz * (ux * py - uy * px);
  return fabsf(denom) >= PARALLEL_EPS && !RT_LDG(s.q_degen + qid) && t_lo < t && t < t_hi &&
         0.0f <= alpha && alpha <= 1.0f && 0.0f <= beta && beta <= 1.0f;
}

// One ray's walk: its winner (-1 on a miss) and t (t_max on a miss). With
// COUNT, counts[0], [1], [2] receive its node visits (slab tests), sphere
// tests and quad tests.
template <bool COUNT>
RT_DEVICE void walk_ray(const WalkScene& s, float ox, float oy, float oz, float dx, float dy,
                        float dz, float tm, float& t_out, long long& prim_out,
                        long long* counts) {
  const float ivx = 1.0f / clamp_dir(dx), ivy = 1.0f / clamp_dir(dy);
  const float ivz = 1.0f / clamp_dir(dz);
  const float a = (dx * dx + dy * dy) + dz * dz;
  float t_best = s.t_max;
  int best = -1;
  int node = s.n_nodes > 0 ? 0 : -1;
  for (int it = 0; node >= 0 && it < s.n_nodes; ++it) {
    const float* lo = s.bmin + 3 * node;
    const float* hi = s.bmax + 3 * node;
    const float t0x = (RT_LDG(lo) - ox) * ivx, t1x = (RT_LDG(hi) - ox) * ivx;
    const float t0y = (RT_LDG(lo + 1) - oy) * ivy, t1y = (RT_LDG(hi + 1) - oy) * ivy;
    const float t0z = (RT_LDG(lo + 2) - oz) * ivz, t1z = (RT_LDG(hi + 2) - oz) * ivz;
    const float enter =
        maxp(maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)), minp(t0z, t1z)), s.t_min);
    const float exit_ =
        minp(minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)), maxp(t0z, t1z)), t_best);
    const bool box_hit = enter < exit_;
    const int prim = RT_LDG(s.prim + node);
    if (COUNT) ++counts[0];
    if (box_hit && prim >= 0) {
      float t;
      bool hit;
      if (prim < s.n_sph) {
        hit = sphere_t(s, prim, ox, oy, oz, dx, dy, dz, a, tm, s.t_min, t_best, t);
        if (COUNT) ++counts[1];
      } else {
        hit = quad_t(s, prim - s.n_sph, ox, oy, oz, dx, dy, dz, s.t_min, t_best, t);
        if (COUNT) ++counts[2];
      }
      if (hit && t < t_best) {
        t_best = t;
        best = prim;
      }
    }
    node = (box_hit && prim < 0) ? node + 1 : RT_LDG(s.miss + node);
  }
  t_out = t_best;
  prim_out = best;
}

}  // namespace

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(WALK_THREADS)
    bvh_walk(const WalkScene s, const float* __restrict__ o, const float* __restrict__ d,
             const float* __restrict__ time, int B, long long* __restrict__ best_prim,
             float* __restrict__ t_best) {
  const int i = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (i >= B) return;
  float t;
  long long prim;
  walk_ray<false>(s, __ldg(o + 3 * i), __ldg(o + 3 * i + 1), __ldg(o + 3 * i + 2),
                  __ldg(d + 3 * i), __ldg(d + 3 * i + 1), __ldg(d + 3 * i + 2), __ldg(time + i),
                  t, prim, nullptr);
  t_best[i] = t;
  best_prim[i] = prim;
}

}  // namespace

// The closest hit of each of B rays o, d (B, 3) at times (B,): best_prim
// (B,) int64 (-1 on a miss) and t_best (B,) f32 (t_max on a miss). The
// quad arrays are quad_plane_basis(quads) (normal, plane constant, w,
// degenerate) and the quads' q, u, v.
extern "C" int rt_bvh_walk(const float* o, const float* d, const float* time, int B,
                           const float* bmin, const float* bmax, const int* prim,
                           const int* miss, int n_nodes, const float* sph_c, const float* sph_v,
                           const float* sph_r, int n_sph, const float* q_n, const float* q_dc,
                           const float* q_w, const unsigned char* q_degen, const float* q_q,
                           const float* q_u, const float* q_v, float t_min, float t_max,
                           int moving, long long* best_prim, float* t_best, void* stream) {
  if (B <= 0) return 0;
  const WalkScene s{bmin, bmax, prim, miss, n_nodes, sph_c, sph_v, sph_r, n_sph,
                    q_n, q_dc, q_w, q_degen, q_q, q_u, q_v, t_min, t_max, moving};
  const dim3 grid((B + WALK_THREADS - 1) / WALK_THREADS);
  bvh_walk<<<grid, WALK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(s, o, d, time, B,
                                                                          best_prim, t_best);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
