// K1, the block megakernel, in CUDA C++ for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel raytracing_tpu/ops/megakernel_block.py
// make_megakernel_block (pallas_call in its `run`). It traces one phase of
// up to max_depth bounces for every ray: closest hit over all sphere rows
// (moving center at ray time, roots in a*t space, strict < so the lowest
// index wins ties) and then all quad rows; the winner's fields from the
// (F, P) unified table; solid, checker, 7-octave marble or nearest-texel
// image albedo; lambertian, metal, dielectric or light; PCG4D keyed on
// (pix, smp, (b + b_off)*4 + 2, seed). In the depth-cap mode of the
// regenerating pool (render/pool.py) every ray carries its own depth dep:
// its counter is (b + b_off + dep)*4 + 2, and it dies once dep + b + 1
// reaches depth_cap.
//
// The closest hit comes from one of two searches with one result, bit for
// bit (the WALK template switch; the wrapper walks scenes of at least
// CULL_MIN_PRIMS primitives):
// * the sweep: every sphere row, then every quad row;
// * the walk: a stackless preorder walk of the chunked BVH (ops/mega_bvh.py,
//   the nodes K5 walks, with boxes padded for this arithmetic) that tests
//   the rows of a hit leaf with the sweep's own arithmetic and tie rule.
//   The pads hold for rays that start within a ball around the scene
//   (mega_bvh.cull_ball); a ray from outside widens each box it meets by
//   its own rounding band, so the result is the sweep's for every ray.
//
// What bounds it: FP32 ALU work in the search, about 27 operations per
// sphere row tested (13 mul, 11 add/sub, a sqrt, 3 compares and selects).
// The bench workload (bouncing_spheres, 400x225, 100 spp, depth 20) traces
// about 24.3M segments against 496 sphere rows: the sweep does 24.3e6 * 496
// * 27 ~ 3.3e11 operations; the walk visits some tens of nodes and tests a
// few dozen rows a segment. Memory traffic is small: 56 B of ray state in
// and out per ray per phase, plus 17 divergent 4-byte reads per hit. A
// marble hit adds about 1,000 operations and 336 table reads (7 octaves x
// 8 corners x 6 reads), an image hit two atan2f and 3 texel reads.
//
// What the design does about it:
// * one thread traces one ray through the whole phase with its state in
//   registers, so nothing but the phase's inputs and outputs touches
//   device memory;
// * a render's first phase starts from the camera (TraceParams::camera):
//   each thread computes its ray from its (pix, smp) ids with
//   rt::camera_ray (rt_camera.cuh), bit-equal to the rays the trace glue
//   built before, so no camera ray crosses device memory. It is a runtime
//   branch at the load, not a template switch: no instantiation is added.
//   The start goes through the thread's own 56-byte stack slot and is
//   loaded back as a ray_f start is, so the bounce loop keeps its
//   registers (MIN_BLOCKS holds the one instantiation that did not):
//   computed into the loop's registers directly, the start raised 14 of
//   the 32 instantiations by up to 8 registers and gave one a spill;
// * the guarded root: a sphere whose discriminant is negative (most rows
//   of a sweep) never reaches sqrtf. Without fast math sqrtf is the
//   correctly rounded sequence MUFU.RSQ + Newton step, which calls a
//   22-instruction slow-path subroutine for any input that is not a
//   positive normal number, a negative one included. In the SASS of the
//   bench instantiation (tools/k1_sass.py, sm_90a) the sweep's loop took
//   192 instructions per 4 unrolled rows (48 a row) and called the slow
//   path on every miss; with the guard it is 210 (52.5 a row), and a miss
//   branches past the root's 16-17 instructions (~36 a row), with no call;
// * the walk reads the nodes from shared memory (staged per block up to
//   NODE_SMEM_BYTES) and the sweep rows of a hit leaf from global memory
//   through the read-only cache, so a large scene keeps its occupancy and
//   has no shared-memory limit;
// * the sweep stages its real rows (15.5 KB at the bench size; the
//   tables' pad rows never win, so it skips them) once per block
//   into shared memory; all threads of a warp read the same row at the
//   same moment, which shared memory serves as a broadcast;
// * the winner's fields are per-ray divergent reads, served from global
//   memory through the read-only cache (__ldg), and so are image texels;
// * a noise scene also stages the 6 KB of Perlin tables in shared memory;
// * marble, image, the depth cap, the walk and participating media are
//   template switches (as motion is), so a scene without them runs the
//   code it would run without them existing, with the same registers;
// * media (MEDIUM; The Next Week's constant_medium) are tested against
//   every ray, beside the surfaces: at most MAX_MEDIA spheres, each with both
//   roots (the entry clamped to T_MIN, the exit to the closest hit), one
//   PCG4D draw a bounce for all of them (lane k, medium k, stream
//   STREAM_MEDIUM) and the free path -ln(u)/density with the log in
//   double, rounded to float, so that the card, the host and PyTorch agree
//   on it. A fog around the whole scene would hold every node of the BVH,
//   so media stay out of it. The media's scatter point is found before the
//   walk, which then culls every box beyond it: a ray random-walking in a
//   dense medium visits only the nodes around its short free path. Each
//   thread counts the bounces media win, and a warp adds its sum to one
//   device counter once, at its end;
// * a ray leaves the bounce loop as soon as it dies; the renderer compacts
//   live rays to the front between phases so warps stay full.
//
// Parity: the build uses -fmad=false and no fast math, so every multiply
// and add rounds on its own as in the JAX reference and the plain PyTorch
// version (ops/megakernel_block.py trace_block_torch, the sweep over
// every row). A rejected sphere is a miss, as its NaN root was before the
// guard; pad sphere rows carry r^2 = -1e30. A miss stays exactly BIG.
//
// Layout: ray_f is (14, n) f32 with rows ox oy oz dx dy dz tm tr tg tb
// rr rg rb act; ray_i is (2, n) i32 with rows pix smp. Outputs: rad
// (3, n) f32, bounces (n,) i32, optionally the new (14, n) state and,
// with want_ids, ids (max_depth, n) i32: the global scene id of the
// winner at each bounce (kid_map of the kernel primitive index), -1 on a
// miss and on every bounce after the ray died. Bounce-major rows make a
// warp's stores of one bounce coalesce.
//
// The shading after the hit is shared with K5 (rt_shade.cuh). The per-ray
// math also compiles as plain C++ (without __CUDACC__), so its arithmetic
// can be exercised on a host.

#include "rt_camera.cuh"
#include "rt_shade.cuh"

#if defined(__CUDACC__) && !defined(RT_K1_MEDIUM_UNIT)
// megakernel_medium.cu: the MEDIUM instantiations' launches
extern "C" int rt_k1_launch_medium(const void* params, int moving, int noise, int image,
                                   int walk, void* stream);
#endif

namespace {

using rt::BIG;
using rt::T_MIN;

// Walk: a relative margin on the cull bound. The best hit t is within
// about sqrt(15 * 2^-24) ~ 1e-3 of the point where the ray really passes
// its primitive (a grazing root: the discriminant's rounding error, of
// order eps * half_b^2, enters t through its square root); a box whose
// entry lies beyond t * (1 + 2^-6) can hold no hit the sweep would take.
constexpr float CULL_MARGIN = 1.0f + 1.0f / 64.0f;
// A wide ray's band (walk_hit): 2^-10 of the distance, and 2^-19 of the
// origin's and the distance's coordinates.
constexpr float WIDE_ROOT = 1.0f / 1024.0f;
constexpr float WIDE_COORD = 1.0f / 524288.0f;
// media a scene may hold: one PCG4D draw has a lane for each (scene/builder.py)
constexpr int MAX_MEDIA = 4;

struct TraceParams {
  const float* sph;      // sphere rows (8 floats): cx cy cz vx vy vz r2 0
  int n_sph_rows;        // the rows the sweep tests (the wrapper passes the real ones)
  const float* quad;     // quad rows (16 floats): nx ny nz D qx qy qz wx wy wz ux uy uz vx vy vz
  int n_quad_rows;
  const float* table;    // (26, n_res_cols) unified-table rows
  int n_res_cols;
  const float* ray_f;    // (N_F, n)
  const int* ray_i;      // (2, n)
  int n;
  float* out_rad;        // (3, n)
  int* out_bc;           // (n,)
  float* out_state;      // (N_F, n) or null
  const int* kid_map;    // (n_res_cols,) kernel primitive -> global scene id
  int* out_ids;          // (max_depth, n) or null
  uint32_t seed;
  uint32_t b_off;
  int max_depth;
  int ns_pad;            // first quad column of the table
  float bg_r, bg_g, bg_b;
  const int* perm;       // (3, 256) marble permutations
  const float* grad;     // (256, 3) marble gradients
  const float* atlas;    // (T, 3) image texels
  const int* dep;        // (n,) segments before this launch, or null (no depth cap)
  int depth_cap;
  const float* nodes;    // walk: (n_nodes, 8) BVH nodes with padded boxes
  int n_nodes;
  const int* sph_gid;    // walk: (n_sph_chunks, 8) sphere rows of each chunk
  int n_sph_chunks;
  const int* quad_gid;   // walk: (n_quad_chunks, 8) unified columns of each quad chunk
  float ball_x, ball_y, ball_z, ball_r2;  // walk: origins the padded boxes hold for
  float band_k;          // walk: a wide ray's sphere band over |box far point|^2
  const float* camera;   // (rt::CAMERA_F,) packed camera, or null: the lanes start from ray_f
  const unsigned char* alive;  // camera start: (n,) flags of the lanes that start alive, or null
  uint32_t cam_width;    // camera start: the image width
  int cam_flags;         // camera start: rt::CAMERA_DEFOCUS | rt::CAMERA_MOTION
  int n_media;           // MEDIUM: media (at most MAX_MEDIA)
  const float* media;    // MEDIUM: (n_media, 8) cx cy cz r2 -1/density ar ag ab
  unsigned long long* medium_scatters;  // MEDIUM: the launch's medium bounces are added here
};

// One segment's ray, with the terms both searches share.
struct HitRay {
  float ox, oy, oz, dx, dy, dz, tm;
  float a, inv_a, ta;  // |d|^2, its inverse, and T_MIN in a*t space
};

RT_DEVICE HitRay hit_ray(const rt::Ray& r) {
  const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  return HitRay{r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tm, a, 1.0f / a, T_MIN * a};
}

// A sphere row's root in a*t space: the nearer root when it lies above
// ta, else the farther one; -1 (below every ta) when the discriminant is
// negative or NaN. The guard keeps a miss away from sqrtf, whose
// correctly rounded sequence branches to a slow path for any input that
// is not a positive normal number. Every disc >= 0 gets the root it got
// without the guard, and a rejected row is a miss as its NaN root was.
template <bool MOVING>
RT_DEVICE float sphere_s(const HitRay& g, const float4 c0, const float4 c1) {
  float ocx, ocy, ocz;
  if (MOVING) {
    ocx = (g.ox - c0.x) - g.tm * c0.w;
    ocy = (g.oy - c0.y) - g.tm * c1.x;
    ocz = (g.oz - c0.z) - g.tm * c1.y;
  } else {
    ocx = g.ox - c0.x;
    ocy = g.oy - c0.y;
    ocz = g.oz - c0.z;
  }
  const float half_b = ocx * g.dx + ocy * g.dy + ocz * g.dz;
  const float cq = ocx * ocx + ocy * ocy + (ocz * ocz - c1.z);
  const float disc = half_b * half_b - g.a * cq;
  if (!(disc >= 0.0f)) return -1.0f;
  const float sq = sqrtf(disc);
  const float nhb = -half_b;
  const float s0 = nhb - sq;
  return s0 > g.ta ? s0 : nhb + sq;
}

// A quad row's plane hit in t space, when it lies above T_MIN inside the
// quad's edges: true and tq, else false.
RT_DEVICE bool quad_t(const HitRay& g, const float4 q0, const float4 q1, const float4 q2,
                      const float4 q3, float& tq) {
  // q0 = nx ny nz D, q1 = qx qy qz wx, q2 = wy wz ux uy, q3 = uz vx vy vz
  const float denom = q0.x * g.dx + q0.y * g.dy + q0.z * g.dz;
  const float safe = fabsf(denom) < 1e-8f ? 1.0f : denom;
  tq = (q0.w - (q0.x * g.ox + q0.y * g.oy + q0.z * g.oz)) / safe;
  const float px = g.ox + tq * g.dx - q1.x;
  const float py = g.oy + tq * g.dy - q1.y;
  const float pz = g.oz + tq * g.dz - q1.z;
  const float wx = q1.w, wy = q2.x, wz = q2.y;
  const float ux = q2.z, uy = q2.w, uz = q3.x;
  const float vx = q3.y, vy = q3.z, vz = q3.w;
  const float alpha = wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz)
                      + wz * (px * vy - py * vx);
  const float beta = wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz)
                     + wz * (ux * py - uy * px);
  return fabsf(denom) >= 1e-8f && tq > T_MIN && alpha >= 0.0f && alpha <= 1.0f &&
         beta >= 0.0f && beta <= 1.0f;
}

// The sweep: every sphere row (strict <, so the lowest row wins ties),
// then every quad row against the sphere winner's t. t = BIG and ib = -1
// on a miss. sph/quad are the staged tables.
template <bool MOVING>
RT_DEVICE void sweep_hit(const TraceParams& p, const float4* sph, const float4* quad,
                         const HitRay& g, float& t, int& ib) {
  float sb = BIG;
  ib = -1;
#pragma unroll 4
  for (int j = 0; j < p.n_sph_rows; ++j) {
    const float s = sphere_s<MOVING>(g, sph[2 * j], sph[2 * j + 1]);
    if (s > g.ta && s < sb) {
      sb = s;
      ib = j;
    }
  }
  t = ib >= 0 ? sb * g.inv_a : BIG;
  for (int j = 0; j < p.n_quad_rows; ++j) {
    float tq;
    if (quad_t(g, quad[4 * j], quad[4 * j + 1], quad[4 * j + 2], quad[4 * j + 3], tq) &&
        tq < t) {
      t = tq;
      ib = j + p.ns_pad;
    }
  }
}

RT_DEVICE float safe_inv(float v) {
  return (v < 0.0f ? -1.0f : 1.0f) / fmaxf(fabsf(v), 1e-20f);
}

// The walk: the same winner as sweep_hit, from the chunked BVH
// (ops/mega_bvh.py: preorder nodes with skip links, sphere chunks first).
// A node is entered when its box meets the ray between T_MIN and the cull
// bound: the best hit so far times CULL_MARGIN. The boxes are padded in
// the build (mega_bvh.cull_nodes) so that every ray the sweep's rounding
// lets hit a primitive passes through each box holding it, for a ray that
// starts inside the ball mega_bvh.cull_ball gives (within 448 radii of
// every sphere). A ray from outside it (one that bounces inside the
// bench's r = 1000 ground, or starts far out) is "wide": each box it meets
// is widened by its own band, the smaller of two bounds on how far
// outside a sphere of radius >= r_min the rounded discriminant can accept
// a ray from distance F (F the box's farthest point, |oc| <= F):
// 16 * 2^-25 * F^2 / r_min and sqrt(16 * 2^-24) * F = 2^-10 * F; plus
// 2^-19 * (|o| + F) for a quad's hit point and the slab test. A hit leaf
// tests its members with the sweep's own arithmetic, sphere rows in a*t
// space and quad rows in t space, read through the read-only cache.
// Leaves come in preorder, not row order, so ties go to the lower row
// explicitly; spheres and quads keep separate bests, and a quad wins only
// when strictly nearer than the sphere winner, as in the sweep. `nodes` is
// the staged or the global node table. Adds the nodes visited, the sphere
// and quad rows tested and the wide rays to `counts` when it is not null.
// With LIMIT the bound starts from `limit` (a medium's scatter point), so
// the walk finds the winner wherever it lies below `limit` and may return
// any hit, or none, where it does not.
template <bool MOVING, bool LIMIT = false>
RT_DEVICE void walk_hit(const TraceParams& p, const float4* nodes, const HitRay& g, float& t,
                        int& ib, long long* counts, float limit = BIG) {
  const float4* sph = reinterpret_cast<const float4*>(p.sph);
  const float4* quad = reinterpret_cast<const float4*>(p.quad);
  const float ivx = safe_inv(g.dx), ivy = safe_inv(g.dy), ivz = safe_inv(g.dz);
  const float ex = g.ox - p.ball_x, ey = g.oy - p.ball_y, ez = g.oz - p.ball_z;
  const bool wide = !(ex * ex + ey * ey + ez * ez <= p.ball_r2);
  const float o1 = fabsf(g.ox) + fabsf(g.oy) + fabsf(g.oz);
  if (counts && wide) ++counts[3];
  float sb = BIG;  // sphere best, a*t space
  int is = -1;
  float tq = BIG;  // quad best, t space
  int iq = -1;
  float bound = LIMIT ? limit * CULL_MARGIN : BIG;
  int node = p.n_nodes > 0 ? 0 : -1;
  while (node >= 0) {
    // b0 = bminx bminy bminz bmaxx, b1 = bmaxy bmaxz miss leaf
    const float4 b0 = nodes[2 * node], b1 = nodes[2 * node + 1];
    float lx = b0.x - g.ox, hx = b0.w - g.ox;
    float ly = b0.y - g.oy, hy = b1.x - g.oy;
    float lz = b0.z - g.oz, hz = b1.y - g.oz;
    if (wide) {
      const float fx = fmaxf(fabsf(lx), fabsf(hx)), fy = fmaxf(fabsf(ly), fabsf(hy)),
                  fz = fmaxf(fabsf(lz), fabsf(hz));
      const float f1 = fx + fy + fz;  // >= the distance to the box's farthest point
      const float w = fminf((fx * fx + fy * fy + fz * fz) * p.band_k, f1 * WIDE_ROOT) +
                      (o1 + f1) * WIDE_COORD;
      lx -= w, ly -= w, lz -= w;
      hx += w, hy += w, hz += w;
    }
    const float t0x = lx * ivx, t1x = hx * ivx;
    const float t0y = ly * ivy, t1y = hy * ivy;
    const float t0z = lz * ivz, t1z = hz * ivz;
    const float enter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                              fmaxf(fminf(t0z, t1z), T_MIN));
    const float exit_ = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                              fminf(fmaxf(t0z, t1z), bound));
    const bool boxhit = enter < exit_;
    const int leaf = (int)b1.w;
    if (counts) ++counts[0];
    node = (boxhit && leaf < 0) ? node + 1 : (int)b1.z;
    if (!boxhit || leaf < 0) continue;
    if (leaf < p.n_sph_chunks) {
      const int* gid = p.sph_gid + (size_t)leaf * 8;
      const int g0 = RT_LDG(gid);
      for (int m = 0; m < 8; ++m) {
        const int j = m == 0 ? g0 : RT_LDG(gid + m);
        if (m > 0 && j == g0) break;  // a short chunk's pad slots repeat its first row
        const float s = sphere_s<MOVING>(g, RT_LDG(sph + 2 * j), RT_LDG(sph + 2 * j + 1));
        if (s > g.ta && (s < sb || (s == sb && j < is))) {
          sb = s;
          is = j;
        }
        if (counts) ++counts[1];
      }
    } else {
      const int* gid = p.quad_gid + (size_t)(leaf - p.n_sph_chunks) * 8;
      const int g0 = RT_LDG(gid);
      for (int m = 0; m < 8; ++m) {
        const int c = m == 0 ? g0 : RT_LDG(gid + m);
        if (m > 0 && c == g0) break;
        const int j = c - p.ns_pad;
        float tc;
        if (quad_t(g, RT_LDG(quad + 4 * j), RT_LDG(quad + 4 * j + 1), RT_LDG(quad + 4 * j + 2),
                   RT_LDG(quad + 4 * j + 3), tc) &&
            (tc < tq || (tc == tq && j < iq))) {
          tq = tc;
          iq = j;
        }
        if (counts) ++counts[2];
      }
    }
    if (LIMIT)
      bound = fminf(fminf(is >= 0 ? sb * g.inv_a : BIG, tq), limit) * CULL_MARGIN;
    else
      bound = fminf(is >= 0 ? sb * g.inv_a : BIG, tq) * CULL_MARGIN;
  }
  t = is >= 0 ? sb * g.inv_a : BIG;
  ib = is;
  if (iq >= 0 && tq < t) {
    t = tq;
    ib = iq + p.ns_pad;
  }
}

// The media's scatter point, before the surfaces are searched: medium k
// offers t1 + free / |d| (its entry t1 clamped to T_MIN, its free path
// -ln(u)/density, u lane k of the bounce's STREAM_MEDIUM draw) where that
// lies below its exit; tm and im = -2 - k are the nearest offer (the
// lowest k among equal ones), BIG and -1 where none. The medium wins the
// bounce when tm lies below the surfaces' closest hit, which is the plain
// version's order (ops/megakernel_block.py _media_hit: surfaces, then
// each medium with its exit clamped to the hit so far) with the same
// result, and lets the walk stop at tm. Boundary roots as a sphere's, in
// a*t space. The draw is made once, for the first medium the ray crosses.
RT_DEVICE void media_first(const TraceParams& p, const HitRay& g, const rt::Ray& r, int b,
                           float& tm, int& im) {
  const float4* media = reinterpret_cast<const float4*>(p.media);
  uint32_t w0 = r.pix, w1 = r.smp, w3 = p.seed;
  uint32_t w2 = ((uint32_t)b + p.b_off) * rt::N_STREAMS + rt::STREAM_MEDIUM;
  bool drawn = false;
  tm = BIG;
  im = -1;
#pragma unroll
  for (int k = 0; k < MAX_MEDIA; ++k) {
    if (k >= p.n_media) break;
    const float4 m0 = RT_LDG(media + 2 * k);  // cx cy cz r2
    const float ocx = g.ox - m0.x, ocy = g.oy - m0.y, ocz = g.oz - m0.z;
    const float half_b = ocx * g.dx + ocy * g.dy + ocz * g.dz;
    const float cq = ocx * ocx + ocy * ocy + (ocz * ocz - m0.w);
    const float disc = half_b * half_b - g.a * cq;
    if (!(disc >= 0.0f)) continue;
    const float sq = sqrtf(disc);
    const float nhb = -half_b;
    const float t1 = fmaxf((nhb - sq) * g.inv_a, T_MIN);
    const float t2 = (nhb + sq) * g.inv_a;
    if (!(t1 < t2)) continue;
    if (!drawn) {
      rt::pcg4d(w0, w1, w2, w3);
      drawn = true;
    }
    const uint32_t w = k == 0 ? w0 : (k == 1 ? w1 : (k == 2 ? w2 : w3));
    const float free = RT_LDG(p.media + 8 * k + 4) * (float)log((double)rt::u01(w));
    const float tk = t1 + free / sqrtf(g.a);
    if (tk < t2 && tk < tm) {
      tm = tk;
      im = -2 - k;
    }
  }
}

// Lane i's start state from the camera (TraceParams::camera) in ray_f's
// row order: the camera ray of its (pix, smp) ids, unit throughput, zero
// radiance, alive unless its alive flag is 0, as ops/megakernel_block.py
// pack_rays packs generate_rays' rays.
RT_DEVICE void camera_state(const TraceParams& p, int i, float* st) {
  const rt::CameraRay c = rt::camera_ray((uint32_t)p.ray_i[i], (uint32_t)p.ray_i[p.n + i],
                                         p.seed, p.camera, p.cam_width, p.cam_flags);
  st[rt::OX] = c.ox;
  st[rt::OY] = c.oy;
  st[rt::OZ] = c.oz;
  st[rt::DX] = c.dx;
  st[rt::DY] = c.dy;
  st[rt::DZ] = c.dz;
  st[rt::TM] = c.tm;
  st[rt::TR] = st[rt::TG] = st[rt::TB] = 1.0f;
  st[rt::RR] = st[rt::RG] = st[rt::RB] = 0.0f;
  st[rt::ACT] = (!p.alive || p.alive[i] != 0) ? 1.0f : 0.0f;
}

// Trace ray i through one phase. The sweep reads the staged sweep tables
// sph/quad (float4 rows: 2 per sphere, 4 per quad), the walk the node
// table `nodes`; perm/grad point at the noise tables. Returns the bounces
// a medium won (0 without MEDIUM).
template <bool MOVING, bool NOISE, bool IMAGE, bool CAP, bool WALK, bool MEDIUM = false>
RT_DEVICE int trace_ray(const TraceParams& p, const float4* sph, const float4* quad,
                        const float4* nodes, const int* perm, const float* grad, int i) {
  const int n = p.n;
  // a camera start goes through the thread's stack and is loaded back as
  // a ray_f start is (see the note at the top)
  float start[rt::N_F];
  const float* rf = p.ray_f;
  int stride = n, at = i;
  if (p.camera) {
    camera_state(p, i, start);
    rf = start;
    stride = 1;
    at = 0;
  }
  rt::Ray r = rt::load_ray(rf, stride, at, p.ray_i, n, i);
  if (CAP) r.dep = p.dep[i];
  const rt::ShadeParams sp{p.table,   p.n_res_cols, p.ns_pad, p.seed, p.b_off, p.bg_r, p.bg_g,
                           p.bg_b,    perm,         grad,     p.atlas, p.depth_cap};
  int bounces = 0, scatters = 0;

  for (int b = 0; b < p.max_depth && r.active; ++b) {
    ++bounces;
    const HitRay g = hit_ray(r);
    float t, tm = BIG;
    int ib, im = -1;
    if (MEDIUM) media_first(p, g, r, b, tm, im);
    if (WALK)
      walk_hit<MOVING, MEDIUM>(p, nodes, g, t, ib, nullptr, tm);
    else
      sweep_hit<MOVING>(p, sph, quad, g, t, ib);
    if (MEDIUM && tm < t) {
      t = tm;
      ib = im;
    }
    if (p.out_ids)
      p.out_ids[(size_t)b * n + i] = t < BIG && (!MEDIUM || ib >= 0) ? RT_LDG(p.kid_map + ib) : -1;
    if (MEDIUM && ib < -1) {
      const float* m = p.media + 8 * (-2 - ib);
      rt::scatter_medium(r, t, b, RT_LDG(m + 5), RT_LDG(m + 6), RT_LDG(m + 7), sp);
      ++scatters;
    } else {
      r.active = rt::shade<NOISE, IMAGE, CAP>(r, t, ib, b, sp);
    }
  }

  rt::store_ray(r, bounces, p.out_rad, p.out_bc, p.out_state, n, i);
  if (p.out_ids)  // one id was written per bounce the ray entered alive
    for (int b = bounces; b < p.max_depth; ++b) p.out_ids[(size_t)b * n + i] = -1;
  return scatters;
}

#ifdef __CUDACC__

constexpr int THREADS = 128;
constexpr size_t DEFAULT_SHARED = 48 * 1024;
// the walk stages node tables up to this size in shared memory (1,536
// nodes, ~6k primitives) and reads larger ones through the caches
constexpr size_t NODE_SMEM_BYTES = 48 * 1024;

// The blocks of THREADS an SM an instantiation's registers must leave room
// for; 0 leaves ptxas free, as no bound does. Free, ptxas gives the marble
// pool's sweep (NOISE and CAP, not WALK) 71 registers since the camera
// start; held to 8 blocks (64 registers, its count before) it needs no
// spill. Bounds on the others cost K1 time in the benchmark cells (PERF.md).
template <bool NOISE, bool WALK, bool CAP>
constexpr int MIN_BLOCKS = NOISE && CAP && !WALK ? 8 : 0;

// Shared memory of one block: the sweep tables (or, walking, the node
// table when it is staged), then with NOISE the permutations (3 x 256 int)
// and gradients (256 x 3 float), 6 KB. With MEDIUM each warp adds the
// bounces its rays lost to media to the launch's counter, once.
template <bool MOVING, bool NOISE, bool IMAGE, bool CAP, bool WALK, bool MEDIUM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<NOISE, WALK, CAP>)
    k1_trace_block(const TraceParams p, int staged4) {
  extern __shared__ float4 smem[];
  const float4* sph = smem;
  const float4* quad = smem + 2 * p.n_sph_rows;
  const float4* nodes = reinterpret_cast<const float4*>(p.nodes);
  if (WALK) {
    for (int k = threadIdx.x; k < staged4; k += blockDim.x) smem[k] = nodes[k];
    if (staged4 > 0) nodes = smem;
  } else {
    const float4* g_sph = reinterpret_cast<const float4*>(p.sph);
    const float4* g_quad = reinterpret_cast<const float4*>(p.quad);
    for (int k = threadIdx.x; k < 2 * p.n_sph_rows; k += blockDim.x) smem[k] = g_sph[k];
    for (int k = threadIdx.x; k < 4 * p.n_quad_rows; k += blockDim.x)
      smem[2 * p.n_sph_rows + k] = g_quad[k];
  }
  int* s_perm = reinterpret_cast<int*>(smem + staged4);
  float* s_grad = reinterpret_cast<float*>(s_perm + 3 * rt::NOISE_POINTS);
  if (NOISE) {
    for (int k = threadIdx.x; k < 3 * rt::NOISE_POINTS; k += blockDim.x) {
      s_perm[k] = p.perm[k];
      s_grad[k] = p.grad[k];
    }
  }
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  int scatters = 0;
  if (i < p.n)
    scatters =
        trace_ray<MOVING, NOISE, IMAGE, CAP, WALK, MEDIUM>(p, sph, quad, nodes, s_perm, s_grad, i);
  if (MEDIUM) {
    const unsigned warp_sum = __reduce_add_sync(0xffffffffu, (unsigned)scatters);
    if ((threadIdx.x & 31) == 0 && warp_sum != 0)
      atomicAdd(p.medium_scatters, (unsigned long long)warp_sum);
  }
}

template <bool MOVING, bool NOISE, bool IMAGE, bool CAP, bool WALK, bool MEDIUM = false>
cudaError_t launch(const TraceParams& p, cudaStream_t stream) {
  // float4s staged before the noise tables
  int staged4 = 2 * p.n_sph_rows + 4 * p.n_quad_rows;
  if (WALK) staged4 = (size_t)p.n_nodes * 8 * sizeof(float) <= NODE_SMEM_BYTES ? 2 * p.n_nodes : 0;
  const size_t smem =
      (size_t)staged4 * sizeof(float4) + (NOISE ? 6 * rt::NOISE_POINTS * sizeof(float) : 0);
  auto kernel = k1_trace_block<MOVING, NOISE, IMAGE, CAP, WALK, MEDIUM>;
  if (smem > DEFAULT_SHARED) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.n + THREADS - 1) / THREADS);
  kernel<<<grid, THREADS, smem, stream>>>(p, staged4);
  return cudaGetLastError();
}

#ifdef RT_K1_MEDIUM_UNIT

// The MEDIUM instantiation for the search, the scene's motion and
// textures (without the cap: the pool, which caps, refuses media).
template <bool MOVING, bool NOISE, bool IMAGE>
cudaError_t launch_medium(const TraceParams& p, bool walk, cudaStream_t s) {
  return walk ? launch<MOVING, NOISE, IMAGE, false, true, true>(p, s)
              : launch<MOVING, NOISE, IMAGE, false, false, true>(p, s);
}

}  // namespace

// The MEDIUM launches, built in their own translation unit
// (megakernel_medium.cu includes this file), which nvcc compiles beside
// this one: `params` is the TraceParams rt_trace_block made, whose layout
// both units take from this one definition.
extern "C" int rt_k1_launch_medium(const void* params, int moving, int noise, int image,
                                   int walk, void* stream) {
  const TraceParams& p = *static_cast<const TraceParams*>(params);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = walk != 0;
  cudaError_t e;
  if (moving)
    e = noise ? (image ? launch_medium<true, true, true>(p, w, s)
                       : launch_medium<true, true, false>(p, w, s))
              : (image ? launch_medium<true, false, true>(p, w, s)
                       : launch_medium<true, false, false>(p, w, s));
  else
    e = noise ? (image ? launch_medium<false, true, true>(p, w, s)
                       : launch_medium<false, true, false>(p, w, s))
              : (image ? launch_medium<false, false, true>(p, w, s)
                       : launch_medium<false, false, false>(p, w, s));
  return (int)e;
}

#else

// The instantiation for the search, the scene's motion, textures and cap;
// a scene with media goes to the MEDIUM unit (rt_k1_launch_medium), which
// has no cap.
template <bool MOVING, bool NOISE, bool IMAGE>
cudaError_t launch_cap(const TraceParams& p, bool walk, cudaStream_t s) {
  if (p.n_media > 0) {
    if (p.dep) return cudaErrorInvalidValue;
    return (cudaError_t)rt_k1_launch_medium(&p, MOVING, NOISE, IMAGE, walk, s);
  }
  if (walk)
    return p.dep ? launch<MOVING, NOISE, IMAGE, true, true>(p, s)
                 : launch<MOVING, NOISE, IMAGE, false, true>(p, s);
  return p.dep ? launch<MOVING, NOISE, IMAGE, true, false>(p, s)
               : launch<MOVING, NOISE, IMAGE, false, false>(p, s);
}

template <bool MOVING>
cudaError_t launch_textures(const TraceParams& p, bool noise, bool image, bool walk,
                            cudaStream_t s) {
  if (noise)
    return image ? launch_cap<MOVING, true, true>(p, walk, s)
                 : launch_cap<MOVING, true, false>(p, walk, s);
  return image ? launch_cap<MOVING, false, true>(p, walk, s)
               : launch_cap<MOVING, false, false>(p, walk, s);
}

}  // namespace

// C entry point (loaded with ctypes). Launches on `stream`, allocates
// nothing and does not synchronize. Returns a cudaError_t. `dep` null:
// no depth cap. `walk` nonzero: the BVH walk (nodes, sph_gid, quad_gid,
// the ball and band of mega_bvh.cull_ball), else the sweep. `camera` not
// null: every lane starts from its camera ray (ray_f is not read) and
// `alive` (null: every lane) says which start alive. `n_media` > 0: the
// MEDIUM instantiation, with the media table and the scatter counter.
extern "C" int rt_trace_block(const float* sph, int n_sph_rows, const float* quad,
                              int n_quad_rows, const float* table, int n_res_cols,
                              const float* ray_f, const int* ray_i, int n, float* out_rad,
                              int* out_bc, float* out_state, const int* kid_map,
                              int* out_ids, uint32_t seed, uint32_t b_off, int max_depth,
                              int ns_pad, float bg_r, float bg_g, float bg_b, int moving,
                              int noise, int image, const int* perm, const float* grad,
                              const float* atlas, const int* dep, int depth_cap,
                              const float* nodes, int n_nodes, const int* sph_gid,
                              int n_sph_chunks, const int* quad_gid, float ball_x,
                              float ball_y, float ball_z, float ball_r2, float band_k,
                              int walk, const float* camera, const unsigned char* alive,
                              uint32_t cam_width, int cam_flags, void* stream, int n_media,
                              const float* media, unsigned long long* medium_scatters) {
  if (n <= 0) return 0;
  if (n_media < 0 || n_media > MAX_MEDIA) return (int)cudaErrorInvalidValue;
  const TraceParams p{sph,     n_sph_rows, quad,    n_quad_rows, table,     n_res_cols,
                      ray_f,   ray_i,      n,       out_rad,     out_bc,    out_state,
                      kid_map, out_ids,    seed,    b_off,       max_depth, ns_pad,
                      bg_r,    bg_g,       bg_b,    perm,        grad,      atlas,
                      dep,     depth_cap,  nodes,   n_nodes,     sph_gid,   n_sph_chunks,
                      quad_gid, ball_x,    ball_y,  ball_z,      ball_r2,   band_k,
                      camera,  alive,      cam_width, cam_flags, n_media, media,
                      medium_scatters};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = walk != 0;
  return (int)(moving ? launch_textures<true>(p, noise, image, w, s)
                      : launch_textures<false>(p, noise, image, w, s));
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#endif  // RT_K1_MEDIUM_UNIT

#else
}  // namespace
#endif
