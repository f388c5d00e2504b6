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
// What bounds it: FP32 ALU work in the sweep, about 27 operations per
// sphere per segment (13 mul, 11 add/sub, a sqrt, 3 compares and selects).
// The bench workload (bouncing_spheres, 400x225, 100 spp, depth 20) traces
// about 24.3M segments against 496 sphere rows: 24.3e6 * 496 * 27 ~ 3.3e11
// operations. Memory traffic is small: 56 B of ray state in and out per
// ray per phase, plus 17 divergent 4-byte reads per hit. A marble hit
// adds about 1,000 operations and 336 table reads (7 octaves x 8 corners x
// 6 reads), an image hit two atan2f and 3 texel reads.
//
// What the design does about it:
// * one thread traces one ray through the whole phase with its state in
//   registers, so nothing but the phase's inputs and outputs touches
//   device memory;
// * the sweep tables (16 KB at the bench size) are staged once per block
//   into shared memory; all threads of a warp read the same row at the
//   same moment, which shared memory serves as a broadcast (one 16-byte
//   load per half row, no bank conflicts);
// * the winner's fields are per-ray divergent reads, served from global
//   memory through the read-only cache (__ldg), and so are image texels;
// * a noise scene also stages the 6 KB of Perlin tables in shared memory;
// * marble, image and the depth cap are template switches (as motion
//   is), so a scene without them runs the code it would run without them
//   existing, with the same registers;
// * a ray leaves the bounce loop as soon as it dies; the renderer compacts
//   live rays to the front between phases so warps stay full.
//
// Parity: the build uses -fmad=false and no fast math, so every multiply
// and add rounds on its own as in the JAX reference and the plain PyTorch
// version (ops/megakernel_block.py trace_block_torch). A miss rejects
// itself through sqrtf(negative) = NaN, which fails every comparison; pad
// sphere rows carry r^2 = -1e30. A miss stays exactly BIG.
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

#include "rt_shade.cuh"

namespace {

using rt::BIG;
using rt::T_MIN;

struct TraceParams {
  const float* sph;      // (n_sph_rows, 8): cx cy cz vx vy vz r2 0
  int n_sph_rows;
  const float* quad;     // (n_quad_rows, 16): nx ny nz D qx qy qz wx wy wz ux uy uz vx vy vz
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
};

// Trace ray i through one phase. sph/quad point at the staged sweep tables
// (float4 rows: 2 per sphere, 4 per quad), perm/grad at the noise tables.
template <bool MOVING, bool NOISE, bool IMAGE, bool CAP>
RT_DEVICE void trace_ray(const TraceParams& p, const float4* sph, const float4* quad,
                         const int* perm, const float* grad, int i) {
  const int n = p.n;
  rt::Ray r = rt::load_ray(p.ray_f, p.ray_i, n, i);
  if (CAP) r.dep = p.dep[i];
  const rt::ShadeParams sp{p.table,   p.n_res_cols, p.ns_pad, p.seed, p.b_off, p.bg_r, p.bg_g,
                           p.bg_b,    perm,         grad,     p.atlas, p.depth_cap};
  int bounces = 0;

  for (int b = 0; b < p.max_depth && r.active; ++b) {
    ++bounces;
    const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
    const float tm = r.tm;
    // ---- closest hit: spheres in a*t space, then quads in t space ----
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv_a = 1.0f / a;
    const float ta = T_MIN * a;
    float sb = BIG;
    int ib = -1;
#pragma unroll 4
    for (int j = 0; j < p.n_sph_rows; ++j) {
      const float4 c0 = sph[2 * j];
      const float4 c1 = sph[2 * j + 1];
      float ocx, ocy, ocz;
      if (MOVING) {
        ocx = (ox - c0.x) - tm * c0.w;
        ocy = (oy - c0.y) - tm * c1.x;
        ocz = (oz - c0.z) - tm * c1.y;
      } else {
        ocx = ox - c0.x;
        ocy = oy - c0.y;
        ocz = oz - c0.z;
      }
      const float half_b = ocx * dx + ocy * dy + ocz * dz;
      const float cq = ocx * ocx + ocy * ocy + (ocz * ocz - c1.z);
      const float disc = half_b * half_b - a * cq;
      const float sq = sqrtf(disc);
      const float nhb = -half_b;
      const float s0 = nhb - sq;
      const float s1 = nhb + sq;
      const float s = s0 > ta ? s0 : s1;
      if (s > ta && s < sb) {
        sb = s;
        ib = j;
      }
    }
    float t = ib >= 0 ? sb * inv_a : BIG;
    for (int j = 0; j < p.n_quad_rows; ++j) {
      const float4 q0 = quad[4 * j], q1 = quad[4 * j + 1];
      const float4 q2 = quad[4 * j + 2], q3 = quad[4 * j + 3];
      // q0 = nx ny nz D, q1 = qx qy qz wx, q2 = wy wz ux uy, q3 = uz vx vy vz
      const float denom = q0.x * dx + q0.y * dy + q0.z * dz;
      const float safe = fabsf(denom) < 1e-8f ? 1.0f : denom;
      const float tq = (q0.w - (q0.x * ox + q0.y * oy + q0.z * oz)) / safe;
      const float px = ox + tq * dx - q1.x;
      const float py = oy + tq * dy - q1.y;
      const float pz = oz + tq * dz - q1.z;
      const float wx = q1.w, wy = q2.x, wz = q2.y;
      const float ux = q2.z, uy = q2.w, uz = q3.x;
      const float vx = q3.y, vy = q3.z, vz = q3.w;
      const float alpha = wx * (py * vz - pz * vy) + wy * (pz * vx - px * vz)
                          + wz * (px * vy - py * vx);
      const float beta = wx * (uy * pz - uz * py) + wy * (uz * px - ux * pz)
                         + wz * (ux * py - uy * px);
      if (fabsf(denom) >= 1e-8f && tq > T_MIN && tq < t && alpha >= 0.0f &&
          alpha <= 1.0f && beta >= 0.0f && beta <= 1.0f) {
        t = tq;
        ib = j + p.ns_pad;
      }
    }
    if (p.out_ids) p.out_ids[(size_t)b * n + i] = t < BIG ? RT_LDG(p.kid_map + ib) : -1;
    r.active = rt::shade<NOISE, IMAGE, CAP>(r, t, ib, b, sp);
  }

  rt::store_ray(r, bounces, p.out_rad, p.out_bc, p.out_state, n, i);
  if (p.out_ids)  // one id was written per bounce the ray entered alive
    for (int b = bounces; b < p.max_depth; ++b) p.out_ids[(size_t)b * n + i] = -1;
}

#ifdef __CUDACC__

constexpr int THREADS = 128;
constexpr size_t DEFAULT_SHARED = 48 * 1024;

// Shared memory of one block: the sweep tables, then with NOISE the
// permutations (3 x 256 int) and gradients (256 x 3 float), 6 KB.
template <bool MOVING, bool NOISE, bool IMAGE, bool CAP>
__global__ void __launch_bounds__(THREADS) k1_trace_block(const TraceParams p) {
  extern __shared__ float4 smem[];
  float4* s_sph = smem;
  float4* s_quad = smem + 2 * p.n_sph_rows;
  const float4* g_sph = reinterpret_cast<const float4*>(p.sph);
  const float4* g_quad = reinterpret_cast<const float4*>(p.quad);
  for (int k = threadIdx.x; k < 2 * p.n_sph_rows; k += blockDim.x) s_sph[k] = g_sph[k];
  for (int k = threadIdx.x; k < 4 * p.n_quad_rows; k += blockDim.x) s_quad[k] = g_quad[k];
  int* s_perm = reinterpret_cast<int*>(s_quad + 4 * p.n_quad_rows);
  float* s_grad = reinterpret_cast<float*>(s_perm + 3 * rt::NOISE_POINTS);
  if (NOISE) {
    for (int k = threadIdx.x; k < 3 * rt::NOISE_POINTS; k += blockDim.x) {
      s_perm[k] = p.perm[k];
      s_grad[k] = p.grad[k];
    }
  }
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < p.n) trace_ray<MOVING, NOISE, IMAGE, CAP>(p, s_sph, s_quad, s_perm, s_grad, i);
}

template <bool MOVING, bool NOISE, bool IMAGE, bool CAP>
cudaError_t launch(const TraceParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)(p.n_sph_rows * 8 + p.n_quad_rows * 16) * sizeof(float) +
                      (NOISE ? 6 * rt::NOISE_POINTS * sizeof(float) : 0);
  auto kernel = k1_trace_block<MOVING, NOISE, IMAGE, CAP>;
  if (smem > DEFAULT_SHARED) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.n + THREADS - 1) / THREADS);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The instantiation for the scene's motion, textures and cap.
template <bool MOVING, bool NOISE, bool IMAGE>
cudaError_t launch_cap(const TraceParams& p, cudaStream_t s) {
  return p.dep ? launch<MOVING, NOISE, IMAGE, true>(p, s)
               : launch<MOVING, NOISE, IMAGE, false>(p, s);
}

template <bool MOVING>
cudaError_t launch_textures(const TraceParams& p, bool noise, bool image, cudaStream_t s) {
  if (noise)
    return image ? launch_cap<MOVING, true, true>(p, s) : launch_cap<MOVING, true, false>(p, s);
  return image ? launch_cap<MOVING, false, true>(p, s) : launch_cap<MOVING, false, false>(p, s);
}

}  // namespace

// C entry point (loaded with ctypes). Launches on `stream`, allocates
// nothing and does not synchronize. Returns a cudaError_t. `dep` null:
// no depth cap.
extern "C" int rt_trace_block(const float* sph, int n_sph_rows, const float* quad,
                              int n_quad_rows, const float* table, int n_res_cols,
                              const float* ray_f, const int* ray_i, int n, float* out_rad,
                              int* out_bc, float* out_state, const int* kid_map,
                              int* out_ids, uint32_t seed, uint32_t b_off, int max_depth,
                              int ns_pad, float bg_r, float bg_g, float bg_b, int moving,
                              int noise, int image, const int* perm, const float* grad,
                              const float* atlas, const int* dep, int depth_cap,
                              void* stream) {
  if (n <= 0) return 0;
  const TraceParams p{sph,     n_sph_rows, quad,    n_quad_rows, table,     n_res_cols,
                      ray_f,   ray_i,      n,       out_rad,     out_bc,    out_state,
                      kid_map, out_ids,    seed,    b_off,       max_depth, ns_pad,
                      bg_r,    bg_g,       bg_b,    perm,        grad,      atlas,
                      dep,     depth_cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(moving ? launch_textures<true>(p, noise, image, s)
                      : launch_textures<false>(p, noise, image, s));
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#else
}  // namespace
#endif
