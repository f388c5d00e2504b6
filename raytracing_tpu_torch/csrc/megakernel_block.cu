// K1, the block megakernel, in CUDA C++ for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel raytracing_tpu/ops/megakernel_block.py
// make_megakernel_block (pallas_call in its `run`). It traces one phase of
// up to max_depth bounces for every ray: closest hit over all sphere rows
// (moving center at ray time, roots in a*t space, strict < so the lowest
// index wins ties) and then all quad rows; the winner's fields from the
// (F, P) resolve table; solid or checker albedo; lambertian, metal,
// dielectric or light; PCG4D keyed on (pix, smp, (b + b_off)*4 + 2, seed).
//
// What bounds it: FP32 ALU work in the sweep, about 27 operations per
// sphere per segment (13 mul, 11 add/sub, a sqrt, 3 compares and selects).
// The bench workload (bouncing_spheres, 400x225, 100 spp, depth 20) traces
// about 24.3M segments against 496 sphere rows: 24.3e6 * 496 * 27 ~ 3.3e11
// operations. Memory traffic is small: 56 B of ray state in and out per
// ray per phase, plus 17 divergent 4-byte reads per hit.
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
//   memory through the read-only cache (__ldg);
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
  const float* resolve;  // (17, n_res_cols)
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
  int ns_pad;            // first quad column of the resolve table
  float bg_r, bg_g, bg_b;
};

// Trace ray i through one phase. sph/quad point at the staged sweep tables
// (float4 rows: 2 per sphere, 4 per quad).
template <bool MOVING>
RT_DEVICE void trace_ray(const TraceParams& p, const float4* sph, const float4* quad, int i) {
  const int n = p.n;
  rt::Ray r = rt::load_ray(p.ray_f, p.ray_i, n, i);
  const rt::ShadeParams sp{p.resolve, p.n_res_cols, p.ns_pad, p.seed, p.b_off,
                           p.bg_r,    p.bg_g,       p.bg_b};
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
    r.active = rt::shade(r, t, ib, b, sp);
  }

  rt::store_ray(r, bounces, p.out_rad, p.out_bc, p.out_state, n, i);
  if (p.out_ids)  // one id was written per bounce the ray entered alive
    for (int b = bounces; b < p.max_depth; ++b) p.out_ids[(size_t)b * n + i] = -1;
}

#ifdef __CUDACC__

constexpr int THREADS = 128;
constexpr size_t DEFAULT_SHARED = 48 * 1024;

template <bool MOVING>
__global__ void __launch_bounds__(THREADS) k1_trace_block(const TraceParams p) {
  extern __shared__ float4 smem[];
  float4* s_sph = smem;
  float4* s_quad = smem + 2 * p.n_sph_rows;
  const float4* g_sph = reinterpret_cast<const float4*>(p.sph);
  const float4* g_quad = reinterpret_cast<const float4*>(p.quad);
  for (int k = threadIdx.x; k < 2 * p.n_sph_rows; k += blockDim.x) s_sph[k] = g_sph[k];
  for (int k = threadIdx.x; k < 4 * p.n_quad_rows; k += blockDim.x) s_quad[k] = g_quad[k];
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < p.n) trace_ray<MOVING>(p, s_sph, s_quad, i);
}

template <bool MOVING>
cudaError_t launch(const TraceParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)(p.n_sph_rows * 8 + p.n_quad_rows * 16) * sizeof(float);
  if (smem > DEFAULT_SHARED) {
    const cudaError_t e = cudaFuncSetAttribute(
        k1_trace_block<MOVING>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.n + THREADS - 1) / THREADS);
  k1_trace_block<MOVING><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). Launches on `stream`, allocates
// nothing and does not synchronize. Returns a cudaError_t.
extern "C" int rt_trace_block(const float* sph, int n_sph_rows, const float* quad,
                              int n_quad_rows, const float* resolve, int n_res_cols,
                              const float* ray_f, const int* ray_i, int n, float* out_rad,
                              int* out_bc, float* out_state, const int* kid_map,
                              int* out_ids, uint32_t seed, uint32_t b_off, int max_depth,
                              int ns_pad, float bg_r, float bg_g, float bg_b, int moving,
                              void* stream) {
  if (n <= 0) return 0;
  const TraceParams p{sph,     n_sph_rows, quad,    n_quad_rows, resolve,   n_res_cols,
                      ray_f,   ray_i,      n,       out_rad,     out_bc,    out_state,
                      kid_map, out_ids,    seed,    b_off,       max_depth, ns_pad,
                      bg_r,    bg_g,       bg_b};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(moving ? launch<true>(p, s) : launch<false>(p, s));
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#else
}  // namespace
#endif
