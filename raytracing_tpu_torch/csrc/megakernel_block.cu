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
// The per-ray math also compiles as plain C++ (without __CUDACC__), so its
// arithmetic can be exercised on a host.

#include "rt_common.cuh"

namespace {

using rt::pcg4d;
using rt::TWO_PI;
using rt::u01;

constexpr float BIG = 3.0e38f;
constexpr float T_MIN = 1e-3f;

// ray_f rows
enum { OX, OY, OZ, DX, DY, DZ, TM, TR, TG, TB, RR, RG, RB, ACT, N_F };
// resolve table rows (scene/flatten.py U_*)
enum { G0, G1, G2, G3, G4, G5, G6, MTYPE, PARAM, AR, AG, AB, TKIND, TSCALE,
       A2R, A2G, A2B };

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
  const float* rf = p.ray_f;
  float ox = rf[OX * n + i], oy = rf[OY * n + i], oz = rf[OZ * n + i];
  float dx = rf[DX * n + i], dy = rf[DY * n + i], dz = rf[DZ * n + i];
  const float tm = rf[TM * n + i];
  float tr = rf[TR * n + i], tg = rf[TG * n + i], tb = rf[TB * n + i];
  float rr = rf[RR * n + i], rg = rf[RG * n + i], rb = rf[RB * n + i];
  bool active = rf[ACT * n + i] > 0.5f;
  const uint32_t pix = (uint32_t)p.ray_i[i];
  const uint32_t smp = (uint32_t)p.ray_i[n + i];
  const float* res = p.resolve;
  const int P = p.n_res_cols;
  int bounces = 0;

  for (int b = 0; b < p.max_depth && active; ++b) {
    ++bounces;
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

    if (!(t < BIG)) {  // miss: background, then the ray dies
      rr += tr * p.bg_r;
      rg += tg * p.bg_g;
      rb += tb * p.bg_b;
      active = false;
      break;
    }
    const float px = ox + t * dx;
    const float py = oy + t * dy;
    const float pz = oz + t * dz;

    // ---- resolve the winner's fields ----
    const float* col = res + ib;
    float own_x, own_y, own_z;
    if (ib >= p.ns_pad) {  // quad: unit normal
      own_x = RT_LDG(col + G0 * P);
      own_y = RT_LDG(col + G1 * P);
      own_z = RT_LDG(col + G2 * P);
    } else {  // sphere: (p - center(tm)) / r
      const float cxt = RT_LDG(col + G0 * P) + tm * RT_LDG(col + G3 * P);
      const float cyt = RT_LDG(col + G1 * P) + tm * RT_LDG(col + G4 * P);
      const float czt = RT_LDG(col + G2 * P) + tm * RT_LDG(col + G5 * P);
      const float r = RT_LDG(col + G6 * P);
      const float inv_r = 1.0f / (r != 0.0f ? r : 1.0f);
      own_x = (px - cxt) * inv_r;
      own_y = (py - cyt) * inv_r;
      own_z = (pz - czt) * inv_r;
    }
    const bool front = (dx * own_x + dy * own_y + dz * own_z) < 0.0f;
    const float sgn = front ? 1.0f : -1.0f;
    const float nx = own_x * sgn, ny = own_y * sgn, nz = own_z * sgn;

    const float mt = RT_LDG(col + MTYPE * P);
    const float prm = RT_LDG(col + PARAM * P);
    float ar = RT_LDG(col + AR * P), ag = RT_LDG(col + AG * P), ab = RT_LDG(col + AB * P);
    if (RT_LDG(col + TKIND * P) == 1.0f) {  // checker of two solids
      const float ts = RT_LDG(col + TSCALE * P);
      // parity of the cell sum; unsigned adds keep the wrap defined
      const uint32_t cells = (uint32_t)(int)floorf(ts * px) + (uint32_t)(int)floorf(ts * py)
                             + (uint32_t)(int)floorf(ts * pz);
      if (cells & 1u) {
        ar = RT_LDG(col + A2R * P);
        ag = RT_LDG(col + A2G * P);
        ab = RT_LDG(col + A2B * P);
      }
    }

    if (mt == 3.0f) {  // light: emission, then the ray dies
      rr += tr * ar;
      rg += tg * ag;
      rb += tb * ab;
      active = false;
      break;
    }

    // ---- scatter ----
    uint32_t v0 = pix, v1 = smp, v3 = p.seed;
    uint32_t v2 = ((uint32_t)b + p.b_off) * rt::N_STREAMS + rt::STREAM_SCATTER;
    pcg4d(v0, v1, v2, v3);
    float ndx, ndy, ndz;
    if (mt == 2.0f) {  // dielectric
      const float u2 = u01(v2);
      const float dinv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz + 1e-30f);
      const float udx = dx * dinv, udy = dy * dinv, udz = dz * dinv;
      const float ri = front ? 1.0f / prm : prm;
      const float cos_t = fminf(-(udx * nx + udy * ny + udz * nz), 1.0f);
      const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
      const bool cannot = ri * sin_t > 1.0f;
      float r0 = (1.0f - ri) / (1.0f + ri);
      r0 = r0 * r0;
      const float x1 = 1.0f - cos_t;
      const float x2 = x1 * x1;
      const float reflectance = r0 + (1.0f - r0) * (x1 * (x2 * x2));
      if (cannot || reflectance > u2) {
        const float u_dot_n = udx * nx + udy * ny + udz * nz;
        ndx = udx - 2.0f * u_dot_n * nx;
        ndy = udy - 2.0f * u_dot_n * ny;
        ndz = udz - 2.0f * u_dot_n * nz;
      } else {
        const float rpx = ri * (udx + cos_t * nx);
        const float rpy = ri * (udy + cos_t * ny);
        const float rpz = ri * (udz + cos_t * nz);
        const float par = -sqrtf(fabsf(1.0f - (rpx * rpx + rpy * rpy + rpz * rpz)));
        ndx = rpx + par * nx;
        ndy = rpy + par * ny;
        ndz = rpz + par * nz;
      }
      ar = 1.0f;
      ag = 1.0f;
      ab = 1.0f;
    } else {
      const float zdir = 1.0f - 2.0f * u01(v0);
      const float rho = sqrtf(fmaxf(0.0f, 1.0f - zdir * zdir));
      const float phi = TWO_PI * u01(v1);
      const float rux = rho * cosf(phi), ruy = rho * sinf(phi), ruz = zdir;
      if (mt == 1.0f) {  // metal: fuzzed mirror, absorbed below the surface
        const float d_dot_on = dx * nx + dy * ny + dz * nz;
        const float rdx = dx - 2.0f * d_dot_on * nx;
        const float rdy = dy - 2.0f * d_dot_on * ny;
        const float rdz = dz - 2.0f * d_dot_on * nz;
        const float rlen = 1.0f / sqrtf(rdx * rdx + rdy * rdy + rdz * rdz + 1e-30f);
        ndx = rdx * rlen + prm * rux;
        ndy = rdy * rlen + prm * ruy;
        ndz = rdz * rlen + prm * ruz;
        if (!((ndx * nx + ndy * ny + ndz * nz) > 0.0f)) {
          active = false;
          break;
        }
      } else {  // lambertian
        ndx = nx + rux;
        ndy = ny + ruy;
        ndz = nz + ruz;
        if (fabsf(ndx) < 1e-8f && fabsf(ndy) < 1e-8f && fabsf(ndz) < 1e-8f) {
          ndx = nx;
          ndy = ny;
          ndz = nz;
        }
      }
    }
    tr = tr * ar;
    tg = tg * ag;
    tb = tb * ab;
    ox = px;
    oy = py;
    oz = pz;
    dx = ndx;
    dy = ndy;
    dz = ndz;
  }

  p.out_rad[i] = rr;
  p.out_rad[n + i] = rg;
  p.out_rad[2 * n + i] = rb;
  p.out_bc[i] = bounces;
  if (p.out_ids)  // one id was written per bounce the ray entered alive
    for (int b = bounces; b < p.max_depth; ++b) p.out_ids[(size_t)b * n + i] = -1;
  if (p.out_state) {
    float* st = p.out_state;
    st[OX * n + i] = ox;
    st[OY * n + i] = oy;
    st[OZ * n + i] = oz;
    st[DX * n + i] = dx;
    st[DY * n + i] = dy;
    st[DZ * n + i] = dz;
    st[TM * n + i] = tm;
    st[TR * n + i] = tr;
    st[TG * n + i] = tg;
    st[TB * n + i] = tb;
    st[RR * n + i] = rr;
    st[RG * n + i] = rg;
    st[RB * n + i] = rb;
    st[ACT * n + i] = active ? 1.0f : 0.0f;
  }
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
