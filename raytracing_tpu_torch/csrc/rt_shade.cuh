// Shared by the forward megakernels K1 (megakernel_block.cu) and K5
// (megakernel_group.cu): the per-ray state of a phase, its load and store,
// and one bounce's shading after the closest hit. The two Pallas kernels
// shade op for op alike (raytracing_tpu/ops/megakernel_block.py and
// megakernel.py:669-972, solid and checker textures), so both kernels call
// this one copy; its plain PyTorch twin is ops/megakernel_block.py shade.
//
// Without __CUDACC__ the same code compiles as plain C++ (rt_common.cuh).
#pragma once

#include "rt_common.cuh"

namespace rt {

constexpr float BIG = 3.0e38f;  // the miss sentinel: a miss keeps exactly this t
constexpr float T_MIN = 1e-3f;
constexpr float PARALLEL_EPS = 1e-8f;

// ray_f rows
enum { OX, OY, OZ, DX, DY, DZ, TM, TR, TG, TB, RR, RG, RB, ACT, N_F };
// unified-table rows (scene/flatten.py U_*): the first 17 are the resolve
// table; quads keep their corner and edges in QX..VZ
enum { G0, G1, G2, G3, G4, G5, G6, MTYPE, PARAM, AR, AG, AB, TKIND, TSCALE,
       A2R, A2G, A2B, QX, QY, QZ, UX, UY, UZ, VX, VY, VZ };

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm, tr, tg, tb, rr, rg, rb;
  bool active;
  uint32_t pix, smp;
};

RT_DEVICE Ray load_ray(const float* rf, const int* ri, int n, int i) {
  Ray r;
  r.ox = rf[OX * n + i];
  r.oy = rf[OY * n + i];
  r.oz = rf[OZ * n + i];
  r.dx = rf[DX * n + i];
  r.dy = rf[DY * n + i];
  r.dz = rf[DZ * n + i];
  r.tm = rf[TM * n + i];
  r.tr = rf[TR * n + i];
  r.tg = rf[TG * n + i];
  r.tb = rf[TB * n + i];
  r.rr = rf[RR * n + i];
  r.rg = rf[RG * n + i];
  r.rb = rf[RB * n + i];
  r.active = rf[ACT * n + i] > 0.5f;
  r.pix = (uint32_t)ri[i];
  r.smp = (uint32_t)ri[n + i];
  return r;
}

// rad (3, n), bounces (n,) and, when st is not null, the state (N_F, n)
RT_DEVICE void store_ray(const Ray& r, int bounces, float* rad, int* bc, float* st, int n,
                         int i) {
  rad[i] = r.rr;
  rad[n + i] = r.rg;
  rad[2 * n + i] = r.rb;
  bc[i] = bounces;
  if (!st) return;
  st[OX * n + i] = r.ox;
  st[OY * n + i] = r.oy;
  st[OZ * n + i] = r.oz;
  st[DX * n + i] = r.dx;
  st[DY * n + i] = r.dy;
  st[DZ * n + i] = r.dz;
  st[TM * n + i] = r.tm;
  st[TR * n + i] = r.tr;
  st[TG * n + i] = r.tg;
  st[TB * n + i] = r.tb;
  st[RR * n + i] = r.rr;
  st[RG * n + i] = r.rg;
  st[RB * n + i] = r.rb;
  st[ACT * n + i] = r.active ? 1.0f : 0.0f;
}

struct ShadeParams {
  const float* res;  // (>= 17, P) unified-table rows
  int P;             // its row stride (columns)
  int ns_pad;        // first quad column
  uint32_t seed;
  uint32_t b_off;
  float bg_r, bg_g, bg_b;
};

// Bounce b of ray r after its closest hit (t, ib): background on a miss;
// else the winner's fields, solid or checker albedo, emission of a light,
// or the scatter of a lambertian, metal or dielectric surface. Returns
// whether the ray lives on (false: it missed, hit a light or was absorbed).
RT_DEVICE bool shade(Ray& r, float t, int ib, int b, const ShadeParams& s) {
  if (!(t < BIG)) {  // miss: background, then the ray dies
    r.rr += r.tr * s.bg_r;
    r.rg += r.tg * s.bg_g;
    r.rb += r.tb * s.bg_b;
    return false;
  }
  const float dx = r.dx, dy = r.dy, dz = r.dz;
  const float px = r.ox + t * dx;
  const float py = r.oy + t * dy;
  const float pz = r.oz + t * dz;

  // ---- resolve the winner's fields ----
  const float* col = s.res + ib;
  const int P = s.P;
  float own_x, own_y, own_z;
  if (ib >= s.ns_pad) {  // quad: unit normal
    own_x = RT_LDG(col + G0 * P);
    own_y = RT_LDG(col + G1 * P);
    own_z = RT_LDG(col + G2 * P);
  } else {  // sphere: (p - center(tm)) / r
    const float cxt = RT_LDG(col + G0 * P) + r.tm * RT_LDG(col + G3 * P);
    const float cyt = RT_LDG(col + G1 * P) + r.tm * RT_LDG(col + G4 * P);
    const float czt = RT_LDG(col + G2 * P) + r.tm * RT_LDG(col + G5 * P);
    const float rad = RT_LDG(col + G6 * P);
    const float inv_r = 1.0f / (rad != 0.0f ? rad : 1.0f);
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
    r.rr += r.tr * ar;
    r.rg += r.tg * ag;
    r.rb += r.tb * ab;
    return false;
  }

  // ---- scatter ----
  uint32_t v0 = r.pix, v1 = r.smp, v3 = s.seed;
  uint32_t v2 = ((uint32_t)b + s.b_off) * N_STREAMS + STREAM_SCATTER;
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
      if (!((ndx * nx + ndy * ny + ndz * nz) > 0.0f)) return false;
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
  r.tr = r.tr * ar;
  r.tg = r.tg * ag;
  r.tb = r.tb * ab;
  r.ox = px;
  r.oy = py;
  r.oz = pz;
  r.dx = ndx;
  r.dy = ndy;
  r.dz = ndz;
  return true;
}

}  // namespace rt
