// Shared by the forward megakernels K1 (megakernel_block.cu) and K5
// (megakernel_group.cu): the per-ray state of a phase, its load and store,
// and one bounce's shading after the closest hit. The two Pallas kernels
// shade op for op alike (raytracing_tpu/ops/megakernel_block.py and
// megakernel.py:669-972: solid, checker, 7-octave marble and nearest-texel
// image textures), so both kernels call this one copy; its plain PyTorch
// twin is ops/megakernel_block.py shade (with scene/perlin.py marble and
// image_texel).
// Marble and image are template switches, so a scene without them
// compiles to the code it had before they existed. atan2f, sinf and
// floorf are CUDA's own (no fast math): the Pallas kernel's atan2
// polynomial exists only because Mosaic has no arctan2.
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

constexpr float PI_F = 3.14159265358979323846f;
constexpr float INV_2PI_F = (float)(1.0 / (2.0 * 3.14159265358979323846));
constexpr float INV_PI_F = (float)(1.0 / 3.14159265358979323846);
constexpr int NOISE_POINTS = 256;    // Perlin lattice table size
constexpr int NOISE_OCTAVES = 7;     // marble turbulence depth

struct Ray {
  float ox, oy, oz, dx, dy, dz, tm, tr, tg, tb, rr, rg, rb;
  bool active;
  uint32_t pix, smp;
  int dep;  // segments traced before this phase (the pool's depth cap); else 0
};

// ray i of ri (2, n), its float rows at rf[k * stride + at]
RT_DEVICE Ray load_ray(const float* rf, int stride, int at, const int* ri, int n, int i) {
  Ray r;
  r.ox = rf[OX * stride + at];
  r.oy = rf[OY * stride + at];
  r.oz = rf[OZ * stride + at];
  r.dx = rf[DX * stride + at];
  r.dy = rf[DY * stride + at];
  r.dz = rf[DZ * stride + at];
  r.tm = rf[TM * stride + at];
  r.tr = rf[TR * stride + at];
  r.tg = rf[TG * stride + at];
  r.tb = rf[TB * stride + at];
  r.rr = rf[RR * stride + at];
  r.rg = rf[RG * stride + at];
  r.rb = rf[RB * stride + at];
  r.active = rf[ACT * stride + at] > 0.5f;
  r.pix = (uint32_t)ri[i];
  r.smp = (uint32_t)ri[n + i];
  r.dep = 0;
  return r;
}

// ray i of rf (N_F, n) and ri (2, n)
RT_DEVICE Ray load_ray(const float* rf, const int* ri, int n, int i) {
  return load_ray(rf, n, i, ri, n, i);
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
  const float* res;    // (>= 26, P) unified-table rows
  int P;               // its row stride (columns)
  int ns_pad;          // first quad column
  uint32_t seed;
  uint32_t b_off;
  float bg_r, bg_g, bg_b;
  const int* perm;     // (3, 256) marble permutations x, y, z (shared or global memory)
  const float* grad;   // (256, 3) marble gradient vectors (shared or global memory)
  const float* atlas;  // (T, 3) image texels, read through the read-only cache
  int depth_cap;       // with CAP: the ray dies once dep + b + 1 reaches it
};

// The marble albedo 0.5 (1 + sin(ts pz + 10 turb(p))), turb the absolute
// sum of 7 octaves of Perlin noise, 2^-k noise(2^k p), each the Hermite-
// weighted blend of its 8 lattice corners' dot(gradient, offset). The
// operation order is the Pallas kernel's (and scene/perlin.py's).
RT_DEVICE float marble(float px, float py, float pz, float ts, const int* perm,
                       const float* grad) {
  float accum = 0.0f, weight = 1.0f;
  float tx = px, ty = py, tz = pz;
#pragma unroll 1
  for (int oct = 0; oct < NOISE_OCTAVES; ++oct) {
    const float fx = floorf(tx), fy = floorf(ty), fz = floorf(tz);
    const float u = tx - fx, v = ty - fy, w = tz - fz;
    const int ix = (int)fx, iy = (int)fy, iz = (int)fz;
    const float hx = u * u * (3.0f - 2.0f * u);
    const float hy = v * v * (3.0f - 2.0f * v);
    const float hz = w * w * (3.0f - 2.0f * w);
    float acc = 0.0f;
#pragma unroll
    for (int di = 0; di < 2; ++di)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj)
#pragma unroll
        for (int dk = 0; dk < 2; ++dk) {
          // & 255 on a negative cell wraps as the reference's does
          const int h = perm[(ix + di) & 255] ^ perm[NOISE_POINTS + ((iy + dj) & 255)] ^
                        perm[2 * NOISE_POINTS + ((iz + dk) & 255)];
          const float* g = grad + 3 * h;
          const float dotg = g[0] * (u - (float)di) + g[1] * (v - (float)dj) +
                             g[2] * (w - (float)dk);
          const float wx = di ? hx : 1.0f - hx;
          const float wy = dj ? hy : 1.0f - hy;
          const float wz = dk ? hz : 1.0f - hz;
          acc = acc + wx * wy * wz * dotg;
        }
    accum = accum + weight * acc;
    weight *= 0.5f;
    tx = tx * 2.0f;
    ty = ty * 2.0f;
    tz = tz * 2.0f;
  }
  return 0.5f * (1.0f + sinf(ts * pz + 10.0f * fabsf(accum)));
}

// i clamped to [0, max(n - 1, 0)]
RT_DEVICE int clamp_index(int i, int n) {
  const int hi = n > 1 ? n - 1 : 0;
  return i < 0 ? 0 : (i > hi ? hi : i);
}

// The nearest texel of an image hit at p on primitive column `col`: a
// sphere's (u, v) from its outward normal own (theta = atan2(sqrt(x^2 +
// z^2), -y), phi = atan2(-z, x) + pi, x taken as 1 on the poles), a quad's
// (alpha, beta) from its corner, edges and w; then u clamped, v clamped
// and flipped, both truncated to the texel. A2R holds the image's first
// atlas texel, A2G its width and A2B its height.
RT_DEVICE void image_albedo(const float* col, int P, bool is_quad, float px, float py, float pz,
                            float own_x, float own_y, float own_z, const float* atlas,
                            float& ar, float& ag, float& ab) {
  float u, v;
  if (is_quad) {
    const float pqx = px - RT_LDG(col + QX * P);
    const float pqy = py - RT_LDG(col + QY * P);
    const float pqz = pz - RT_LDG(col + QZ * P);
    const float ux = RT_LDG(col + UX * P), uy = RT_LDG(col + UY * P), uz = RT_LDG(col + UZ * P);
    const float vx = RT_LDG(col + VX * P), vy = RT_LDG(col + VY * P), vz = RT_LDG(col + VZ * P);
    const float wx = RT_LDG(col + G4 * P), wy = RT_LDG(col + G5 * P), wz = RT_LDG(col + G6 * P);
    u = wx * (pqy * vz - pqz * vy) + wy * (pqz * vx - pqx * vz) + wz * (pqx * vy - pqy * vx);
    v = wx * (uy * pqz - uz * pqy) + wy * (uz * pqx - ux * pqz) + wz * (ux * pqy - uy * pqx);
  } else {
    const float rxz = sqrtf(fmaxf(own_x * own_x + own_z * own_z, 0.0f));
    const float theta = atan2f(rxz, -own_y);
    const float x_safe = rxz > 0.0f ? own_x : 1.0f;
    const float phi = atan2f(-own_z, x_safe) + PI_F;
    u = phi * INV_2PI_F;
    v = theta * INV_PI_F;
  }
  const float w_img = RT_LDG(col + A2G * P), h_img = RT_LDG(col + A2B * P);
  const int w_i = (int)w_img, h_i = (int)h_img;
  const float x = fminf(fmaxf(u, 0.0f), 1.0f) * w_img;
  const float y = (1.0f - fminf(fmaxf(v, 0.0f), 1.0f)) * h_img;
  const int ti = clamp_index((int)x, w_i);
  const int tj = clamp_index((int)y, h_i);
  const float* texel = atlas + 3 * (size_t)((int)RT_LDG(col + A2R * P) + tj * w_i + ti);
  ar = RT_LDG(texel);
  ag = RT_LDG(texel + 1);
  ab = RT_LDG(texel + 2);
}

// Bounce b of ray r after its closest hit (t, ib): background on a miss;
// else the winner's fields, solid, checker, marble (NOISE) or image
// (IMAGE) albedo, emission of a light, or the scatter of a lambertian,
// metal or dielectric surface. With CAP the ray's RNG counter continues
// at its own bounce index dep + b, and the ray dies, its state kept, once
// it has traced depth_cap segments. Returns whether the ray lives on
// (false: it missed, hit a light, was absorbed or reached the cap).
template <bool NOISE, bool IMAGE, bool CAP>
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
  const bool is_quad = ib >= s.ns_pad;
  float own_x, own_y, own_z;
  if (is_quad) {  // quad: unit normal
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
  const float tkind = RT_LDG(col + TKIND * P);
  if (tkind == 1.0f) {  // checker of two solids
    const float ts = RT_LDG(col + TSCALE * P);
    // parity of the cell sum; unsigned adds keep the wrap defined
    const uint32_t cells = (uint32_t)(int)floorf(ts * px) + (uint32_t)(int)floorf(ts * py)
                           + (uint32_t)(int)floorf(ts * pz);
    if (cells & 1u) {
      ar = RT_LDG(col + A2R * P);
      ag = RT_LDG(col + A2G * P);
      ab = RT_LDG(col + A2B * P);
    }
  } else if (NOISE && tkind == 2.0f) {  // marble; TSCALE is the noise scale
    ar = ag = ab = marble(px, py, pz, RT_LDG(col + TSCALE * P), s.perm, s.grad);
  } else if (IMAGE && tkind == 3.0f) {
    image_albedo(col, P, is_quad, px, py, pz, own_x, own_y, own_z, s.atlas, ar, ag, ab);
  }

  if (mt == 3.0f) {  // light: emission, then the ray dies
    r.rr += r.tr * ar;
    r.rg += r.tg * ag;
    r.rb += r.tb * ab;
    return false;
  }
  if (CAP && r.dep + b + 1 >= s.depth_cap) return false;  // its last segment

  // ---- scatter ----
  uint32_t v0 = r.pix, v1 = r.smp, v3 = s.seed;
  uint32_t v2 = ((uint32_t)b + s.b_off) * N_STREAMS + STREAM_SCATTER;
  if (CAP) v2 += (uint32_t)r.dep * N_STREAMS;  // the ray's own bounce index dep + b
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

// Bounce b of ray r won by a participating medium at t (K1's MEDIUM): the
// ray moves to the scatter point and leaves it in a uniform direction
// from the bounce's scatter draw (the lambertian's unit vector), with the
// medium's albedo (ar, ag, ab) as attenuation; it lives on. The book's
// isotropic phase function.
RT_DEVICE void scatter_medium(Ray& r, float t, int b, float ar, float ag, float ab,
                              const ShadeParams& s) {
  const float px = r.ox + t * r.dx;
  const float py = r.oy + t * r.dy;
  const float pz = r.oz + t * r.dz;
  uint32_t v0 = r.pix, v1 = r.smp, v3 = s.seed;
  uint32_t v2 = ((uint32_t)b + s.b_off) * N_STREAMS + STREAM_SCATTER;
  pcg4d(v0, v1, v2, v3);
  const float zdir = 1.0f - 2.0f * u01(v0);
  const float rho = sqrtf(fmaxf(0.0f, 1.0f - zdir * zdir));
  const float phi = TWO_PI * u01(v1);
  r.tr = r.tr * ar;
  r.tg = r.tg * ag;
  r.tb = r.tb * ab;
  r.ox = px;
  r.oy = py;
  r.oz = pz;
  r.dx = rho * cosf(phi);
  r.dy = rho * sinf(phi);
  r.dz = zdir;
}

}  // namespace rt
