// K3 and K2, the decision-replay kernels, in CUDA C++ for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernels of raytracing_tpu/diff/replay_kernel.py
// make_replay_kernels: fwd_kernel (K3, pallas_call in fwd_run) and
// bwd_kernel (K2, pallas_call in bwd_run). Both replay a ray's bounce
// chain from the winner ids a decision pass recorded, reading the winner's
// row of the packed (L, 23) replay table (diff/replay_fast.py) instead of
// searching for the hit:
// * K3: radiance and bounce counts;
// * K2: the same forward, stashing each bounce's entry state (origin,
//   direction, throughput), then the hand-derived reverse sweep
//   (bounce_bwd, the VJP of bounce_fwd) from the radiance cotangent,
//   writing the cotangents of the NG = 19 differentiable table fields at
//   every (bounce, ray).
//
// What bounds them: FP32 ALU work. A replayed segment is ~190 operations
// forward (K3) and ~600 in K2 (the forward, its recomputation in the
// reverse sweep and ~280 for the VJP), with a few sqrt, divides and a
// sin/cos pair. Memory traffic per segment is one 4-byte id, one 92-byte
// table row (served from L1/L2: the bench table is 47 KB) and, in K2, 76
// bytes of cotangents and its 36-byte stash entry, written and read back
// through the same rows; K2 also writes zeros for the bounces a ray did
// not run, (D, NG, n) in all.
//
// What the design does about it:
// * one thread replays one ray at a time with its state in registers;
//   nothing but the inputs and the outputs (K2's stash among them) touches
//   memory;
// * K3's warps are persistent and their lanes refill: a ray runs 2.7
//   bounces on average and up to D, so one thread per ray kept a warp
//   running until its longest ray died with most lanes idle; instead a
//   lane whose ray ends writes it and takes the next ray index from a
//   global counter (one warp-merged atomicAdd per refill). A ray's
//   arithmetic does not depend on the lane or refill that runs it;
// * table rows are read through the read-only cache (__ldg) and re-read
//   in K2's reverse sweep rather than stashed: on the card a row read is
//   a cached load, where the TPU kernel stashed the gathered fields
//   because its lane gather was most of a bounce;
// * K2's stash (each bounce's 9-float entry state) lives in its own
//   output: thread i alone owns g[b, :, i], so the forward writes bounce
//   b's state to g[b, 0:9, i] and the reverse sweep reads it back before
//   it overwrites that bounce with the NG cotangents. A replay of any depth
//   D fits (the TPU kernel sizes its VMEM stash by D), no memory is added,
//   and the stores coalesce as the output's do;
// * gating: bounces b >= maxlen[tile] of a 1024-ray tile are not run, as
//   the Pallas kernels' pl.when(b < ml); within them a ray stops at its
//   death (a dead ray's bounce is the identity, its cotangents zero);
// * outputs are field-major, (3, n) and (D, NG, n), so a warp's stores
//   coalesce and a bounce's prefix of rays is one contiguous slice.
//
// Parity: built with -fmad=false and no fast math. The arithmetic mirrors
// the JAX bounce_fwd / bounce_bwd op for op (sqrt + divide for unit
// vectors, (1 - cos)^5 as x * ((x*x)*(x*x)), the guarded sqrt forms that
// keep masked values finite); the plain PyTorch versions
// (diff/replay_kernel.py replay_fwd_torch, replay_bwd_torch by autograd)
// repeat the forward.
//
// Layout: table (L, 23) f32 row-major; ids (D, n) i32 (-1 = miss); ray_f
// (8, n) f32 rows ox oy oz dx dy dz tm act; ray_i (2, n) i32 rows pix smp;
// maxlen (ceil(n/1024),) i32; K2's rad_bar (3, n) f32.
//
// Without __CUDACC__ the per-ray functions compile as plain C++, so a host
// build can exercise their arithmetic.

#include "rt_common.cuh"

namespace {

using rt::pcg4d;
using rt::TWO_PI;
using rt::u01;

constexpr int TILE = 1024;     // rays per gating tile
constexpr float T_MIN = 1e-3f;
constexpr float PARALLEL_EPS = 1e-8f;
constexpr float NEAR_ZERO_EPS = 1e-8f;

// packed table fields (diff/replay_fast.py _F_*)
enum { F_ISQUAD = 0, F_G0 = 1, F_G1 = 4, F_RAD = 7, F_QN = 8, F_QD = 11, F_MTYPE = 12,
       F_FUZZ = 13, F_IOR = 14, F_ISCHK = 15, F_RGB_E = 16, F_RGB_O = 19, F_INVSC = 22,
       N_FIELDS = 23 };
// gradient slots (diff/replay_kernel.py _G_*)
enum { G_C = 0, G_V = 3, G_R = 6, G_QN = 7, G_QD = 10, G_FUZZ = 11, G_IOR = 12, G_ER = 13,
       G_OR = 16, NG = 19 };
// ray_f rows
enum { RX, RY, RZ, RDX, RDY, RDZ, RTM, RACT, N_RAY_F };

struct ReplayParams {
  const float* table;    // (L, N_FIELDS)
  const int* ids;        // (D, n)
  const float* ray_f;    // (N_RAY_F, n)
  const int* ray_i;      // (2, n)
  const int* maxlen;     // (ceil(n / TILE),)
  const float* rad_bar;  // (3, n), K2
  int n;
  int D;
  int n_sph;             // global ids >= n_sph are quads
  uint32_t seed;
  float bg_r, bg_g, bg_b;
  float* out_rad;        // (3, n), K3
  int* out_bc;           // (n,), K3
  float* out_g;          // (D, NG, n), K2
};

// A bounce's entry state (the ray is alive on entry).
struct State {
  float ox, oy, oz, dx, dy, dz, tr, tg, tb;
};

// Everything bounce_fwd computes that the reverse sweep reads.
struct Inter {
  bool has_id, is_quad, miss, emit, live, pos, use0, par, use_even, clip1, usef, kpos;
  bool is_metal, is_diel;
  float cx, cy, cz, ocx, ocy, ocz, a, hb, r, cq, sq, qnx, qny, qnz, sden, t_q, ts_;
  float px, py, pz, inv_r, owx, owy, owz, sgn, nx, ny, nz;
  float tex_r, tex_g, tex_b, rux, ruy, ruz, ddn, rfx, rfy, rfz, rlen;
  float ri, dlen, udx, udy, udz, cost, ppx, ppy, ppz, w, kroot, udn;
  float att_r, att_g, att_b, ndx, ndy, ndz;
};

// One replayed bounce of a live ray (JAX bounce_fwd with act = 1).
template <bool MOVING>
RT_DEVICE void bounce_fwd(const ReplayParams& p, int id, const State& s, float tm,
                          uint32_t pix, uint32_t smp, int b, Inter& I) {
  I.has_id = id >= 0;
  const int pid = I.has_id ? id : 0;
  I.is_quad = pid >= p.n_sph;
  const float* v = p.table + (size_t)pid * N_FIELDS;
  const float ox = s.ox, oy = s.oy, oz = s.oz, dx = s.dx, dy = s.dy, dz = s.dz;

  I.cx = RT_LDG(v + F_G0);
  I.cy = RT_LDG(v + F_G0 + 1);
  I.cz = RT_LDG(v + F_G0 + 2);
  if (MOVING) {
    I.cx = I.cx + tm * RT_LDG(v + F_G1);
    I.cy = I.cy + tm * RT_LDG(v + F_G1 + 1);
    I.cz = I.cz + tm * RT_LDG(v + F_G1 + 2);
  }
  I.ocx = ox - I.cx;
  I.ocy = oy - I.cy;
  I.ocz = oz - I.cz;
  I.a = dx * dx + dy * dy + dz * dz;
  I.hb = I.ocx * dx + I.ocy * dy + I.ocz * dz;
  I.r = RT_LDG(v + F_RAD);
  I.cq = (I.ocx * I.ocx + I.ocy * I.ocy + I.ocz * I.ocz) - I.r * I.r;
  const float disc = I.hb * I.hb - I.a * I.cq;
  I.pos = disc > 0.0f;
  I.sq = I.pos ? sqrtf(disc) : 0.0f;
  const float root0 = (-I.hb - I.sq) / I.a;
  const float root1 = (-I.hb + I.sq) / I.a;
  I.use0 = root0 > T_MIN;
  const float t_s = I.use0 ? root0 : root1;

  I.qnx = RT_LDG(v + F_QN);
  I.qny = RT_LDG(v + F_QN + 1);
  I.qnz = RT_LDG(v + F_QN + 2);
  const float den = I.qnx * dx + I.qny * dy + I.qnz * dz;
  I.par = fabsf(den) < PARALLEL_EPS;
  I.sden = I.par ? 1.0f : den;
  I.t_q = (RT_LDG(v + F_QD) - (I.qnx * ox + I.qny * oy + I.qnz * oz)) / I.sden;

  I.ts_ = I.has_id ? (I.is_quad ? I.t_q : t_s) : 0.0f;
  I.px = ox + I.ts_ * dx;
  I.py = oy + I.ts_ * dy;
  I.pz = oz + I.ts_ * dz;
  I.inv_r = 1.0f / (I.r > 0.0f ? I.r : 1.0f);
  I.owx = I.is_quad ? I.qnx : (I.px - I.cx) * I.inv_r;
  I.owy = I.is_quad ? I.qny : (I.py - I.cy) * I.inv_r;
  I.owz = I.is_quad ? I.qnz : (I.pz - I.cz) * I.inv_r;
  const bool front = (dx * I.owx + dy * I.owy + dz * I.owz) < 0.0f;
  I.sgn = front ? 1.0f : -1.0f;
  I.nx = I.sgn * I.owx;
  I.ny = I.sgn * I.owy;
  I.nz = I.sgn * I.owz;

  const float inv_sc = RT_LDG(v + F_INVSC);
  // parity of the cell sum; unsigned adds keep the wrap defined
  const uint32_t cells = (uint32_t)(int)floorf(inv_sc * I.px) +
                         (uint32_t)(int)floorf(inv_sc * I.py) +
                         (uint32_t)(int)floorf(inv_sc * I.pz);
  I.use_even = (cells & 1u) == 0u || RT_LDG(v + F_ISCHK) == 0.0f;
  const int tex = I.use_even ? F_RGB_E : F_RGB_O;
  I.tex_r = RT_LDG(v + tex);
  I.tex_g = RT_LDG(v + tex + 1);
  I.tex_b = RT_LDG(v + tex + 2);

  uint32_t w0 = pix, w1 = smp, w3 = p.seed;
  uint32_t w2 = (uint32_t)b * rt::N_STREAMS + rt::STREAM_SCATTER;
  pcg4d(w0, w1, w2, w3);
  const float zdir = 1.0f - 2.0f * u01(w0);
  const float rho = sqrtf(fmaxf(0.0f, 1.0f - zdir * zdir));
  const float phi = TWO_PI * u01(w1);
  I.rux = rho * cosf(phi);
  I.ruy = rho * sinf(phi);
  I.ruz = zdir;

  // lambertian
  float ldx = I.nx + I.rux, ldy = I.ny + I.ruy, ldz = I.nz + I.ruz;
  if (fabsf(ldx) < NEAR_ZERO_EPS && fabsf(ldy) < NEAR_ZERO_EPS && fabsf(ldz) < NEAR_ZERO_EPS) {
    ldx = I.nx;
    ldy = I.ny;
    ldz = I.nz;
  }
  // metal
  I.ddn = dx * I.nx + dy * I.ny + dz * I.nz;
  I.rfx = dx - 2.0f * I.ddn * I.nx;
  I.rfy = dy - 2.0f * I.ddn * I.ny;
  I.rfz = dz - 2.0f * I.ddn * I.nz;
  I.rlen = sqrtf(I.rfx * I.rfx + I.rfy * I.rfy + I.rfz * I.rfz);
  const float fuzz = RT_LDG(v + F_FUZZ);
  const float mdx = I.rfx / I.rlen + fuzz * I.rux;
  const float mdy = I.rfy / I.rlen + fuzz * I.ruy;
  const float mdz = I.rfz / I.rlen + fuzz * I.ruz;
  const bool metal_ok = (mdx * I.nx + mdy * I.ny + mdz * I.nz) > 0.0f;
  // dielectric
  const float ior = RT_LDG(v + F_IOR);
  I.ri = front ? 1.0f / ior : ior;
  I.dlen = sqrtf(dx * dx + dy * dy + dz * dz);
  I.udx = dx / I.dlen;
  I.udy = dy / I.dlen;
  I.udz = dz / I.dlen;
  const float inner = -(I.udx * I.nx + I.udy * I.ny + I.udz * I.nz);
  I.clip1 = inner < 1.0f;
  I.cost = I.clip1 ? inner : 1.0f;
  const float sint = sqrtf(fmaxf(0.0f, 1.0f - I.cost * I.cost));
  const bool cannot = I.ri * sint > 1.0f;
  const float r0s = (1.0f - I.ri) / (1.0f + I.ri);
  const float r0 = r0s * r0s;
  const float x1 = 1.0f - I.cost;
  const float x2 = x1 * x1;
  const float refl = r0 + (1.0f - r0) * (x1 * (x2 * x2));
  I.usef = cannot || refl > u01(w2);
  I.ppx = I.ri * (I.udx + I.cost * I.nx);
  I.ppy = I.ri * (I.udy + I.cost * I.ny);
  I.ppz = I.ri * (I.udz + I.cost * I.nz);
  I.w = 1.0f - (I.ppx * I.ppx + I.ppy * I.ppy + I.ppz * I.ppz);
  const float k = fabsf(I.w);
  I.kpos = k > 0.0f;
  I.kroot = I.kpos ? sqrtf(k) : 0.0f;
  I.udn = I.udx * I.nx + I.udy * I.ny + I.udz * I.nz;
  float gdx, gdy, gdz;
  if (I.usef) {
    gdx = I.udx - 2.0f * I.udn * I.nx;
    gdy = I.udy - 2.0f * I.udn * I.ny;
    gdz = I.udz - 2.0f * I.udn * I.nz;
  } else {
    gdx = I.ppx - I.kroot * I.nx;
    gdy = I.ppy - I.kroot * I.ny;
    gdz = I.ppz - I.kroot * I.nz;
  }

  const float mtype = RT_LDG(v + F_MTYPE);
  I.is_metal = mtype == 1.0f;
  I.is_diel = mtype == 2.0f;
  const bool is_light = mtype == 3.0f;
  I.ndx = I.is_diel ? gdx : (I.is_metal ? mdx : ldx);
  I.ndy = I.is_diel ? gdy : (I.is_metal ? mdy : ldy);
  I.ndz = I.is_diel ? gdz : (I.is_metal ? mdz : ldz);
  I.att_r = I.is_diel ? 1.0f : I.tex_r;
  I.att_g = I.is_diel ? 1.0f : I.tex_g;
  I.att_b = I.is_diel ? 1.0f : I.tex_b;
  const bool did_scatter = ((I.is_metal && metal_ok) || (!I.is_metal && !is_light)) && !is_light;
  I.miss = !I.has_id;
  I.emit = I.has_id && is_light;
  I.live = I.has_id && did_scatter;
}

// Hand-derived VJP of bounce_fwd (JAX bounce_bwd, op for op). adj holds
// the cotangents of the bounce's outputs (thr r g b, o x y z, d x y z)
// and becomes those of its inputs; g receives the NG field cotangents.
template <bool MOVING>
RT_DEVICE void bounce_bwd(const ReplayParams& p, const Inter& I, const State& s, float tm,
                          float RRr, float RRg, float RRb, float adj[9], float g[NG]) {
  const float TRr = adj[0], TRg = adj[1], TRb = adj[2];
  const float Ox = adj[3], Oy = adj[4], Oz = adj[5];
  const float Dx = adj[6], Dy = adj[7], Dz = adj[8];
  const float ox = s.ox, oy = s.oy, oz = s.oz, dx = s.dx, dy = s.dy, dz = s.dz;
  const bool live = I.live, miss = I.miss, emit = I.emit;
#define W_(m, x) ((m) ? (x) : 0.0f)

  // o' = live ? p : o ; d' = live ? nd : d ; tr' = live ? tr*att : tr
  float pbx = W_(live, Ox), pby = W_(live, Oy), pbz = W_(live, Oz);
  float obx = W_(!live, Ox), oby = W_(!live, Oy), obz = W_(!live, Oz);
  const float ndbx = W_(live, Dx), ndby = W_(live, Dy), ndbz = W_(live, Dz);
  float dbx = W_(!live, Dx), dby = W_(!live, Dy), dbz = W_(!live, Dz);
  const float attbr = W_(live, s.tr * TRr);
  const float attbg = W_(live, s.tg * TRg);
  const float attbb = W_(live, s.tb * TRb);
  float trb = live ? I.att_r * TRr : TRr;
  float tgb = live ? I.att_g * TRg : TRg;
  float tbb = live ? I.att_b * TRb : TRb;
  // emit adds tr*tex ; miss adds tr*bg
  trb = trb + W_(emit, I.tex_r * RRr) + W_(miss, p.bg_r * RRr);
  tgb = tgb + W_(emit, I.tex_g * RRg) + W_(miss, p.bg_g * RRg);
  tbb = tbb + W_(emit, I.tex_b * RRb) + W_(miss, p.bg_b * RRb);
  const float texbr = W_(emit, s.tr * RRr) + W_(!I.is_diel, attbr);
  const float texbg = W_(emit, s.tg * RRg) + W_(!I.is_diel, attbg);
  const float texbb = W_(emit, s.tb * RRb) + W_(!I.is_diel, attbb);
  const bool ue = I.use_even;

  // direction selects
  const bool idie = I.is_diel, mm = !idie && I.is_metal, ll = !idie && !I.is_metal;
  const float gdbx = W_(idie, ndbx), gdby = W_(idie, ndby), gdbz = W_(idie, ndbz);
  const float mdbx = W_(mm, ndbx), mdby = W_(mm, ndby), mdbz = W_(mm, ndbz);
  float nbx = W_(ll, ndbx), nby = W_(ll, ndby), nbz = W_(ll, ndbz);  // lambert: d(ld)/dn = 1

  // metal: md = rf/rlen + fuzz*ru
  const float fuzzb = mdbx * I.rux + mdby * I.ruy + mdbz * I.ruz;
  const float s_md_rf = mdbx * I.rfx + mdby * I.rfy + mdbz * I.rfz;
  const float inv_rl = 1.0f / I.rlen;
  const float inv_rl3 = inv_rl * inv_rl * inv_rl;
  const float rfbx = mdbx * inv_rl - s_md_rf * I.rfx * inv_rl3;
  const float rfby = mdby * inv_rl - s_md_rf * I.rfy * inv_rl3;
  const float rfbz = mdbz * inv_rl - s_md_rf * I.rfz * inv_rl3;
  // rf = d - 2 ddn n
  const float S_rf_n = rfbx * I.nx + rfby * I.ny + rfbz * I.nz;
  dbx = dbx + rfbx - 2.0f * S_rf_n * I.nx;
  dby = dby + rfby - 2.0f * S_rf_n * I.ny;
  dbz = dbz + rfbz - 2.0f * S_rf_n * I.nz;
  nbx = nbx - 2.0f * (dx * S_rf_n + I.ddn * rfbx);
  nby = nby - 2.0f * (dy * S_rf_n + I.ddn * rfby);
  nbz = nbz - 2.0f * (dz * S_rf_n + I.ddn * rfbz);

  // dielectric: gd = usef ? xr : fd
  const float xrbx = W_(I.usef, gdbx), xrby = W_(I.usef, gdby), xrbz = W_(I.usef, gdbz);
  const float fdbx = W_(!I.usef, gdbx), fdby = W_(!I.usef, gdby), fdbz = W_(!I.usef, gdbz);
  // xr = ud - 2 udn n
  const float S_xr_n = xrbx * I.nx + xrby * I.ny + xrbz * I.nz;
  float udbx = 0.0f + xrbx - 2.0f * S_xr_n * I.nx;
  float udby = 0.0f + xrby - 2.0f * S_xr_n * I.ny;
  float udbz = 0.0f + xrbz - 2.0f * S_xr_n * I.nz;
  nbx = nbx - 2.0f * (I.udx * S_xr_n + I.udn * xrbx);
  nby = nby - 2.0f * (I.udy * S_xr_n + I.udn * xrby);
  nbz = nbz - 2.0f * (I.udz * S_xr_n + I.udn * xrbz);
  // fd = pp - kroot n
  float ppbx = fdbx, ppby = fdby, ppbz = fdbz;
  const float krootb = -(fdbx * I.nx + fdby * I.ny + fdbz * I.nz);
  nbx = nbx - I.kroot * fdbx;
  nby = nby - I.kroot * fdby;
  nbz = nbz - I.kroot * fdbz;
  // kroot = kpos ? sqrt|w| : 0
  const float kb = I.kpos ? krootb / (2.0f * (I.kpos ? I.kroot : 1.0f)) : 0.0f;
  const float wb = kb * (I.w >= 0.0f ? 1.0f : -1.0f);
  ppbx = ppbx - 2.0f * wb * I.ppx;
  ppby = ppby - 2.0f * wb * I.ppy;
  ppbz = ppbz - 2.0f * wb * I.ppz;
  // pp = ri (ud + cost n)
  const float ri = I.ri, cost = I.cost;
  const float rib = ppbx * (I.udx + cost * I.nx) + ppby * (I.udy + cost * I.ny) +
                    ppbz * (I.udz + cost * I.nz);
  udbx = udbx + ri * ppbx;
  udby = udby + ri * ppby;
  udbz = udbz + ri * ppbz;
  const float costb = ri * (ppbx * I.nx + ppby * I.ny + ppbz * I.nz);
  nbx = nbx + ri * cost * ppbx;
  nby = nby + ri * cost * ppby;
  nbz = nbz + ri * cost * ppbz;
  // cost = clip1 ? -(ud.n) : 1
  const float cib = I.clip1 ? costb : 0.0f;
  udbx = udbx - cib * I.nx;
  udby = udby - cib * I.ny;
  udbz = udbz - cib * I.nz;
  nbx = nbx - cib * I.udx;
  nby = nby - cib * I.udy;
  nbz = nbz - cib * I.udz;
  // ud = d / dlen
  const float s_ud_d = udbx * dx + udby * dy + udbz * dz;
  const float inv_dl = 1.0f / I.dlen;
  const float inv_dl3 = inv_dl * inv_dl * inv_dl;
  dbx = dbx + udbx * inv_dl - s_ud_d * dx * inv_dl3;
  dby = dby + udby * inv_dl - s_ud_d * dy * inv_dl3;
  dbz = dbz + udbz * inv_dl - s_ud_d * dz * inv_dl3;
  // ri = front ? 1/ior : ior ; d(1/ior)/dior = -ri^2
  const float iorb = rib * (I.sgn > 0.0f ? -(ri * ri) : 1.0f);

  // n = sgn * ow ; ow = is_quad ? qn : (p - c) * inv_r
  const float owbx = I.sgn * nbx, owby = I.sgn * nby, owbz = I.sgn * nbz;
  const bool isq = I.is_quad;
  float qnbx = W_(isq, owbx), qnby = W_(isq, owby), qnbz = W_(isq, owbz);
  pbx = pbx + W_(!isq, owbx * I.inv_r);
  pby = pby + W_(!isq, owby * I.inv_r);
  pbz = pbz + W_(!isq, owbz * I.inv_r);
  float cbx = -W_(!isq, owbx * I.inv_r);
  float cby = -W_(!isq, owby * I.inv_r);
  float cbz = -W_(!isq, owbz * I.inv_r);
  float rb_ = (I.r > 0.0f && !isq) ? -(owbx * I.owx + owby * I.owy + owbz * I.owz) * I.inv_r
                                   : 0.0f;

  // p = o + ts d (the checker floor has zero gradient)
  obx = obx + pbx;
  oby = oby + pby;
  obz = obz + pbz;
  dbx = dbx + I.ts_ * pbx;
  dby = dby + I.ts_ * pby;
  dbz = dbz + I.ts_ * pbz;
  const float tsb = pbx * dx + pby * dy + pbz * dz;
  // ts_ = has_id ? t : 0 ; t = is_quad ? t_q : t_s
  const float tb_ = W_(I.has_id, tsb);
  const float tqb = W_(isq, tb_);
  const float tsb2 = W_(!isq, tb_);
  // t_q = (qd - qn.o) / sden (den cotangents only off the parallel mask)
  const float inv_sd = 1.0f / I.sden;
  const float qdb = tqb * inv_sd;
  const bool not_par = !I.par;
  qnbx = qnbx + tqb * (-ox * inv_sd) + W_(not_par, tqb * (-I.t_q * inv_sd) * dx);
  qnby = qnby + tqb * (-oy * inv_sd) + W_(not_par, tqb * (-I.t_q * inv_sd) * dy);
  qnbz = qnbz + tqb * (-oz * inv_sd) + W_(not_par, tqb * (-I.t_q * inv_sd) * dz);
  obx = obx + tqb * (-I.qnx * inv_sd);
  oby = oby + tqb * (-I.qny * inv_sd);
  obz = obz + tqb * (-I.qnz * inv_sd);
  dbx = dbx + W_(not_par, tqb * (-I.t_q * inv_sd) * I.qnx);
  dby = dby + W_(not_par, tqb * (-I.t_q * inv_sd) * I.qny);
  dbz = dbz + W_(not_par, tqb * (-I.t_q * inv_sd) * I.qnz);
  // t_s = (-hb + sg*sq)/a with sg = use0 ? -1 : +1
  const float a = I.a;
  const float inv_a = 1.0f / a;
  const float sg = I.use0 ? -1.0f : 1.0f;
  const float t_s = I.use0 ? (-I.hb - I.sq) * inv_a : (-I.hb + I.sq) * inv_a;
  const float sqb = tsb2 * sg * inv_a;
  float hbb = -tsb2 * inv_a;
  float ab = -tsb2 * t_s * inv_a;
  // sq = pos ? sqrt(disc) : 0
  const float discb = I.pos ? sqb / (2.0f * (I.pos ? I.sq : 1.0f)) : 0.0f;
  // disc = hb^2 - a*cq
  hbb = hbb + 2.0f * I.hb * discb;
  ab = ab - I.cq * discb;
  const float cqb = -a * discb;
  // cq = oc.oc - r^2
  float ocbx = 2.0f * cqb * I.ocx;
  float ocby = 2.0f * cqb * I.ocy;
  float ocbz = 2.0f * cqb * I.ocz;
  rb_ = rb_ - 2.0f * I.r * cqb;
  // hb = oc.d
  ocbx = ocbx + hbb * dx;
  ocby = ocby + hbb * dy;
  ocbz = ocbz + hbb * dz;
  dbx = dbx + hbb * I.ocx;
  dby = dby + hbb * I.ocy;
  dbz = dbz + hbb * I.ocz;
  // a = d.d
  dbx = dbx + 2.0f * ab * dx;
  dby = dby + 2.0f * ab * dy;
  dbz = dbz + 2.0f * ab * dz;
  // oc = o - c(tm)
  obx = obx + ocbx;
  oby = oby + ocby;
  obz = obz + ocbz;
  cbx = cbx - ocbx;
  cby = cby - ocby;
  cbz = cbz - ocbz;

  g[G_C] = cbx;
  g[G_C + 1] = cby;
  g[G_C + 2] = cbz;
  // c = c0 + tm*v; a static scene's velocity gets no cotangent
  g[G_V] = MOVING ? tm * cbx : 0.0f;
  g[G_V + 1] = MOVING ? tm * cby : 0.0f;
  g[G_V + 2] = MOVING ? tm * cbz : 0.0f;
  g[G_R] = rb_;
  g[G_QN] = qnbx;
  g[G_QN + 1] = qnby;
  g[G_QN + 2] = qnbz;
  g[G_QD] = qdb;
  g[G_FUZZ] = fuzzb;
  g[G_IOR] = iorb;
  g[G_ER] = W_(ue, texbr);
  g[G_ER + 1] = W_(ue, texbg);
  g[G_ER + 2] = W_(ue, texbb);
  g[G_OR] = W_(!ue, texbr);
  g[G_OR + 1] = W_(!ue, texbg);
  g[G_OR + 2] = W_(!ue, texbb);
#undef W_
  adj[0] = trb;
  adj[1] = tgb;
  adj[2] = tbb;
  adj[3] = obx;
  adj[4] = oby;
  adj[5] = obz;
  adj[6] = dbx;
  adj[7] = dby;
  adj[8] = dbz;
}

static_assert(NG >= 9, "K2 stashes a bounce's 9-float State in its NG output rows");

// K2's stash: bounce b's entry state in rows 0-8 of its output g[b, :, i]
// (`row` = g + b * NG * n + i, `stride` = n).
RT_DEVICE void stash_store(float* row, size_t stride, const State& s) {
  row[0] = s.ox;
  row[stride] = s.oy;
  row[2 * stride] = s.oz;
  row[3 * stride] = s.dx;
  row[4 * stride] = s.dy;
  row[5 * stride] = s.dz;
  row[6 * stride] = s.tr;
  row[7 * stride] = s.tg;
  row[8 * stride] = s.tb;
}

RT_DEVICE State stash_load(const float* row, size_t stride) {
  return State{row[0],          row[stride],     row[2 * stride],
               row[3 * stride], row[4 * stride], row[5 * stride],
               row[6 * stride], row[7 * stride], row[8 * stride]};
}

// The state after a live bounce.
RT_DEVICE void advance(const Inter& I, State& s) {
  s.tr = s.tr * I.att_r;
  s.tg = s.tg * I.att_g;
  s.tb = s.tb * I.att_b;
  s.ox = I.px;
  s.oy = I.py;
  s.oz = I.pz;
  s.dx = I.ndx;
  s.dy = I.ndy;
  s.dz = I.ndz;
}

struct Ray {
  State s;
  float tm;
  bool active;
  uint32_t pix, smp;
  int nb;  // bounces this ray's tile runs
};

RT_DEVICE Ray load_ray(const ReplayParams& p, int i) {
  const int n = p.n;
  const float* rf = p.ray_f;
  Ray r;
  r.s = State{rf[RX * n + i], rf[RY * n + i], rf[RZ * n + i], rf[RDX * n + i],
              rf[RDY * n + i], rf[RDZ * n + i], 1.0f, 1.0f, 1.0f};
  r.tm = rf[RTM * n + i];
  r.active = rf[RACT * n + i] > 0.5f;
  r.pix = (uint32_t)p.ray_i[i];
  r.smp = (uint32_t)p.ray_i[n + i];
  const int ml = p.maxlen[i / TILE];
  r.nb = ml < p.D ? ml : p.D;
  return r;
}

// K3's per-ray state between bounces.
struct FwdLane {
  Ray ray;
  float rr, rg, rb;  // radiance so far
  int bc;            // bounces run
};

RT_DEVICE void fwd_start(const ReplayParams& p, int i, FwdLane& l) {
  l.ray = load_ray(p, i);
  l.rr = l.rg = l.rb = 0.0f;
  l.bc = 0;
}

// Whether ray l has a bounce left to run (its bounce index is l.bc).
RT_DEVICE bool fwd_running(const FwdLane& l) { return l.bc < l.ray.nb && l.ray.active; }

// The recorded id of ray i at bounce b.
RT_DEVICE int recorded_id(const ReplayParams& p, int i, int b) {
  return p.ids[(size_t)b * p.n + i];
}

// K3: one replayed bounce of ray i, whose recorded id is `id`.
template <bool MOVING>
RT_DEVICE void fwd_step(const ReplayParams& p, int id, FwdLane& l) {
  const int b = l.bc++;
  State& s = l.ray.s;
  Inter I;
  bounce_fwd<MOVING>(p, id, s, l.ray.tm, l.ray.pix, l.ray.smp, b, I);
  if (I.miss) {
    l.rr = l.rr + s.tr * p.bg_r;
    l.rg = l.rg + s.tg * p.bg_g;
    l.rb = l.rb + s.tb * p.bg_b;
  }
  if (I.emit) {
    l.rr = l.rr + s.tr * I.tex_r;
    l.rg = l.rg + s.tg * I.tex_g;
    l.rb = l.rb + s.tb * I.tex_b;
  }
  if (I.live)
    advance(I, s);
  else
    l.ray.active = false;
}

RT_DEVICE void fwd_finish(const ReplayParams& p, int i, const FwdLane& l) {
  const int n = p.n;
  p.out_rad[i] = l.rr;
  p.out_rad[n + i] = l.rg;
  p.out_rad[2 * n + i] = l.rb;
  p.out_bc[i] = l.bc;
}

// K3: replay ray i forward.
template <bool MOVING>
RT_DEVICE void replay_fwd_ray(const ReplayParams& p, int i) {
  FwdLane l;
  fwd_start(p, i, l);
  while (fwd_running(l)) fwd_step<MOVING>(p, recorded_id(p, i, l.bc), l);
  fwd_finish(p, i, l);
}

// K2: replay ray i forward, stashing each bounce's entry state in its
// output rows, then the reverse sweep.
template <bool MOVING>
RT_DEVICE void replay_bwd_ray(const ReplayParams& p, int i) {
  const int n = p.n;
  Ray ray = load_ray(p, i);
  float* out = p.out_g + i;
  const size_t stride = (size_t)n;
  const size_t bounce = (size_t)NG * stride;  // from one bounce's rows to the next's
  int n_run = 0;  // bounces the ray entered alive
  {
    State s = ray.s;
    for (int b = 0; b < ray.nb && ray.active; ++b) {
      stash_store(out + (size_t)b * bounce, stride, s);
      n_run = b + 1;
      Inter I;
      bounce_fwd<MOVING>(p, p.ids[(size_t)b * n + i], s, ray.tm, ray.pix, ray.smp, b, I);
      if (I.live)
        advance(I, s);
      else
        ray.active = false;
    }
  }
  const float RRr = p.rad_bar[i], RRg = p.rad_bar[n + i], RRb = p.rad_bar[2 * n + i];
  float adj[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int b = p.D - 1; b >= n_run; --b)
    for (int k = 0; k < NG; ++k) out[(size_t)b * bounce + k * stride] = 0.0f;
  for (int b = n_run - 1; b >= 0; --b) {
    float* row = out + (size_t)b * bounce;
    const State s = stash_load(row, stride);
    Inter I;
    bounce_fwd<MOVING>(p, p.ids[(size_t)b * n + i], s, ray.tm, ray.pix, ray.smp, b, I);
    float g[NG];
    bounce_bwd<MOVING>(p, I, s, ray.tm, RRr, RRg, RRb, adj, g);
    for (int k = 0; k < NG; ++k) row[k * stride] = g[k];
  }
}

#ifdef __CUDACC__

constexpr int THREADS = 128;
// K3's resident blocks per SM (at most as many as fit). Measured on the
// bench chunk in camera order at depth 20: 6 (0.083 ms), 4 and as many as
// fit (8: 0.089); waiting for 8 free lanes before a refill gained nothing.
constexpr int K3_BLOCKS_PER_SM = 6;
constexpr unsigned FULL = 0xffffffffu;

// K3's measurement counters: bounces run (lanes summed over issues) and
// bounce issues, one per warp and bounce, from its lowest active lane.
__device__ __forceinline__ void count_bounce(unsigned long long* stats) {
  const unsigned a = __activemask();
  if ((threadIdx.x & 31) == __ffs(a) - 1) {
    atomicAdd(stats, (unsigned long long)__popc(a));
    atomicAdd(stats + 1, 1ull);
  }
}

// K3. REFILL: persistent warps whose lanes refill: a lane whose ray dies
// or reaches its tile's bounce count writes that ray and takes the next
// index from `next` (one atomicAdd per warp and refill, for all its free
// lanes), so a warp no longer waits for its longest ray with its other
// lanes idle. Not REFILL: the design before, one thread per ray, a warp
// running until its longest ray ends. Each ray's arithmetic is the same
// in both, so are its outputs. COUNT: the measurement instantiation,
// which ticks `stats` at every bounce.
template <bool MOVING, bool REFILL, bool COUNT>
__global__ void __launch_bounds__(THREADS)
    k3_replay_fwd(const ReplayParams p, int* next, unsigned long long* stats) {
  if (!REFILL) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= p.n) return;
    FwdLane l;
    fwd_start(p, i, l);
    while (fwd_running(l)) {
      if (COUNT) count_bounce(stats);
      fwd_step<MOVING>(p, recorded_id(p, i, l.bc), l);
    }
    fwd_finish(p, i, l);
    return;
  }
  const int lane = threadIdx.x & 31;
  int i = -1;  // this lane's ray; -1: none; >= n: no rays left
  int id = 0;  // its next bounce's recorded id, loaded a bounce ahead
  FwdLane l;
  while (true) {
    const bool free = i < 0;
    const unsigned want = __ballot_sync(FULL, free);
    if (want) {
      const int first = __ffs(want) - 1;
      int base = 0;
      if (lane == first) base = atomicAdd(next, __popc(want));
      base = __shfl_sync(FULL, base, first);
      if (free) {
        i = base + __popc(want & ((1u << lane) - 1u));
        if (i < p.n) {
          fwd_start(p, i, l);
          if (fwd_running(l)) id = recorded_id(p, i, l.bc);
        }
      }
    }
    if (__all_sync(FULL, i >= p.n)) return;
    if (i < p.n) {
      if (fwd_running(l)) {
        if (COUNT) count_bounce(stats);
        const int cur = id;  // the next load overlaps this bounce's arithmetic
        if (l.bc + 1 < l.ray.nb) id = recorded_id(p, i, l.bc + 1);
        fwd_step<MOVING>(p, cur, l);
      }
      if (!fwd_running(l)) {
        fwd_finish(p, i, l);
        i = -1;
      }
    }
  }
}

template <bool MOVING>
__global__ void __launch_bounds__(THREADS) k2_replay_bwd(const ReplayParams p) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < p.n) replay_bwd_ray<MOVING>(p, i);
}

// K3's persistent grid: K3_BLOCKS_PER_SM blocks on every SM, or as many as fit.
template <bool MOVING, bool COUNT>
int k3_refill_grid() {
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k3_replay_fwd<MOVING, true, COUNT>,
                                                  THREADS, 0);
    if (K3_BLOCKS_PER_SM < per_sm) per_sm = K3_BLOCKS_PER_SM;
    grid = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return grid;
}

template <bool MOVING, bool REFILL, bool COUNT>
void launch_k3(const ReplayParams& p, int* next, unsigned long long* stats, cudaStream_t s) {
  int grid = (p.n + THREADS - 1) / THREADS;
  if (REFILL) {
    const int most = k3_refill_grid<MOVING, COUNT>();
    grid = grid < most ? grid : most;
  }
  k3_replay_fwd<MOVING, REFILL, COUNT><<<grid, THREADS, 0, s>>>(p, next, stats);
}

}  // namespace

// C entry points (loaded with ctypes). Each launches on `stream`,
// allocates nothing, does not synchronize, and returns a cudaError_t.
// `next` is one int the caller zeroes on `stream` (K3's ray counter).
extern "C" int rt_replay_fwd(const float* table, const int* ids, const float* ray_f,
                             const int* ray_i, const int* maxlen, int n, int D, int n_sph,
                             int moving, uint32_t seed, float bg_r, float bg_g, float bg_b,
                             float* out_rad, int* out_bc, int* next, void* stream) {
  if (n <= 0) return 0;
  const ReplayParams p{table, ids,  ray_f, ray_i, maxlen,  nullptr, n,      D,
                       n_sph, seed, bg_r,  bg_g,  bg_b,    out_rad, out_bc, nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (moving)
    launch_k3<true, true, false>(p, next, nullptr, s);
  else
    launch_k3<false, true, false>(p, next, nullptr, s);
  return (int)cudaGetLastError();
}

// K3's measurement probe: `refill` 0 runs the design before the refill
// (one thread per ray), 1 K3's; with `stats` (two zeroed u64) the counting
// instantiation, which adds the bounces run and the bounce issues.
extern "C" int rt_replay_fwd_probe(const float* table, const int* ids, const float* ray_f,
                                   const int* ray_i, const int* maxlen, int n, int D, int n_sph,
                                   int moving, uint32_t seed, float bg_r, float bg_g, float bg_b,
                                   float* out_rad, int* out_bc, int* next, int refill,
                                   unsigned long long* stats, void* stream) {
  if (n <= 0) return 0;
  const ReplayParams p{table, ids,  ray_f, ray_i, maxlen,  nullptr, n,      D,
                       n_sph, seed, bg_r,  bg_g,  bg_b,    out_rad, out_bc, nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = (moving ? 4 : 0) + (refill ? 2 : 0) + (stats ? 1 : 0);
  switch (k) {
    case 0: launch_k3<false, false, false>(p, next, stats, s); break;
    case 1: launch_k3<false, false, true>(p, next, stats, s); break;
    case 2: launch_k3<false, true, false>(p, next, stats, s); break;
    case 3: launch_k3<false, true, true>(p, next, stats, s); break;
    case 4: launch_k3<true, false, false>(p, next, stats, s); break;
    case 5: launch_k3<true, false, true>(p, next, stats, s); break;
    case 6: launch_k3<true, true, false>(p, next, stats, s); break;
    default: launch_k3<true, true, true>(p, next, stats, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_replay_bwd(const float* table, const int* ids, const float* ray_f,
                             const int* ray_i, const int* maxlen, const float* rad_bar, int n,
                             int D, int n_sph, int moving, uint32_t seed, float bg_r, float bg_g,
                             float bg_b, float* out_g, void* stream) {
  if (n <= 0) return 0;
  const ReplayParams p{table, ids,  ray_f, ray_i, maxlen,  rad_bar, n,       D,
                       n_sph, seed, bg_r,  bg_g,  bg_b,    nullptr, nullptr, out_g};
  const dim3 grid((n + THREADS - 1) / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (moving)
    k2_replay_bwd<true><<<grid, THREADS, 0, s>>>(p);
  else
    k2_replay_bwd<false><<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

#else
}  // namespace
#endif
