// Camera rays: render/camera.py generate_rays as one device function, so a
// kernel computes a lane's camera ray where it uses it, from the lane's
// (pixel, sample) ids, the render seed and the packed camera
// (render/camera.py pack_camera). K1 starts its first phase from it
// (megakernel_block.cu, TraceParams::camera) and rt_camera_rays writes the
// gradient replay's packed rays with it (camera_rays.cu).
//
// Bit-equal to generate_rays on CUDA tensors: PyTorch runs every multiply
// and add there as its own kernel, so each rounds on its own here too
// (__fmul_rn and __fadd_rn, which nvcc never contracts into an FMA), in
// generate_rays' order; sqrtf, sinf and cosf are CUDA's own without fast
// math, as PyTorch's kernels call them; 2*pi is the float32 that
// `(2.0 * math.pi) * u` multiplies by (rt::TWO_PI).
//
// Without __CUDACC__ the same code compiles as plain C++ (rt_common.cuh);
// built with -ffp-contract=off it is bit-equal to generate_rays on CPU
// tensors without defocus, and within an ulp or two of it with defocus,
// where the host's sqrtf, sinf and cosf may differ from PyTorch's.
#pragma once

#include "rt_common.cuh"

namespace rt {

constexpr uint32_t STREAM_RAYGEN = 0u;  // core/rng.py STREAM_RAYGEN
constexpr uint32_t STREAM_TIME = 1u;    // core/rng.py STREAM_TIME

// the packed camera's floats (render/camera.py pack_camera), three each
enum { CAM_P00 = 0, CAM_DU = 3, CAM_DV = 6, CAM_CENTER = 9, CAM_DDU = 12, CAM_DDV = 15,
       CAMERA_F = 18 };
// camera flags (render/camera.py CameraStart.flags)
constexpr int CAMERA_DEFOCUS = 1;  // origins on the defocus disk
constexpr int CAMERA_MOTION = 2;   // ray times drawn from STREAM_TIME, else 0

#ifdef __CUDACC__
RT_DEVICE float mul_rn(float a, float b) { return __fmul_rn(a, b); }
RT_DEVICE float add_rn(float a, float b) { return __fadd_rn(a, b); }
RT_DEVICE float sub_rn(float a, float b) { return __fsub_rn(a, b); }
#else
RT_DEVICE float mul_rn(float a, float b) { return a * b; }
RT_DEVICE float add_rn(float a, float b) { return a + b; }
RT_DEVICE float sub_rn(float a, float b) { return a - b; }
#endif

struct CameraRay {
  float ox, oy, oz, dx, dy, dz, tm;
};

// a + s * u + t * v on one axis, in generate_rays' order
RT_DEVICE float cam_axis(const float* cam, int a, int u, int v, float s, float t, int k) {
  return add_rn(add_rn(RT_LDG(cam + a + k), mul_rn(s, RT_LDG(cam + u + k))),
                mul_rn(t, RT_LDG(cam + v + k)));
}

// The camera ray of (pix, smp): AA jitter from STREAM_RAYGEN's first two
// draws, the defocus disk from its last two, the time from STREAM_TIME's
// first; the direction is left unnormalized.
RT_DEVICE CameraRay camera_ray(uint32_t pix, uint32_t smp, uint32_t seed, const float* cam,
                               uint32_t width, int flags) {
  const float i = (float)(int)(pix % width);
  const float j = (float)(int)(pix / width);
  uint32_t v0 = pix, v1 = smp, v2 = STREAM_RAYGEN, v3 = seed;
  pcg4d(v0, v1, v2, v3);
  const float su = add_rn(i, sub_rn(u01(v0), 0.5f));
  const float sv = add_rn(j, sub_rn(u01(v1), 0.5f));
  const float px = cam_axis(cam, CAM_P00, CAM_DU, CAM_DV, su, sv, 0);
  const float py = cam_axis(cam, CAM_P00, CAM_DU, CAM_DV, su, sv, 1);
  const float pz = cam_axis(cam, CAM_P00, CAM_DU, CAM_DV, su, sv, 2);
  CameraRay r;
  if (flags & CAMERA_DEFOCUS) {
    const float rad = sqrtf(u01(v2));
    const float theta = mul_rn(TWO_PI, u01(v3));
    const float ddx = mul_rn(rad, cosf(theta));
    const float ddy = mul_rn(rad, sinf(theta));
    r.ox = cam_axis(cam, CAM_CENTER, CAM_DDU, CAM_DDV, ddx, ddy, 0);
    r.oy = cam_axis(cam, CAM_CENTER, CAM_DDU, CAM_DDV, ddx, ddy, 1);
    r.oz = cam_axis(cam, CAM_CENTER, CAM_DDU, CAM_DDV, ddx, ddy, 2);
  } else {
    r.ox = RT_LDG(cam + CAM_CENTER);
    r.oy = RT_LDG(cam + CAM_CENTER + 1);
    r.oz = RT_LDG(cam + CAM_CENTER + 2);
  }
  r.dx = sub_rn(px, r.ox);
  r.dy = sub_rn(py, r.oy);
  r.dz = sub_rn(pz, r.oz);
  r.tm = 0.0f;
  if (flags & CAMERA_MOTION) {
    uint32_t w0 = pix, w1 = smp, w2 = STREAM_TIME, w3 = seed;
    pcg4d(w0, w1, w2, w3);
    r.tm = u01(w0);
  }
  return r;
}

}  // namespace rt
