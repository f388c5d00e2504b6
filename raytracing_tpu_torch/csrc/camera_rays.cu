// The gradient replay's camera rays in one launch, in CUDA C++ for Hopper
// (sm_90a). It replaces no TPU kernel: the JAX package regenerates the
// replay's rays with XLA's elementwise ops, and the port ran
// render/camera.py generate_rays (about 250 int64 PyTorch kernels for the
// PCG4D hash and the packing) before it.
//
// Given the replay's (2, n) i32 ids in its sorted order (rows pix smp) and
// each ray's alive flag, it writes diff/replay_kernel.py pack_replay_rays'
// (8, n) f32 layout (rows ox oy oz dx dy dz tm act) directly, the rays
// from rt::camera_ray (rt_camera.cuh), bit-equal to generate_rays. K2
// reads that layout unchanged.
//
// What bounds it: bytes, 8 B of ids and a flag in and 32 B out a ray
// (cell 4's chunk of 3,244,032 rays: 133 MB, 0.04 ms at 3.35 TB/s); the
// arithmetic is two PCG4D hashes and about 40 flops. One thread a ray;
// consecutive threads read and write consecutive addresses, so every
// warp's row access is one coalesced transaction.

#include "rt_camera.cuh"

#ifdef __CUDACC__

namespace {

constexpr int CAMERA_THREADS = 256;

__global__ void __launch_bounds__(CAMERA_THREADS)
    camera_rays(const int* __restrict__ ray_i, const unsigned char* __restrict__ alive, int n,
                const float* __restrict__ camera, uint32_t width, int flags, uint32_t seed,
                float* __restrict__ out) {
  const int i = blockIdx.x * CAMERA_THREADS + threadIdx.x;
  if (i >= n) return;
  const rt::CameraRay r = rt::camera_ray((uint32_t)__ldg(ray_i + i),
                                         (uint32_t)__ldg(ray_i + n + i), seed, camera, width,
                                         flags);
  out[i] = r.ox;
  out[n + i] = r.oy;
  out[2 * n + i] = r.oz;
  out[3 * n + i] = r.dx;
  out[4 * n + i] = r.dy;
  out[5 * n + i] = r.dz;
  out[6 * n + i] = r.tm;
  out[7 * n + i] = (!alive || __ldg(alive + i) != 0) ? 1.0f : 0.0f;
}

}  // namespace

// The camera rays of the n rays with ids ray_i (2, n) as out (8, n);
// alive (n,) or null (every ray alive). Launches on `stream`, allocates
// nothing and does not synchronize. Returns a cudaError_t.
extern "C" int rt_camera_rays(const int* ray_i, const unsigned char* alive, int n,
                              const float* camera, uint32_t width, int flags, uint32_t seed,
                              float* out, void* stream) {
  if (n <= 0) return 0;
  if (width == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + CAMERA_THREADS - 1) / CAMERA_THREADS);
  camera_rays<<<grid, CAMERA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ray_i, alive, n, camera, width, flags, seed, out);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
