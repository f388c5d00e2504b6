// Shared by the port's CUDA kernels (megakernel_block.cu, replay_kernel.cu):
// the host/device macros and the PCG4D hash with its unit-float map, so
// every kernel draws from one copy of the generator.
//
// Without __CUDACC__ the same code compiles as plain C++, so a host build
// can exercise the kernels' per-ray arithmetic.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RT_DEVICE __device__ __forceinline__
#define RT_LDG(p) __ldg(p)
#else
#include <math.h>
struct float4 { float x, y, z, w; };
#define RT_DEVICE static inline
#define RT_LDG(p) (*(p))
#endif

namespace rt {

constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float INV_2_24 = 1.0f / 16777216.0f;
constexpr uint32_t N_STREAMS = 4u;       // core/rng.py N_STREAMS
constexpr uint32_t STREAM_SCATTER = 2u;  // core/rng.py STREAM_SCATTER
constexpr uint32_t STREAM_MEDIUM = 3u;   // core/rng.py STREAM_MEDIUM: lane k, medium k

// PCG4D (Jarzynski & Olano 2020), bit-exact with core/rng.py pcg4d.
RT_DEVICE void pcg4d(uint32_t& v0, uint32_t& v1, uint32_t& v2, uint32_t& v3) {
  v0 = v0 * 1664525u + 1013904223u;
  v1 = v1 * 1664525u + 1013904223u;
  v2 = v2 * 1664525u + 1013904223u;
  v3 = v3 * 1664525u + 1013904223u;
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
  v0 ^= v0 >> 16;
  v1 ^= v1 >> 16;
  v2 ^= v2 >> 16;
  v3 ^= v3 >> 16;
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
}

// u32 -> f32 uniform in [0, 1) from the top 24 bits (core/rng.py to_unit_float)
RT_DEVICE float u01(uint32_t v) { return (float)(int)(v >> 8) * INV_2_24; }

}  // namespace rt
