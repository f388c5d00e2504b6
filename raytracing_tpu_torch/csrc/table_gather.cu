// K4, the per-ray table gather, in CUDA C++ for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel raytracing_tpu/ops/table_gather.py
// _pallas_gather (the forward of table_lookup). Given a packed (L, F) f32
// table and one i32 id per ray, it clips each id into [0, L-1] and writes
// the id's row field-major, out[f * B + i] = table[id_i * F + f], so that
// each field of every ray is one contiguous row of the (F, B) output.
//
// What bounds it: bytes. Per ray it reads a 4-byte id and writes F floats;
// the table itself is small (the bench's 512 x 23 table is 47 KB, the
// 4,224-row table of a 4,100-sphere scene 389 KB) and is read from the
// L1/L2 caches after its first touch. At the fwd+bwd chunk (B = 360,448,
// F = 23) the output is 33 MB, ~0.01 ms at 3.35 TB/s.
//
// What the design does about it: one thread per ray. A thread loads its
// id, clips it and reads its row through the read-only cache (__ldg); the
// stores of field f by consecutive threads land on consecutive addresses,
// so every warp's store is one coalesced 128-byte transaction per field.
// The TPU kernel replicated each field over 8 sublanes and looped over
// 128-lane table chunks because a TPU lane gather reaches only 128 lanes;
// a GPU thread reads any address, so none of that is kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    k4_table_gather(const float* __restrict__ table, const int* __restrict__ ids, int L, int F,
                    int B, float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B) return;
  int id = __ldg(ids + i);
  id = id < 0 ? 0 : (id > L - 1 ? L - 1 : id);
  const float* row = table + (size_t)id * F;
  for (int f = 0; f < F; ++f) out[(size_t)f * B + i] = __ldg(row + f);
}

}  // namespace

extern "C" int rt_table_gather(const float* table, const int* ids, int L, int F, int B,
                               float* out, void* stream) {
  if (B <= 0 || F <= 0) return 0;
  if (L <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + THREADS - 1) / THREADS);
  k4_table_gather<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(table, ids, L, F,
                                                                            B, out);
  return (int)cudaGetLastError();
}
