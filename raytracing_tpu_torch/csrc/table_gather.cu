// K4, the per-ray table gather, and its backward, the table fold, in CUDA
// C++ for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel raytracing_tpu/ops/table_gather.py
// _pallas_gather (the forward of table_lookup). Given a packed (L, F) f32
// table and one i32 id per ray, it clips each id into [0, L-1] and writes
// the id's row field-major, out[f * B + i] = table[id_i * F + f], so that
// each field of every ray is one contiguous row of the (F, B) output. The
// JAX package takes the backward as a one-hot matmul outside Pallas
// (raytracing_tpu/ops/table_gather.py _lookup_bwd); here it is a kernel of
// its own, the fold (below), which also folds the replay's per-bounce
// cotangents (diff/replay_kernel.py reduce_table_grads).
//
// K4 forward. What bounds it: bytes. Per ray it reads a 4-byte id and
// writes F floats; the table is small (the bench's 512 x 23 table is 47 KB,
// the 4,224-row table of a 4,100-sphere scene 389 KB) and is read from the
// L1/L2 caches after its first touch. At the fwd+bwd chunk (B = 360,448,
// F = 23) the output is 33 MB, ~0.01 ms at 3.35 TB/s. What the design does
// about it: one thread per ray; a thread loads its id, clips it and reads
// its row through the read-only cache (__ldg); the stores of field f by
// consecutive threads land on consecutive addresses, so every warp's store
// is one coalesced 128-byte transaction per field, and they are streaming
// stores (__stcs: the output is written once here and not read back by this
// kernel). Measured on the card against this design (device time, launches
// queued behind a spin kernel): 4 rays a thread with 16-byte id loads and
// float4 stores, the table staged field-major in shared memory and a grid
// of one block per SM took 0.0146 ms at L = 512 against 0.0123 (this
// design already reaches 84% of its bound there) and 0.027 against 0.018
// at L = 4,224; 2 rays a thread with float2 stores 0.0117 and 0.0225; the
// streaming stores 0.0116 and 0.0176. The TPU kernel replicated each field
// over 8 sublanes and looped over 128-lane table chunks because a TPU lane
// gather reaches only 128 lanes; a GPU thread reads any address, so none of
// that is kept.
//
// The fold. tbar[clip(ids[b, i], 0, L-1), f] += g[b, f, i] for f < F and
// i < P[b], over the bounces b < D of a (D, F, n) cotangent (D = 1 for the
// lookup's backward). What bounds it: bytes, the cotangent read once
// (360,448 x 23 x 4 = 33 MB a lookup, ~0.01 ms). What held index_add_ back
// was contention: misses and dead rays (id -1, clipped to row 0) and the
// ground sphere (row 0 too) send most of the adds to the same 23 addresses.
// What the design does about it:
// (a) a ray whose F cotangents are all exactly zero adds nothing, and a
//     zero field is not added (exact: the sums start at +0.0 and no sum
//     becomes -0.0, so adding +-0.0 changes none);
// (b) the lanes of a warp that share a row are found with
//     __match_any_sync and summed by shuffles, so a row gets one add per
//     field per warp;
// (c) a table that fits (L * FP * 4 <= FOLD_SMEM, FP = F rounded up to 4)
//     is accumulated in a block-private copy in shared memory by the group
//     leaders' atomicAdd (a compare-and-swap loop on this card, SASS
//     ATOMS.CAST.SPIN: ~10 of the fold's 32 us at L = 512; global atomics
//     alone took 78), and flushed once per block with 16-byte vector
//     atomics to the (L, FP) output;
// (d) a larger table takes the warp-merged adds straight to the output as
//     16-byte vector atomics (atomicAdd on float4, sm_90);
// (e) a persistent grid of FOLD_BLOCKS_PER_SM blocks per SM walks the
//     warp tiles of all D bounces, so one launch covers a chunk of up to
//     FOLD_MAX_D bounces (their prefixes ride in the launch parameters);
//     the wrapper folds a deeper chunk in windows of FOLD_MAX_D bounces,
//     one launch each, all adding into the same output.
// The order of the adds within a row is not fixed (atomics), as with
// index_add_; results agree to float32 reassociation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATHER_THREADS = 256;
constexpr int FOLD_THREADS = 256;
constexpr int FOLD_SMEM = 96 * 1024;    // largest table the fold keeps in shared memory
constexpr int FOLD_BLOCKS_PER_SM = 8;   // at L = 512: 0.0325 ms; 4: 0.036, 2 (512 threads): 0.036-0.040
constexpr int FOLD_MAX_D = 64;          // bounces of one launch; deeper replays fold in windows
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clip_id(int id, int L) {
  return id < 0 ? 0 : (id > L - 1 ? L - 1 : id);
}

__global__ void __launch_bounds__(GATHER_THREADS)
    k4_table_gather(const float* __restrict__ table, const int* __restrict__ ids, int L, int F,
                    int B, float* __restrict__ out) {
  const int i = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (i >= B) return;
  const int id = clip_id(__ldg(ids + i), L);
  const float* row = table + (size_t)id * F;
  for (int f = 0; f < F; ++f) __stcs(out + (size_t)f * B + i, __ldg(row + f));
}

struct FoldParams {
  const float* g;  // (D, F, n)
  const int* ids;  // (D, n)
  int L, F, n, D;
  int P[FOLD_MAX_D];         // rays counted per bounce
  int tile0[FOLD_MAX_D + 1]; // first warp tile of each bounce (tiles of 32 rays)
  float* out;                // (L, FP), zeroed by the caller
};

// A 16-byte vector atomic add to global memory (sm_90; the result unused,
// so it compiles to a reduction, RED.E.ADD.F32x4).
__device__ __forceinline__ void red_v4(float* addr, float a, float b, float c, float d) {
  atomicAdd(reinterpret_cast<float4*>(addr), make_float4(a, b, c, d));
}

// FV = FP / 4 float4 groups of fields a ray carries.
template <int FV, bool SMEM>
__global__ void __launch_bounds__(FOLD_THREADS) k4_table_fold(const FoldParams p) {
  constexpr int FP = 4 * FV;
  extern __shared__ float s_acc[];  // (L, FP) when SMEM
  __shared__ int s_P[FOLD_MAX_D], s_tile0[FOLD_MAX_D + 1];
  if (threadIdx.x < FOLD_MAX_D) s_P[threadIdx.x] = p.P[threadIdx.x];
  if (threadIdx.x <= FOLD_MAX_D) s_tile0[threadIdx.x] = p.tile0[threadIdx.x];
  if (SMEM)
    for (int k = threadIdx.x; k < p.L * FP; k += blockDim.x) s_acc[k] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int tiles = s_tile0[p.D];
  int b = 0;
  for (int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); t < tiles; t += warps) {
    while (t >= s_tile0[b + 1]) ++b;  // a warp's tiles ascend
    const int i = (t - s_tile0[b]) * 32 + lane;
    const bool in = i < s_P[b];
    float x[FP];
    bool nz = false;
#pragma unroll
    for (int f = 0; f < FP; ++f) {
      x[f] = (in && f < p.F) ? __ldg(p.g + ((size_t)b * p.F + f) * p.n + i) : 0.0f;
      nz |= x[f] != 0.0f;
    }
    const unsigned act = __ballot_sync(FULL, nz);
    if (act == 0u) continue;
    const int id = nz ? clip_id(__ldg(p.ids + (size_t)b * p.n + i), p.L) : -1 - lane;
    // (b): sum the lanes that share a row by a shuffle tree; the lowest
    // lane of each group ends with the group's sum
    const unsigned peers = __match_any_sync(FULL, id);
    const bool leader = lane == __ffs(peers) - 1;
    unsigned rest = peers & (0xfffffffeu << lane);  // peers above this lane
    unsigned pos = __popc(peers & ((1u << lane) - 1u));
    while (__any_sync(FULL, rest != 0u)) {
      const int next = __ffs(rest);  // 1 + the lowest remaining higher peer, or 0
#pragma unroll
      for (int f = 0; f < FP; ++f) {
        const float v = __shfl_sync(FULL, x[f], (next - 1) & 31);
        if (next) x[f] += v;
      }
      rest &= ~__ballot_sync(FULL, pos & 1u);
      pos >>= 1;
    }
    if (!(nz && leader)) continue;
    if (SMEM) {
      float* row = s_acc + id * FP;
#pragma unroll
      for (int f = 0; f < FP; ++f)
        if (x[f] != 0.0f) atomicAdd(row + f, x[f]);
    } else {
      float* row = p.out + (size_t)id * FP;
#pragma unroll
      for (int v = 0; v < FV; ++v) {
        const float* q = x + 4 * v;
        if (q[0] != 0.0f || q[1] != 0.0f || q[2] != 0.0f || q[3] != 0.0f)
          red_v4(row + 4 * v, q[0], q[1], q[2], q[3]);
      }
    }
  }
  if (SMEM) {  // flush the block's table
    __syncthreads();
    for (int k = threadIdx.x; k < p.L * FV; k += blockDim.x) {
      const float4 q = reinterpret_cast<const float4*>(s_acc)[k];
      if (q.x != 0.0f || q.y != 0.0f || q.z != 0.0f || q.w != 0.0f)
        red_v4(p.out + 4 * (size_t)k, q.x, q.y, q.z, q.w);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

// Lets `kernel` take up to `bytes` of dynamic shared memory (beyond the
// default 48 KB less its static shared memory); once per instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

template <int FV>
int launch_fold(const FoldParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)p.L * 4 * FV * sizeof(float);
  constexpr int WARPS = FOLD_THREADS / 32;
  const int need = (p.tile0[p.D] + WARPS - 1) / WARPS;
  const int blocks = sm_count() * FOLD_BLOCKS_PER_SM;
  const int grid = need < blocks ? need : blocks;
  if (grid <= 0) return 0;
  if (smem <= FOLD_SMEM) {
    static bool allowed = false;
    const cudaError_t e = allow_smem(k4_table_fold<FV, true>, FOLD_SMEM, allowed);
    if (e != cudaSuccess) return (int)e;
    k4_table_fold<FV, true><<<grid, FOLD_THREADS, smem, stream>>>(p);
  } else {
    k4_table_fold<FV, false><<<grid, FOLD_THREADS, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_table_gather(const float* table, const int* ids, int L, int F, int B,
                               float* out, void* stream) {
  if (B <= 0 || F <= 0) return 0;
  if (L <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + GATHER_THREADS - 1) / GATHER_THREADS);
  k4_table_gather<<<grid, GATHER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(table, ids, L,
                                                                                  F, B, out);
  return (int)cudaGetLastError();
}

// The fold: out (L, FP) += the cotangents g (D, F, n) of rays i < P[b] at
// rows clip(ids[b, i], 0, L - 1); FP = F rounded up to a multiple of 4 (the
// pad columns stay zero). `prefixes` is a host array of D ints; one
// launch takes D <= FOLD_MAX_D bounces (the size of its parameter arrays).
extern "C" int rt_table_fold(const float* g, const int* ids, const int* prefixes, int L, int F,
                             int n, int D, float* out, void* stream) {
  if (n <= 0 || D <= 0 || F <= 0) return 0;
  if (L <= 0 || D > FOLD_MAX_D || F > 32 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  FoldParams p{};
  p.g = g;
  p.ids = ids;
  p.L = L;
  p.F = F;
  p.n = n;
  p.D = D;
  p.out = out;
  p.tile0[0] = 0;
  for (int b = 0; b < D; ++b) {
    const int P = prefixes[b] < 0 ? 0 : (prefixes[b] > n ? n : prefixes[b]);
    p.P[b] = P;
    p.tile0[b + 1] = p.tile0[b] + (P + 31) / 32;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((F + 3) / 4) {
    case 1: return launch_fold<1>(p, s);
    case 2: return launch_fold<2>(p, s);
    case 3: return launch_fold<3>(p, s);
    case 4: return launch_fold<4>(p, s);
    case 5: return launch_fold<5>(p, s);
    case 6: return launch_fold<6>(p, s);
    case 7: return launch_fold<7>(p, s);
    default: return launch_fold<8>(p, s);
  }
}
