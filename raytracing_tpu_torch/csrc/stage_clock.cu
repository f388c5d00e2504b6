// The stage clock: device time of the named stages of a render or sweep
// step, measured on the device inside captured CUDA graphs and WHILE bodies
// (utils/profiling.py stage).
//
// Replaces no Pallas kernel: the JAX package reads its stage times from the
// TPU profiler. On the card, torch.profiler sees the kernels of a replayed
// graph by name only (PyTorch's glue kernels are generic ATen kernels, the
// same names for camera rays, compaction and sorts) and sees no kernel
// inside a graph's WHILE node at all. A stage is bracketed by two launches
// of a one-thread kernel that reads %globaltimer (the device's nanosecond
// clock, common to all SMs): the begin mark stores the time, the end mark
// adds the time since to the stage's total and one to its calls. It is a
// kernel and not an event record because a conditional (WHILE) body takes
// kernel nodes but no event nodes, and because the totals add up on the
// device over any number of replays, read once by the host at the end.
//
// What bounds it: neither bytes nor operations. A mark is one thread that
// reads a clock and writes 8-16 bytes; its cost is a node's launch latency
// in the stream or graph, twice a stage call (PERF.md gives the measured
// cost of a mark pair). The stages do not nest, so each mark is ordered
// after the stage's work by the stream alone.
//
// Layout of the int64 clock buffer, n = the number of stages:
// [0, n) the begin time of each stage, [n, 2n) its total ns, [2n, 3n) its
// calls.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void rt_stage_mark(long long* clock, int n_stages, int stage, int end) {
  long long now = (long long)globaltimer();
  if (end) {
    clock[n_stages + stage] += now - clock[stage];
    clock[2 * n_stages + stage] += 1;
  } else {
    clock[stage] = now;
  }
}

// One thread reads %globaltimer `n` times in a row: out[0] the reads that
// saw a new value, out[1] the smallest step between two values, out[2] the
// largest, out[3] the time from the first read to the last.
__global__ void rt_globaltimer_probe(long long* out, int n) {
  unsigned long long first = globaltimer(), last = first;
  long long changes = 0, lo = 0, hi = 0;
  for (int k = 1; k < n; ++k) {
    unsigned long long t = globaltimer();
    if (t != last) {
      long long step = (long long)(t - last);
      lo = changes == 0 || step < lo ? step : lo;
      hi = step > hi ? step : hi;
      ++changes;
      last = t;
    }
  }
  out[0] = changes;
  out[1] = lo;
  out[2] = hi;
  out[3] = (long long)(last - first);
}

}  // namespace

// C entry points (loaded with ctypes). Each returns a cudaError_t.
//
// rt_stage_mark_launch: the begin (end = 0) or end (end = 1) mark of stage
// `stage` of the n_stages-stage clock at `clock` (3 * n_stages int64 on the
// device), launched on `stream`; does not synchronize.
extern "C" int rt_stage_mark_launch(void* clock, int n_stages, int stage, int end,
                                    void* stream) {
  rt_stage_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(clock), n_stages, stage, end);
  return (int)cudaGetLastError();
}

// rt_globaltimer_probe_launch: the probe above into `out` (4 int64 on the
// device), launched on `stream`.
extern "C" int rt_globaltimer_probe_launch(void* out, int n, void* stream) {
  rt_globaltimer_probe<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), n);
  return (int)cudaGetLastError();
}

// rt_graph_kernel_nodes: the kernel nodes of the captured graph `graph` (a
// cudaGraph_t) in *n_kernels, and in *n_marks those among them that launch
// rt_stage_mark. Launches nothing.
extern "C" int rt_graph_kernel_nodes(void* graph, int* n_kernels, int* n_marks) {
  *n_kernels = *n_marks = 0;
  size_t n = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n > 0 ? n : 1];
  err = cudaGraphGetNodes(g, nodes, &n);
  for (size_t k = 0; err == cudaSuccess && k < n; ++k) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[k], &type);
    if (err != cudaSuccess || type != cudaGraphNodeTypeKernel) continue;
    ++*n_kernels;
    cudaKernelNodeParams p;
    // a kernel of another library (PyTorch's) may not resolve to a
    // function of this one: such a node is a kernel, not a mark
    if (cudaGraphKernelNodeGetParams(nodes[k], &p) == cudaSuccess &&
        p.func == reinterpret_cast<void*>(rt_stage_mark))
      ++*n_marks;
    cudaGetLastError();
  }
  delete[] nodes;
  return (int)err;
}
