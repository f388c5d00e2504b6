// A device-side WHILE loop around a captured CUDA graph: the regenerating
// pool's single dispatch (render/graphs.py WhileProgram, render/pool.py).
//
// Replaces no Pallas kernel. The JAX package runs each sample window of its
// pool as one compiled lax.while_loop (raytracing_tpu/render/pool.py
// trace_pool, raytracing_tpu/render/renderer.py _render_pool): XLA tests the
// loop's condition on the device. PyTorch captures one iteration of the
// port's pool as a CUDA graph (torch.cuda.CUDAGraph(keep_graph=True)); this
// file wraps that graph in a conditional WHILE node (CUDA 12.3+), so that a
// whole window runs as one graph launch and the host reads nothing until
// the image is copied at the end:
//
//   [set the condition from *flag] -> WHILE(handle) { [body] -> [set the
//   condition from *flag] }
//
// The first set-condition node tests the flag before the first iteration,
// as lax.while_loop tests its condition before its first body. The body is
// the captured graph added as a child graph node (a clone). The body writes
// the loop's condition into the one-byte device flag (a 0-d torch.bool), and
// the node after it copies the flag into the conditional handle.
//
// What bounds it: neither bytes nor operations. The set-condition kernel is
// one thread that reads one byte; its cost is a node's launch latency, once
// an iteration. The body's kernels (K1 and PyTorch's sorts, gathers and
// camera rays) are the work.
//
// A conditional body takes only kernel, memset, memcpy, empty, child-graph
// and conditional nodes, so the captured body has to come from one stream
// with PyTorch's native caching allocator (no event or allocation nodes);
// a body with other nodes is refused here, by cudaGraphAddChildGraphNode or
// cudaGraphInstantiate, and the caller raises. The graph and the stream
// come from PyTorch (its own CUDA runtime); they are driver objects, shared
// with this library's runtime on the device's primary context, as every
// kernel launch of this library already shares PyTorch's streams.
#include <cuda_runtime.h>

#include <cstring>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t add_set_condition(cudaGraphNode_t* node, cudaGraph_t graph,
                              const cudaGraphNode_t* deps, size_t n_deps,
                              cudaGraphConditionalHandle handle, const bool* flag) {
  void* args[] = {&handle, &flag};
  cudaKernelNodeParams kp;
  std::memset(&kp, 0, sizeof(kp));
  kp.func = reinterpret_cast<void*>(set_condition);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &kp);
}

cudaError_t build(cudaGraph_t graph, cudaGraph_t body, const bool* flag) {
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t first;
  err = add_set_condition(&first, graph, nullptr, 0, handle, flag);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams cp = {cudaGraphNodeTypeConditional};
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&loop, graph, &first, nullptr, 1, &cp);
#else
  err = cudaGraphAddNode(&loop, graph, &first, 1, &cp);
#endif
  if (err != cudaSuccess) return err;
  cudaGraph_t inner = cp.conditional.phGraph_out[0];

  cudaGraphNode_t step;
  err = cudaGraphAddChildGraphNode(&step, inner, nullptr, 0, body);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t again;
  return add_set_condition(&again, inner, &step, 1, handle, flag);
}

}  // namespace

// C entry points (loaded with ctypes). Each returns a cudaError_t.
//
// rt_while_build: an executable graph that runs `body` (a cudaGraph_t, which
// it clones) while the device byte `flag` is nonzero, testing it first.
// Writes the executable graph to `*exec_out`. Launches nothing.
extern "C" int rt_while_build(void* body, const void* flag, void** exec_out) {
  *exec_out = nullptr;
  cudaGraph_t graph;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return (int)err;
  err = build(graph, static_cast<cudaGraph_t>(body), static_cast<const bool*>(flag));
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  cudaGraphDestroy(graph);
  if (err != cudaSuccess) return (int)err;
  *exec_out = exec;
  return 0;
}

// rt_while_launch: one launch of the loop on `stream`; does not synchronize.
extern "C" int rt_while_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                              static_cast<cudaStream_t>(stream));
}

// rt_while_destroy: frees the executable graph (a launch in flight completes).
extern "C" int rt_while_destroy(void* exec) {
  return (int)cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}
