// Conditional (IF) nodes for the serving loop's CUDA graphs, for Hopper (sm_90a).
//
// The JAX engine's pipelined policy step is one compiled program with two
// `lax.cond`s (`streamspeech_tpu/runtime/session.py` policy_core: decode or
// skip, emit or not). A CUDA graph branches only through a conditional node,
// which PyTorch's Python API exposes only from a release later than some
// installations carry. This source builds the node through the CUDA runtime: `runtime/graphs.py` captures the program as a chain of segments,
// each an ordinary PyTorch capture into the engine's graph pool, and
// `graph_cond_compose` assembles them, in order, into one graph whose IF
// segments sit in the body of a conditional node. In front of each such node
// runs `set_if_kernel`, one thread that reads the segment's predicate (one
// bool on the device, written by the segment before it) and sets the node's
// condition with `cudaGraphSetConditional`. A body that is not taken costs
// the one-thread kernel and the node; nothing is read on the host.
//
// It replaces no TPU kernel (Pallas has no counterpart: `lax.cond` is an XLA
// control-flow op). What bounds it: launch latency, one thread a node.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps,
                     size_t n_deps, cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, n_deps, params);
#else
  return cudaGraphAddNode(node, graph, deps, n_deps, params);
#endif
}

}  // namespace

// Assemble `n` captured graphs into one, in order. kinds[i] == 0: graphs[i]
// runs as a child graph; kinds[i] == 1: graphs[i] is the body of an IF node
// taken when the bool at preds[i] (device memory) is true at that point of
// the run. The graphs are cloned; the caller keeps their memory alive while
// the result lives. A graph that captured no node is left out (an IF body
// too, with no node and no setter). Writes the assembled graph, its
// executable and the IF nodes it holds; returns the cudaError_t code.
extern "C" int graph_cond_compose(int n, const int* kinds, void* const* graphs,
                                  void* const* preds, void** graph_out, void** exec_out,
                                  int* if_nodes_out) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int if_nodes = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t prev = nullptr;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    cudaGraph_t child = static_cast<cudaGraph_t>(graphs[i]);
    const cudaGraphNode_t* deps = prev ? &prev : nullptr;
    const size_t n_deps = prev ? 1 : 0;
    cudaGraphNode_t node = nullptr;
    size_t n_nodes = 0;
    err = cudaGraphGetNodes(child, nullptr, &n_nodes);
    if (err != cudaSuccess) break;
    if (n_nodes == 0) continue;  // a segment that captured nothing (e.g. a cond ended the part)
    if (kinds[i] == 0) {
      err = cudaGraphAddChildGraphNode(&node, graph, deps, n_deps, child);
    } else {
      cudaGraphConditionalHandle handle;
      err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
      if (err != cudaSuccess) break;
      const bool* pred = static_cast<const bool*>(preds[i]);
      void* args[] = {&handle, &pred};
      cudaKernelNodeParams kp = {};
      kp.func = reinterpret_cast<void*>(set_if_kernel);
      kp.gridDim = dim3(1);
      kp.blockDim = dim3(1);
      kp.kernelParams = args;
      cudaGraphNode_t setter = nullptr;
      err = cudaGraphAddKernelNode(&setter, graph, deps, n_deps, &kp);
      if (err != cudaSuccess) break;
      cudaGraphNodeParams cp = {};
      cp.type = cudaGraphNodeTypeConditional;
      cp.conditional.handle = handle;
      cp.conditional.type = cudaGraphCondTypeIf;
      cp.conditional.size = 1;
      err = add_node(&node, graph, &setter, 1, &cp);
      if (err != cudaSuccess) break;
      cudaGraphNode_t inner = nullptr;
      err = cudaGraphAddChildGraphNode(&inner, cp.conditional.phGraph_out[0], nullptr, 0,
                                       child);
      ++if_nodes;
    }
    prev = node;
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(graph);
    return (int)err;
  }
  *graph_out = graph;
  *exec_out = exec;
  *if_nodes_out = if_nodes;
  return (int)cudaSuccess;
}

// Launch an assembled graph on `stream`, without synchronising.
extern "C" int graph_cond_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                              static_cast<cudaStream_t>(stream));
}

// Free an assembled graph and its executable.
extern "C" int graph_cond_destroy(void* graph, void* exec) {
  cudaError_t a = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  cudaError_t b = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return (int)(a != cudaSuccess ? a : b);
}
