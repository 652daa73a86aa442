// A CUDA graph conditional IF node opened while a stream is capturing: the
// work captured on the child stream between ndcn_graph_if_begin and
// ndcn_graph_if_end runs at a replay only when the 0-dim bool tensor `pred`
// holds true at that point of the replay. The solver's bounded solve puts
// each step attempt behind one (ode/graph_gate.py), so that a replay skips
// the kernels of an attempt that is frozen.
//
// Begin: a one-thread kernel captured on the parent stream copies *pred into
// the node's condition; the IF node is added after it, becomes the parent
// stream's only capture dependency (what the parent captures next waits for
// the node), and the child stream starts capturing into the node's body
// graph. End: the child stream's capture ends (the body graph is the node's
// own; nothing is instantiated here).

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

int capture_info(cudaStream_t stream, cudaGraph_t* graph,
                 const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? 0 : static_cast<int>(cudaErrorStreamCaptureInvalidated);
}

}  // namespace

// parent: the capturing stream; pred: device pointer to one bool; child: an
// idle stream that captures the body until ndcn_graph_if_end; mode: the
// cudaStreamCaptureMode of the child's capture. Returns a cudaError_t.
extern "C" int ndcn_graph_if_begin(const void* pred, void* parent, void* child,
                                   int mode) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  int err = capture_info(ps, &graph, &deps, &n_deps);
  if (err != 0) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition_kernel<<<1, 1, 0, ps>>>(handle,
                                        static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the setter kernel is now the parent's dependency
  err = capture_info(ps, &graph, &deps, &n_deps);
  if (err != 0) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, static_cast<cudaStreamCaptureMode>(mode));
}

extern "C" int ndcn_graph_if_end(void* child) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body);
}
