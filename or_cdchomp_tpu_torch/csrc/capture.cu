// The nodes of the CUDA graph a stream is capturing, for the step's phase
// map (chomp/solver.py StepGraph, utils/profiling.py NodeMap).
//
// No kernel and no graph node: the host reads the graph under capture
// (cudaStreamGetCaptureInfo; every operation but destroy and node removal
// is permitted on it while the capture runs) at each phase's edges.
//
// cdx_capture_nodes(stream, kinds, cap, count):
//   count <- the graph's nodes so far.  With kinds non-null, also one
//   letter per node in creation order (up to cap): 'k' kernel, 'c' memcpy,
//   's' memset (what a profiler reports of a replay), '-' any other; and
//   the nodes must form one chain in that order (node i's only dependency
//   is node i - 1), which is the order a replay runs them in.
// Returns 0, a CUDA error code, -1 if the stream is not capturing, or -2
// if the nodes are not one chain in creation order.

#include <cuda_runtime.h>

#include <vector>

namespace {

char kind_of(cudaGraphNodeType t) {
  switch (t) {
    case cudaGraphNodeTypeKernel: return 'k';
    case cudaGraphNodeTypeMemcpy: return 'c';
    case cudaGraphNodeTypeMemset: return 's';
    default: return '-';
  }
}

cudaError_t dependencies(cudaGraphNode_t node, cudaGraphNode_t* deps,
                         size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaGraphNodeGetDependencies(node, deps, nullptr, n);
#else
  return cudaGraphNodeGetDependencies(node, deps, n);
#endif
}

}  // namespace

extern "C" int cdx_capture_nodes(void* stream, char* kinds, long long cap,
                                 long long* count) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &id, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) return -1;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  *count = static_cast<long long>(n);
  if (kinds == nullptr) return 0;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool chain = true;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (static_cast<long long>(i) < cap) kinds[i] = kind_of(t);
    size_t nd = 0;
    err = dependencies(nodes[i], nullptr, &nd);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (i == 0) {
      chain = chain && nd == 0;
    } else if (nd != 1) {
      chain = false;
    } else {
      cudaGraphNode_t dep = nullptr;
      err = dependencies(nodes[i], &dep, &nd);
      if (err != cudaSuccess) return static_cast<int>(err);
      chain = chain && dep == nodes[i - 1];
    }
  }
  return chain ? 0 : -2;
}
