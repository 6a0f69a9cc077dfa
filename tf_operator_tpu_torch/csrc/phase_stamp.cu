// Device phase stamps of the training step (telemetry/phases.py), and the
// graph-node queries that count a captured step's operations by phase.
//
// Replaces no TPU kernel: the JAX trainer's step is one XLA program, and its
// phases show only in a profiler's trace. The port's step replays one CUDA
// graph, whose thousands of kernels carry one correlation id and share their
// names between phases (an elementwise kernel of AdamW and of the MLM head
// look alike), so the step marks its phase boundaries itself, on the device.
//
// tpujob_phase_stamp is one thread that writes %globaltimer (ns) into a ring
// of int64 laid out as [1 + slots x marks]: element 0 counts the steps whose
// last stamp ran, and row `count % slots` (from element 1 on) is the step in
// progress. The step's first stamp (mark 0) clears the rest of its row, so a
// mark that a step does not reach reads 0; the last stamp advances the count.
// Captured into the step's graph, every replay fills the next row with no
// host read, event or sync; the host copies the ring when it chooses. Bound:
// one launch (a few microseconds at most, a handful of bytes).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void tpujob_phase_stamp(long long* ring, int mark, int marks, int slots,
                                   int advance) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long step = ring[0];
  long long* row = ring + 1 + (step % slots) * marks;
  if (mark == 0) {
    for (int m = 1; m < marks; ++m) row[m] = 0;
  }
  row[mark] = static_cast<long long>(now);
  if (advance) ring[0] = step + 1;
}

// The stream's capture state after a launch: while it captures, the node the
// next operation will depend on, which is the launch just recorded.
static CUresult last_captured(CUstream s, CUgraphNode* node) {
  CUstreamCaptureStatus status;
  cuuint64_t id;
  CUgraph graph;
  const CUgraphNode* deps = nullptr;
  size_t n = 0;
#if CUDA_VERSION >= 13000
  CUresult rc = cuStreamGetCaptureInfo(s, &status, &id, &graph, &deps, nullptr, &n);
#else
  CUresult rc = cuStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &n);
#endif
  *node = nullptr;
  if (rc == CUDA_SUCCESS && status == CU_STREAM_CAPTURE_STATUS_ACTIVE && n == 1) {
    *node = deps[0];
  }
  return rc;
}

// Launch one stamp on `stream`; with `node` non-null, also return the graph
// node the launch became while the stream captures (null otherwise).
// Returns 0, a cudaError_t of the launch, or 100000 + a CUresult of the query.
extern "C" int tpujob_phase_stamp_launch(void* ring, int mark, int marks, int slots,
                                         int advance, void* stream, void** node) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tpujob_phase_stamp<<<1, 1, 0, s>>>(static_cast<long long*>(ring), mark, marks, slots,
                                     advance);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (node == nullptr) return 0;
  CUgraphNode captured;
  CUresult rc = last_captured(reinterpret_cast<CUstream>(s), &captured);
  *node = reinterpret_cast<void*>(captured);
  return rc == CUDA_SUCCESS ? 0 : 100000 + static_cast<int>(rc);
}

// The numbers of nodes and edges of a captured graph (torch.cuda.CUDAGraph's
// raw_cuda_graph(), kept with keep_graph=True). Returns a CUresult.
extern "C" int tpujob_graph_size(void* graph, size_t* n_nodes, size_t* n_edges) {
  CUgraph g = static_cast<CUgraph>(graph);
  CUresult rc = cuGraphGetNodes(g, nullptr, n_nodes);
  if (rc != CUDA_SUCCESS) return static_cast<int>(rc);
#if CUDA_VERSION >= 13000
  rc = cuGraphGetEdges(g, nullptr, nullptr, nullptr, n_edges);
#else
  rc = cuGraphGetEdges(g, nullptr, nullptr, n_edges);
#endif
  return static_cast<int>(rc);
}

// The graph's nodes with their CUgraphNodeType, and its edges (from[i] ->
// to[i]: to[i] depends on from[i]), into arrays of the sizes
// tpujob_graph_size gave. Returns a CUresult.
extern "C" int tpujob_graph_read(void* graph, void** nodes, int* types, size_t n_nodes,
                                 void** from, void** to, size_t n_edges) {
  CUgraph g = static_cast<CUgraph>(graph);
  size_t n = n_nodes;
  CUresult rc = cuGraphGetNodes(g, reinterpret_cast<CUgraphNode*>(nodes), &n);
  if (rc != CUDA_SUCCESS) return static_cast<int>(rc);
  for (size_t i = 0; i < n; ++i) {
    CUgraphNodeType t;
    rc = cuGraphNodeGetType(static_cast<CUgraphNode>(nodes[i]), &t);
    if (rc != CUDA_SUCCESS) return static_cast<int>(rc);
    types[i] = static_cast<int>(t);
  }
  size_t e = n_edges;
#if CUDA_VERSION >= 13000
  rc = cuGraphGetEdges(g, reinterpret_cast<CUgraphNode*>(from),
                       reinterpret_cast<CUgraphNode*>(to), nullptr, &e);
#else
  rc = cuGraphGetEdges(g, reinterpret_cast<CUgraphNode*>(from),
                       reinterpret_cast<CUgraphNode*>(to), &e);
#endif
  return static_cast<int>(rc);
}
