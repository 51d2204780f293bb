// A plain C interface over the CUDA runtime's conditional graph nodes: the
// port's counterpart of lax.while_loop / lax.cond around the Krylov loops
// (exsaddle_tpu/treeops.py:289, :416-431; exsaddle_tpu/abf.py:1165).
//
// torch.cuda.CUDAGraph has no method for a conditional node, so
// graphs.ControlGraph builds the solve's graph here: a root graph, one
// WHILE or IF node per loop (its body graph owned by the node), and the
// captured pieces of device work added into those bodies as child-graph
// nodes, chained in order. A conditional node reads its handle when it
// runs; the Krylov control kernels (krylov_ctl.cu) set the handles with
// cudaGraphSetConditional. Graphs, nodes, handles and streams are driver
// objects, so the values torch hands out (raw_cuda_graph, cuda_stream) are
// used as they are.
//
// Every function returns its cudaError_t (0 on success); the Python wrapper
// raises on anything else.

#include <cuda_runtime.h>

#include <cstring>

extern "C" {

int gc_versions(int* runtime, int* driver) {
  cudaError_t e = cudaRuntimeGetVersion(runtime);
  if (e != cudaSuccess) return e;
  return cudaDriverGetVersion(driver);
}

int gc_graph_create(void** graph) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  *graph = g;
  return e;
}

// A handle for a conditional node that `graph` will hold; its value is
// reset to default_value at every launch (cudaGraphCondAssignDefault).
int gc_handle_create(void* graph, unsigned long long* handle,
                     unsigned int default_value) {
  cudaGraphConditionalHandle h = 0;
  cudaError_t e = cudaGraphConditionalHandleCreate(
      &h, static_cast<cudaGraph_t>(graph), default_value,
      cudaGraphCondAssignDefault);
  *handle = h;
  return e;
}

// A WHILE (is_while 1) or IF (0) node in `graph`, no dependencies yet;
// *body is its body graph, owned by the node.
int gc_add_conditional(void* graph, unsigned long long handle, int is_while,
                       void** node, void** body) {
  // the params' union has no default constructor: zeroed raw storage
  alignas(cudaGraphNodeParams) unsigned char raw[sizeof(cudaGraphNodeParams)];
  std::memset(raw, 0, sizeof(raw));
  cudaGraphNodeParams* p = reinterpret_cast<cudaGraphNodeParams*>(raw);
  p->type = cudaGraphNodeTypeConditional;
  p->conditional.handle = handle;
  p->conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p->conditional.size = 1;
  cudaGraphNode_t n = nullptr;
  cudaError_t e = cudaGraphAddNode(&n, static_cast<cudaGraph_t>(graph),
                                   nullptr, 0, p);
  *node = n;
  *body = (e == cudaSuccess) ? p->conditional.phGraph_out[0] : nullptr;
  return e;
}

// `child` (a captured piece) cloned into `graph` as a child-graph node.
int gc_add_child(void* graph, void* child, void** node) {
  cudaGraphNode_t n = nullptr;
  cudaError_t e = cudaGraphAddChildGraphNode(
      &n, static_cast<cudaGraph_t>(graph), nullptr, 0,
      static_cast<cudaGraph_t>(child));
  *node = n;
  return e;
}

// An edge: `to` runs after `from` (both nodes of `graph`).
int gc_add_edge(void* graph, void* from, void* to) {
  cudaGraphNode_t f = static_cast<cudaGraphNode_t>(from);
  cudaGraphNode_t t = static_cast<cudaGraphNode_t>(to);
  return cudaGraphAddDependencies(static_cast<cudaGraph_t>(graph), &f, &t, 1);
}

int gc_instantiate(void* graph, int device, void** exec) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaGraphExec_t x = nullptr;
  e = cudaGraphInstantiate(&x, static_cast<cudaGraph_t>(graph), 0);
  *exec = x;
  return e;
}

int gc_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

int gc_exec_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

int gc_graph_destroy(void* graph) {
  return cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
}

// The kernel nodes of a graph (torch's raw_cuda_graph of a capture):
// the kernel launches the captured work makes.
int gc_kernel_nodes(void* graph, unsigned long long* count) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return e;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n > 0 ? n : 1];
  e = cudaGraphGetNodes(g, nodes, &n);
  unsigned long long k = 0;
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e == cudaSuccess && t == cudaGraphNodeTypeKernel) ++k;
  }
  delete[] nodes;
  if (e == cudaSuccess) *count = k;
  return e;
}

const char* gc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
