// The ICP loop's condition on the device, and the one graph per scan that
// runs the loop there: the counterpart of the JAX step's lax.while_loop
// (lidar_odometry_demo_tpu/ops/icp.py:267-283 and :332). Not the port of a
// TPU kernel: the JAX loop's `cond` function, as a kernel.
//
// - loop_condition_kernel: from the loop's carry (rounds run `iters`, rounds
//   without improvement `stall`, the last step norm), each lane's condition
//       i < max_outer & (step_norm >= tol | i <= min_outer - 1)
//         & stall < stall_exit,
//   written to `go` (over lanes the round's `active` mask), and "any lane
//   goes" set as the value of a graph's conditional handle. Each time some
//   lane goes, a round total on the device is counted up (the host reads it
//   only when it reads the kernels' launch counters).
// - loop_graph_build: a graph of the condition kernel, then a conditional
//   WHILE node whose body is the round's graph (a child graph node) followed
//   by the condition kernel, then the scan's tail graph (a child graph
//   node), instantiated: `while cond(carry): body`, then the tail, in one
//   graph launch. The round and tail graphs are captured by the caller;
//   their nodes address memory the caller keeps alive.
//
// One block serves every lane (a step's lanes are few): each thread
// evaluates its lanes, __syncthreads_or takes the "any", thread 0 sets the
// handle. A conditional node needs CUDA 12.4 or later (a WHILE node whose
// body holds child graphs, copies and memsets).

#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "the ICP loop's WHILE node needs CUDA 12.4 or later"
#endif

namespace {

constexpr int kThreads = 128;

struct Carry {
  const int* iters;
  const int* stall;
  const float* step_norm;  // at lane stride norm_stride (a view of K2's workspace)
  int norm_stride;
  unsigned char* go;       // (lanes,) bool
  int lanes;
  int max_outer;
  int min_outer;
  int stall_exit;
  float tol;
  unsigned long long* rounds;  // the round total, or nullptr
};

__global__ void __launch_bounds__(kThreads)
loop_condition_kernel(Carry c, cudaGraphConditionalHandle handle, int set_handle) {
  int any = 0;
  for (int b = threadIdx.x; b < c.lanes; b += kThreads) {
    const int i = c.iters[b];
    const bool not_converged = c.step_norm[(long long)b * c.norm_stride] >= c.tol
                               || i <= c.min_outer - 1;
    const bool go = i < c.max_outer && not_converged && c.stall[b] < c.stall_exit;
    c.go[b] = go;
    any |= go;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    if (set_handle) cudaGraphSetConditional(handle, any ? 1u : 0u);
    if (any && c.rounds != nullptr) *c.rounds += 1;
  }
}

Carry make_carry(const void* iters, const void* stall, const void* step_norm, int norm_stride,
                 void* go, int lanes, int max_outer, int min_outer, int stall_exit, float tol,
                 void* rounds) {
  return Carry{(const int*)iters, (const int*)stall, (const float*)step_norm, norm_stride,
               (unsigned char*)go, lanes, max_outer, min_outer, stall_exit, tol,
               (unsigned long long*)rounds};
}

// The condition kernel as a node of `graph` after `dep` (none when nullptr).
cudaError_t add_condition(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                          Carry* carry, cudaGraphConditionalHandle* handle) {
  int set_handle = 1;
  void* args[] = {carry, handle, &set_handle};
  cudaKernelNodeParams p = {};
  p.func = (void*)loop_condition_kernel;
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(kThreads, 1, 1);
  p.kernelParams = args;
  return cudaGraphAddKernelNode(node, graph, dep, dep ? 1 : 0, &p);
}

}  // namespace

// The condition alone, outside any graph (its check against the plain
// version): go written, the round total counted where `rounds` is given.
extern "C" int loop_condition_launch(const void* iters, const void* stall, const void* step_norm,
                                     int norm_stride, void* go, int lanes, int max_outer,
                                     int min_outer, int stall_exit, float tol, void* rounds,
                                     void* stream) {
  const Carry c = make_carry(iters, stall, step_norm, norm_stride, go, lanes, max_outer,
                             min_outer, stall_exit, tol, rounds);
  loop_condition_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(c, 0, 0);
  return (int)cudaGetLastError();
}

#define LOOP_CHECK(call)              \
  do {                                \
    err = (call);                     \
    if (err != cudaSuccess) goto done; \
  } while (0)

// The scan's loop and tail as one instantiated graph, written to *exec_out:
// condition; WHILE (any lane goes) { round graph; condition }; tail graph.
// round_graph and tail_graph are cudaGraph_t (cloned into the new graph);
// the carry pointers are those the round graph reads and writes.
extern "C" int loop_graph_build(void* round_graph, void* tail_graph, const void* iters,
                                const void* stall, const void* step_norm, int norm_stride,
                                void* go, int lanes, int max_outer, int min_outer,
                                int stall_exit, float tol, void* rounds, void** exec_out) {
  cudaError_t err = cudaSuccess;
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphConditionalHandle handle = 0;
  cudaGraphNode_t first = nullptr, loop = nullptr, body_round = nullptr, body_cond = nullptr,
                  tail = nullptr;
  cudaGraph_t body = nullptr;
  Carry carry = make_carry(iters, stall, step_norm, norm_stride, go, lanes, max_outer,
                           min_outer, stall_exit, tol, rounds);
  cudaGraphNodeParams cond = {};
  LOOP_CHECK(cudaGraphCreate(&graph, 0));
  LOOP_CHECK(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
  LOOP_CHECK(add_condition(&first, graph, nullptr, &carry, &handle));
  cond.type = cudaGraphNodeTypeConditional;
  cond.conditional.handle = handle;
  cond.conditional.type = cudaGraphCondTypeWhile;
  cond.conditional.size = 1;
#if CUDART_VERSION >= 13000
  LOOP_CHECK(cudaGraphAddNode(&loop, graph, &first, nullptr, 1, &cond));
#else
  LOOP_CHECK(cudaGraphAddNode(&loop, graph, &first, 1, &cond));
#endif
  body = cond.conditional.phGraph_out[0];
  LOOP_CHECK(cudaGraphAddChildGraphNode(&body_round, body, nullptr, 0, (cudaGraph_t)round_graph));
  LOOP_CHECK(add_condition(&body_cond, body, &body_round, &carry, &handle));
  LOOP_CHECK(cudaGraphAddChildGraphNode(&tail, graph, &loop, 1, (cudaGraph_t)tail_graph));
  LOOP_CHECK(cudaGraphInstantiate(&exec, graph, 0));
  *exec_out = exec;
done:
  if (graph != nullptr) cudaGraphDestroy(graph);
  return (int)err;
}

#undef LOOP_CHECK

extern "C" int loop_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int loop_graph_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}
