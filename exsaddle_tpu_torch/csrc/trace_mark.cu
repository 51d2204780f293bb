// The port's tracer on the card (exsaddle_tpu_torch/trace.py): a mark is
// one record of (word, %globaltimer) appended to a preallocated device
// buffer. Captured into a graph, a mark is one kernel node, so the marks
// time the work inside the conditional bodies of the device loop
// (graphs.ControlGraph), where CUPTI sees no kernel.
//
// No TPU kernel is replaced: the JAX package has no tracer. A mark is one
// thread of one block; its cost is a graph node's fixed cost (~1 us), not
// bytes or operations.
//
// state (int64): [cursor, drops, seq]. A mark takes slot cursor++ with
// atomicAdd; past the buffer's capacity it writes nothing and counts a
// drop, so the records kept are always the first ones (never wrapped).
// seq counts solves: the graph's entry mark (entry != 0) adds one before it
// writes, and every record carries seq in the word's high 32 bits above the
// mark's code (tag * 2 + end).
//
// Every entry returns its cudaError_t (0 on success); the wrapper raises on
// anything else.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void trace_mark_kernel(unsigned long long* buf,
                                  unsigned long long* state,
                                  unsigned long long cap,
                                  unsigned long long code, int entry) {
  const unsigned long long t = global_ns();
  unsigned long long seq = state[2];
  if (entry) {
    seq += 1ULL;
    state[2] = seq;
  }
  const unsigned long long i = atomicAdd(&state[0], 1ULL);
  if (i < cap) {
    buf[2 * i] = (seq << 32) | code;
    buf[2 * i + 1] = t;
  } else {
    atomicAdd(&state[1], 1ULL);
  }
}

__global__ void trace_now_kernel(unsigned long long* out) {
  out[0] = global_ns();
}

// %globaltimer's step: over n readings in a spin loop, the least nonzero
// difference of consecutive readings (out[0]), the number of distinct
// readings after the first (out[1]) and the time they span (out[2]).
__global__ void trace_timer_step_kernel(unsigned long long* out, int n) {
  unsigned long long prev = global_ns();
  const unsigned long long first = prev;
  unsigned long long least = ~0ULL, changes = 0;
  for (int k = 0; k < n; ++k) {
    const unsigned long long t = global_ns();
    if (t != prev) {
      if (t - prev < least) least = t - prev;
      ++changes;
      prev = t;
    }
  }
  out[0] = changes ? least : 0ULL;
  out[1] = changes;
  out[2] = prev - first;
}

}  // namespace

extern "C" {

int trace_mark(void* buf, void* state, long long cap, long long code,
               int entry, void* stream) {
  trace_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(buf),
      static_cast<unsigned long long*>(state),
      static_cast<unsigned long long>(cap),
      static_cast<unsigned long long>(code), entry);
  return cudaGetLastError();
}

int trace_now(void* out, void* stream) {
  trace_now_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

int trace_timer_step(void* out, int n, void* stream) {
  trace_timer_step_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out), n);
  return cudaGetLastError();
}

}  // extern "C"
