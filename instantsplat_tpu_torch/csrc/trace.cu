// trace_mark: the device clock at a point of a stream, for the program's
// tracing (instantsplat_tpu_torch/utils/profiling.py, ops/trace_mark.py).
//
// Replaces no TPU kernel. A step of a device-resident loop runs as a
// replayed CUDA graph, which carries no host op, so a host clock cannot
// tell its phases apart; the kernel is launched (captured) between them
// and writes the device's %globaltimer (nanoseconds) into
// marks[counter, slot], where counter is the loop's device step counter.
// One thread, one 8-byte load and one 8-byte store: what bounds it is the
// launch itself (a few microseconds inside a graph), and stream order
// makes the time it writes the end of every kernel launched before it on
// the stream and the start of every kernel after it.

#include <cuda_runtime.h>

namespace {

__global__ void trace_mark_kernel(long long* marks, const long long* counter,
                                  int cap, int n_marks, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long row = *counter;
  if (row >= 0 && row < cap) marks[row * n_marks + slot] = (long long)t;
}

}  // namespace

extern "C" int trace_mark(long long* marks, const long long* counter,
                          int cap, int n_marks, int slot, void* stream) {
  trace_mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(marks, counter, cap,
                                                       n_marks, slot);
  return (int)cudaGetLastError();
}
