// A device timestamp for the program's own tracing: one thread writes the
// card's %globaltimer (ns since an arbitrary epoch, the same for every SM)
// into one slot of a buffer, when the stream reaches the launch.
//
// Replaces no TPU kernel: it splits a stage captured as one CUDA graph by
// where its parts start and end on the card (pipeline/stages.py stamps the
// ControlNet's start, the UNet's start and the UNet's end in each denoise
// step).  A CUDA event recorded inside a capture is recorded again by every
// replay of the graph, so a sweep that replays chunk i + 1 before it reads
// chunk i back would read chunk i + 1's times; a stamp lands in a buffer that
// the editor copies out behind each replay, with the edit's images.
//
// Bound by nothing: one thread and one 8-byte store, a launch's latency on the
// stream.  It does no work that a roofline could count.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* buf, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[slot] = t;
}

}  // namespace

// buf [slots] int64 on the card; writes buf[slot] on the stream.
extern "C" int device_stamp(void* buf, int slot, void* stream) {
  if (slot < 0) return static_cast<int>(cudaErrorInvalidValue);
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(buf), slot);
  return static_cast<int>(cudaGetLastError());
}
