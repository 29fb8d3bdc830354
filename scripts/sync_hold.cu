// A device-side hold for chip_smoke.py's stream sync check.
//
// One thread spins on a flag in mapped pinned host memory until the host
// sets it or the kernel's own time-out, read from %globaltimer, passes. It
// records which came first and how long it spun, so the host can tell a
// submit that returned while the card was still held (released) from one
// that waited for its own frame (timed out).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and loaded with ctypes, as runtime/kernels.py builds the port's kernels.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// state[0]: the host's flag (non-zero releases the hold); state[1]: the
// outcome (0 not run, 1 released, 2 timed out); state[2], state[3]: the
// nanoseconds spun, low and high words
__global__ void hold_kernel(volatile uint32_t* state, unsigned long long timeout_ns) {
  const unsigned long long t0 = globaltimer_ns();
  unsigned long long t = t0;
  uint32_t outcome = 2;
  while (t - t0 < timeout_ns) {
    if (state[0] != 0) {
      outcome = 1;
      break;
    }
    __nanosleep(1000);
    t = globaltimer_ns();
  }
  const unsigned long long spun = globaltimer_ns() - t0;
  state[2] = static_cast<uint32_t>(spun);
  state[3] = static_cast<uint32_t>(spun >> 32);
  __threadfence_system();
  state[1] = outcome;
}

}  // namespace

extern "C" {

// four words of mapped pinned host memory, zeroed
int qie_hold_alloc(void** host) {
  cudaError_t e = cudaHostAlloc(host, 4 * sizeof(uint32_t), cudaHostAllocMapped);
  if (e == cudaSuccess) memset(*host, 0, 4 * sizeof(uint32_t));
  return static_cast<int>(e);
}

// queue the hold on ``stream``; it spins until state[0] is set or timeout_ns pass
int qie_hold_launch(void* host, unsigned long long timeout_ns, void* stream) {
  void* dev = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&dev, host, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  hold_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<volatile uint32_t*>(dev), timeout_ns);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
