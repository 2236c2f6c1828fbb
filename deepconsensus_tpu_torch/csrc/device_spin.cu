// A test-only device spin: one thread that busy-waits on the card for a
// given time.
//
// It replaces no TPU kernel. Fault injection (faults.ENV_DEVICE_HANG_AT_PACK)
// launches it on a side stream between a pack's last copy and the event
// the dispatch watchdog polls, so the watchdog is tested against an event
// that the card really has not reached, while later packs run on the
// compute stream beside it. The wait reads the card's global nanosecond
// timer, so its length does not depend on the SM clock. Bound: none (it
// moves no bytes and does no arithmetic); it occupies one warp of one SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void device_spin_kernel(uint64_t ns) {
  const uint64_t start = global_ns();
  while (global_ns() - start < ns) {
    __nanosleep(1000);
  }
}

}  // namespace

extern "C" int dc_device_spin(double seconds, cudaStream_t stream) {
  const uint64_t ns = seconds > 0 ? static_cast<uint64_t>(seconds * 1e9) : 0;
  device_spin_kernel<<<1, 1, 0, stream>>>(ns);
  return static_cast<int>(cudaGetLastError());
}
