// Shared C entry points and host helpers of the p265_tpu_torch kernel
// library.
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

extern "C" const char* p265_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// CTAs of `kernel` that the current device holds at once over all its SMs,
// at `threads` threads and `smem` bytes of dynamic shared memory.  The
// occupancy query runs once per (device, kernel, threads, smem): the
// wrappers size every grid with it, several times a picture.
cudaError_t p265_resident_ctas(const void* kernel, int threads, int smem,
                               int* slots) {
  struct Entry {
    int dev;
    const void* kernel;
    int threads, smem, slots;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Entry& c : cache)
      if (c.dev == dev && c.kernel == kernel && c.threads == threads &&
          c.smem == smem) {
        *slots = c.slots;
        return cudaSuccess;
      }
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  *slots = sms * per_sm > 0 ? sms * per_sm : 1;
  std::lock_guard<std::mutex> lock(mu);
  cache.push_back({dev, kernel, threads, smem, *slots});
  return cudaSuccess;
}
