// Set-up that a launcher needs once per device and process, not per launch:
// raising a kernel's dynamic shared-memory limit (cudaFuncSetAttribute), or
// reading the device's budget for it.  Each call site keeps one
// `OncePerDevice` in a function-local static (one per template
// instantiation), so the step runs the first time a device launches the
// kernel and every later launch reads the kept status and value.
// std::call_once makes the first use thread-safe: the wrappers are called
// from several host threads (AsyncSolveEngine's flushes).

#pragma once

#include <mutex>

#include <cuda_runtime.h>

namespace {  // each library is one translation unit; its launch lambdas are local too

template <typename Value = int>
class OncePerDevice {
 public:
  // Runs `init(device, &value)` once for the current device and returns its
  // status; `*out` (if given) receives the value it stored.
  template <typename Init>
  cudaError_t get(Init&& init, Value* out = nullptr) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    Slot& slot = slots_[dev];
    std::call_once(slot.flag, [&] { slot.status = init(dev, &slot.value); });
    if (out != nullptr) *out = slot.value;
    return slot.status;
  }

 private:
  static constexpr int kMaxDevices = 64;
  struct Slot {
    std::once_flag flag;
    cudaError_t status = cudaSuccess;
    Value value{};
  };
  Slot slots_[kMaxDevices];
};

}  // namespace
