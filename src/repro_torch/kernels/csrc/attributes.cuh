// The kernel instances a source's launchers can take, for the plan auditor
// (`repro_torch.analysis.audit`, rule kernel-resources).
//
// Each source lists every template instance its launchers can launch, with
// the largest block and the largest dynamic shared memory its launcher asks
// for, and exports two C entries through KERNEL_INSTANCE_ENTRIES(name):
//
//   int <name>_instances();
//   int <name>_instance_attributes(int i, const char** kernel, const char** dtype,
//                                  long long* out);
//
// The second fills out[0..5] with cudaFuncGetAttributes' numRegs,
// sharedSizeBytes, localSizeBytes and maxThreadsPerBlock of instance i, then
// the block and the dynamic shared memory that its launcher asks for, and
// returns the cudaError_t of the read.
#pragma once

#include <cuda_runtime.h>

struct KernelInstance {
  const char* kernel;  // the kernel and its template arguments
  const char* dtype;   // the storage type: "f32", "f64", "bf16" or "f16"
  const void* fn;
  int block;           // threads a block, the largest the launcher asks for
  long long dyn_smem;  // dynamic shared memory a block, the largest the launcher
                       // asks for; kOptinRest: the device's opt-in budget less
                       // the kernel's static shared memory
};

constexpr long long kOptinRest = -1;

inline int instance_attributes(const KernelInstance* table, int n, int i, const char** kernel,
                               const char** dtype, long long* out) {
  if (i < 0 || i >= n) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, table[i].fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long dyn = table[i].dyn_smem;
  if (dyn == kOptinRest) {
    int dev = 0, optin = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    dyn = static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
  }
  *kernel = table[i].kernel;
  *dtype = table[i].dtype;
  out[0] = attr.numRegs;
  out[1] = static_cast<long long>(attr.sharedSizeBytes);
  out[2] = static_cast<long long>(attr.localSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  out[4] = table[i].block;
  out[5] = dyn;
  return static_cast<int>(cudaSuccess);
}

// The two C entries over a source's table `kInstances`.
#define KERNEL_INSTANCE_ENTRIES(name)                                                         \
  extern "C" int name##_instances() {                                                        \
    return static_cast<int>(sizeof(kInstances) / sizeof(kInstances[0]));                     \
  }                                                                                           \
  extern "C" int name##_instance_attributes(int i, const char** kernel, const char** dtype,   \
                                            long long* out) {                                 \
    return instance_attributes(kInstances, name##_instances(), i, kernel, dtype, out);       \
  }

#define KI(fn) reinterpret_cast<const void*>(fn)
