// Device memory shared between processes through CUDA IPC, for the
// collectives with one rank per process (ring_all_gather_rank,
// ring_all_to_all_rank).  No kernel: each rank allocates its symmetric
// buffer (flags and output) here, exports a 64-byte handle, and opens its
// peers' handles once; _rank_sync.SymmetricBuffers gathers the handles over
// the ranks' gloo group and caches the mapped pointers.
//
// Every function sets `device` when it is not already current and returns a
// cudaError_t (0 on success).
#include <cuda_runtime.h>
#include <string.h>

namespace {

cudaError_t use(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// `bytes` of device memory, zeroed and synchronised, so a peer that opens
// it after the handles are exchanged sees zeroed flags.
extern "C" int rank_ipc_alloc(long long bytes, int device, void** out) {
  cudaError_t err = use(device);
  if (err != cudaSuccess) return (int)err;
  *out = nullptr;
  err = cudaMalloc(out, (size_t)bytes);
  if (err == cudaSuccess) err = cudaMemset(*out, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}

extern "C" int rank_ipc_free(void* ptr, int device) {
  cudaError_t err = use(device);
  return (int)(err != cudaSuccess ? err : cudaFree(ptr));
}

// The handle of an allocation of rank_ipc_alloc, into 64 bytes at `out`.
extern "C" int rank_ipc_handle(void* ptr, int device, unsigned char* out) {
  cudaError_t err = use(device);
  if (err != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t handle;
  err = cudaIpcGetMemHandle(&handle, ptr);
  if (err == cudaSuccess) memcpy(out, &handle, sizeof(handle));
  return (int)err;
}

extern "C" int rank_ipc_handle_bytes(void) { return (int)sizeof(cudaIpcMemHandle_t); }

// A peer's allocation mapped into this process (another process's handle:
// a process cannot open its own).
extern "C" int rank_ipc_open(const unsigned char* bytes, int device, void** out) {
  cudaError_t err = use(device);
  if (err != cudaSuccess) return (int)err;
  cudaIpcMemHandle_t handle;
  memcpy(&handle, bytes, sizeof(handle));
  *out = nullptr;
  return (int)cudaIpcOpenMemHandle(out, handle, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int rank_ipc_close(void* ptr, int device) {
  cudaError_t err = use(device);
  return (int)(err != cudaSuccess ? err : cudaIpcCloseMemHandle(ptr));
}

// `bytes` from src to dst on `stream`, device to device; nothing is
// synchronised (the copy out of a rank's symmetric output).
extern "C" int rank_ipc_copy(void* dst, const void* src, long long bytes, int device,
                             void* stream) {
  cudaError_t err = use(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyAsync(dst, src, (size_t)bytes, cudaMemcpyDeviceToDevice,
                              static_cast<cudaStream_t>(stream));
}
