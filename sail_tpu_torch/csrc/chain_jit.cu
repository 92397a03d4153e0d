// Compile, load and launch the chain kernels (K16, K17) that
// sail_tpu_torch/ops/chain_codegen.py generates, one for each chain
// program, when exec/local.py binds the chain.
//
// NVRTC compiles a generated source (which includes csrc/chain.cuh) for
// sm_90a into a cubin; the CUDA driver loads the cubin into the current
// context and launches its one kernel on PyTorch's stream; the Python side
// unloads the module when no program holds its kernel any more. The kernel
// takes one parameter: its program's arguments, 64-bit words (pointers,
// lengths, scalar-subquery values), by value. Every entry point returns its error
// code (an nvrtcResult from sail_jit_compile's handle, a CUresult
// otherwise); the Python side raises on any but 0, with NVRTC's log.

#include <cuda.h>
#include <cuda_runtime.h>
#include <nvrtc.h>

#include <cstring>
#include <string>
#include <vector>

namespace {

struct Compiled {
  int result = 0;
  std::string log;
  std::vector<char> cubin;
};

long long copy_out(const char* data, size_t size, char* buf, long long cap) {
  if (buf != nullptr && cap > 0)
    std::memcpy(buf, data, size < (size_t)cap ? size : (size_t)cap);
  return (long long)size;
}

// The runtime's primary context, made current on this thread, which is
// the context PyTorch's tensors and streams live in.
CUresult current_context() {
  CUcontext ctx = nullptr;
  CUresult r = cuCtxGetCurrent(&ctx);
  if (r != CUDA_SUCCESS || ctx != nullptr) return r;
  cudaError_t e = cudaFree(nullptr);
  return e == cudaSuccess ? CUDA_SUCCESS : CUDA_ERROR_NOT_INITIALIZED;
}

}  // namespace

// Compile `source` (named `name` in NVRTC's messages) with `options`; a
// handle to its result, log and cubin, freed by sail_jit_free.
extern "C" void* sail_jit_compile(const char* source, const char* name,
                                  const char* const* options, int noptions) {
  Compiled* c = new Compiled();
  nvrtcProgram prog;
  nvrtcResult r = nvrtcCreateProgram(&prog, source, name, 0, nullptr,
                                     nullptr);
  if (r != NVRTC_SUCCESS) {
    c->result = (int)r;
    c->log = nvrtcGetErrorString(r);
    return c;
  }
  r = nvrtcCompileProgram(prog, noptions, options);
  size_t size = 0;
  if (nvrtcGetProgramLogSize(prog, &size) == NVRTC_SUCCESS && size > 1) {
    c->log.resize(size);
    if (nvrtcGetProgramLog(prog, &c->log[0]) != NVRTC_SUCCESS) c->log.clear();
    while (!c->log.empty() && c->log.back() == '\0') c->log.pop_back();
  }
  if (r == NVRTC_SUCCESS && (r = nvrtcGetCUBINSize(prog, &size)) ==
                                NVRTC_SUCCESS) {
    c->cubin.resize(size);
    r = nvrtcGetCUBIN(prog, c->cubin.data());
  }
  if (r != NVRTC_SUCCESS) {
    c->log += "\n";
    c->log += nvrtcGetErrorString(r);
  }
  c->result = (int)r;
  nvrtcDestroyProgram(&prog);
  return c;
}

extern "C" int sail_jit_result(void* handle) {
  return static_cast<Compiled*>(handle)->result;
}

// The log's length; its first `cap` bytes copied to buf.
extern "C" long long sail_jit_log(void* handle, char* buf, long long cap) {
  const Compiled* c = static_cast<Compiled*>(handle);
  return copy_out(c->log.data(), c->log.size(), buf, cap);
}

// The cubin's length; its first `cap` bytes copied to buf.
extern "C" long long sail_jit_cubin(void* handle, char* buf, long long cap) {
  const Compiled* c = static_cast<Compiled*>(handle);
  return copy_out(c->cubin.data(), c->cubin.size(), buf, cap);
}

extern "C" void sail_jit_free(void* handle) {
  delete static_cast<Compiled*>(handle);
}

// Load a cubin into the current context: its module in *module (loaded
// until sail_jit_unload) and its kernel `name` in *function, allowed `smem`
// bytes of dynamic shared memory.
extern "C" int sail_jit_load(const void* cubin, const char* name, int smem,
                             void** module, void** function) {
  CUresult r = current_context();
  if (r != CUDA_SUCCESS) return (int)r;
  CUmodule mod;
  if ((r = cuModuleLoadData(&mod, cubin)) != CUDA_SUCCESS) return (int)r;
  CUfunction fn;
  if ((r = cuModuleGetFunction(&fn, mod, name)) != CUDA_SUCCESS ||
      (r = cuFuncSetAttribute(fn,
                              CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                              smem)) != CUDA_SUCCESS) {
    cuModuleUnload(mod);
    return (int)r;
  }
  *module = mod;
  *function = fn;
  return 0;
}

// Unload a module of sail_jit_load once the work queued on the device, which
// may still run its kernel, has finished.
extern "C" int sail_jit_unload(void* module) {
  CUresult r = current_context();
  if (r != CUDA_SUCCESS || (r = cuCtxSynchronize()) != CUDA_SUCCESS)
    return (int)r;
  return (int)cuModuleUnload(static_cast<CUmodule>(module));
}

// The kernel's registers a thread, local (spill and stack) bytes a thread,
// and resident blocks an SM at `block` threads and `smem` dynamic shared
// bytes: out[0..2].
extern "C" int sail_jit_attributes(void* function, int block, int smem,
                                   int* out) {
  CUfunction fn = static_cast<CUfunction>(function);
  CUresult r;
  if ((r = cuFuncGetAttribute(&out[0], CU_FUNC_ATTRIBUTE_NUM_REGS, fn)) !=
          CUDA_SUCCESS ||
      (r = cuFuncGetAttribute(&out[1], CU_FUNC_ATTRIBUTE_LOCAL_SIZE_BYTES,
                              fn)) != CUDA_SUCCESS)
    return (int)r;
  return (int)cuOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, block,
                                                          (size_t)smem);
}

// Launch the kernel over `grid` blocks of `block` threads on `stream`; args:
// the kernel's one parameter, its bytes.
extern "C" int sail_jit_launch(void* function, void* args, int grid,
                               int block, int smem, void* stream) {
  void* params[] = {args};
  return (int)cuLaunchKernel(static_cast<CUfunction>(function), grid, 1, 1,
                             block, 1, 1, smem, static_cast<CUstream>(stream),
                             params, nullptr);
}
