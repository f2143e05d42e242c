// Hopper (sm_90a) building blocks shared by the kernels that feed wgmma from
// TMA: mbarriers, TMA loads and stores, wgmma fences and shared-memory
// descriptors, and the host side's tensor-map encoder with its cache.
// Included by q8_matmul.cu and flash_attention.cu; ops/_build.py hashes it
// with each source that includes it.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

namespace hopper {

// ------------------------------------------------------------------ device ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed; a wait of
// more than about ten seconds can only be a fault, and traps (the launch then
// fails with an error instead of holding the card)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    const long long t0 = clock64();
    while (true) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - t0 > (1ll << 34)) __trap();
    }
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// shared -> global; the parts of the box outside the tensor are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// makes this thread's generic-proxy writes to shared memory visible to TMA
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a tile with the 128-byte swizzle: rows
// 128 bytes apart, 8-row groups 1024 bytes apart (stride byte offset 64 in
// 16-byte units), leading byte offset unused (1), layout type 1 (B128). The
// same descriptor serves a K-major operand (rows along M or N) and an
// MN-major one exactly 64 two-byte values wide (rows along K, read with the
// transpose bit).
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr) {
    return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(64) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across it
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][M]) {
#pragma unroll
    for (int i = 0; i < N; ++i) fence_regs(d[i]);
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(float (&d)[N][M]) {
#pragma unroll
    for (int i = 0; i < N; ++i) fence_regs(d[i]);
}

// -------------------------------------------------------------------- host ---

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

using CtxGetCurrent = CUresult (*)(CUcontext*);

// a function of the CUDA driver library, found with dlsym: nothing links
// against libcuda
inline void* driver_fn(const char* name) {
    static void* h = []() -> void* {
        void* p = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        return p != nullptr ? p : dlopen("libcuda.so.1", RTLD_NOW);
    }();
    return h == nullptr ? nullptr : dlsym(h, name);
}

inline EncodeTiled encode_tiled() {
    static const auto fn = reinterpret_cast<EncodeTiled>(driver_fn("cuTensorMapEncodeTiled"));
    return fn;
}

// Makes the current device's primary context current on a thread that has
// none: the encoder is a driver call and needs one, which a thread that has
// made no runtime call yet (autograd's backward thread) lacks. A thread that
// has one pays one cuCtxGetCurrent.
inline bool ensure_context() {
    static const auto get = reinterpret_cast<CtxGetCurrent>(driver_fn("cuCtxGetCurrent"));
    CUcontext ctx = nullptr;
    if (get != nullptr && get(&ctx) == CUDA_SUCCESS && ctx != nullptr) return true;
    int dev = 0;
    return cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess;
}

// The map of a tensor of `rank` (<= 4) dimensions, innermost first, dense in
// the first; strides in bytes of dimensions 1.. ; a box of `box` values, the
// 128-byte swizzle, zero fill outside the tensor. A map is a pure function of
// its arguments, so maps are cached by them (at most 4096, then the cache
// starts over). Returns 0, -2 if the encoder is not found, or -1000 - CUresult.
inline int tensor_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank, const void* ptr,
                      const uint64_t* dims, const uint64_t* strides, const uint32_t* box) {
    using Key = std::array<uint64_t, 14>;
    static std::mutex lock;
    static std::map<Key, CUtensorMap> cache;
    Key key{};
    key[0] = reinterpret_cast<uintptr_t>(ptr);
    key[1] = (static_cast<uint64_t>(dtype) << 8) | static_cast<uint64_t>(rank);
    for (int i = 0; i < rank; ++i) {
        key[2 + i] = dims[i];
        key[6 + i] = box[i];
        if (i > 0) key[9 + i] = strides[i - 1];
    }
    std::lock_guard<std::mutex> guard(lock);
    const auto it = cache.find(key);
    if (it != cache.end()) {
        *map = it->second;
        return 0;
    }
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return -2;
    if (!ensure_context()) return -1000 - static_cast<int>(CUDA_ERROR_INVALID_CONTEXT);
    cuuint64_t d[4], s[3];
    cuuint32_t b[4], e[4];
    for (int i = 0; i < rank; ++i) {
        d[i] = dims[i];
        b[i] = box[i];
        e[i] = 1;
        if (i > 0) s[i - 1] = strides[i - 1];
    }
    const CUresult r = fn(map, dtype, static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), d, s,
                          b, e, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -1000 - static_cast<int>(r);
    if (cache.size() >= 4096) cache.clear();
    cache.emplace(key, *map);
    return 0;
}

// Sets a kernel's dynamic shared-memory limit once per device (the call
// costs host time on every launch otherwise); `ready` is the caller's own
// flag array for this kernel. Returns a cudaError_t.
inline int set_smem_once(const void* kernel, int bytes, bool (&ready)[64]) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64 && ready[dev]) return 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) ready[dev] = true;
    return 0;
}

}  // namespace hopper
