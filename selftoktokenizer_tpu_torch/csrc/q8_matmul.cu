// W8A8 int8 matrix product for Hopper (sm_90a), in two kernels on one stream.
//
//   sx[m]   = max(max_k |x[m][k]| * fp32(1/127), 1e-8)
//   xq[m,k] = clamp(rint(x[m][k] / sx[m]), -127, 127)             (int8)
//   acc     = sum_k xq[m,k] * wq[n,k]                             (int32, exact)
//   bf16:  y = bf16((float(acc) * sx[m]) * sw[n]);  out = bf16(float(y) + float(bf16(bias[n])))
//   fp32:  out = fma(float(acc) * sx[m], sw[n], bias[n])  (no bias: the product)
//
// T is the type of x and of the output (bf16 or fp32). Replaces the Pallas
// TPU kernel selftoktokenizer_tpu/ops/q8_matmul.py:46-95 (q8_matmul and its
// _kernel); the bias step is the one ops/q8_matmul.py::q8_linear adds in x's
// type after the kernel. In fp32 the bias enters through one fused
// multiply-add because XLA contracts the reference's product and sum into one
// (its bf16 path rounds in between, so nothing is contracted there). The
// scale is a product with the fp32 reciprocal of 127, not a division: XLA
// rewrites the reference's division by the constant 127 so in every compiled
// program (the Pallas kernel and the jitted decode alike).
//
// Exactness. |acc| <= 6144 * 127^2 < 2^31, so the int32 sum is exact in any
// order: wgmma's order, the K tiles' and the K splits' change no bit. Every
// float step is an explicitly rounded intrinsic (__fmul_rn, __fdiv_rn,
// rintf, __fadd_rn, __fmaf_rn), so nothing the compiler contracts can make
// the result differ from the plain PyTorch version, which it equals bit for
// bit.
//
// Bound on an H100: 2*M*K*N int8 tensor-core operations (1,979 TOP/s) against
// M*K*itemsize + K*N + 6*N + M*N*itemsize bytes (3.35 TB/s). At the decode's
// x stream (M = 512) bytes bound it: x qkv [512,1536] x [1536,4608] is 4.0 us
// of bytes and 3.7 us of operations. At its context stream (M = 1024)
// operations do: context fc1 [1024,1536] x [1536,6144] is 9.8 us of
// operations and 7.5 us of bytes.
//
// Design. The earlier single kernel (one 64 x 128 tile per block, mma.sync)
// ran at 0.007-0.19 of that bound for five reasons; each is answered here:
//  1. x was read and divided again for every 128 output columns. Now
//     q8_matmul_quantize_rows quantizes x once per linear (a block of 128
//     threads per row, the row's 16-byte chunks held in registers, M*K
//     divisions in all) into an int8 xq [M, Kp], Kp = K rounded up to 16 so
//     that TMA can describe its rows, with the scales sx [M] beside it.
//  2. One barrier pair per K tile and no prefetch. Now one producer warp
//     keeps TMA loads in flight through a ring of STAGES stages, each signed
//     off by mbarriers (full: the bytes arrived; empty: both consumer
//     warpgroups are done with it). The consumers keep one K tile's wgmma in
//     flight while the previous tile's stage goes back to the producer.
//  3. mma.sync from shared memory read by hand. Now two consumer warpgroups
//     run wgmma.mma_async s32.s8.s8 straight from the 128-byte-swizzled TMA
//     tiles: xq [M, Kp] and torch's wq [N, K] are both K-major, the only
//     layout wgmma takes for 8-bit types, so nothing is transposed. A K tile
//     is 128 bytes, one swizzle row, and each k32 step moves the
//     descriptor's start address by 32 bytes.
//  4. Too few blocks, and no split-K. The host planner
//     (ops/q8_matmul.py::plan_q8) picks the tile width BN (64, 96, 128, 144
//     or 192; tiles are 128 x BN, the widths cut the decode's N = 1536, 4608
//     and 6144 into whole waves of the 132 SMs) and the number of K splits.
//     A split writes its int32 partial tile to a workspace in fragment order;
//     a per-tile arrival counter lets the last split add the others' partials
//     (exact, in int32) and run the epilogue, so a product is still one GEMM
//     launch. The counters are cleared by the quantize kernel, which runs
//     first on the same stream, so no memset is launched.
//  5. The epilogue stored one 2-byte value at a time. Now the tile is staged
//     through shared memory (the ring, once every consumer is done with it)
//     and stored with 16-byte vectors where the row allows.
// The GEMM is launched as a programmatic dependent of the quantize pass: its
// blocks set up and request their first weight tiles while the pass runs,
// and wait for it (griddepcontrol.wait) before touching xq, sx or the
// counters. TMA fills the part of a box past M, N or Kp with zeros (K = 16 at
// the context embedder); ragged M and N are masked in the epilogue. Tensor
// maps are encoded on the host with cuTensorMapEncodeTiled, found in the
// CUDA library libcuda with dlsym (nothing links against it), and cached by
// (pointer, shape, box): a map is a pure function of those.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                  // output rows per block: two warpgroups of 64
constexpr int BK = 128;                  // int8 depth of a K tile: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int QTHREADS = 128;            // threads of the quantize pass per row
constexpr float INV127 = 1.0f / 127.0f;

constexpr int smem_bytes(int bn) {
    // 1024 bytes of slack to align the ring for the 128-byte swizzle, the
    // ring, full and empty barriers, the tile's sw and bias, the last-split flag
    return 1024 + STAGES * (BM + bn) * BK + 2 * STAGES * 8 + 2 * bn * 4 + 16;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// the values of 16 bytes of x
__device__ __forceinline__ void unpack16(uint4 t, float v[4], float) {
    v[0] = __uint_as_float(t.x); v[1] = __uint_as_float(t.y);
    v[2] = __uint_as_float(t.z); v[3] = __uint_as_float(t.w);
}

__device__ __forceinline__ void unpack16(uint4 t, float v[8], __nv_bfloat16) {
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ uint32_t quant(float v, float sx) {
    float q = rintf(__fdiv_rn(v, sx));               // half to even, IEEE division
    q = fminf(fmaxf(q, -127.f), 127.f);
    return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

// 16 bytes of x -> their int8 values at q
template <typename T>
__device__ __forceinline__ void quant16(int8_t* q, uint4 t, float s) {
    constexpr int V = 16 / sizeof(T);
    float v[V];
    unpack16(t, v, T());
    uint32_t w[V / 4];
#pragma unroll
    for (int j = 0; j < V / 4; ++j)
        w[j] = quant(v[4 * j], s) | (quant(v[4 * j + 1], s) << 8)
             | (quant(v[4 * j + 2], s) << 16) | (quant(v[4 * j + 3], s) << 24);
    if constexpr (V == 8) *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
    else *reinterpret_cast<uint32_t*>(q) = w[0];
}

template <typename T>
__device__ __forceinline__ float amax16(float amax, uint4 t) {
    constexpr int V = 16 / sizeof(T);
    float v[V];
    unpack16(t, v, T());
#pragma unroll
    for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[e]));
    return amax;
}

__device__ __forceinline__ float round_out(float v, float) { return v; }
__device__ __forceinline__ float round_out(float v, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_pair(uint8_t* p, float a, float b, float) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(uint8_t* p, float a, float b, __nv_bfloat16) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);   // both already bf16 values
}

// ---------------------------------------------------------------- quantize ---

// One block of QTHREADS per row. With C > 0 each thread loads its C
// 16-byte chunks of the row at once into registers (all loads in flight
// together), the block reduces max|x|, and the thread quantizes from its
// registers: x is read once. C = 0 (rows longer than 8 chunks a thread, or
// not 16-byte aligned) walks the row twice; the second walk hits L1. Writes
// xq[m, :Kp] (zero past K) and sx[m], and clears the split-K arrival counters
// of the GEMM that follows on the stream. Lets that GEMM launch at once
// (programmatic dependent launch): it waits for this grid before reading
// what the grid writes.
template <typename T, int C>
__global__ void __launch_bounds__(QTHREADS)
q8_matmul_quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                        unsigned* __restrict__ counters, int n_counters,
                        int M, int K, int Kp, int vec) {
    __shared__ float s_max[QTHREADS / 32];
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    for (int i = blockIdx.x * QTHREADS + threadIdx.x; i < n_counters; i += gridDim.x * QTHREADS)
        counters[i] = 0u;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int row = blockIdx.x;
    constexpr int V = 16 / sizeof(T);                // values per 16-byte chunk
    const T* xr = x + (size_t)row * K;
    int8_t* qr = xq + (size_t)row * Kp;

    float amax = 0.f;
    uint4 buf[C > 0 ? C : 1];
    if constexpr (C > 0) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int k = (c * QTHREADS + tid) * V;
            buf[c] = k < K ? *reinterpret_cast<const uint4*>(xr + k) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) amax = amax16<T>(amax, buf[c]);
    } else if (vec) {
#pragma unroll 4
        for (int k = tid * V; k < K; k += QTHREADS * V)
            amax = amax16<T>(amax, *reinterpret_cast<const uint4*>(xr + k));
    } else {
#pragma unroll 4
        for (int k = tid; k < K; k += QTHREADS) amax = fmaxf(amax, fabsf(to_f(xr[k])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) s_max[tid >> 5] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < QTHREADS / 32; ++w) amax = fmaxf(amax, s_max[w]);
    const float s = fmaxf(__fmul_rn(amax, INV127), 1e-8f);
    if (tid == 0) sx[row] = s;

    if constexpr (C > 0) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int k = (c * QTHREADS + tid) * V;
            if (k < K) quant16<T>(qr + k, buf[c], s);
        }
    } else if (vec) {
        for (int k = tid * V; k < K; k += QTHREADS * V)
            quant16<T>(qr + k, *reinterpret_cast<const uint4*>(xr + k), s);
    } else {
        for (int k = tid; k < K; k += QTHREADS) qr[k] = static_cast<int8_t>(quant(to_f(xr[k]), s));
    }
    for (int k = K + tid; k < Kp; k += QTHREADS) qr[k] = 0;
}

// -------------------------------------------------------------------- gemm ---

// named barrier 1 over the two consumer warpgroups (the producer warp has left)
__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}

// m64nBNk32 s32 += s8 * s8, A and B K-major in shared memory; thread t of the
// warpgroup holds d[4j + 2h + e] = D[16 (t/32) + (t%32)/4 + 8h][8j + 2 (t%4) + e]
template <int BN> struct Wgmma;

template <>
struct Wgmma<64> {
    static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db) {
        asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
    }
};

template <>
struct Wgmma<96> {
    static __device__ __forceinline__ void mma(int (&d)[48], uint64_t da, uint64_t db) {
        asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "l"(da), "l"(db), "r"(1));
    }
};

template <>
struct Wgmma<128> {
    static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db) {
        asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
    }
};

template <>
struct Wgmma<144> {
    static __device__ __forceinline__ void mma(int (&d)[72], uint64_t da, uint64_t db) {
        asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71"
        "}, %72, %73, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
        : "l"(da), "l"(db), "r"(1));
    }
};

template <>
struct Wgmma<192> {
    static __device__ __forceinline__ void mma(int (&d)[96], uint64_t da, uint64_t db) {
        asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
        : "l"(da), "l"(db), "r"(1));
    }
};
// One block: the 128 x BN output tile (blockIdx.x, blockIdx.y) over this
// split's K tiles (blockIdx.z of `splits`; the first k_tiles % splits splits
// take one tile more, as plan_q8's k_range). Warps 0-7 are two consumer
// warpgroups (rows 0-63 and 64-127 of the tile), warp 8 the TMA producer.
template <typename T, int BN>
__global__ void __launch_bounds__(THREADS, 1)
q8_matmul_gemm(const __grid_constant__ CUtensorMap tmap_x, const __grid_constant__ CUtensorMap tmap_w,
               const float* __restrict__ sx, const float* __restrict__ sw,
               const void* __restrict__ bias, int bias_bf16, T* __restrict__ out,
               int* __restrict__ partials, unsigned* __restrict__ counters,
               int M, int N, int k_tiles, int splits, int out_vec) {
    constexpr int ACC = BN / 2;                  // int32 accumulators per consumer thread
    constexpr int A_BYTES = BM * BK;
    constexpr int STAGE_BYTES = (BM + BN) * BK;
    constexpr bool OUT_F32 = sizeof(T) == sizeof(float);

    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;
    float* s_sw = reinterpret_cast<float*>(empty + STAGES);
    float* s_b = s_sw + BN;
    int* s_last = reinterpret_cast<int*>(s_b + BN);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int split = blockIdx.z;
    const int per = k_tiles / splits, rem = k_tiles % splits;
    const int kb = split * per + min(split, rem);
    const int nk = per + (split < rem ? 1 : 0);

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(smem_u32(&full[s]), 1);
            mbar_init(smem_u32(&empty[s]), CONSUMERS / 32);   // one arrival per consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (warp == CONSUMERS / 32) {
        // producer: one thread keeps up to STAGES tiles of xq and wq in flight
        if (lane == 0) {
            prefetch_map(&tmap_w);
            prefetch_map(&tmap_x);
            // the weights do not depend on the quantize pass: the first
            // stages' weight tiles are requested before waiting for it
            const int first = nk < STAGES ? nk : STAGES;
            for (int i = 0; i < first; ++i) {
                const uint32_t bar = smem_u32(&full[i]);
                mbar_expect_tx(bar, STAGE_BYTES);    // a box counts whole, zero-filled part included
                tma_load_2d(smem_u32(smem + i * STAGE_BYTES + A_BYTES), &tmap_w, bar, (kb + i) * BK, n0);
            }
            asm volatile("griddepcontrol.wait;\n" ::: "memory");   // xq is the quantize pass's
            for (int i = 0; i < first; ++i)
                tma_load_2d(smem_u32(smem + i * STAGE_BYTES), &tmap_x, smem_u32(&full[i]), (kb + i) * BK, m0);
            for (int i = first; i < nk; ++i) {
                const int s = i % STAGES;
                mbar_wait(smem_u32(&empty[s]), ((i / STAGES) & 1) ^ 1);
                const uint32_t bar = smem_u32(&full[s]);
                mbar_expect_tx(bar, STAGE_BYTES);
                const int k = (kb + i) * BK;
                tma_load_2d(smem_u32(smem + s * STAGE_BYTES), &tmap_x, bar, k, m0);
                tma_load_2d(smem_u32(smem + s * STAGE_BYTES + A_BYTES), &tmap_w, bar, k, n0);
            }
        }
        return;
    }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");   // so are sx and the counters

    // consumers
    const int wg = warp >> 2;                    // rows 64 wg .. 64 wg + 63 of the tile
    int acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0;

    for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        mbar_wait(smem_u32(&full[s]), (i / STAGES) & 1);
        const uint32_t a = smem_u32(smem + s * STAGE_BYTES + wg * 64 * BK);
        const uint32_t b = smem_u32(smem + s * STAGE_BYTES + A_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
            Wgmma<BN>::mma(acc, smem_desc(a + kk * 32), smem_desc(b + kk * 32));
        wgmma_commit();
        // keep this tile's products in flight; the previous tile's are done,
        // and its stage goes back to the producer
        wgmma_wait1();
        fence_regs(acc);
        if (i > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(i + STAGES - 1) % STAGES]));
    }
    wgmma_wait0();
    fence_regs(acc);

    if (splits > 1) {
        // write this split's partial tile in fragment order (coalesced 16-byte
        // stores), count the arrival; the last split to arrive adds the others
        const int tile = blockIdx.x + gridDim.x * blockIdx.y;
        int4* ws = reinterpret_cast<int4*>(partials);
        int4* mine = ws + ((size_t)tile * splits + split) * (ACC / 4) * CONSUMERS;
#pragma unroll
        for (int v = 0; v < ACC / 4; ++v)
            mine[v * CONSUMERS + tid] = make_int4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
        __threadfence();
        consumer_sync();
        if (tid == 0) *s_last = atomicAdd(&counters[tile], 1u) == static_cast<unsigned>(splits - 1);
        consumer_sync();
        if (!*s_last) return;
        __threadfence();
        for (int o = 0; o < splits; ++o) {
            if (o == split) continue;
            const int4* other = ws + ((size_t)tile * splits + o) * (ACC / 4) * CONSUMERS;
#pragma unroll
            for (int v = 0; v < ACC / 4; ++v) {
                const int4 t = __ldcg(other + v * CONSUMERS + tid);
                acc[4 * v] += t.x;
                acc[4 * v + 1] += t.y;
                acc[4 * v + 2] += t.z;
                acc[4 * v + 3] += t.w;
            }
        }
    }

    // epilogue: every consumer is done with the ring, which now stages the tile
    consumer_sync();
    for (int c = tid; c < BN; c += CONSUMERS) {
        const int col = n0 + c;
        float bv = 0.f;
        if (bias != nullptr && col < N)
            bv = round_out(bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col])
                                     : static_cast<const float*>(bias)[col], T());
        s_sw[c] = col < N ? sw[col] : 0.f;
        s_b[c] = bv;
    }
    const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const float sx0 = m0 + r0 < M ? sx[m0 + r0] : 0.f;
    const float sx1 = m0 + r0 + 8 < M ? sx[m0 + r0 + 8] : 0.f;
    consumer_sync();

    constexpr int PITCH = BN * static_cast<int>(sizeof(T)) + 16;   // bytes; the pad spreads rows over banks
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            const int c = 8 * j + 2 * (lane & 3);
            const float sxr = h ? sx1 : sx0;
            float y[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float p = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), sxr);
                const float w = s_sw[c + e];
                if (bias == nullptr) {
                    y[e] = round_out(__fmul_rn(p, w), T());
                } else {
                    y[e] = OUT_F32 ? __fmaf_rn(p, w, s_b[c + e])
                                   : round_out(__fadd_rn(round_out(__fmul_rn(p, w), T()), s_b[c + e]), T());
                }
            }
            store_pair(smem + r * PITCH + c * static_cast<int>(sizeof(T)), y[0], y[1], T());
        }
    }
    consumer_sync();

    constexpr int CH = 16 / static_cast<int>(sizeof(T));    // values per 16-byte store
    constexpr int CPR = BN / CH;
    for (int idx = tid; idx < BM * CPR; idx += CONSUMERS) {
        const int r = idx / CPR;
        const int cc = (idx % CPR) * CH;
        const int row = m0 + r;
        const int col = n0 + cc;
        if (row >= M || col >= N) continue;
        const uint8_t* src = smem + r * PITCH + cc * static_cast<int>(sizeof(T));
        T* dst = out + (size_t)row * N + col;
        if (out_vec && col + CH <= N) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
            for (int e = 0; e < CH && col + e < N; ++e) dst[e] = reinterpret_cast<const T*>(src)[e];
        }
    }
}

// ------------------------------------------------------------------- host ---

// the map of an int8 [rows, cols] row-major array (cols a multiple of 16)
// read in boxes of 128 bytes x box_rows; 0 or an error code
int q8_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows) {
    const uint64_t dims[2] = {cols, rows};
    const uint64_t strides[1] = {cols};
    const uint32_t box[2] = {static_cast<uint32_t>(BK), box_rows};
    return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ptr, dims, strides, box);
}

template <typename T, int C>
int launch_quantize_c(const void* x, void* xq, void* sx, void* counters, int n_counters,
                      int M, int K, int Kp, int vec, cudaStream_t s) {
    // the GEMM after it needs the SM's shared memory at its largest; asking
    // the same split of L1 and shared memory here spares the SM a
    // reconfiguration between the two
    static bool ready[64] = {};                  // set once per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64 || !ready[dev]) {
        e = cudaFuncSetAttribute(q8_matmul_quantize_rows<T, C>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout, 100);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (dev < 64) ready[dev] = true;
    }
    q8_matmul_quantize_rows<T, C><<<M, QTHREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx),
        static_cast<unsigned*>(counters), n_counters, M, K, Kp, vec);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_quantize(const void* x, void* xq, void* sx, void* counters, int n_counters,
                    int M, int K, int Kp, cudaStream_t s) {
    const int vec = (static_cast<long long>(K) * sizeof(T)) % 16 == 0
                    && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    constexpr int V = 16 / sizeof(T);
    const int chunks = (K + QTHREADS * V - 1) / (QTHREADS * V);   // 16-byte chunks a thread
    if (vec && chunks <= 1) return launch_quantize_c<T, 1>(x, xq, sx, counters, n_counters, M, K, Kp, vec, s);
    if (vec && chunks <= 2) return launch_quantize_c<T, 2>(x, xq, sx, counters, n_counters, M, K, Kp, vec, s);
    if (vec && chunks <= 4) return launch_quantize_c<T, 4>(x, xq, sx, counters, n_counters, M, K, Kp, vec, s);
    if (vec && chunks <= 8) return launch_quantize_c<T, 8>(x, xq, sx, counters, n_counters, M, K, Kp, vec, s);
    return launch_quantize_c<T, 0>(x, xq, sx, counters, n_counters, M, K, Kp, vec, s);
}

template <typename T, int BN>
int launch_gemm(const CUtensorMap& tx, const CUtensorMap& tw, const void* sx, const void* sw,
                const void* bias, int bias_bf16, void* out, void* partials, void* counters,
                int M, int N, int k_tiles, int splits, cudaStream_t s) {
    constexpr int SMEM = smem_bytes(BN);
    static bool ready[64] = {};                  // the attribute is set once per device
    cudaError_t e = static_cast<cudaError_t>(
        set_smem_once(reinterpret_cast<const void*>(q8_matmul_gemm<T, BN>), SMEM, ready));
    if (e != cudaSuccess) return static_cast<int>(e);
    const int out_vec = (static_cast<long long>(N) * sizeof(T)) % 16 == 0
                        && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
    // programmatic dependent launch: the blocks may start while the quantize
    // pass finishes; they wait for it (griddepcontrol.wait) before reading
    // what it writes
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, q8_matmul_gemm<T, BN>, tx, tw, static_cast<const float*>(sx),
                           static_cast<const float*>(sw), bias, bias_bf16, static_cast<T*>(out),
                           static_cast<int*>(partials), static_cast<unsigned*>(counters),
                           M, N, k_tiles, splits, out_vec);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gemm_bn(int bn, const CUtensorMap& tx, const CUtensorMap& tw, const void* sx,
                   const void* sw, const void* bias, int bias_bf16, void* out, void* partials,
                   void* counters, int M, int N, int k_tiles, int splits, cudaStream_t s) {
#define Q8_GEMM(BN_) launch_gemm<T, BN_>(tx, tw, sx, sw, bias, bias_bf16, out, partials, counters, \
                                          M, N, k_tiles, splits, s)
    switch (bn) {
        case 64: return Q8_GEMM(64);
        case 96: return Q8_GEMM(96);
        case 128: return Q8_GEMM(128);
        case 144: return Q8_GEMM(144);
        case 192: return Q8_GEMM(192);
        default: return -1;
    }
#undef Q8_GEMM
}

}  // namespace

// x [M,K] (bf16 when x_bf16, else fp32) -> xq [M,Kp] int8 (zero past K) and
// sx [M] fp32: the quantize pass alone. Returns cudaGetLastError(), or -1
// for arguments the kernel does not take.
extern "C" int stk_q8_quantize_rows(const void* x, void* xq, void* sx, int M, int K, int Kp,
                                    int x_bf16, void* stream) {
    if (M <= 0 || K <= 0 || Kp < K || Kp % 16 != 0) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return x_bf16 ? launch_quantize<__nv_bfloat16>(x, xq, sx, nullptr, 0, M, K, Kp, s)
                  : launch_quantize<float>(x, xq, sx, nullptr, 0, M, K, Kp, s);
}

// The whole product: the quantize pass, then the GEMM, on `stream`.
// x [M,K] (bf16 when x_bf16, else fp32); wq [N,Kp] int8 (K padded with zero
// columns to Kp = K rounded up to 16); sw [N] fp32; bias [N] (bf16 when
// bias_bf16, else fp32) or null; out [M,N] of x's type. Scratch from the
// caller: xq [M,Kp] int8 and sx [M] fp32, 16-byte aligned; with splits > 1
// also counters [tiles] and partials [splits * tiles * 128 * bn] int32.
// bn (64, 96, 128, 144 or 192) and splits (1..k_tiles) are plan_q8's. Returns
// cudaGetLastError(), -1 for arguments the kernels do not take, -2 if the
// cuTensorMapEncodeTiled is not found in libcuda, -1000 - CUresult if it fails.
extern "C" int stk_q8_matmul(const void* x, const void* wq, const void* sw, const void* bias,
                             void* out, void* xq, void* sx, void* counters, void* partials,
                             int M, int K, int N, int Kp, int bn, int splits,
                             int x_bf16, int bias_bf16, void* stream) {
    const int k_tiles = (Kp + BK - 1) / BK;
    if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp >= K + 16 || Kp % 16 != 0
        || (bn != 64 && bn != 96 && bn != 128 && bn != 144 && bn != 192)
        || splits < 1 || splits > k_tiles
        || reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(wq) % 16 != 0
        || (splits > 1 && (counters == nullptr || partials == nullptr
                           || reinterpret_cast<uintptr_t>(partials) % 16 != 0)))
        return -1;
    CUtensorMap tx, tw;
    int rc = q8_map(&tx, xq, M, Kp, BM);
    if (rc != 0) return rc;
    rc = q8_map(&tw, wq, N, Kp, bn);
    if (rc != 0) return rc;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_counters = splits > 1 ? ((M + BM - 1) / BM) * ((N + bn - 1) / bn) : 0;
    if (x_bf16) {
        rc = launch_quantize<__nv_bfloat16>(x, xq, sx, counters, n_counters, M, K, Kp, s);
        if (rc != 0) return rc;
        return launch_gemm_bn<__nv_bfloat16>(bn, tx, tw, sx, sw, bias, bias_bf16, out, partials,
                                             counters, M, N, k_tiles, splits, s);
    }
    rc = launch_quantize<float>(x, xq, sx, counters, n_counters, M, K, Kp, s);
    if (rc != 0) return rc;
    return launch_gemm_bn<float>(bn, tx, tw, sx, sw, bias, bias_bf16, out, partials, counters,
                                 M, N, k_tiles, splits, s);
}
