// W8A8 int8 matrix product with the activation quantization fused in.
//
//   sx[m]   = max(max_k |x[m][k]| * fp32(1/127), 1e-8)
//   xq[m,k] = clamp(rint(x[m][k] / sx[m]), -127, 127)             (int8)
//   acc     = sum_k xq[m,k] * wq[n,k]                             (int32, exact)
//   bf16:  y = bf16((float(acc) * sx[m]) * sw[n]);  out = bf16(float(y) + float(bf16(bias[n])))
//   fp32:  out = fma(float(acc) * sx[m], sw[n], bias[n])  (no bias: the product)
//
// T is the type of x and of the output (bf16 or fp32). In fp32 the bias
// enters through one fused multiply-add because XLA contracts the
// reference's product and sum into one (its bf16 path rounds in between, so
// nothing is contracted there). Replaces the Pallas TPU
// kernel selftoktokenizer_tpu/ops/q8_matmul.py::q8_matmul; the bias step is the
// one ops/q8_matmul.py::q8_linear adds in x's type after the kernel. The
// scale is a product with the fp32 reciprocal of 127, not a division: XLA
// rewrites the reference's division by the constant 127 so in every compiled
// program (the Pallas kernel and the jitted decode alike).
//
// Bound on an H100: 2*M*K*N int8 tensor-core operations (1,979 TOP/s) against
// M*K*itemsize + K*N + 6*N + M*N*itemsize bytes (3.35 TB/s). At the decode's
// shapes (M = 512 or 1024) the two are close: the x-stream qkv [512,1536] x
// [1536,4608] is 3.7 us of operations and 4.0 us of bytes, so the product sits
// below the ridge point and the int8 weights (half the bytes of bf16) are where
// the card can gain.
//
// Design, simple and exact first. One block owns a 64 x 128 output tile and
// 256 threads (8 warps, each a 32 x 32 warp tile of mma.sync m16n8k32 s8).
// It first reads its 64 rows of x once to get sx, then walks K in 64-wide
// tiles: each x tile is quantized on the way into shared memory (the TPU
// kernel quantizes its whole row block in VMEM), each int8 weight tile is
// copied as it is. Torch's [out, in] weight layout is the mma's "col" B
// operand without a transpose. K is padded with zero int8 columns inside the
// kernel (K = 16 at the context embedder); ragged M and N are masked, and
// nothing is padded in device memory. Every float step is an explicitly
// rounded intrinsic (__fmul_rn, __fdiv_rn, rintf, __fadd_rn, __fmaf_rn), so
// no contraction of the compiler's or fast division can make the result
// differ from the plain PyTorch version, which it equals bit for bit. Later work: wgmma with TMA,
// and quantizing x once per linear instead of once per column tile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64;              // rows of x per block
constexpr int BN = 128;             // output columns per block
constexpr int BK = 64;              // int8 depth per shared tile
constexpr int LDS = BK + 16;        // padded shared row (80 bytes): conflict-free fragment reads
constexpr float INV127 = 1.0f / 127.0f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load4(const float* p, float v[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ uint32_t quant(float v, float sx) {
    float q = rintf(__fdiv_rn(v, sx));               // half to even, IEEE division
    q = fminf(fmaxf(q, -127.f), 127.f);
    return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ float round_out(float v, float) { return v; }
__device__ __forceinline__ float round_out(float v, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);                     // v is already a bf16 value
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
q8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ sw, const void* __restrict__ bias,
                 int bias_bf16, T* __restrict__ out, int M, int K, int N,
                 int x_vec, int w_vec) {
    __shared__ __align__(16) uint8_t As[BM * LDS];
    __shared__ __align__(16) uint8_t Bs[BN * LDS];
    __shared__ float s_sx[BM];

    constexpr bool OUT_F32 = sizeof(T) == sizeof(float);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;

    // ---- per-row activation scale: warp w reduces rows 8w .. 8w+7
    for (int r = warp * (BM / 8); r < (warp + 1) * (BM / 8); ++r) {
        const int row = m0 + r;
        float amax = 0.f;
        if (row < M) {
            const T* xr = x + (size_t)row * K;
            if (x_vec) {
                for (int k = lane * 4; k < K; k += 128) {
                    float v[4];
                    load4(xr + k, v);
                    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                                             fmaxf(fabsf(v[2]), fabsf(v[3]))));
                }
            } else {
                for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f(xr[k])));
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        if (lane == 0) s_sx[r] = row < M ? fmaxf(__fmul_rn(amax, INV127), 1e-8f) : 1.f;
    }

    const int warp_m = warp >> 2;       // 0..1: rows warp_m*32 ..
    const int warp_n = warp & 3;        // 0..3: cols warp_n*32 ..
    const int g = lane >> 2;            // mma groupID
    const int t4 = lane & 3;            // mma threadID_in_group

    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    __syncthreads();                    // s_sx ready

    for (int k0 = 0; k0 < K; k0 += BK) {
        // x tile: 64 rows x 64 k, four consecutive k per thread and step,
        // quantized and packed into one 32-bit shared word
#pragma unroll
        for (int i = 0; i < (BM * BK / 4) / THREADS; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx >> 4;
            const int kq = (idx & 15) * 4;
            const int row = m0 + r;
            const int k = k0 + kq;
            float v[4] = {0.f, 0.f, 0.f, 0.f};
            if (row < M) {
                const T* xr = x + (size_t)row * K;
                if (x_vec && k + 3 < K) {
                    load4(xr + k, v);
                } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e) if (k + e < K) v[e] = to_f(xr[k + e]);
                }
            }
            const float sx = s_sx[r];
            const uint32_t packed = quant(v[0], sx) | (quant(v[1], sx) << 8)
                                  | (quant(v[2], sx) << 16) | (quant(v[3], sx) << 24);
            *reinterpret_cast<uint32_t*>(&As[r * LDS + kq]) = packed;
        }
        // weight tile: 128 output rows x 64 bytes of K, 16 bytes per thread and step
#pragma unroll
        for (int i = 0; i < (BN * BK / 16) / THREADS; ++i) {
            const int idx = tid + i * THREADS;
            const int n = idx >> 2;
            const int kc = (idx & 3) * 16;
            const int col = n0 + n;
            const int k = k0 + kc;
            uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
            if (col < N) {
                const int8_t* wr = wq + (size_t)col * K;
                if (w_vec && k + 15 < K) {
                    chunk = *reinterpret_cast<const uint4*>(wr + k);
                } else {
                    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                    for (int e = 0; e < 16; ++e)
                        if (k + e < K)
                            words[e >> 2] |= (static_cast<uint32_t>(static_cast<uint8_t>(wr[k + e]))
                                              << (8 * (e & 3)));
                    chunk = make_uint4(words[0], words[1], words[2], words[3]);
                }
            }
            *reinterpret_cast<uint4*>(&Bs[n * LDS + kc]) = chunk;
        }
        __syncthreads();

#pragma unroll
        for (int ks = 0; ks < BK; ks += 32) {
            uint32_t a[2][4], b[4][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                const uint8_t* base = &As[(warp_m * 32 + mt * 16 + g) * LDS + ks + t4 * 4];
                a[mt][0] = *reinterpret_cast<const uint32_t*>(base);
                a[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
                a[mt][2] = *reinterpret_cast<const uint32_t*>(base + 16);
                a[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const uint8_t* base = &Bs[(warp_n * 32 + nt * 8 + g) * LDS + ks + t4 * 4];
                b[nt][0] = *reinterpret_cast<const uint32_t*>(base);
                b[nt][1] = *reinterpret_cast<const uint32_t*>(base + 16);
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
        }
        __syncthreads();                // tiles consumed before the next load
    }

    // ---- epilogue: dequantize, round to T, add the bias in T
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = warp_m * 32 + mt * 16 + g + (e >= 2 ? 8 : 0);
                const int row = m0 + r;
                const int col = n0 + warp_n * 32 + nt * 8 + t4 * 2 + (e & 1);
                if (row >= M || col >= N) continue;
                const float p = __fmul_rn(__int2float_rn(acc[mt][nt][e]), s_sx[r]);
                float y;
                if (bias == nullptr) {
                    y = round_out(__fmul_rn(p, sw[col]), T());
                } else {
                    const float bv = round_out(bias_bf16
                        ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[col])
                        : static_cast<const float*>(bias)[col], T());
                    y = OUT_F32 ? __fmaf_rn(p, sw[col], bv)
                                : round_out(__fadd_rn(round_out(__fmul_rn(p, sw[col]), T()), bv), T());
                }
                store_out(out + (size_t)row * N + col, y);
            }
        }
    }
}

}  // namespace

// x [M,K] (bf16 when x_bf16, else fp32), wq [N,K] int8, sw [N] fp32, bias [N]
// (bf16 when bias_bf16, else fp32) or null, out [M,N] of x's type; every
// array contiguous. Launches on `stream`; returns cudaGetLastError().
extern "C" int stk_q8_matmul(const void* x, const void* wq, const void* sw,
                             const void* bias, void* out, int M, int K, int N,
                             int x_bf16, int bias_bf16, void* stream) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const int x_vec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const int w_vec = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(wq) % 16 == 0);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_bf16) {
        q8_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
            static_cast<const float*>(sw), bias, bias_bf16,
            static_cast<__nv_bfloat16*>(out), M, K, N, x_vec, w_vec);
    } else {
        q8_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
            static_cast<const float*>(x), static_cast<const int8_t*>(wq),
            static_cast<const float*>(sw), bias, bias_bf16,
            static_cast<float*>(out), M, K, N, x_vec, w_vec);
    }
    return static_cast<int>(cudaGetLastError());
}
