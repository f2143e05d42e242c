// 3x3 SAME stride-1 convolution from 3 input channels, NHWC:
//
//   out[b,h,w,c] = round_T( sum_{dy,dx,ci} x[b,h+dy-1,w+dx-1,ci] * round_T(W[c,ci,dy,dx])
//                           + bias[c] )
//
// with the 27 taps summed in fp32 in (dy, dx, ci) order and zero outside the
// image. T is the type of x and of the output (bf16 or fp32); W (torch's OIHW
// layout) and the bias come in fp32, W is rounded to T as the TPU kernel casts
// it, the bias is added in fp32. Replaces the Pallas TPU kernel
// selftoktokenizer_tpu/ops/conv3ch.py::conv3ch_3x3 (a 27-tap im2col per row
// band, padded to 32, one matmul plus bias), which no path of the JAX package
// runs; neither does this one yet.
//
// Bound on an H100: the output stream. At the VAE's conv_in, [8,256,256,3] ->
// 128 channels, it writes 134 MB in bf16 (40 us at 3.35 TB/s) from 3 MB of
// input, against 3.6 GFLOP (3.7 us on the bf16 tensor cores). The TPU kernel
// built the patch tensor in VMEM to avoid an im2col in HBM; here a block
// stages its (ROWS+2) x (W+2) x 3 input band in shared memory once and keeps
// the 27 x C weights there, so nothing but x is read from device memory and
// no patch tensor exists anywhere. Each thread produces one pixel x 8
// channels with CUDA-core FMAs (1.8 G FMA: about 54 us at the fp32 rate, so
// this simple kernel cannot reach the byte bound; a tensor-core variant is
// later work) and stores them as one 16-byte vector along C. Any H, W and C
// are taken: the ragged edges are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;             // output rows per block
constexpr int CG = 8;               // channels per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_t(float v, float) { return v; }
__device__ __forceinline__ float round_t(float v, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// floats of the input band, rounded up to a multiple of 4 so that the weight
// table after it starts on a 16-byte boundary
__host__ __device__ __forceinline__ int band_floats(int W) {
    return ((ROWS + 2) * (W + 2) * 3 + 3) / 4 * 4;
}

__host__ __device__ __forceinline__ int padded_channels(int C) { return (C + CG - 1) / CG * CG; }

__device__ __forceinline__ void store8(float* p, const float v[CG], bool vec) {
    if (vec) {
        reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
        for (int i = 0; i < CG; ++i) p[i] = v[i];
    }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[CG], bool vec) {
    if (vec) {
        uint4 u;
        __nv_bfloat162 h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        u.x = *reinterpret_cast<uint32_t*>(&h[0]);
        u.y = *reinterpret_cast<uint32_t*>(&h[1]);
        u.z = *reinterpret_cast<uint32_t*>(&h[2]);
        u.w = *reinterpret_cast<uint32_t*>(&h[3]);
        *reinterpret_cast<uint4*>(p) = u;
    } else {
#pragma unroll
        for (int i = 0; i < CG; ++i) p[i] = __float2bfloat16_rn(v[i]);
    }
}

// grid: (ceil(H / ROWS), B); dynamic shared memory: band_floats(W) floats of
// input band, then 27*Cp floats of weights (Cp = C rounded up to CG), then Cp
// floats of bias.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3ch_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, T* __restrict__ out,
               int H, int W, int C, int vec) {
    extern __shared__ __align__(16) float smem[];
    const int Cp = padded_channels(C);
    const int band_w = W + 2;
    float* band = smem;                                  // [ROWS+2][W+2][3]
    float* ws = band + band_floats(W);                   // [27][Cp], tap = (dy*3+dx)*3+ci
    float* bs = ws + 27 * Cp;                            // [Cp]

    const int b = blockIdx.y;
    const int h0 = blockIdx.x * ROWS;
    const int tid = threadIdx.x;

    const int n_band = (ROWS + 2) * band_w * 3;
    for (int i = tid; i < n_band; i += THREADS) {
        const int ci = i % 3;
        const int col = (i / 3) % band_w;
        const int r = i / (3 * band_w);
        const int hh = h0 + r - 1;
        const int ww = col - 1;
        float v = 0.f;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            v = to_f(x[(((size_t)b * H + hh) * W + ww) * 3 + ci]);
        band[i] = v;
    }
    for (int i = tid; i < 27 * Cp; i += THREADS) {
        const int c = i % Cp;
        const int tap = i / Cp;
        const int ci = tap % 3;
        const int dx = (tap / 3) % 3;
        const int dy = tap / 9;
        // OIHW: w[c][ci][dy][dx]
        ws[i] = c < C ? round_t(w[((c * 3 + ci) * 3 + dy) * 3 + dx], T()) : 0.f;
    }
    for (int i = tid; i < Cp; i += THREADS) bs[i] = i < C ? bias[i] : 0.f;
    __syncthreads();

    const int groups = Cp / CG;
    const int rows_here = min(ROWS, H - h0);
    const int items = rows_here * W * groups;
    for (int it = tid; it < items; it += THREADS) {
        const int cg = it % groups;
        const int pix = it / groups;
        const int pw = pix % W;
        const int pr = pix / W;
        float acc[CG];
#pragma unroll
        for (int i = 0; i < CG; ++i) acc[i] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
                for (int ci = 0; ci < 3; ++ci) {
                    const float xv = band[((pr + dy) * band_w + pw + dx) * 3 + ci];
                    const float4* wr = reinterpret_cast<const float4*>(
                        ws + ((dy * 3 + dx) * 3 + ci) * Cp + cg * CG);
                    const float4 w0 = wr[0], w1 = wr[1];
                    acc[0] = __fmaf_rn(xv, w0.x, acc[0]); acc[1] = __fmaf_rn(xv, w0.y, acc[1]);
                    acc[2] = __fmaf_rn(xv, w0.z, acc[2]); acc[3] = __fmaf_rn(xv, w0.w, acc[3]);
                    acc[4] = __fmaf_rn(xv, w1.x, acc[4]); acc[5] = __fmaf_rn(xv, w1.y, acc[5]);
                    acc[6] = __fmaf_rn(xv, w1.z, acc[6]); acc[7] = __fmaf_rn(xv, w1.w, acc[7]);
                }
            }
        }
        const int c0 = cg * CG;
#pragma unroll
        for (int i = 0; i < CG; ++i) acc[i] = __fadd_rn(acc[i], bs[c0 + i]);
        T* dst = out + (((size_t)b * H + h0 + pr) * W + pw) * C + c0;
        if (c0 + CG <= C) {
            store8(dst, acc, vec != 0);
        } else {
            for (int i = 0; c0 + i < C; ++i) store1(dst + i, acc[i]);
        }
    }
}

size_t smem_bytes(int W, int C) {
    return sizeof(float) * ((size_t)band_floats(W) + 28 * (size_t)padded_channels(C));
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, void* out,
           int B, int H, int W, int C, cudaStream_t s) {
    const size_t smem = smem_bytes(W, C);
    cudaError_t e = cudaFuncSetAttribute(conv3ch_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    // 16-byte stores need C * itemsize to be a multiple of 16 and an aligned base
    const int vec = (C % CG == 0) && ((C * sizeof(T)) % 16 == 0)
                    && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const dim3 grid((H + ROWS - 1) / ROWS, B);
    conv3ch_kernel<T><<<grid, THREADS, smem, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<T*>(out), H, W, C, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B,H,W,3] (bf16 when x_bf16, else fp32), w [C,3,3,3] fp32 (OIHW),
// bias [C] fp32, out [B,H,W,C] of x's type; every array contiguous.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int stk_conv3ch(const void* x, const void* w, const void* bias, void* out,
                           int B, int H, int W, int C, int x_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return x_bf16 ? launch<__nv_bfloat16>(x, w, bias, out, B, H, W, C, s)
                  : launch<float>(x, w, bias, out, B, H, W, C, s);
}

// Shared memory the kernel needs for width W and C channels, in bytes (the
// wrapper refuses a shape above the card's 227 KB per block).
extern "C" long long stk_conv3ch_smem(int W, int C) {
    return static_cast<long long>(smem_bytes(W, C));
}
