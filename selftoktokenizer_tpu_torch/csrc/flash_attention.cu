// Fused softmax attention with an optional per-key mask (forward only).
//
//   out = softmax(q k^T / sqrt(D) + bias) v,   bias[b, key] = mask ? 0 : -1e30
//
// Replaces the Pallas TPU kernel
// selftoktokenizer_tpu/ops/flash_attention.py::_flash_mha (entered through
// flash_sdpa_key_mask). The TPU kernel keeps one head's whole K and V in VMEM
// and softmaxes a [block_q, Lk] tile in one pass; a block on Hopper has
// 227 KB of shared memory, so here the grid is (q tile, batch*head), a loop
// walks K/V in tiles of 64 keys staged in shared memory, and the softmax is
// the online one (running max, running sum, fp32 accumulator). The mask is
// read per K tile from [B, Lk] with batch index blockIdx.y / H and applied as
// a finite -1e30 added in fp32, so a fully masked row yields the uniform mean
// over the Lk real keys. Keys past Lk in the last tile get -inf (weight 0)
// and rows past Lq are not stored, so any Lq and Lk are accepted.
//
// bf16 inputs: mma.sync m16n8k16 tensor-core products with fp32 accumulate,
// P cast to bf16 before P V. fp32 inputs: fp32 FMAs on the CUDA cores
// throughout. Bound: 4*B*H*Lq*Lk*D FLOP against (2*Lq + 2*Lk)*D*B*H*itemsize
// bytes; at the flagship shapes the operations bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float NEG_BIAS = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per shared tile

struct Params {
    const void* q; const void* k; const void* v; void* o;
    const unsigned char* mask;        // [B, Lk] bytes, non-zero = attend; or null
    int B, H, Lq, Lk;
    long long q_sb, q_sh, q_sl;       // strides in elements; last dim is dense
    long long k_sb, k_sh, k_sl;
    long long v_sb, v_sh, v_sl;
    long long o_sb, o_sh, o_sl;
    long long mask_sb;
    float scale_log2;                 // log2(e) / sqrt(D)
};

__device__ __forceinline__ void fill_bias(float* bias, const Params& p, int b,
                                          int k0, int tid) {
    if (tid < BN) {
        const int key = k0 + tid;
        float v = -CUDART_INF_F;
        if (key < p.Lk) {
            v = 0.f;
            if (p.mask != nullptr && p.mask[(long long)b * p.mask_sb + key] == 0)
                v = NEG_BIAS;
        }
        bias[tid] = v;
    }
}

// ----------------------------------------------------------------- bf16 ----

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

// rows x D bf16 from global (row stride `sl` elements) into shared [rows][LD],
// 16 bytes a thread; rows at or past `limit` are zero-filled
template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long sl, int row0, int limit,
                                               int tid) {
    constexpr int CH = D / 8;
    for (int i = tid; i < BN * CH; i += THREADS) {
        const int r = i / CH, c = i % CH;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < limit)
            val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * sl + c * 8);
        *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
    }
}

template <int D>
__global__ void __launch_bounds__(128) flash_bf16_kernel(const Params p) {
    constexpr int THREADS = 128;
    constexpr int LD = D + 8;         // padded row stride: conflict-free fragment loads
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Ks = Qs + BM * LD;
    __nv_bfloat16* Vs = Ks + BN * LD;
    float* bias = reinterpret_cast<float*>(Vs + BN * LD);

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
    const int q0 = blockIdx.x * BM;

    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
    const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

    load_tile_bf16<D, LD, THREADS>(Qs, qg, p.q_sl, q0, p.Lq, tid);
    __syncthreads();

    // this warp's 16 query rows as A fragments, kept in registers
    uint32_t qf[D / 16][4];
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LD + kk * 16 + 2 * t]);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LD + kk * 16 + 2 * t]);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LD + kk * 16 + 8 + 2 * t]);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LD + kk * 16 + 8 + 2 * t]);
    }

    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_run[2] = {0.f, 0.f};
    float o[D / 8][4];
#pragma unroll
    for (int dd = 0; dd < D / 8; ++dd) { o[dd][0] = o[dd][1] = o[dd][2] = o[dd][3] = 0.f; }

    for (int k0 = 0; k0 < p.Lk; k0 += BN) {
        __syncthreads();              // the previous tile is fully consumed
        load_tile_bf16<D, LD, THREADS>(Ks, kg, p.k_sl, k0, p.Lk, tid);
        load_tile_bf16<D, LD, THREADS>(Vs, vg, p.v_sl, k0, p.Lk, tid);
        fill_bias(bias, p, b, k0, tid);
        __syncthreads();

        // S = Q K^T for 16 rows x 64 keys
        float s[BN / 8][4];
#pragma unroll
        for (int nn = 0; nn < BN / 8; ++nn) {
            s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const __nv_bfloat16* kp = &Ks[(nn * 8 + g) * LD + kk * 16 + 2 * t];
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
                const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
                mma_bf16(s[nn], qf[kk], b0, b1);
            }
        }

        // scale into the log2 domain, add the key bias, tile row max
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int nn = 0; nn < BN / 8; ++nn) {
            const float b_lo = bias[nn * 8 + 2 * t], b_hi = bias[nn * 8 + 2 * t + 1];
            s[nn][0] = s[nn][0] * p.scale_log2 + b_lo;
            s[nn][1] = s[nn][1] * p.scale_log2 + b_hi;
            s[nn][2] = s[nn][2] * p.scale_log2 + b_lo;
            s[nn][3] = s[nn][3] * p.scale_log2 + b_hi;
            mx[0] = fmaxf(mx[0], fmaxf(s[nn][0], s[nn][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[nn][2], s[nn][3]));
        }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            // every tile holds a real key, whose score is finite, so m_new is finite
            const float m_new = fmaxf(m_run[i], mx[i]);
            alpha[i] = exp2f(m_run[i] - m_new);
            m_run[i] = m_new;
        }
#pragma unroll
        for (int nn = 0; nn < BN / 8; ++nn) {
            s[nn][0] = exp2f(s[nn][0] - m_run[0]);
            s[nn][1] = exp2f(s[nn][1] - m_run[0]);
            s[nn][2] = exp2f(s[nn][2] - m_run[1]);
            s[nn][3] = exp2f(s[nn][3] - m_run[1]);
            rs[0] += s[nn][0] + s[nn][1];
            rs[1] += s[nn][2] + s[nn][3];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
            rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
            l_run[i] = l_run[i] * alpha[i] + rs[i];
        }
#pragma unroll
        for (int dd = 0; dd < D / 8; ++dd) {
            o[dd][0] *= alpha[0]; o[dd][1] *= alpha[0];
            o[dd][2] *= alpha[1]; o[dd][3] *= alpha[1];
        }

        // O += P V, P cast to bf16; V fragments through ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int dd = 0; dd < D / 8; ++dd) {
                const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(
                    &Vs[(kk * 16 + (lane & 15)) * LD + dd * 8]));
                uint32_t b0, b1;
                asm volatile(
                    "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                    : "=r"(b0), "=r"(b1) : "r"(addr) : "memory");
                mma_bf16(o[dd], pa, b0, b1);
            }
        }
    }

    const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = q0 + r0 + 8 * i;
        if (row < p.Lq) {
            __nv_bfloat16* dst = og + (long long)row * p.o_sl;
#pragma unroll
            for (int dd = 0; dd < D / 8; ++dd) {
                *reinterpret_cast<__nv_bfloat162*>(dst + dd * 8 + 2 * t) =
                    __floats2bfloat162_rn(o[dd][2 * i] * inv[i], o[dd][2 * i + 1] * inv[i]);
            }
        }
    }
}

// ----------------------------------------------------------------- fp32 ----

// rows x D floats from global into shared [rows][LD]; float4 global loads,
// scalar shared stores (LD may be odd); rows at or past `limit` are zero-filled
template <int D, int LD, int THREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long sl, int row0, int limit,
                                              int tid) {
    constexpr int CH = D / 4;
    for (int i = tid; i < BN * CH; i += THREADS) {
        const int r = i / CH, c = i % CH;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < limit)
            val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * sl + c * 4);
        float* d = dst + r * LD + c * 4;
        d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
    }
}

template <int D>
__global__ void __launch_bounds__(256) flash_f32_kernel(const Params p) {
    constexpr int THREADS = 256;
    constexpr int LQ = D + 1;         // odd strides: conflict-free column walks
    constexpr int LP = BN + 1;
    constexpr int E = D / 16;         // output columns per thread
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(smem_raw);   // [BM][LQ]
    float* Ks = Qs + BM * LQ;                         // [BN][LQ]
    float* Vs = Ks + BN * LQ;                         // [BN][D]
    float* Ps = Vs + BN * D;                          // [BM][LP]
    float* bias = Ps + BM * LP;                       // [BN]

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;           // 16 x 16 threads, 4 x 4 scores each
    const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
    const int q0 = blockIdx.x * BM;

    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
    const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
    float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

    load_tile_f32<D, LQ, THREADS>(Qs, qg, p.q_sl, q0, p.Lq, tid);

    float m_run[4], l_run[4], acc[4][E];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        m_run[a] = -CUDART_INF_F; l_run[a] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[a][e] = 0.f;
    }

    for (int k0 = 0; k0 < p.Lk; k0 += BN) {
        __syncthreads();              // the previous tile is fully consumed
        load_tile_f32<D, LQ, THREADS>(Ks, kg, p.k_sl, k0, p.Lk, tid);
        load_tile_f32<D, D, THREADS>(Vs, vg, p.v_sl, k0, p.Lk, tid);
        fill_bias(bias, p, b, k0, tid);
        __syncthreads();

        // scores: rows ty*4 + a, keys tx + 16*c
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            float qa[4], kc[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) qa[a] = Qs[(ty * 4 + a) * LQ + d];
#pragma unroll
            for (int c = 0; c < 4; ++c) kc[c] = Ks[(tx + 16 * c) * LQ + d];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        }

        float alpha[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            float mx = -CUDART_INF_F;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                s[a][c] = s[a][c] * p.scale_log2 + bias[tx + 16 * c];
                mx = fmaxf(mx, s[a][c]);
            }
            // the 16 threads of a row are one half of a warp
#pragma unroll
            for (int off = 8; off >= 1; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m_run[a], mx);   // finite: the tile holds a real key
            alpha[a] = exp2f(m_run[a] - m_new);
            m_run[a] = m_new;
            float rs = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float pv = exp2f(s[a][c] - m_new);
                rs += pv;
                Ps[(ty * 4 + a) * LP + tx + 16 * c] = pv;
            }
#pragma unroll
            for (int off = 8; off >= 1; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l_run[a] = l_run[a] * alpha[a] + rs;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[a][e] *= alpha[a];
        }
        __syncthreads();

        // O += P V: rows ty*4 + a, columns tx + 16*e
#pragma unroll 4
        for (int j = 0; j < BN; ++j) {
            float pa[4], ve[E];
#pragma unroll
            for (int a = 0; a < 4; ++a) pa[a] = Ps[(ty * 4 + a) * LP + j];
#pragma unroll
            for (int e = 0; e < E; ++e) ve[e] = Vs[j * D + tx + 16 * e];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int e = 0; e < E; ++e) acc[a][e] = fmaf(pa[a], ve[e], acc[a][e]);
        }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int row = q0 + ty * 4 + a;
        if (row < p.Lq) {
            const float inv = 1.f / l_run[a];
            float* dst = og + (long long)row * p.o_sl;
#pragma unroll
            for (int e = 0; e < E; ++e) dst[tx + 16 * e] = acc[a][e] * inv;
        }
    }
}

template <typename K>
int launch(K kernel, const Params& p, int threads, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((p.Lq + BM - 1) / BM, p.B * p.H);
    kernel<<<grid, threads, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32. Strides are in elements; the last dimension
// (D, 64 or 128) is dense. mask may be null. Returns a cudaError_t.
extern "C" int stk_flash_attention(
        const void* q, const void* k, const void* v, void* o, const void* mask,
        int B, int H, int Lq, int Lk, int D, int dtype,
        long long q_sb, long long q_sh, long long q_sl,
        long long k_sb, long long k_sh, long long k_sl,
        long long v_sb, long long v_sh, long long v_sl,
        long long o_sb, long long o_sh, long long o_sl,
        long long mask_sb, void* stream) {
    if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || (long long)B * H > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.q = q; p.k = k; p.v = v; p.o = o;
    p.mask = static_cast<const unsigned char*>(mask);
    p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk;
    p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
    p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
    p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
    p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
    p.mask_sb = mask_sb;
    p.scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        const size_t smem = (size_t)(BM + 2 * BN) * (D + 8) * 2 + BN * 4;
        if (D == 64) return launch(flash_bf16_kernel<64>, p, 128, smem, s);
        if (D == 128) return launch(flash_bf16_kernel<128>, p, 128, smem, s);
    } else if (dtype == 1) {
        const size_t smem = ((size_t)(BM + BN) * (D + 1) + BN * D + BM * (BN + 1) + BN) * 4;
        if (D == 64) return launch(flash_f32_kernel<64>, p, 256, smem, s);
        if (D == 128) return launch(flash_f32_kernel<128>, p, 256, smem, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
