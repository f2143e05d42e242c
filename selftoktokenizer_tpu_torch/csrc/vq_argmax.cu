// Fused score + first-occurrence argmax over a VQ codebook, for Hopper (sm_90a).
//
//   s(n,c)  = 16 __fmaf_rn in the order d = 0..15:  s = fma(z[n][d], E[c][d], s), s0 = 0
//   ids[n]  = argmax_c s(n,c)                       (ties -> lowest c)
//
// Replaces the Pallas TPU kernel selftoktokenizer_tpu/ops/vq_kernels.py::vq_argmax.
//
// Bound on an H100. The exact scores are 2*N*C*16 fp32 operations, 0.064 ms
// at N = 4096, C = 32768 on the CUDA cores (67 TFLOP/s); the same products on
// the TF32 tensor cores (495 TFLOP/s) take 0.0087 ms, and one CUDA-core
// compare per score, N*C / (132 SMs x 128 lanes x clock), 0.0040 ms. Bytes
// (z, E, ids: 2.4 MB) take 0.0007 ms. So this kernel screens on the tensor
// cores and keeps the CUDA cores for about one operation per score.
//
// Design.
//  1. Screen. Each block owns ROWS rows of z (a warpgroup 64 of them) and one
//     split of the codebook, staged TILE_C = 128 codes at a time through a
//     four-tile cp.async ring (a code past C is staged as a copy of code
//     C-1, so it changes no maximum and never wins a tie). Each tile is
//     stored with the 64-byte swizzle wgmma reads, and each warpgroup screens
//     it with two wgmma.m64n128k8 TF32 (both operands K-major, as z and E
//     already are): z rounded by cvt.rna.tf32.f32 once per block and held in
//     registers, E read from shared memory as its fp32 bits, which the tensor
//     core reads as TF32 by dropping the low 13 bits (truncation: twice the
//     error of rounding, counted so below). torch.backends.cuda.matmul.
//     allow_tf32 does not govern this kernel and need not: the screen only
//     chooses which codes are scored exactly, and the ids are exact (below).
//  2. Bound of the screen. For every (n, c):
//        |screen(n,c) - s(n,c)| <= K_EPS * ||z_n|| * ||e_c||  =: eps(n,c),
//     with u = 2^-24 (fp32) and v = 2^-11 (TF32 unit roundoff), summed over
//     T = sum_d |z_d e_d| <= ||z|| ||e|| (Cauchy-Schwarz):
//        operands           z rounded (v), E truncated (2v):
//                           |z'e' - z e| <= (3v + 2v^2) |z e|   1.5 * 2^-10 + 2^-21
//        tensor-core sums   allowance 2^-17 (1 + v)(1 + 2v) T    2^-17 (1.002)
//          (products of TF32 values are exact in fp32; the accumulation is
//           not IEEE, it may align to the largest term and truncate; 2^-17 is
//           over four times the ~18 truncations of 2^-23 two k8 steps can make)
//        the exact chain    |s - sum z e| <= 16u / (1 - 16u) T    2^-20 (1.000001)
//     which sums to 1.5093 * 2^-10 * T; K_EPS = 1.5625 * 2^-10 leaves 3.5 %.
//     The norms are computed with upward rounding (__fmaf_ru, __fsqrt_ru) and
//     floored at NORM_FLOOR = 2^-50, which also covers the absolute error of
//     subnormal operands or products the tensor core may flush (at most
//     16 * 2^-126 * max(||z||, ||e||, 1) < K_EPS * 2^-50 * max(...)). Inputs
//     must be finite with |scores| far below 2^127. Per staged tile the
//     kernel uses the largest norm of its codes, nmax >= ||e_c||, so
//     kz * nmax >= eps(n,c) with kz = K_EPS * ||z_n|| rounded up. Warpgroup 0
//     finds the next tile's nmax while the current one is screened, so a
//     tile costs one block barrier.
//  3. Exact by interval. Each thread keeps, per row, a lower bound L on the
//     best exact score. At each tile, L = max(L, fma_rd(-kz, nmax, M)), M the
//     tile's largest screen (the code c' behind it has s(c') >= M - eps >=
//     that), shared over the row's four lanes; then a code of the tile is
//     re-scored exactly (the chain above, from the staged fp32 z and E) iff
//     screen >= fma_rd(-kz, nmax, L), and every exact score raises L.
//     Proof that the first-occurrence argmax c* is always re-scored: every
//     term of L is <= s(c) for some code c, and s(c) <= s(c*), so L <= s(c*)
//     at every moment, whichever codes, threads or splits built it; and
//     screen(c*) >= s(c*) - eps(c*) >= L - kz * nmax >= fma_rd(-kz, nmax, L).
//     Every re-scored code is merged under "higher exact score wins, equal
//     scores -> lower index", within the thread, over the four lanes of a
//     row, and over the splits; c* beats every other re-scored code under
//     that rule, so the result is the first-occurrence argmax of the exact
//     scores: the same ids as the kernel that scored every code exactly.
//  4. Few re-scores. A tile re-scores only codes within about 2 eps of the
//     best screen so far, its own included: on random codebooks about
//     ln(tiles of the split) + 1 codes per row and split. Identical codes
//     make every code a candidate (correct, and the slowest case).
//  5. Fill the card. The host planner (ops/vq_kernels.py::plan_vq) splits
//     the codebook S ways so that the grid (row tiles, S) fills one wave.
//     Each block writes its per-row (best, arg) to scratch; a per-row-tile
//     arrival counter lets the last block merge the splits in ascending
//     order, write ids and set the counter back to 0 for the next launch on
//     the stream (the wrapper zeroes the counters once for each device and
//     stream, so launches on two streams never share them; no memset per
//     call).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::smem_u32;

constexpr int D = 16;
constexpr int WGS = 2;                      // warpgroups, 64 rows each
constexpr int THREADS = 128 * WGS;
constexpr int ROWS = 64 * WGS;              // rows of z per block
constexpr int TILE_C = 128;                 // codes per staged tile: one wgmma N
constexpr int STAGES = 4;                   // code tiles in flight or in use
constexpr int TILE_BYTES = TILE_C * D * 4;
constexpr float K_EPS = 1.5625f / 1024.0f;  // eps(n,c) = K_EPS * ||z_n|| * ||e_c||
constexpr float NORM_FLOOR = 8.8817841970012523e-16f;   // 2^-50

static_assert(TILE_C == 128, "warpgroup 0 computes the norms, one thread per code");
static_assert(THREADS >= ROWS, "one thread per row merges the splits");

// 16 bytes global -> shared
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// every group but the newest has landed
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// A code tile is [TILE_C codes][16 floats], rows of 64 bytes with the 64-byte
// swizzle wgmma reads: the 16-byte chunk k4 of code c sits at chunk
// k4 ^ ((c >> 1) & 3) of its row (the tile is 1024-byte aligned).
__device__ __forceinline__ uint32_t chunk_offset(int c, int k4) {
    return static_cast<uint32_t>(c * 64 + ((k4 ^ ((c >> 1) & 3)) << 4));
}

// K-major operand with the 64-byte swizzle: 8-row groups 512 bytes apart
// (stride byte offset 32 in 16-byte units), leading byte offset unused (1),
// layout type 2 (B64)
__device__ __forceinline__ uint64_t desc_b64(uint32_t saddr) {
    return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(32) << 32) | (static_cast<uint64_t>(2) << 62);
}

// D (64 x 128, fp32) = or += A (64 x 8, TF32, registers) * B (8 x 128, TF32,
// shared memory through `desc`); thread t of the warpgroup holds
// d[4j + 2h + e] = D[16 (t/32) + (t%32)/4 + 8h][8j + 2 (t%4) + e]
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// ||e|| of code c of a staged tile, rounded up at every step, floored
__device__ __forceinline__ float code_norm_ru(const unsigned char* tile, int c) {
    float s = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < D / 4; ++k4) {
        const float4 t = *reinterpret_cast<const float4*>(tile + chunk_offset(c, k4));
        s = __fmaf_ru(t.x, t.x, s); s = __fmaf_ru(t.y, t.y, s);
        s = __fmaf_ru(t.z, t.z, s); s = __fmaf_ru(t.w, t.w, s);
    }
    return fmaxf(__fsqrt_ru(s), NORM_FLOOR);
}

__device__ __forceinline__ float norm_ru(const float4* v) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
        const float4 t = v[i];
        s = __fmaf_ru(t.x, t.x, s); s = __fmaf_ru(t.y, t.y, s);
        s = __fmaf_ru(t.z, t.z, s); s = __fmaf_ru(t.w, t.w, s);
    }
    return fmaxf(__fsqrt_ru(s), NORM_FLOOR);
}

// the exact score: 16 __fmaf_rn in the order d = 0..15
__device__ __forceinline__ float exact_score(const float4* z, const unsigned char* tile, int c) {
    float s = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < D / 4; ++k4) {
        const float4 a = z[k4];
        const float4 b = *reinterpret_cast<const float4*>(tile + chunk_offset(c, k4));
        s = __fmaf_rn(a.x, b.x, s); s = __fmaf_rn(a.y, b.y, s);
        s = __fmaf_rn(a.z, b.z, s); s = __fmaf_rn(a.w, b.w, s);
    }
    return s;
}

__device__ __forceinline__ bool better(float s, int c, float best, int arg) {
    return s > best || (s == best && c < arg);
}

// grid (row tiles, splits). Scratch, when splits > 1: part_best / part_arg
// [row tiles][splits][ROWS]; counters [row tiles], zero between launches.
// rescored (may be null): per row, the number of codes scored exactly.
__global__ void __launch_bounds__(THREADS, 1)
vq_argmax_kernel(const float* __restrict__ z, const float* __restrict__ embed,
                 int* __restrict__ ids, float* __restrict__ part_best, int* __restrict__ part_arg,
                 unsigned* __restrict__ counters, int* __restrict__ rescored,
                 int N, int C, int splits) {
    __shared__ __align__(16) unsigned char ring_raw[STAGES * TILE_BYTES + 1024];
    __shared__ __align__(16) float zs[ROWS * D];          // z rows, fp32
    __shared__ float nw[STAGES][TILE_C / 32];             // per warp of warpgroup 0, the largest norm of its codes
    __shared__ int s_last;

    unsigned char* ring = ring_raw + ((1024u - (smem_u32(ring_raw) & 1023u)) & 1023u);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int q = lane & 3;
    const int row0 = blockIdx.x * ROWS;
    const int split = blockIdx.y;
    const int c_tiles = (C + TILE_C - 1) / TILE_C;
    const int per = c_tiles / splits, rem = c_tiles % splits;
    const int t_begin = split * per + min(split, rem);
    const int n_tiles = per + (split < rem ? 1 : 0);

    // a code past C is staged as a copy of code C-1: it changes no maximum
    auto stage_codes = [&](int slot, int t) {
        const uint32_t base = smem_u32(ring + slot * TILE_BYTES);
        for (int i = tid; i < TILE_C * (D / 4); i += THREADS) {
            const int cl = i / (D / 4), k4 = i % (D / 4);
            const int c = min(t * TILE_C + cl, C - 1);
            cp16(base + chunk_offset(cl, k4), embed + (size_t)c * D + 4 * k4, 16);
        }
    };
    for (int i = tid; i < ROWS * (D / 4); i += THREADS) {
        const int r = row0 + i / (D / 4);
        const bool ok = r < N;
        cp16(smem_u32(zs + 4 * i), ok ? z + (size_t)r * D + 4 * (i % (D / 4)) : z, ok ? 16 : 0);
    }
    // one group per tile, empty past the split: z and tiles 0, 1, 2 in flight;
    // tile it + 1 lands before tile it is screened, tile it + 2 is in flight
    for (int t = 0; t < STAGES - 1; ++t) {
        if (t < n_tiles) stage_codes(t, t_begin + t);
        cp_commit();
    }

    // this thread's rows: warpgroup warp/4 holds rows 64 (warp/4) .. +63,
    // warp 16 of them; the thread the rows g and g + 8 of its warp's 16
    const float4* zs4 = reinterpret_cast<const float4*>(zs);
    const int lrow[2] = {warp * 16 + g, warp * 16 + g + 8};

    // the largest code norm of a tile, by warpgroup 0 (one thread per code),
    // published by the next block barrier
    auto tile_norm = [&](int slot) {
        if (tid < TILE_C) {
            float n = code_norm_ru(ring + slot * TILE_BYTES, tid);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) n = fmaxf(n, __shfl_xor_sync(0xffffffffu, n, o));
            if (lane == 0) nw[slot][warp] = n;
        }
    };
    cp_wait1();
    __syncthreads();                           // z and the first two code tiles landed
    tile_norm(0);
    uint32_t a[2][4];                          // [k step]: k = q <-> d = 8t + q, k = q + 4 <-> d = 8t + q + 4
#pragma unroll
    for (int t = 0; t < 2; ++t) {
        a[t][0] = tf32(zs[lrow[0] * D + 8 * t + q]);
        a[t][1] = tf32(zs[lrow[1] * D + 8 * t + q]);
        a[t][2] = tf32(zs[lrow[0] * D + 8 * t + q + 4]);
        a[t][3] = tf32(zs[lrow[1] * D + 8 * t + q + 4]);
    }
    float kz[2], L[2], best[2];
    int arg[2], cnt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        kz[r] = __fmul_ru(K_EPS, norm_ru(zs4 + lrow[r] * 4));
        // rows past N take part in nothing
        L[r] = row0 + lrow[r] < N ? -CUDART_INF_F : CUDART_INF_F;
        best[r] = -CUDART_INF_F;
        arg[r] = t_begin * TILE_C;
        cnt[r] = 0;
    }

    float acc[64];
    for (int it = 0; it < n_tiles; ++it) {
        const int slot = it % STAGES;
        cp_wait1();
        hopper::fence_async_shared();          // the landed tiles, to wgmma's proxy
        __syncthreads();                       // tiles it, it+1 landed; tile it's norm is out; tile it-1 is done
        if (it + STAGES - 1 < n_tiles) stage_codes((it + STAGES - 1) % STAGES, t_begin + it + STAGES - 1);
        cp_commit();
        const unsigned char* tile = ring + slot * TILE_BYTES;
        float nmax = nw[slot][0];
#pragma unroll
        for (int w = 1; w < TILE_C / 32; ++w) nmax = fmaxf(nmax, nw[slot][w]);
        if (it + 1 < n_tiles) tile_norm((it + 1) % STAGES);
        const int cbase = (t_begin + it) * TILE_C;
        const uint32_t tile_s = smem_u32(tile);

        // the screen of the tile for this warpgroup's 64 rows, into acc
        auto screen = [&]() {
            hopper::fence_regs(acc);
            hopper::wgmma_fence();
            wgmma_tf32(acc, a[0], desc_b64(tile_s), 0);
            wgmma_tf32(acc, a[1], desc_b64(tile_s + 32), 1);
            hopper::wgmma_commit();
            hopper::wgmma_wait0();
            hopper::fence_regs(acc);
        };
        float gmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
        screen();
#pragma unroll
        for (int i = 0; i < 64; ++i) gmax[(i >> 1) & 1] = fmaxf(gmax[(i >> 1) & 1], acc[i]);
        float T[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            // the tile's own maximum raises L before any of its codes is tested
            L[r] = fmaxf(L[r], __fmaf_rd(-kz[r], nmax, gmax[r]));
            L[r] = fmaxf(L[r], __shfl_xor_sync(0xffffffffu, L[r], 1));
            L[r] = fmaxf(L[r], __shfl_xor_sync(0xffffffffu, L[r], 2));
            T[r] = __fmaf_rd(-kz[r], nmax, L[r]);
        }
        // an exact score for every screen that reaches T
        if (gmax[0] >= T[0] || gmax[1] >= T[1]) {
            uint32_t flag[2] = {0u, 0u};        // bit 2j + e: code 8j + 2q + e of the tile
#pragma unroll
            for (int i = 0; i < 64; ++i)
                if (acc[i] >= T[(i >> 1) & 1]) flag[(i >> 1) & 1] |= 1u << (2 * (i >> 2) + (i & 1));
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                while (flag[r]) {
                    const int bit = __ffs(flag[r]) - 1;
                    flag[r] &= flag[r] - 1;
                    const int col = (bit >> 1) * 8 + 2 * q + (bit & 1);
                    const int code = cbase + col;
                    if (code >= C) continue;
                    const float s = exact_score(zs4 + lrow[r] * 4, tile, col);
                    ++cnt[r];
                    L[r] = fmaxf(L[r], s);
                    T[r] = __fmaf_rd(-kz[r], nmax, L[r]);
                    if (better(s, code, best[r], arg[r])) { best[r] = s; arg[r] = code; }
                }
            }
        }
    }

    // merge the four lanes of each row; lane q = 0 holds the split's result
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
            const float bo = __shfl_xor_sync(0xffffffffu, best[r], o);
            const int ao = __shfl_xor_sync(0xffffffffu, arg[r], o);
            if (better(bo, ao, best[r], arg[r])) { best[r] = bo; arg[r] = ao; }
            cnt[r] += __shfl_xor_sync(0xffffffffu, cnt[r], o);
        }
    }
    if (q == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = row0 + lrow[r];
            if (row >= N) continue;
            if (rescored != nullptr) atomicAdd(&rescored[row], cnt[r]);
            if (splits == 1) {
                ids[row] = arg[r];
            } else {
                const size_t o = ((size_t)blockIdx.x * splits + split) * ROWS + lrow[r];
                part_best[o] = best[r];
                part_arg[o] = arg[r];
            }
        }
    }
    if (splits == 1) return;

    // the last split to arrive for this row tile merges all splits in order
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&counters[blockIdx.x], 1u) == static_cast<unsigned>(splits - 1);
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const int row = row0 + tid;
    if (tid < ROWS && row < N) {
        const size_t base = (size_t)blockIdx.x * splits * ROWS + tid;
        float b = __ldcg(part_best + base);
        int a0 = __ldcg(part_arg + base);
        for (int o = 1; o < splits; ++o) {
            const float bo = __ldcg(part_best + base + (size_t)o * ROWS);
            const int ao = __ldcg(part_arg + base + (size_t)o * ROWS);
            if (better(bo, ao, b, a0)) { b = bo; a0 = ao; }
        }
        ids[row] = a0;
    }
    if (tid == 0) counters[blockIdx.x] = 0u;
}

}  // namespace

// z [N,16], embed [C,16] fp32, ids [N] int32, every array contiguous and
// 16-byte aligned. splits > 1 needs part_best / part_arg of
// row_tiles * splits * ROWS (256) values each and counters [row_tiles], all zero
// and used by no launch that may run at the same time (left zero again).
// rescored: null, or [N] int32 zeros that receive each row's number of
// exactly scored codes. Launches on `stream`; returns cudaGetLastError().
extern "C" int stk_vq_argmax(const void* z, const void* embed, void* ids, void* part_best,
                             void* part_arg, void* counters, void* rescored,
                             int N, int C, int splits, void* stream) {
    const dim3 grid((N + ROWS - 1) / ROWS, splits);
    vq_argmax_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(z), static_cast<const float*>(embed), static_cast<int*>(ids),
        static_cast<float*>(part_best), static_cast<int*>(part_arg),
        static_cast<unsigned*>(counters), static_cast<int*>(rescored), N, C, splits);
    return static_cast<int>(cudaGetLastError());
}
