// Fused cosine-score + first-occurrence argmax over a VQ codebook.
//
//   ids[n] = argmax_c  sum_{d<16} z[n][d] * E[c][d]        (ties -> lowest c)
//
// Replaces the Pallas TPU kernel selftoktokenizer_tpu/ops/vq_kernels.py::vq_argmax.
// One block owns TILE_N rows and walks the whole codebook in tiles of TILE_C
// codes staged through shared memory. Warp w scores the codes
// [w*CODES_PER_WARP, (w+1)*CODES_PER_WARP) of each tile, lane l the rows l and
// l+32 of the block's tile, so all lanes of a warp read the same code and the
// shared-memory reads are broadcasts. Each thread keeps a running
// (best, arg) per row under strict '>' while its codes ascend; the eight
// warps are then merged per row with "higher score wins, equal -> lower
// index". A score is 16 __fmaf_rn in the fixed order d = 0..15, so it is the
// same whatever the tiling. Bound: 2*N*C*16 FLOP of fp32 FMA (CUDA cores)
// against N*64 + C*64 + N*4 bytes.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int D = 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_THREAD = 2;
constexpr int TILE_N = 32 * ROWS_PER_THREAD;       // 64 rows per block
constexpr int TILE_C = 256;                        // codes per shared tile
constexpr int CODES_PER_WARP = TILE_C / WARPS;     // 32
constexpr int VEC_PER_THREAD = TILE_C * D / 4 / THREADS;  // float4 loads: 4

__global__ void __launch_bounds__(THREADS)
vq_argmax_kernel(const float* __restrict__ z, const float* __restrict__ embed,
                 int* __restrict__ ids, int N, int C) {
    __shared__ float4 tile[TILE_C * D / 4];
    __shared__ float m_best[WARPS][TILE_N];
    __shared__ int m_arg[WARPS][TILE_N];

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int row0 = blockIdx.x * TILE_N;

    float zr[ROWS_PER_THREAD][D];
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
        const int row = row0 + lane + 32 * r;
        if (row < N) {
            const float4* src = reinterpret_cast<const float4*>(z + (size_t)row * D);
#pragma unroll
            for (int q = 0; q < D / 4; ++q) {
                const float4 v = src[q];
                zr[r][4 * q + 0] = v.x; zr[r][4 * q + 1] = v.y;
                zr[r][4 * q + 2] = v.z; zr[r][4 * q + 3] = v.w;
            }
        } else {
#pragma unroll
            for (int d = 0; d < D; ++d) zr[r][d] = 0.f;
        }
    }

    float best[ROWS_PER_THREAD];
    int arg[ROWS_PER_THREAD];
#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) { best[r] = -CUDART_INF_F; arg[r] = 0; }

    const float4* e4 = reinterpret_cast<const float4*>(embed);
    const size_t total_vec = (size_t)C * (D / 4);
    const int n_tiles = (C + TILE_C - 1) / TILE_C;

    // register prefetch of the next tile while the current one is scored
    float4 pre[VEC_PER_THREAD];
#pragma unroll
    for (int i = 0; i < VEC_PER_THREAD; ++i) {
        const size_t g = (size_t)tid + (size_t)i * THREADS;
        pre[i] = g < total_vec ? e4[g] : make_float4(0.f, 0.f, 0.f, 0.f);
    }

    for (int t = 0; t < n_tiles; ++t) {
        __syncthreads();                      // previous tile fully consumed
#pragma unroll
        for (int i = 0; i < VEC_PER_THREAD; ++i) tile[tid + i * THREADS] = pre[i];
        __syncthreads();
        if (t + 1 < n_tiles) {
            const size_t base = (size_t)(t + 1) * (TILE_C * D / 4);
#pragma unroll
            for (int i = 0; i < VEC_PER_THREAD; ++i) {
                const size_t g = base + tid + (size_t)i * THREADS;
                pre[i] = g < total_vec ? e4[g] : make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
        const int c_base = t * TILE_C + warp * CODES_PER_WARP;
        int n_codes = C - c_base;
        n_codes = n_codes > CODES_PER_WARP ? CODES_PER_WARP : n_codes;
        for (int j = 0; j < n_codes; ++j) {
            const float4* code = &tile[(warp * CODES_PER_WARP + j) * (D / 4)];
            float e[D];
#pragma unroll
            for (int q = 0; q < D / 4; ++q) {
                const float4 v = code[q];
                e[4 * q + 0] = v.x; e[4 * q + 1] = v.y;
                e[4 * q + 2] = v.z; e[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int r = 0; r < ROWS_PER_THREAD; ++r) {
                float s = 0.f;
#pragma unroll
                for (int d = 0; d < D; ++d) s = __fmaf_rn(zr[r][d], e[d], s);
                if (s > best[r]) { best[r] = s; arg[r] = c_base + j; }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < ROWS_PER_THREAD; ++r) {
        m_best[warp][lane + 32 * r] = best[r];
        m_arg[warp][lane + 32 * r] = arg[r];
    }
    __syncthreads();
    if (tid < TILE_N) {
        const int row = row0 + tid;
        if (row < N) {
            float b = m_best[0][tid];
            int a = m_arg[0][tid];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) {
                const float bw = m_best[w][tid];
                const int aw = m_arg[w][tid];
                if (bw > b || (bw == b && aw < a)) { b = bw; a = aw; }
            }
            ids[row] = a;
        }
    }
}

}  // namespace

extern "C" int stk_vq_argmax(const void* z, const void* embed, void* ids,
                             int N, int C, void* stream) {
    const int blocks = (N + TILE_N - 1) / TILE_N;
    vq_argmax_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(z), static_cast<const float*>(embed),
        static_cast<int*>(ids), N, C);
    return static_cast<int>(cudaGetLastError());
}
