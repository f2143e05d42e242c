// 3x3 SAME stride-1 convolution from 3 input channels, NHWC, for Hopper (sm_90a):
//
//   out[b,h,w,c] = round_T( sum_{dy,dx,ci} x[b,h+dy-1,w+dx-1,ci] * round_T(W[c,ci,dy,dx])
//                           + bias[c] )
//
// with the 27 taps summed in fp32 and zero outside the image. T is the type of
// x and of the output (bf16 or fp32); W (torch's OIHW layout) and the bias
// come in fp32, W is rounded to T as the TPU kernel casts it, the bias is
// added in fp32. Replaces the Pallas TPU kernel
// selftoktokenizer_tpu/ops/conv3ch.py::conv3ch_3x3 (a 27-tap im2col per row
// band, padded to 32 taps, one matmul plus bias), which no path of the JAX
// package runs; neither does this one yet.
//
// Bound on an H100: the output stream. At the VAE's conv_in, [8,256,256,3] ->
// 128 channels, it writes 134 MB in bf16 (0.041 ms at 3.35 TB/s) or 268 MB
// in fp32 (0.082 ms) from 3 or 6 MB of input, against 1.8 G multiply-adds
// (0.054 ms on the fp32 CUDA cores, 0.0037 ms on the bf16 tensor cores).
//
// Design. The earlier kernel (one block per 4 rows, each thread one pixel x 8
// channels on the CUDA cores) read 36 bytes of shared memory for every 8 FMAs
// and ran at 0.08 / 0.15 of the bound. Here:
//  1. Persistent blocks (at most two an SM) walk the image rows (b, h). A
//     block loads the weights and the bias once. The input band of a row (the
//     rows h-1..h+1, each one contiguous run of 3W values in x's own type)
//     comes through a cp.async double buffer: the next row's band is in
//     flight while the current row is computed and stored. Rows outside the
//     image are zero-filled by the copy itself, and so are the values past
//     each row's end; the three before its start are never written (zeroed
//     once), except in bf16 when the row starts 2 bytes into a 4-byte word,
//     where the value before it is masked at w = 0. The copies are whole
//     4-byte words, so x need only be aligned to its type (a batch slice of
//     a bf16 tensor may start 2 bytes into a word).
//  2. bf16: tensor cores. Eight warps each take 16 pixels of the row at a time
//     and run mma.sync.m16n8k16 (bf16 in, fp32 accumulate) over two k-steps of
//     the 32 taps (27, then 5 zero taps, as the TPU kernel pads them). A is
//     gathered straight from the band into fragments (no patch tensor
//     anywhere); B, the [32, C] bf16 weight tile, lives in shared memory in
//     fragment order, one 16-byte read per 8 channels and two k-steps. The
//     accumulators start at the bias. Products of bf16 values are exact in
//     fp32; only the order of the sum differs from the plain version.
//  3. fp32: CUDA cores (TF32 would break the 1e-5 tolerance). A thread makes 8
//     pixels x 4 channels, its 27 x 4 weights held in registers for the
//     block's lifetime; the lanes of a warp share the pixels and differ in
//     the channels, so every band value is a broadcast read serving 4 FMAs.
//     The weight table passes through shared memory once, and the bands
//     then reuse its space. Above 1024 channels (more 4-channel groups than
//     threads) a thread takes its groups in turn, its weights taken again
//     from the table, which then stays beside the bands.
//  4. Epilogue. bf16: each warp writes its 16 x C tile to shared memory (rows
//     padded by 16 bytes against bank conflicts) and stores it back as 16-byte
//     vectors, a warp writing 512 contiguous bytes at a time (64 channels at
//     a time where the warps' 16 x C tiles do not fit). fp32: a warp's
//     lanes hold 32 consecutive 4-channel groups of one pixel and store them
//     straight from registers as one contiguous 512-byte run. All stores
//     stream past L1 (st.global.cs) and overlap the next tile's products.
// Any H, W and C are taken whose shared memory fits a block (stk_conv3ch_smem):
// the ragged edges are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FRONT = 8;            // values of zero padding before each band row
constexpr int TAIL = 24;            // values after a row's data: the shift, the last
                                    // word's pad and fp32's reads past the last pixel group
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr int PIX_F32 = 8;          // fp32: pixels per thread
constexpr int CH_F32 = 4;           // fp32: channels per thread
constexpr int STAGE_MIN = 64;       // bf16: channels of a warp's output tile when all C do not fit
constexpr size_t SMEM_LIMIT = 232448;  // shared memory a block may use on Hopper

template <typename T> constexpr int ITEM = static_cast<int>(sizeof(T));

__host__ __device__ __forceinline__ size_t max_size(size_t a, size_t b) { return a > b ? a : b; }

// Sizes, each one expression (a CPU test reads them from this source).
// Values of one band row slot: FRONT, 3W data values (plus a shift of one) and the tail.
__host__ __device__ __forceinline__ int row_stride(int W) { return (FRONT + 3 * W + TAIL + 7) / 8 * 8; }
__host__ __device__ __forceinline__ int pad8(int C) { return (C + 7) / 8 * 8; }
__host__ __device__ __forceinline__ int pad4(int C) { return (C + 3) / 4 * 4; }
// bf16: a warp's output tile row, in bytes, for sw channels
__host__ __device__ __forceinline__ int stage_pitch(int sw) { return sw * 2 + 16; }
// bf16 shared memory: weight fragments, bias, two bands, the warps' output tiles of sw channels
__host__ __device__ __forceinline__ size_t smem_bf16(int W, int C, int sw) { return (size_t)pad8(C) * 64 + (size_t)pad8(C) * 4 + (size_t)2 * 3 * row_stride(W) * 2 + (size_t)WARPS * 16 * stage_pitch(sw); }
// bf16: the channels of a warp's output tile, all of them where they fit
__host__ __device__ __forceinline__ int stage_channels(int W, int C) { return smem_bf16(W, C, pad8(C)) <= SMEM_LIMIT || pad8(C) <= STAGE_MIN ? pad8(C) : STAGE_MIN; }
// fp32: the turns a thread takes over the 4-channel groups
__host__ __device__ __forceinline__ int f32_chunks(int C) { return (pad4(C) / CH_F32 + THREADS - 1) / THREADS; }
// fp32 shared memory: the weight table, and two bands in its space or beside it
__host__ __device__ __forceinline__ size_t smem_f32(int W, int C) { return f32_chunks(C) > 1 ? (size_t)27 * pad4(C) * 4 + (size_t)2 * 3 * row_stride(W) * 4 : max_size((size_t)27 * pad4(C) * 4, (size_t)2 * 3 * row_stride(W) * 4); }
__host__ __device__ __forceinline__ size_t smem_bytes(int W, int C, bool bf16) { return bf16 ? smem_bf16(W, C, stage_channels(W, C)) : smem_f32(W, C); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, the part past src_bytes zero-filled
__device__ __forceinline__ void cp4(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// address of the first value of image row hh of image b
template <typename T>
__device__ __forceinline__ uintptr_t row_addr(const T* x, int b, int hh, int H, int W) {
    return reinterpret_cast<uintptr_t>(x + (((size_t)b * H + hh) * W) * 3);
}

// shift, in values, of a band row inside its slot: the copy starts at the
// 4-byte word that holds the row's first value
template <typename T>
__device__ __forceinline__ int row_shift(const T* x, int b, int hh, int H, int W) {
    if (hh < 0 || hh >= H) return 0;
    return static_cast<int>(row_addr(x, b, hh, H, W) & 3u) / ITEM<T>;
}

// start the copy of the band of image row r = b*H + h into band slots `band`
// (3 rows of row_stride(W) values, each FRONT values in). A row's first word
// may begin up to 2 bytes before the row, and before x itself: that word lies
// inside x's allocation (which starts on a word), and its value before the
// row is masked.
template <typename T>
__device__ __forceinline__ void load_band(T* band, const T* x, int r, int H, int W) {
    const int b = r / H, h = r % H;
    const int rs = row_stride(W);
    const int words = ((1 + 3 * W + 3) * ITEM<T> + 3) / 4;   // data, shift and zero tail
    // an aligned source for the copies that only zero-fill
    const char* zero_src = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(x) & ~uintptr_t(3));
    for (int i = threadIdx.x; i < 3 * words; i += THREADS) {
        const int dy = i / words, wd = i % words;
        const int hh = h + dy - 1;
        char* dst = reinterpret_cast<char*>(band + dy * rs + FRONT) + 4 * wd;
        if (hh < 0 || hh >= H) {
            cp4(dst, zero_src, 0);
            continue;
        }
        const uintptr_t a = row_addr(x, b, hh, H, W);
        const uintptr_t wa = a & ~uintptr_t(3);
        const long long left = (long long)(a - wa) + 3ll * W * ITEM<T> - 4ll * wd;
        const int nb = left >= 4 ? 4 : (left > 0 ? static_cast<int>(left) : 0);
        cp4(dst, nb > 0 ? reinterpret_cast<const char*>(wa) + 4 * (size_t)wd : zero_src, nb);
    }
}

// ------------------------------------------------------------------- bf16 ---

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Slot k of the 32 taps is tap (dy*3 + dx)*3 + ci for k < 27, zero after.
// Lane (g = lane/4, q = lane%4) holds slot pairs p = 0..3: slots 8p + 2q and
// 8p + 2q + 1 (low half first); pairs 0, 1 feed k-step 0, pairs 2, 3 k-step 1.
__global__ void __launch_bounds__(THREADS)
conv3ch_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                    int B, int H, int W, int C, int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int Cp = pad8(C);
    const int rs = row_stride(W);
    uint4* wfrag = reinterpret_cast<uint4*>(smem);                    // [Cp/8][32]
    float* bs = reinterpret_cast<float*>(wfrag + Cp / 8 * 32);         // [Cp]
    __nv_bfloat16* bands = reinterpret_cast<__nv_bfloat16*>(bs + Cp);  // [2][3][rs]
    unsigned char* stage = reinterpret_cast<unsigned char*>(bands + 2 * 3 * rs);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int sw = stage_channels(W, C);
    const int pitch = stage_pitch(sw);
    unsigned char* my_stage = stage + warp * 16 * pitch;

    for (int i = tid; i < 2 * 3 * rs; i += THREADS) bands[i] = __float2bfloat16_rn(0.f);
    for (int i = tid; i < Cp / 8 * 32; i += THREADS) {
        const int n = (i >> 5) * 8 + ((i & 31) >> 2), qq = i & 3;
        uint32_t v[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            uint32_t pair = 0;
#pragma unroll
            for (int hlf = 0; hlf < 2; ++hlf) {
                const int k = 8 * p + 2 * qq + hlf;
                uint32_t bits = 0;
                if (k < 27 && n < C) {
                    const int ci = k % 3, dx = (k / 3) % 3, dy = k / 9;
                    bits = bf16_bits(w[((n * 3 + ci) * 3 + dy) * 3 + dx]);
                }
                pair |= bits << (16 * hlf);
            }
            v[p] = pair;
        }
        wfrag[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
    for (int i = tid; i < Cp; i += THREADS) bs[i] = i < C ? bias[i] : 0.f;

    // this lane's slots: the tap's (dy, column offset) and the masks of the
    // zero slots (k >= 27) and of the value before a row (dx = 0, ci = 2)
    int k_dy[8], k_col[8];
    uint32_t vmask[4], lmask[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        vmask[p] = 0u;
        lmask[p] = 0xffffffffu;
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
            const int k = 8 * p + 2 * q + hlf;
            const int kk = k < 27 ? k : 0;
            const int ci = kk % 3, dx = (kk / 3) % 3, dy = kk / 9;
            k_dy[2 * p + hlf] = dy;
            k_col[2 * p + hlf] = (dx - 1) * 3 + ci;
            if (k < 27) vmask[p] |= 0xffffu << (16 * hlf);
            if (k < 27 && dx == 0 && ci == 2) lmask[p] &= ~(0xffffu << (16 * hlf));
        }
    }

    const int n_rows = B * H;
    const int blocks_per_row = (W + 15) / 16;
    const bool vec_out = vec != 0;
    int r = blockIdx.x;
    __syncthreads();                                  // the zeroed bands before any copy
    if (r < n_rows) load_band(bands, x, r, H, W);
    cp_commit();
    for (int it = 0; r < n_rows; ++it, r += gridDim.x) {
        const int buf = it & 1;
        if (r + (int)gridDim.x < n_rows) load_band(bands + (buf ^ 1) * 3 * rs, x, r + gridDim.x, H, W);
        cp_commit();
        cp_wait1();
        __syncthreads();                              // the band of row r is in

        const int b = r / H, h = r % H;
        const uint16_t* band = reinterpret_cast<const uint16_t*>(bands + buf * 3 * rs);
        int toff[8];
#pragma unroll
        for (int s = 0; s < 8; ++s)
            toff[s] = k_dy[s] * rs + FRONT + row_shift(x, b, h + k_dy[s] - 1, H, W) + k_col[s];

        for (int mb = warp; mb < blocks_per_row; mb += WARPS) {
            const int w0 = mb * 16;
            const int npix = min(16, W - w0);
            // A fragments of pixels w0 + g (rows g) and w0 + g + 8 (rows g + 8)
            uint32_t pa[2][4];
#pragma unroll
            for (int hm = 0; hm < 2; ++hm) {
                const int p = min(w0 + g + 8 * hm, W - 1);
#pragma unroll
                for (int pp = 0; pp < 4; ++pp) {
                    uint32_t v = static_cast<uint32_t>(band[3 * p + toff[2 * pp]])
                               | (static_cast<uint32_t>(band[3 * p + toff[2 * pp + 1]]) << 16);
                    v &= vmask[pp];
                    if (p == 0) v &= lmask[pp];
                    pa[hm][pp] = v;
                }
            }
            const uint32_t a0[4] = {pa[0][0], pa[1][0], pa[0][1], pa[1][1]};
            const uint32_t a1[4] = {pa[0][2], pa[1][2], pa[0][3], pa[1][3]};

            // channels [cs, ce) of the 16 pixels into the warp's tile, from column 0
            auto mma_to_stage = [&](int cs, int ce) {
                for (int c0 = cs; c0 < ce; c0 += 64) {
                    const int nj = min(8, (ce - c0) / 8);
                    float acc[8][4];
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        if (j < nj) {
                            const float2 bv = *reinterpret_cast<const float2*>(bs + c0 + 8 * j + 2 * q);
                            acc[j][0] = bv.x; acc[j][1] = bv.y; acc[j][2] = bv.x; acc[j][3] = bv.y;
                            const uint4 bf = wfrag[(c0 / 8 + j) * 32 + lane];
                            mma_bf16(acc[j], a0, bf.x, bf.y);
                            mma_bf16(acc[j], a1, bf.z, bf.w);
                        }
                    }
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        if (j < nj) {
                            const int cb = (c0 - cs + 8 * j + 2 * q) * 2;
                            *reinterpret_cast<__nv_bfloat162*>(my_stage + g * pitch + cb) =
                                __floats2bfloat162_rn(acc[j][0], acc[j][1]);
                            *reinterpret_cast<__nv_bfloat162*>(my_stage + (g + 8) * pitch + cb) =
                                __floats2bfloat162_rn(acc[j][2], acc[j][3]);
                        }
                    }
                }
                __syncwarp();
            };
            __nv_bfloat16* dst = out + (((size_t)b * H + h) * W + w0) * C;
            if (sw == Cp) {
                // the whole tile: its npix x C values are one contiguous run of the output
                mma_to_stage(0, Cp);
                if (vec_out) {
                    const int per_pix = C * 2 / 16;
                    for (int i = lane; i < npix * per_pix; i += 32) {
                        const int px = i / per_pix, part = i % per_pix;
                        __stcs(reinterpret_cast<uint4*>(dst) + i,
                               *reinterpret_cast<const uint4*>(my_stage + px * pitch + part * 16));
                    }
                } else {
                    for (int i = lane; i < npix * C; i += 32) {
                        const int px = i / C, c = i % C;
                        dst[i] = *reinterpret_cast<const __nv_bfloat16*>(my_stage + px * pitch + c * 2);
                    }
                }
                __syncwarp();
            } else {
                // sw channels at a time: each pixel's run of cw channels from cs
                for (int cs = 0; cs < Cp; cs += sw) {
                    mma_to_stage(cs, min(cs + sw, Cp));
                    const int cw = min(sw, C - cs);
                    if (vec_out) {
                        const int per_pix = cw * 2 / 16;
                        for (int i = lane; i < npix * per_pix; i += 32) {
                            const int px = i / per_pix, part = i % per_pix;
                            __stcs(reinterpret_cast<uint4*>(dst + (size_t)px * C + cs) + part,
                                   *reinterpret_cast<const uint4*>(my_stage + px * pitch + part * 16));
                        }
                    } else {
                        for (int i = lane; i < npix * cw; i += 32) {
                            const int px = i / cw, c = i % cw;
                            dst[(size_t)px * C + cs + c] =
                                *reinterpret_cast<const __nv_bfloat16*>(my_stage + px * pitch + c * 2);
                        }
                    }
                    __syncwarp();
                }
            }
        }
        __syncthreads();                              // done with this band before it is refilled
    }
}

// ------------------------------------------------------------------- fp32 ---

// fp32: a thread's weights for channels 4cg .. 4cg+3 from the table, its
// bias from global memory (zero past C)
__device__ __forceinline__ void take_weights(const float* wt, int Cp, const float* __restrict__ bias,
                                             int C, int cg, float (&wr)[27][CH_F32], float (&br)[CH_F32]) {
#pragma unroll
    for (int t = 0; t < 27; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(wt + t * Cp + CH_F32 * cg);
        wr[t][0] = v.x; wr[t][1] = v.y; wr[t][2] = v.z; wr[t][3] = v.w;
    }
#pragma unroll
    for (int c = 0; c < CH_F32; ++c) br[c] = CH_F32 * cg + c < C ? bias[CH_F32 * cg + c] : 0.f;
}

// Thread t: channel group cgl = t % Gc (Gc = min(G, THREADS), G = ceil(C/4)
// groups of 4 channels), pixel set t / Gc; a row's groups of 8 pixels go round
// the nps = THREADS / Gc sets. Above THREADS groups the thread takes groups
// cgl, cgl + THREADS, ... in turn.
__global__ void __launch_bounds__(THREADS, 1)
conv3ch_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int B, int H, int W, int C, int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int Cp = pad4(C);
    const int rs = row_stride(W);
    const int G = Cp / CH_F32;
    const int chunks = f32_chunks(C);
    const int Gc = min(G, THREADS);
    float* wt = reinterpret_cast<float*>(smem);     // [27][Cp], tap = (dy*3 + dx)*3 + ci
    // [2][3][rs]: in the table's space once every thread holds its weights
    float* bands = wt + (chunks > 1 ? 27 * Cp : 0);
    const int tid = threadIdx.x;
    const int nps = THREADS / Gc;
    const int cgl = tid % Gc, ps = tid / Gc;

    for (int i = tid; i < 27 * Cp; i += THREADS) {
        const int c = i % Cp, tap = i / Cp;
        const int ci = tap % 3, dx = (tap / 3) % 3, dy = tap / 9;
        wt[i] = c < C ? w[((c * 3 + ci) * 3 + dy) * 3 + dx] : 0.f;
    }
    __syncthreads();
    float wr[27][CH_F32], br[CH_F32];
    if (chunks == 1) take_weights(wt, Cp, bias, C, cgl, wr, br);
    __syncthreads();                                  // the table is read before the bands reuse it
    for (int i = tid; i < 2 * 3 * rs; i += THREADS) bands[i] = 0.f;

    const int n_rows = B * H;
    int r = blockIdx.x;
    __syncthreads();                                  // the zeroed bands before any copy
    if (r < n_rows) load_band(bands, x, r, H, W);
    cp_commit();
    const int groups = (W + PIX_F32 - 1) / PIX_F32;

    for (int it = 0; r < n_rows; ++it, r += gridDim.x) {
        const int buf = it & 1;
        if (r + (int)gridDim.x < n_rows) load_band(bands + (buf ^ 1) * 3 * rs, x, r + gridDim.x, H, W);
        cp_commit();
        cp_wait1();
        __syncthreads();                              // the band of row r is in
        const int b = r / H, h = r % H;
        const float* band = bands + buf * 3 * rs + FRONT;   // fp32 rows start on a word: no shift
        for (int k = 0; k < chunks; ++k) {
            const int cg = k * Gc + cgl;
            if (ps >= nps || cg >= G) continue;
            if (chunks > 1) take_weights(wt, Cp, bias, C, cg, wr, br);
            const int c0 = CH_F32 * cg;
            const bool vec_out = vec != 0 && c0 + CH_F32 <= C;
            for (int pg = ps; pg < groups; pg += nps) {
                const int w0 = pg * PIX_F32;
                float acc[PIX_F32][CH_F32];
#pragma unroll
                for (int p = 0; p < PIX_F32; ++p)
#pragma unroll
                    for (int c = 0; c < CH_F32; ++c) acc[p][c] = br[c];
#pragma unroll
                for (int dy = 0; dy < 3; ++dy) {
                    // the (8 + 2) x 3 values pixels w0-1 .. w0+8 of band row dy
                    float xv[(PIX_F32 + 2) * 3];
                    const float* src = band + dy * rs + (w0 - 1) * 3;
#pragma unroll
                    for (int i = 0; i < (PIX_F32 + 2) * 3; ++i) xv[i] = src[i];
#pragma unroll
                    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
                        for (int ci = 0; ci < 3; ++ci) {
                            const int t = (dy * 3 + dx) * 3 + ci;
#pragma unroll
                            for (int p = 0; p < PIX_F32; ++p) {
                                const float xs = xv[(p + dx) * 3 + ci];
#pragma unroll
                                for (int c = 0; c < CH_F32; ++c)
                                    acc[p][c] = __fmaf_rn(xs, wr[t][c], acc[p][c]);
                            }
                        }
                }
                float* dst = out + (((size_t)b * H + h) * W + w0) * C + c0;
#pragma unroll
                for (int p = 0; p < PIX_F32; ++p) {
                    if (w0 + p >= W) break;
                    float* d = dst + (size_t)p * C;
                    if (vec_out) {
                        __stcs(reinterpret_cast<float4*>(d), make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]));
                    } else {
#pragma unroll
                        for (int c = 0; c < CH_F32; ++c)
                            if (c0 + c < C) d[c] = acc[p][c];
                    }
                }
            }
        }
        __syncthreads();                              // done with this band before it is refilled
    }
}

// ------------------------------------------------------------------- host ---

template <typename T>
int launch(void (*kernel)(const T*, const float*, const float*, T*, int, int, int, int, int),
           const T* x, const float* w, const float* bias, T* out,
           int B, int H, int W, int C, int vec, size_t smem, cudaStream_t s) {
    // per device: the SM count and the largest shared-memory size set so far
    static int sms[64] = {};
    static size_t smem_set[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (sms[dev] == 0) {
        e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    if (smem > smem_set[dev]) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        smem_set[dev] = smem;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    per_sm = per_sm < 1 ? 1 : (per_sm > MAX_BLOCKS_PER_SM ? MAX_BLOCKS_PER_SM : per_sm);
    const long long rows = (long long)B * H;
    const int grid = static_cast<int>(rows < (long long)sms[dev] * per_sm ? rows : (long long)sms[dev] * per_sm);
    kernel<<<grid, THREADS, smem, s>>>(x, w, bias, out, B, H, W, C, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B,H,W,3] (bf16 when x_bf16, else fp32), w [C,3,3,3] fp32 (OIHW),
// bias [C] fp32, out [B,H,W,C] of x's type; every array contiguous and
// aligned to its type, B*H below 2^31, stk_conv3ch_smem(W, C, x_bf16) at most
// SMEM_LIMIT (else cudaErrorInvalidValue). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int stk_conv3ch(const void* x, const void* w, const void* bias, void* out,
                           int B, int H, int W, int C, int x_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = smem_bytes(W, C, x_bf16 != 0);
    if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
    const size_t item = x_bf16 ? 2 : 4;
    // 16-byte stores need C * itemsize to be a multiple of 16 and an aligned base
    const int vec = ((C * item) % 16 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    if (x_bf16)
        return launch(conv3ch_bf16_kernel, static_cast<const __nv_bfloat16*>(x),
                      static_cast<const float*>(w), static_cast<const float*>(bias),
                      static_cast<__nv_bfloat16*>(out), B, H, W, C, vec, smem, s);
    return launch(conv3ch_f32_kernel, static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, C, vec, smem, s);
}

// Shared memory the kernel needs for width W, C channels and x's type, in
// bytes (a shape above SMEM_LIMIT, the card's 227 KB per block, is refused).
extern "C" long long stk_conv3ch_smem(int W, int C, int x_bf16) {
    return static_cast<long long>(smem_bytes(W, C, x_bf16 != 0));
}
