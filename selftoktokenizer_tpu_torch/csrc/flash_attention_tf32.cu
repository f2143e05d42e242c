// Split-TF32 attention on Hopper's tensor cores: the fp32 forward of the fused
// softmax attention with a per-key mask, and its backward (bf16 and fp32).
//
//   out = softmax(q k^T / sqrt(D) + bias) v,   bias[b, key] = mask ? 0 : -1e30
//
// Replaces, with csrc/flash_attention.cu (the bf16 forward), the Pallas TPU
// kernel selftoktokenizer_tpu/ops/flash_attention.py::_flash_mha and the
// backward of its custom VJP (_make_flash_vjp, an XLA recompute there: no
// Pallas kernel). The TPU kernel runs both products on the MXU at the caller's
// precision; at HIGHEST the MXU builds fp32-accurate products from several
// bf16 passes. The counterpart here is split TF32: each fp32 operand is
// x = hi + lo with hi = x rounded to TF32 and lo = x - hi (exact in fp32; the
// tensor core reads it truncated to TF32), and a product sums hi*hi + hi*lo
// + lo*hi in fp32 (lo*lo, under 2^-22 of the product, is dropped). hi must
// be exactly what the tensor core reads, which drops the low 13 mantissa
// bits: it is rounded first, and lo formed from the rounded value. Three TF32 products at 495 TFLOP/s in place of one
// fp32 product at 67 on the CUDA cores. A bf16 value is exact in TF32, so a
// bf16 operand has no lo half and its products are one or two passes.
//
// The products run on mma.sync.m16n8k8 (TF32), not wgmma: wgmma reads 32-bit
// operands only K-major from shared memory, and P V, dV = P^T dO,
// dK = dS^T Q and dQ = dS K all take an operand whose rows run along the
// product's N (V, dO, Q, K as stored); each would need a transposed copy
// of its tile in shared memory per tile. An mma.sync fragment is loaded by
// the threads themselves, so any tile is read in either orientation from
// the layout TMA wrote, without bank conflicts (128-byte swizzle: the
// 16-byte chunk c of row r lies at chunk c ^ (r % 8)), and the split runs on
// the loaded registers. A product's A operand held in registers as an
// accumulator (P, dS) is fed back without a shuffle: the key order inside
// each k8 step is permuted (k = t holds key 2t, k = t + 4 key 2t + 1) so that
// the accumulator's (2t, 2t + 1) pair is the A fragment's (t, t + 4) pair,
// and the B operand is read with the same permutation.
//
// Every kernel here: a block of 64 rows of one (batch, head), four consumer
// warps of 16 rows each and one producer warp. The producer loads the
// block's own tiles once and streams 64-row tiles of the other side through
// a ring of two stages by TMA (tensor maps of four dimensions (D, L, H, B)
// from the caller's strides, so strided views are taken as they are and the
// ragged edges are zero-filled), with the per-tile side data (the key bias,
// or the query rows' statistics) written beside each stage; mbarriers sign
// the stages off (full: the bytes and the side data arrived; empty: every
// consumer warp is done).
//
// Forward (fp32 only; bf16 is flash_attention.cu's wgmma kernel): S = Q K^T
// in split TF32, the online softmax in registers (log2 domain: x = s * scale
// * log2(e) + bias, running max m and sum l), O += P V in split TF32 with P
// from registers. Each k8 step of S and each key tile's P V go into a fresh
// accumulator, added by one fadd / fmaf a value: the tensor core truncates
// what it adds to its accumulator at the accumulator's magnitude, which at
// scores of ~30 put the output as far from the plain version as the fp32
// gate (2e-5). The backward's products (gate 1e-4 of scale) accumulate in
// place. Masked keys get a finite -1e30, so a fully masked row is
// the uniform mean over the Lk real keys; keys past Lk get -inf. With a
// statistics pointer the forward also writes each row's m and l (fp32
// [B, H, Lq] each): the backward's P is exp2(x - m) / l. The two are kept
// apart: for a fully masked row m = -1e30 and m + log2(l) rounds back to
// -1e30, so one log-sum-exp would give every key weight 1, not 1 / Lk.
//
// Backward, two kernels, no atomics (two runs give the same bits):
//  - dQ pass (one block per 64 query rows): Delta = rowsum(dO * O) (equal to
//    rowsum(dP * P)) from device memory, written for the second pass; then
//    over the key tiles: S, P from the forward's m and l, dP = dO V^T,
//    dS = P * (dP - Delta), dQ += dS K; dQ * scale stored.
//  - dK / dV pass (one block per 64 keys): over the query tiles, with each
//    tile's m, 1 / l and Delta beside it: S^T = K Q^T, P^T, dV += P^T dO,
//    dP^T = V dO^T, dS^T = P^T * (dP^T - Delta), dK += dS^T Q; dK * scale
//    and dV stored.
// Each is cast to its input's type; no [Lq, Lk] tensor reaches device memory.
//
// Bound on an H100: the forward's two products are 4*B*H*Lq*Lk*D FLOP, the
// backward's five (S again, dV, dP, dQ, dK) 10*B*H*Lq*Lk*D; in split TF32
// three passes each at 495 TFLOP/s. mma.sync reaches only part of the
// tensor cores' rate on Hopper, and every fragment value is loaded from
// shared memory and split by the threads, so a kernel here sits well below
// that bound (PERF.md).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float NEG_BIAS = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;               // rows of a block's own tile: 4 consumer warps x 16
constexpr int BN = 64;               // rows of a streamed tile
constexpr int NT = BN / 8;           // 8-column tiles of a 16 x 64 product
constexpr int THREADS = 128 + 32;    // the consumer warps and one producer warp
constexpr int STAGES = 2;
constexpr int COL_BYTES = 64 * 128;  // one 128-byte column block of a 64-row tile

// The shared memory of one instantiation: 1024 bytes of slack to align the
// tiles for the 128-byte swizzle, OWN tiles of the block's rows, the ring
// (STAGES x 2 tiles), SIDE floats of side data a stage, the barriers (own
// tiles, full and empty a stage). ops/flash_attention.py::tf32_smem_bytes
// repeats this sum.
template <typename T, int D, int OWN, int SIDE>
struct Smem {
    static constexpr int TILE = 64 * D * static_cast<int>(sizeof(T));
    static constexpr int RING = OWN * TILE;
    static constexpr int SIDE_OFF = RING + STAGES * 2 * TILE;
    static constexpr int BAR_OFF = SIDE_OFF + STAGES * SIDE * 4;
    static constexpr int BYTES = 1024 + BAR_OFF + (1 + 2 * STAGES) * 8;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// element (r, c) of a 64-row tile of T as TMA wrote it: column blocks of 128
// bytes, 64 rows each, the 16-byte chunk c of row r at chunk c ^ (r % 8)
template <typename T>
__device__ __forceinline__ float ld(const uint8_t* tile, int r, int c) {
    constexpr int PER = 128 / static_cast<int>(sizeof(T));
    const int b = (c % PER) * static_cast<int>(sizeof(T));
    return to_f(*reinterpret_cast<const T*>(
        tile + (c / PER) * COL_BYTES + r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15))));
}

// x = hi + lo: hi is x rounded to TF32, to nearest with ties away from zero
// (what cvt.rna.tf32.f32 gives, for finite x, in two integer operations
// instead of cvt's longer sequence: PERF.md), and lo = x - hi, exact in
// fp32, which the tensor core reads truncated to TF32 (an error under 2^-21
// of x). An exact operand (SPLIT false: a bf16 value) is its own hi.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    if constexpr (SPLIT) {
        hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
        lo = __float_as_uint(x - __uint_as_float(hi));
    } else {
        hi = __float_as_uint(x);
        lo = 0u;
    }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32: lo*hi, hi*lo, then hi*hi; a term with an exact
// operand's (zero) lo half is left out
template <bool ALO, bool BLO>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
    if constexpr (ALO) mma(d, al, bh0, bh1);
    if constexpr (BLO) mma(d, ah, bl0, bl1);
    mma(d, ah, bh0, bh1);
}

// four 8 x 8 matrices of 16-bit values (here 8 rows x 4 fp32 values each)
// from shared memory: lanes 8i .. 8i + 7 give the row addresses of matrix
// i, and thread (g, t) gets word t of row g of each
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// the shared address of 16 bytes at row r, fp32 column c (a multiple of 4)
// of a 64-row fp32 tile as TMA wrote it
__device__ __forceinline__ uint32_t row_addr(uint32_t tile, int r, int c) {
    return tile + (c >> 5) * COL_BYTES + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void split4(const uint32_t (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split<true>(__uint_as_float(x[i]), hi[i], lo[i]);
}

// acc[j] += A[r0 .. r0 + 16) . B[8j .. 8j + 8)^T over the D columns of both
// tiles (S = Q K^T, dP = dO V^T and their transposes); thread (g, t) of the
// warp: lane = 4g + t. fp32 tiles are read with ldmatrix: one x4 gives the
// A fragment of a k8 step (rows g, g + 8 at columns t, t + 4), or the B
// fragments of two 8-row tiles. FRESH (fp32): each k8 step's three passes
// go into a fresh accumulator, added to acc by one fadd a value. The tensor
// core truncates what it adds to its accumulator at the accumulator's
// magnitude, 24 times a D = 64 product: at scores of ~30 that alone put the
// forward 2.0e-5 / 2.3e-5 (D 64 / 128) from the plain version (PERF.md).
template <typename T, int D, bool SA, bool SB, bool FRESH = false>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], const uint8_t* ta, int r0,
                                         const uint8_t* tb, int g, int t) {
    if constexpr (sizeof(T) == 4) {
        const int lane = 4 * g + t, i = lane >> 3, rr = lane & 7;
        const uint32_t a_base = smem_u32(ta), b_base = smem_u32(tb);
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
            uint32_t x[4], ah[4], al[4];
            ldsm4(x, row_addr(a_base, r0 + rr + 8 * (i & 1), 8 * kk + 4 * (i >> 1)));
            split4(x, ah, al);
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                uint32_t y[4], bh[4], bl[4];
                ldsm4(y, row_addr(b_base, 8 * (j + (i >> 1)) + rr, 8 * kk + 4 * (i & 1)));
                split4(y, bh, bl);
                if constexpr (FRESH) {
                    float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
                    mma3<SA, SB>(d0, ah, al, bh[0], bh[1], bl[0], bl[1]);
                    mma3<SA, SB>(d1, ah, al, bh[2], bh[3], bl[2], bl[3]);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        acc[j][e] += d0[e];
                        acc[j + 1][e] += d1[e];
                    }
                } else {
                    mma3<SA, SB>(acc[j], ah, al, bh[0], bh[1], bl[0], bl[1]);
                    mma3<SA, SB>(acc[j + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
                }
            }
        }
        return;
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t ah[4], al[4];
        split<SA>(ld<T>(ta, r0 + g, 8 * kk + t), ah[0], al[0]);
        split<SA>(ld<T>(ta, r0 + g + 8, 8 * kk + t), ah[1], al[1]);
        split<SA>(ld<T>(ta, r0 + g, 8 * kk + t + 4), ah[2], al[2]);
        split<SA>(ld<T>(ta, r0 + g + 8, 8 * kk + t + 4), ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            uint32_t bh0, bl0, bh1, bl1;
            split<SB>(ld<T>(tb, 8 * j + g, 8 * kk + t), bh0, bl0);
            split<SB>(ld<T>(tb, 8 * j + g, 8 * kk + t + 4), bh1, bl1);
            mma3<SA, SB>(acc[j], ah, al, bh0, bh1, bl0, bl1);
        }
    }
}

// acc[jd] += P . B[:, 8(j0 + jd) .. 8(j0 + jd) + 8) over the 64 rows of tile
// B, for NJ column tiles from j0 (all D / 8 by default), P the accumulator
// of a 16 x 64 product (O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q);
// k = t is row 2t of each k8 step, k = t + 4 row 2t + 1
template <typename T, int D, bool SB, int NJ>
__device__ __forceinline__ void mma_regs(float (&acc)[NJ][4], const float (&p)[NT][4],
                                         const uint8_t* tb, int g, int t, int j0 = 0) {
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
        uint32_t ah[4], al[4];
        split<true>(p[kk][0], ah[0], al[0]);
        split<true>(p[kk][2], ah[1], al[1]);
        split<true>(p[kk][1], ah[2], al[2]);
        split<true>(p[kk][3], ah[3], al[3]);
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd) {
            uint32_t bh0, bl0, bh1, bl1;
            split<SB>(ld<T>(tb, 8 * kk + 2 * t, 8 * (j0 + jd) + g), bh0, bl0);
            split<SB>(ld<T>(tb, 8 * kk + 2 * t + 1, 8 * (j0 + jd) + g), bh1, bl1);
            mma3<true, SB>(acc[jd], ah, al, bh0, bh1, bl0, bl1);
        }
    }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// 2^x on the special-function unit; -inf gives 0, results below the
// smallest normal flush to 0
__device__ __forceinline__ float exp2_sfu(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// one 64-row tile of the tensor behind `map` (rows row0.., head h, batch b):
// D * sizeof(T) / 128 boxes of 128 bytes x 64 rows
template <typename T, int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int h, int b) {
    constexpr int PER = 128 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int c = 0; c < D / PER; ++c)
        tma_load_4d(smem_u32(dst + c * COL_BYTES), map, bar, PER * c, row0, h, b);
}

// a key's bias: 0, -1e30 where the mask is off, -inf past Lk
__device__ __forceinline__ float key_bias(const unsigned char* mask, long long mask_sb, int b,
                                          int key, int Lk) {
    if (key >= Lk) return -CUDART_INF_F;
    return (mask != nullptr && mask[b * mask_sb + key] == 0) ? NEG_BIAS : 0.f;
}

// Whether key tile i can be left out: the batch row has an active key
// (row_active) and no key of the tile is active. There every score is -1e30
// against a finite row max, so its weights are exactly 0 and the tile adds
// nothing to O, l, dQ, dK or dV; a row with no active key leaves out nothing
// (its weights are 1 / Lk). Warp-wide: every lane gets the answer.
__device__ __forceinline__ bool any_active(const unsigned char* mask, long long mask_sb, int b,
                                           int k0, int k1, int Lk, int lane) {
    bool any = false;
    for (int key = k0 + lane; key < min(k1, Lk); key += 32) any |= mask[b * mask_sb + key] != 0;
    return __any_sync(0xffffffffu, any);
}

__device__ __forceinline__ bool skip_tile(const unsigned char* mask, long long mask_sb, int b,
                                          bool row_active, int i, int Lk, int lane) {
    return mask != nullptr && row_active && !any_active(mask, mask_sb, b, i * BN, i * BN + BN, Lk, lane);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// rows g and g + 8 of a 16-row accumulator [D / 8][4] times `mul`, to a
// [.., D] tensor of T at `base` (row stride sl), rows at or past `limit` left out
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], T* base, long long sl,
                                           int row0, int limit, int g, int t, const float (&mul)[2]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + g + 8 * hh;
        if (row >= limit) continue;
        T* dst = base + row * sl + 2 * t;
#pragma unroll
        for (int jd = 0; jd < D / 8; ++jd)
            store2<T>(dst + 8 * jd, acc[jd][2 * hh] * mul[hh], acc[jd][2 * hh + 1] * mul[hh]);
    }
}

struct View {                       // a [B, H, L, D] tensor: strides in elements, D dense
    void* p;
    long long sb, sh, sl;
};

struct Args {
    const unsigned char* mask;      // [B, Lk] bytes, non-zero = attend; or null
    long long mask_sb;
    View o, dout, dq, dk, dv;       // the forward's output; the backward's gradients
    float* stat_m;                  // [B, H, Lq] each: the rows' max (log2 domain) and sum
    float* stat_l;
    float* delta;                   // [B, H, Lq]: rowsum(dO * O), the backward's scratch
    int H, Lq, Lk;
    float scale_log2;               // log2(e) / sqrt(D)
    float scale;                    // 1 / sqrt(D)
};

// ----------------------------------------------------------------- forward ---

// One block: query rows [q0, q0 + 64) of one (batch, head), blockIdx.y =
// b*H + h; warps 0-3 the consumers, warp 4 the producer.
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_tf32_fwd_kernel(const __grid_constant__ CUtensorMap tmap_q, const __grid_constant__ CUtensorMap tmap_k,
                      const __grid_constant__ CUtensorMap tmap_v, const Args a) {
    using S = Smem<float, D, 1, BN>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    uint8_t* sq = smem;
    uint8_t* ring = smem + S::RING;
    float* sbias = reinterpret_cast<float*>(smem + S::SIDE_OFF);
    uint64_t* own = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
    uint64_t* full = own + 1;
    uint64_t* empty = full + STAGES;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
    const int q0 = blockIdx.x * BM;
    const int nk = (a.Lk + BN - 1) / BN;

    if (tid == 0) {
        mbar_init(smem_u32(own), 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(smem_u32(&full[s]), 1 + 32);          // the bytes, and the warp's bias
            mbar_init(smem_u32(&empty[s]), 4);              // one arrival per consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();
    const bool row_active = a.mask != nullptr && any_active(a.mask, a.mask_sb, b, 0, a.Lk, a.Lk, lane);

    if (warp == 4) {
        if (lane == 0) {
            prefetch_map(&tmap_q);
            prefetch_map(&tmap_k);
            prefetch_map(&tmap_v);
            mbar_expect_tx(smem_u32(own), S::TILE);
            load_tile<float, D>(sq, &tmap_q, smem_u32(own), q0, h, b);
        }
        for (int i = 0, n = 0; i < nk; ++i) {
            if (skip_tile(a.mask, a.mask_sb, b, row_active, i, a.Lk, lane)) continue;
            const int s = n % STAGES;
            if (n >= STAGES) mbar_wait(smem_u32(&empty[s]), ((n / STAGES) & 1) ^ 1);
            ++n;
            const uint32_t bar = smem_u32(&full[s]);
            if (lane == 0) {
                uint8_t* st = ring + s * 2 * S::TILE;
                mbar_expect_tx(bar, 2 * S::TILE);           // a box counts whole, zero-filled part included
                load_tile<float, D>(st, &tmap_k, bar, i * BN, h, b);
                load_tile<float, D>(st + S::TILE, &tmap_v, bar, i * BN, h, b);
            }
            for (int c = lane; c < BN; c += 32)
                sbias[s * BN + c] = key_bias(a.mask, a.mask_sb, b, i * BN + c, a.Lk);
            mbar_arrive(bar);
        }
        return;
    }

    const int t = lane & 3, g = lane >> 2, r0 = warp * 16;
    float o[D / 8][4];
    zero(o);
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_run[2] = {0.f, 0.f};
    mbar_wait(smem_u32(own), 0);
    for (int i = 0, n = 0; i < nk; ++i) {
        if (skip_tile(a.mask, a.mask_sb, b, row_active, i, a.Lk, lane)) continue;
        const int s = n % STAGES;
        mbar_wait(smem_u32(&full[s]), (n / STAGES) & 1);
        ++n;
        const uint8_t* kt = ring + s * 2 * S::TILE;
        const float* bias = sbias + s * BN;
        float sc[NT][4];
        zero(sc);
        mma_rows<float, D, true, true, true>(sc, sq, r0, kt, g, t);
        // the online softmax: s[j] holds rows g (0, 1) and g + 8 (2, 3), keys
        // 8j + 2t, 8j + 2t + 1; a row's four threads are one quad
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
            sc[j][0] = fmaf(sc[j][0], a.scale_log2, bb.x);
            sc[j][1] = fmaf(sc[j][1], a.scale_log2, bb.y);
            sc[j][2] = fmaf(sc[j][2], a.scale_log2, bb.x);
            sc[j][3] = fmaf(sc[j][3], a.scale_log2, bb.y);
            mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
            mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
        }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
            // every tile holds a real key, whose x is finite, so m_new is finite
            const float m_new = fmaxf(m_run[hh], mx[hh]);
            alpha[hh] = exp2_sfu(m_run[hh] - m_new);
            m_run[hh] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = exp2_sfu(sc[j][e] - m_run[e >> 1]);
            rs[0] += sc[j][0] + sc[j][1];
            rs[1] += sc[j][2] + sc[j][3];
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + rs[hh];
        // the tile's P V into a fresh accumulator, four column tiles at a
        // time (P split again for each four), then O = O * alpha + P V in
        // one fmaf a value: O does not take the tensor core's truncation
        // 24 times a tile
#pragma unroll
        for (int j0 = 0; j0 < D / 8; j0 += 4) {
            float pv[4][4];
            zero(pv);
            mma_regs<float, D, true>(pv, sc, kt + S::TILE, g, t, j0);
#pragma unroll
            for (int jd = 0; jd < 4; ++jd) {
                o[j0 + jd][0] = fmaf(o[j0 + jd][0], alpha[0], pv[jd][0]);
                o[j0 + jd][1] = fmaf(o[j0 + jd][1], alpha[0], pv[jd][1]);
                o[j0 + jd][2] = fmaf(o[j0 + jd][2], alpha[1], pv[jd][2]);
                o[j0 + jd][3] = fmaf(o[j0 + jd][3], alpha[1], pv[jd][3]);
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    }

    float inv[2];
    const int bh = b * a.H + h;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float l = l_run[hh];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[hh] = 1.f / l;
        const int row = q0 + r0 + g + 8 * hh;
        if (a.stat_m != nullptr && t == 0 && row < a.Lq) {
            a.stat_m[static_cast<long long>(bh) * a.Lq + row] = m_run[hh];
            a.stat_l[static_cast<long long>(bh) * a.Lq + row] = l;
        }
    }
    float* og = static_cast<float*>(a.o.p) + b * a.o.sb + h * a.o.sh;
    store_rows<float, D>(o, og, a.o.sl, q0 + r0, a.Lq, g, t, inv);
}

// ---------------------------------------------------------------- backward ---

// dQ pass. One block: query rows [q0, q0 + 64) of one (batch, head); Q and dO
// loaded once, K / V tiles and their key bias streamed.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tmap_q, const __grid_constant__ CUtensorMap tmap_k,
                    const __grid_constant__ CUtensorMap tmap_v, const __grid_constant__ CUtensorMap tmap_do,
                    const Args a) {
    using S = Smem<T, D, 2, BN>;
    constexpr bool SX = sizeof(T) == 4;          // fp32 inputs carry a lo half, bf16 do not
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    uint8_t* sq = smem;
    uint8_t* sdo = smem + S::TILE;
    uint8_t* ring = smem + S::RING;
    float* sbias = reinterpret_cast<float*>(smem + S::SIDE_OFF);
    uint64_t* own = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
    uint64_t* full = own + 1;
    uint64_t* empty = full + STAGES;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
    const int q0 = blockIdx.x * BM;
    const int nk = (a.Lk + BN - 1) / BN;

    if (tid == 0) {
        mbar_init(smem_u32(own), 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(smem_u32(&full[s]), 1 + 32);
            mbar_init(smem_u32(&empty[s]), 4);
        }
        mbar_init_fence();
    }
    __syncthreads();
    const bool row_active = a.mask != nullptr && any_active(a.mask, a.mask_sb, b, 0, a.Lk, a.Lk, lane);

    if (warp == 4) {
        if (lane == 0) {
            prefetch_map(&tmap_q);
            prefetch_map(&tmap_k);
            prefetch_map(&tmap_v);
            prefetch_map(&tmap_do);
            mbar_expect_tx(smem_u32(own), 2 * S::TILE);
            load_tile<T, D>(sq, &tmap_q, smem_u32(own), q0, h, b);
            load_tile<T, D>(sdo, &tmap_do, smem_u32(own), q0, h, b);
        }
        for (int i = 0, n = 0; i < nk; ++i) {
            if (skip_tile(a.mask, a.mask_sb, b, row_active, i, a.Lk, lane)) continue;
            const int s = n % STAGES;
            if (n >= STAGES) mbar_wait(smem_u32(&empty[s]), ((n / STAGES) & 1) ^ 1);
            ++n;
            const uint32_t bar = smem_u32(&full[s]);
            if (lane == 0) {
                uint8_t* st = ring + s * 2 * S::TILE;
                mbar_expect_tx(bar, 2 * S::TILE);
                load_tile<T, D>(st, &tmap_k, bar, i * BN, h, b);
                load_tile<T, D>(st + S::TILE, &tmap_v, bar, i * BN, h, b);
            }
            for (int c = lane; c < BN; c += 32)
                sbias[s * BN + c] = key_bias(a.mask, a.mask_sb, b, i * BN + c, a.Lk);
            mbar_arrive(bar);
        }
        return;
    }

    const int t = lane & 3, g = lane >> 2, r0 = warp * 16;
    const long long bh = static_cast<long long>(b) * a.H + h;
    // rows g and g + 8: the forward's m and 1 / l, and Delta = rowsum(dO * O)
    // from device memory (each thread of a quad takes every fourth 16-byte
    // chunk of the row); a row past Lq gets P = 0
    float m[2], il[2], dl[2];
    constexpr int CH = D * static_cast<int>(sizeof(T)) / 16, PER = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int row = q0 + r0 + g + 8 * hh;
        float acc = 0.f;
        m[hh] = CUDART_INF_F;
        il[hh] = 0.f;
        if (row < a.Lq) {
            m[hh] = a.stat_m[bh * a.Lq + row];
            il[hh] = 1.f / a.stat_l[bh * a.Lq + row];
            const T* orow = static_cast<const T*>(a.o.p) + b * a.o.sb + h * a.o.sh + row * a.o.sl;
            const T* drow = static_cast<const T*>(a.dout.p) + b * a.dout.sb + h * a.dout.sh
                            + row * a.dout.sl;
#pragma unroll
            for (int c = t; c < CH; c += 4) {
                const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * PER);
                const uint4 dv = *reinterpret_cast<const uint4*>(drow + c * PER);
                const T* oe = reinterpret_cast<const T*>(&ov);
                const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
                for (int e = 0; e < PER; ++e) acc = fmaf(to_f(oe[e]), to_f(de[e]), acc);
            }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        dl[hh] = acc;
        if (t == 0 && row < a.Lq) a.delta[bh * a.Lq + row] = acc;
    }

    float dq[D / 8][4];
    zero(dq);
    mbar_wait(smem_u32(own), 0);
    for (int i = 0, n = 0; i < nk; ++i) {
        if (skip_tile(a.mask, a.mask_sb, b, row_active, i, a.Lk, lane)) continue;
        const int s = n % STAGES;
        mbar_wait(smem_u32(&full[s]), (n / STAGES) & 1);
        ++n;
        const uint8_t* kt = ring + s * 2 * S::TILE;
        const float* bias = sbias + s * BN;
        float p[NT][4], dp[NT][4];
        zero(p);
        mma_rows<T, D, SX, SX>(p, sq, r0, kt, g, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e)
                p[j][e] = exp2_sfu(fmaf(p[j][e], a.scale_log2, (e & 1) ? bb.y : bb.x) - m[e >> 1])
                          * il[e >> 1];
        }
        zero(dp);
        mma_rows<T, D, SX, SX>(dp, sdo, r0, kt + S::TILE, g, t);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - dl[e >> 1]);
        mma_regs<T, D, SX>(dq, dp, kt, g, t);
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    }
    const float mul[2] = {a.scale, a.scale};
    T* dst = static_cast<T*>(a.dq.p) + b * a.dq.sb + h * a.dq.sh;
    store_rows<T, D>(dq, dst, a.dq.sl, q0 + r0, a.Lq, g, t, mul);
}

// dK / dV pass. One block: keys [k0, k0 + 64) of one (batch, head); K and V
// loaded once, Q / dO tiles streamed with each query row's m, 1 / l and
// Delta (rows past Lq: m = +inf, 1 / l = 0, so P = 0).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tmap_q, const __grid_constant__ CUtensorMap tmap_k,
                      const __grid_constant__ CUtensorMap tmap_v, const __grid_constant__ CUtensorMap tmap_do,
                      const Args a) {
    using S = Smem<T, D, 2, 3 * BN>;
    constexpr bool SX = sizeof(T) == 4;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    uint8_t* sk = smem;
    uint8_t* sv = smem + S::TILE;
    uint8_t* ring = smem + S::RING;
    float* sstat = reinterpret_cast<float*>(smem + S::SIDE_OFF);   // a stage: m, 1 / l, Delta
    uint64_t* own = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
    uint64_t* full = own + 1;
    uint64_t* empty = full + STAGES;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
    const int k0 = blockIdx.x * BN;
    const int nq = (a.Lq + BM - 1) / BM;
    const long long bh = static_cast<long long>(b) * a.H + h;

    const bool row_active = a.mask != nullptr && any_active(a.mask, a.mask_sb, b, 0, a.Lk, a.Lk, lane);
    if (skip_tile(a.mask, a.mask_sb, b, row_active, blockIdx.x, a.Lk, lane)) {
        if (warp < 4) {
            float zeros[D / 8][4];
            zero(zeros);
            const float one[2] = {1.f, 1.f};
            const int t = lane & 3, g = lane >> 2, r0 = warp * 16;
            store_rows<T, D>(zeros, static_cast<T*>(a.dk.p) + b * a.dk.sb + h * a.dk.sh, a.dk.sl,
                             k0 + r0, a.Lk, g, t, one);
            store_rows<T, D>(zeros, static_cast<T*>(a.dv.p) + b * a.dv.sb + h * a.dv.sh, a.dv.sl,
                             k0 + r0, a.Lk, g, t, one);
        }
        return;
    }

    if (tid == 0) {
        mbar_init(smem_u32(own), 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(smem_u32(&full[s]), 1 + 32);
            mbar_init(smem_u32(&empty[s]), 4);
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (warp == 4) {
        if (lane == 0) {
            prefetch_map(&tmap_q);
            prefetch_map(&tmap_k);
            prefetch_map(&tmap_v);
            prefetch_map(&tmap_do);
            mbar_expect_tx(smem_u32(own), 2 * S::TILE);
            load_tile<T, D>(sk, &tmap_k, smem_u32(own), k0, h, b);
            load_tile<T, D>(sv, &tmap_v, smem_u32(own), k0, h, b);
        }
        for (int i = 0; i < nq; ++i) {
            const int s = i % STAGES;
            if (i >= STAGES) mbar_wait(smem_u32(&empty[s]), ((i / STAGES) & 1) ^ 1);
            const uint32_t bar = smem_u32(&full[s]);
            if (lane == 0) {
                uint8_t* st = ring + s * 2 * S::TILE;
                mbar_expect_tx(bar, 2 * S::TILE);
                load_tile<T, D>(st, &tmap_q, bar, i * BM, h, b);
                load_tile<T, D>(st + S::TILE, &tmap_do, bar, i * BM, h, b);
            }
            float* ss = sstat + s * 3 * BN;
            for (int c = lane; c < BM; c += 32) {
                const int row = i * BM + c;
                const bool in = row < a.Lq;
                ss[c] = in ? a.stat_m[bh * a.Lq + row] : CUDART_INF_F;
                ss[BN + c] = in ? 1.f / a.stat_l[bh * a.Lq + row] : 0.f;
                ss[2 * BN + c] = in ? a.delta[bh * a.Lq + row] : 0.f;
            }
            mbar_arrive(bar);
        }
        return;
    }

    const int t = lane & 3, g = lane >> 2, r0 = warp * 16;
    const float kb[2] = {key_bias(a.mask, a.mask_sb, b, k0 + r0 + g, a.Lk),
                         key_bias(a.mask, a.mask_sb, b, k0 + r0 + g + 8, a.Lk)};
    float dk[D / 8][4], dv[D / 8][4];
    zero(dk);
    zero(dv);
    mbar_wait(smem_u32(own), 0);
    for (int i = 0; i < nq; ++i) {
        const int s = i % STAGES;
        mbar_wait(smem_u32(&full[s]), (i / STAGES) & 1);
        const uint8_t* qt = ring + s * 2 * S::TILE;
        const uint8_t* dot = qt + S::TILE;
        const float* ss = sstat + s * 3 * BN;
        // p[j]: keys g (0, 1) and g + 8 (2, 3), queries 8j + 2t, 8j + 2t + 1
        float p[NT][4], dp[NT][4];
        zero(p);
        mma_rows<T, D, SX, SX>(p, sk, r0, qt, g, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const float2 mm = *reinterpret_cast<const float2*>(ss + 8 * j + 2 * t);
            const float2 ll = *reinterpret_cast<const float2*>(ss + BN + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e)
                p[j][e] = exp2_sfu(fmaf(p[j][e], a.scale_log2, kb[e >> 1]) - ((e & 1) ? mm.y : mm.x))
                          * ((e & 1) ? ll.y : ll.x);
        }
        mma_regs<T, D, SX>(dv, p, dot, g, t);
        zero(dp);
        mma_rows<T, D, SX, SX>(dp, sv, r0, dot, g, t);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const float2 dd = *reinterpret_cast<const float2*>(ss + 2 * BN + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - ((e & 1) ? dd.y : dd.x));
        }
        mma_regs<T, D, SX>(dk, dp, qt, g, t);
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    }
    const float mk[2] = {a.scale, a.scale}, one[2] = {1.f, 1.f};
    store_rows<T, D>(dk, static_cast<T*>(a.dk.p) + b * a.dk.sb + h * a.dk.sh, a.dk.sl, k0 + r0,
                     a.Lk, g, t, mk);
    store_rows<T, D>(dv, static_cast<T*>(a.dv.p) + b * a.dv.sb + h * a.dv.sh, a.dv.sl, k0 + r0,
                     a.Lk, g, t, one);
}

// ------------------------------------------------------------------ launch ---

// the map of a [B, H, L, D] tensor of T (strides in elements, D dense) as
// four dimensions (D, L, H, B), read in boxes of 128 bytes x 64 rows
template <typename T>
int attn_map(CUtensorMap* map, const void* ptr, int B, int H, int L, int D, long long sb,
             long long sh, long long sl) {
    constexpr uint64_t E = sizeof(T);
    const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(L),
                              static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
    const uint64_t strides[3] = {static_cast<uint64_t>(sl) * E, static_cast<uint64_t>(sh) * E,
                                 static_cast<uint64_t>(sb) * E};
    const uint32_t box[4] = {static_cast<uint32_t>(128 / E), 64, 1, 1};
    return tensor_map(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      4, ptr, dims, strides, box);
}

struct Call {
    View q, k, v;
    int B;
    Args a;
};

template <int D>
int launch_fwd(const Call& c, cudaStream_t stream) {
    using S = Smem<float, D, 1, BN>;
    static bool ready[64] = {};
    CUtensorMap mq, mk, mv;
    int rc = attn_map<float>(&mq, c.q.p, c.B, c.a.H, c.a.Lq, D, c.q.sb, c.q.sh, c.q.sl);
    if (rc == 0) rc = attn_map<float>(&mk, c.k.p, c.B, c.a.H, c.a.Lk, D, c.k.sb, c.k.sh, c.k.sl);
    if (rc == 0) rc = attn_map<float>(&mv, c.v.p, c.B, c.a.H, c.a.Lk, D, c.v.sb, c.v.sh, c.v.sl);
    if (rc != 0) return rc;
    const auto kernel = flash_tf32_fwd_kernel<D>;
    const int e = set_smem_once(reinterpret_cast<const void*>(kernel), S::BYTES, ready);
    if (e != 0) return e;
    const dim3 grid((c.a.Lq + BM - 1) / BM, c.B * c.a.H);
    kernel<<<grid, THREADS, S::BYTES, stream>>>(mq, mk, mv, c.a);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const Call& c, cudaStream_t stream) {
    using SQ = Smem<T, D, 2, BN>;
    using SK = Smem<T, D, 2, 3 * BN>;
    static bool ready_q[64] = {}, ready_k[64] = {};
    const Args& a = c.a;
    const View& d = a.dout;
    CUtensorMap mq, mk, mv, mdo;
    int rc = attn_map<T>(&mq, c.q.p, c.B, a.H, a.Lq, D, c.q.sb, c.q.sh, c.q.sl);
    if (rc == 0) rc = attn_map<T>(&mk, c.k.p, c.B, a.H, a.Lk, D, c.k.sb, c.k.sh, c.k.sl);
    if (rc == 0) rc = attn_map<T>(&mv, c.v.p, c.B, a.H, a.Lk, D, c.v.sb, c.v.sh, c.v.sl);
    if (rc == 0) rc = attn_map<T>(&mdo, d.p, c.B, a.H, a.Lq, D, d.sb, d.sh, d.sl);
    if (rc != 0) return rc;
    const auto kq = flash_bwd_dq_kernel<T, D>;
    const auto kk = flash_bwd_dkdv_kernel<T, D>;
    int e = set_smem_once(reinterpret_cast<const void*>(kq), SQ::BYTES, ready_q);
    if (e == 0) e = set_smem_once(reinterpret_cast<const void*>(kk), SK::BYTES, ready_k);
    if (e != 0) return e;
    // the dQ pass writes Delta, which the dK / dV pass reads: one stream, in order
    kq<<<dim3((a.Lq + BM - 1) / BM, c.B * a.H), THREADS, SQ::BYTES, stream>>>(mq, mk, mv, mdo, a);
    e = static_cast<int>(cudaGetLastError());
    if (e != 0) return e;
    kk<<<dim3((a.Lk + BN - 1) / BN, c.B * a.H), THREADS, SK::BYTES, stream>>>(mq, mk, mv, mdo, a);
    return static_cast<int>(cudaGetLastError());
}

bool sizes_ok(int B, int H, int Lq, int Lk) {
    return B > 0 && H > 0 && Lq > 0 && Lk > 0 && static_cast<long long>(B) * H <= 65535;
}

}  // namespace

// The fp32 forward. Arguments as stk_flash_attention's (csrc/flash_attention.cu):
// dtype must be 1 (fp32); stat_m / stat_l ([B, H, Lq] fp32 each) may both be
// null. Returns a cudaError_t, -1 for arguments the kernel does not take, -2
// if cuTensorMapEncodeTiled is not found in libcuda, -1000 - CUresult if it fails.
extern "C" int stk_flash_attention_f32(
        const void* q, const void* k, const void* v, void* o, const void* mask,
        int B, int H, int Lq, int Lk, int D, int dtype,
        long long q_sb, long long q_sh, long long q_sl,
        long long k_sb, long long k_sh, long long k_sl,
        long long v_sb, long long v_sh, long long v_sl,
        long long o_sb, long long o_sh, long long o_sl,
        long long mask_sb, void* stat_m, void* stat_l, void* stream) {
    if (!sizes_ok(B, H, Lq, Lk) || dtype != 1 || ((stat_m == nullptr) != (stat_l == nullptr)))
        return -1;
    Call c{};
    c.q = {const_cast<void*>(q), q_sb, q_sh, q_sl};
    c.k = {const_cast<void*>(k), k_sb, k_sh, k_sl};
    c.v = {const_cast<void*>(v), v_sb, v_sh, v_sl};
    c.B = B;
    c.a.mask = static_cast<const unsigned char*>(mask);
    c.a.mask_sb = mask_sb;
    c.a.o = {o, o_sb, o_sh, o_sl};
    c.a.stat_m = static_cast<float*>(stat_m);
    c.a.stat_l = static_cast<float*>(stat_l);
    c.a.H = H;
    c.a.Lq = Lq;
    c.a.Lk = Lk;
    c.a.scale = 1.f / sqrtf(static_cast<float>(D));
    c.a.scale_log2 = LOG2E * c.a.scale;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D == 64) return launch_fwd<64>(c, s);
    if (D == 128) return launch_fwd<128>(c, s);
    return -1;
}

// The backward: dq, dk, dv (laid out by the caller's strides, of the inputs'
// type) from q, k, v, the forward's output o, its gradient dout, the mask
// and the forward's row statistics; delta is [B, H, Lq] fp32 scratch.
// dtype: 0 = bf16, 1 = fp32. Strides in elements, (batch, head, row) for
// each of q, k, v, o, dout, dq, dk, dv. Returns as stk_flash_attention_f32.
extern "C" int stk_flash_attention_backward(
        const void* q, const void* k, const void* v, const void* o, const void* dout,
        const void* mask, void* dq, void* dk, void* dv,
        const void* stat_m, const void* stat_l, void* delta,
        int B, int H, int Lq, int Lk, int D, int dtype, const long long* strides,
        long long mask_sb, void* stream) {
    if (!sizes_ok(B, H, Lq, Lk) || stat_m == nullptr || stat_l == nullptr || delta == nullptr)
        return -1;
    const long long* s = strides;
    Call c{};
    c.q = {const_cast<void*>(q), s[0], s[1], s[2]};
    c.k = {const_cast<void*>(k), s[3], s[4], s[5]};
    c.v = {const_cast<void*>(v), s[6], s[7], s[8]};
    c.B = B;
    c.a.mask = static_cast<const unsigned char*>(mask);
    c.a.mask_sb = mask_sb;
    c.a.o = {const_cast<void*>(o), s[9], s[10], s[11]};
    c.a.dout = {const_cast<void*>(dout), s[12], s[13], s[14]};
    c.a.dq = {dq, s[15], s[16], s[17]};
    c.a.dk = {dk, s[18], s[19], s[20]};
    c.a.dv = {dv, s[21], s[22], s[23]};
    c.a.stat_m = static_cast<float*>(const_cast<void*>(stat_m));
    c.a.stat_l = static_cast<float*>(const_cast<void*>(stat_l));
    c.a.delta = static_cast<float*>(delta);
    c.a.H = H;
    c.a.Lq = Lq;
    c.a.Lk = Lk;
    c.a.scale = 1.f / sqrtf(static_cast<float>(D));
    c.a.scale_log2 = LOG2E * c.a.scale;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && D == 64) return launch_bwd<__nv_bfloat16, 64>(c, st);
    if (dtype == 0 && D == 128) return launch_bwd<__nv_bfloat16, 128>(c, st);
    if (dtype == 1 && D == 64) return launch_bwd<float, 64>(c, st);
    if (dtype == 1 && D == 128) return launch_bwd<float, 128>(c, st);
    return -1;
}
