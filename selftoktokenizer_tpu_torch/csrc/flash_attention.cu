// Fused softmax attention with an optional per-key mask: the bf16 forward.
//
//   out = softmax(q k^T / sqrt(D) + bias) v,   bias[b, key] = mask ? 0 : -1e30
//
// Replaces the Pallas TPU kernel
// selftoktokenizer_tpu/ops/flash_attention.py::_flash_mha (entered through
// flash_sdpa_key_mask) for bf16 inputs; the fp32 forward and the backward of
// both types are csrc/flash_attention_tf32.cu (split TF32 on the tensor
// cores). The TPU kernel keeps one head's whole K and V in VMEM
// and softmaxes a [block_q, Lk] tile in one pass; a block on Hopper has
// 227 KB of shared memory, so here a block takes one query tile of one
// (batch, head) and walks K/V in tiles with the online softmax (running max,
// running sum, fp32 accumulator), never writing the scores to device memory.
// The mask is read per K tile from [B, Lk] and applied as a finite -1e30
// added in fp32, so a fully masked row yields the uniform mean over the Lk
// real keys. Keys past Lk in the last tile get -inf (weight 0) and rows past
// Lq are not stored, so any Lq and Lk are accepted. With a statistics
// pointer the epilogue also writes each row's running max (log2 domain) and
// sum, fp32 [B, H, Lq] each, for the backward.
//
// Bound on an H100: 4*B*H*Lq*Lk*D FLOP against (2*Lq + 2*Lk)*D*B*H*itemsize
// bytes, and B*H*Lq*Lk exponentials on the special-function units (16 a
// clock per SM). At D = 64 the tensor cores do 4,096 bf16 FLOP a clock per
// SM, 256 per score: the exponentials take as long as the products, so a
// kernel that runs them one after the other reaches at most half its bound.
//
// bf16 (flash_bf16_kernel), built for Hopper. A block is 64 query rows of
// one (batch, head): one consumer warpgroup and one producer warp.
//  - The producer loads the block's Q once and keeps K/V tiles of 64 keys
//    in flight through a ring of 4 stages (2 at D = 128) by TMA (tensor maps of four
//    dimensions (D, L, H, B) built from the caller's strides, so a box
//    never crosses into another head's rows and the ragged edges at Lq and
//    Lk are zero-filled), each stage signed off by mbarriers (full: the
//    bytes and the key bias arrived; empty: every consumer warp is done).
//    It flags a tile whose keys are all real and unmasked; there the
//    consumers skip the bias and fold the scale into the exponent's
//    multiply-add.
//  - The consumers run both products with wgmma: S = Q K^T with Q in
//    registers (read once from its 128-byte-swizzled tile) against the
//    K-major K tile, O += P V with P from registers (the S accumulator
//    converted to bf16 in place) and V read with the transpose bit.
//  - The exponentials of tile i run while tile i-1's P V is on the tensor
//    cores: S of tile i and P V of tile i-1 are issued together, and only S
//    is awaited before the softmax.
//  - The output is staged in shared memory and stored by TMA, which clips
//    the rows at or past Lq.
// The ring has 4 stages at D = 64, the most that leaves three blocks an SM
// (126 registers a thread), and 2 at D = 128 (one block an SM). A deeper ring
// was no slower at any shape of the main path, whatever its tile counts, so
// the stage count is fixed per head dim, not planned per call. There neither
// the loads, the exponentials nor the tensor cores' work bound the kernel:
// builds that load half the K/V tiles, skip the exponentials, or cut either
// product to a quarter took at most 10 % less time on an H100 (PERF.md).
// What is left is each warpgroup's chain of waits per tile (S, softmax,
// P V), with three warpgroups an SM to hide it.
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

// m64n64k16 f32 += bf16 * bf16, A from registers (each warp's 16 rows as the
// m16n8k16 A fragment), B in shared memory: K-major (TB = 0) or MN-major,
// read with the transpose bit (TB = 1); accumulate = 0 overwrites d
template <int TB>
__device__ __forceinline__ void wgmma_rs_64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// ----------------------------------------------------------------- bf16 ----

constexpr int BM = 64;         // query rows per block: one consumer warpgroup
constexpr int BN = 64;         // keys per K/V tile
constexpr int THREADS = 128 + 32;   // the warpgroup and one producer warp

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit; -inf gives 0 and results below the
// smallest normal flush to 0 (weights under 1e-38 of the row's largest)
__device__ __forceinline__ float exp2_sfu(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// The shared memory of one instantiation (D head dim, STAGES K/V tiles in
// the ring): 1024 bytes of slack to align the tiles for the 128-byte
// swizzle, Q, the ring, each stage's key bias, the Q barrier, full / empty
// barriers, and each stage's flag "no key of this tile is masked or past
// Lk". ops/flash_attention.py::smem_bytes repeats this sum.
template <int D>
struct Tile {
    static constexpr int STAGES = D == 64 ? 4 : 2;
    static constexpr int SUB = D / 64;                 // 64-column (128-byte) sub-tiles of a row
    static constexpr int Q_BYTES = SUB * BM * 128;
    static constexpr int KV_BYTES = SUB * BN * 128;    // one K or one V tile
    static constexpr int STAGE_BYTES = 2 * KV_BYTES;
    static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + STAGES * BN * 4
                              + (1 + 2 * STAGES) * 8 + STAGES * 4;
};

struct AttnArgs {
    const unsigned char* mask;        // [B, Lk] bytes, non-zero = attend; or null
    long long mask_sb;
    int H, Lq, Lk;
    float scale_log2;                 // log2(e) / sqrt(D)
    float* stat_m;                    // [B, H, Lq] each: the rows' max and sum, or null
    float* stat_l;
};

// Q as the A fragments of the k16 steps of Q K^T, read once from its
// swizzled tile (the 16-byte chunk c of row r lies at chunk c ^ (r % 8))
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qf)[D / 16][4], const uint8_t* q, int r, int t) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint8_t* sub = q + (kk / 4) * BM * 128;
        const int c0 = 2 * (kk % 4), g = r & 7;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = r + 8 * (i & 1), chunk = (c0 + (i >> 1)) ^ g;
            qf[kk][i] = *reinterpret_cast<const uint32_t*>(sub + row * 128 + chunk * 16 + 4 * t);
        }
    }
}

// S = Q K^T for the block's 64 rows and one K tile (K-major in the ring; a
// k16 step moves 32 bytes along a swizzled row, a 64-column sub-tile ends
// every 4 steps). One commit group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], const uint32_t (&qf)[D / 16][4],
                                         uint32_t k) {
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        wgmma_rs_64<0>(s, qf[kk], smem_desc(k + (kk / 4) * BN * 128 + (kk % 4) * 32), kk > 0);
    wgmma_commit();
}

// O += P V: P from registers, V [BN keys][D] read with the transpose bit, a
// k16 step 16 keys (2048 bytes) further. One commit group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 64][32], uint32_t (&p)[BN / 16][4],
                                         uint32_t v) {
    fence_regs(p);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int sd = 0; sd < D / 64; ++sd)
            wgmma_rs_64<1>(o[sd], p[kk], smem_desc(v + sd * BN * 128 + kk * 2048), 1);
    wgmma_commit();
}

// The online softmax's step on one tile of scores, in place: scale into the
// log2 domain, add the key bias, new running max (alpha rescales what came
// before), exponentials, this thread's share of the row sums. Thread holds
// rows g and g + 8 of its warp's 16; s[4j + 2h + e] is row g + 8h, key
// 8j + 2t + e. A tile whose bias is all zero (BIAS false) skips it: the max
// is taken on the raw scores and scaled once, and the scale folds into the
// exponent's fused multiply-add.
template <bool BIAS>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], const float* bias, int t,
                                             float scale_log2, float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2]) {
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
        if constexpr (BIAS) {
            const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
            s[4 * j] = fmaf(s[4 * j], scale_log2, bb.x);
            s[4 * j + 1] = fmaf(s[4 * j + 1], scale_log2, bb.y);
            s[4 * j + 2] = fmaf(s[4 * j + 2], scale_log2, bb.x);
            s[4 * j + 3] = fmaf(s[4 * j + 3], scale_log2, bb.y);
        }
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // every tile holds a real key, whose score is finite, so m_new is finite
        const float m_new = fmaxf(m_run[h], BIAS ? mx[h] : mx[h] * scale_log2);
        alpha[h] = exp2_sfu(m_run[h] - m_new);
        m_run[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float m = m_run[e >> 1];
            s[4 * j + e] = exp2_sfu(BIAS ? s[4 * j + e] - m : fmaf(s[4 * j + e], scale_log2, -m));
        }
        rs[0] += s[4 * j] + s[4 * j + 1];
        rs[1] += s[4 * j + 2] + s[4 * j + 3];
    }
    // the quad's four partial sums are added once, after the last tile
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
}

// one tile's softmax step, without the bias where the tile has none
__device__ __forceinline__ void softmax_step(float (&s)[BN / 2], const float* bias, int unbiased,
                                             int t, float scale_log2, float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2]) {
    if (unbiased) {
        softmax_tile<false>(s, bias, t, scale_log2, m_run, l_run, alpha);
        return;
    }
    softmax_tile<true>(s, bias, t, scale_log2, m_run, l_run, alpha);
}

// P in bf16 as the A fragments of the k16 steps of P V: step kk takes keys
// 16 kk .. 16 kk + 15, which are the accumulator's column groups 2 kk, 2 kk + 1
__device__ __forceinline__ void pack_p(uint32_t (&p)[BN / 16][4], const float (&s)[BN / 2]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 64][32], const float (&alpha)[2]) {
#pragma unroll
    for (int sd = 0; sd < D / 64; ++sd)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            o[sd][4 * j] *= alpha[0];
            o[sd][4 * j + 1] *= alpha[0];
            o[sd][4 * j + 2] *= alpha[1];
            o[sd][4 * j + 3] *= alpha[1];
        }
}


// One block: query rows [q0, q0 + 64) of one (batch, head), blockIdx.y =
// b*H + h. Warps 0-3 are the consumer warpgroup, warp 4 the producer. At
// D = 64 three blocks share an SM (at most 136 registers a thread).
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 3 : 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tmap_q, const __grid_constant__ CUtensorMap tmap_k,
                  const __grid_constant__ CUtensorMap tmap_v, const __grid_constant__ CUtensorMap tmap_o,
                  const AttnArgs a) {
    using C = Tile<D>;
    constexpr int SUB = C::SUB, STAGES = C::STAGES;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    uint8_t* sq = smem;
    uint8_t* ring = smem + C::Q_BYTES;
    float* sbias = reinterpret_cast<float*>(ring + STAGES * C::STAGE_BYTES);
    uint64_t* q_full = reinterpret_cast<uint64_t*>(sbias + STAGES * BN);
    uint64_t* full = q_full + 1;
    uint64_t* empty = full + STAGES;
    int* unbiased = reinterpret_cast<int*>(empty + STAGES);

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
    const int q0 = blockIdx.x * BM;
    const int nk = (a.Lk + BN - 1) / BN;

    if (tid == 0) {
        mbar_init(smem_u32(q_full), 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(smem_u32(&full[s]), 1 + 32);          // the bytes, and the warp's bias
            mbar_init(smem_u32(&empty[s]), 4);              // one arrival per consumer warp
        }
        mbar_init_fence();
    }
    __syncthreads();

    if (warp == 4) {
        // producer: lane 0 keeps up to STAGES K/V tiles in flight by TMA; the
        // warp writes each tile's key bias and flag beside it. Keys at or
        // past Lk (the zero-filled part of the last tile) get -inf, masked
        // keys -1e30.
        if (lane == 0) {
            prefetch_map(&tmap_q);
            prefetch_map(&tmap_k);
            prefetch_map(&tmap_v);
            const uint32_t bar = smem_u32(q_full);
            mbar_expect_tx(bar, C::Q_BYTES);
#pragma unroll
            for (int sd = 0; sd < SUB; ++sd)
                tma_load_4d(smem_u32(sq + sd * BM * 128), &tmap_q, bar, 64 * sd, q0, h, b);
        }
        for (int i = 0; i < nk; ++i) {
            const int s = i % STAGES;
            if (i >= STAGES) mbar_wait(smem_u32(&empty[s]), ((i / STAGES) & 1) ^ 1);
            const uint32_t bar = smem_u32(&full[s]);
            if (lane == 0) {
                uint8_t* st = ring + s * C::STAGE_BYTES;
                mbar_expect_tx(bar, C::STAGE_BYTES);    // a box counts whole, zero-filled part included
#pragma unroll
                for (int sd = 0; sd < SUB; ++sd) {
                    tma_load_4d(smem_u32(st + sd * BN * 128), &tmap_k, bar, 64 * sd, i * BN, h, b);
                    tma_load_4d(smem_u32(st + C::KV_BYTES + sd * BN * 128), &tmap_v, bar, 64 * sd, i * BN, h, b);
                }
            }
            float* bias = sbias + s * BN;
            bool zero = true;
            for (int c = lane; c < BN; c += 32) {
                const int key = i * BN + c;
                float v = -CUDART_INF_F;
                if (key < a.Lk) {
                    v = 0.f;
                    if (a.mask != nullptr && a.mask[b * a.mask_sb + key] == 0) v = NEG_BIAS;
                }
                bias[c] = v;
                zero = zero && v == 0.f;
            }
            zero = __all_sync(0xffffffffu, zero);
            if (lane == 0) unbiased[s] = zero;
            mbar_arrive(bar);
        }
        return;
    }

    // consumers
    const int t = lane & 3, g = lane >> 2;
    const int r_base = warp * 16 + g;                    // row g of this warp's 16
    const uint32_t ring_addr = smem_u32(ring);
    // a stage goes back to the producer once every consumer warp is done with it
    auto release = [&](int s) {
        if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    };

    float o[SUB][32];
#pragma unroll
    for (int sd = 0; sd < SUB; ++sd)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[sd][i] = 0.f;
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l_run[2] = {0.f, 0.f};
    float alpha[2];
    float s_acc[BN / 2];
    uint32_t p[BN / 16][4];
    uint32_t qf[D / 16][4];

    mbar_wait(smem_u32(q_full), 0);
    load_q<D>(qf, sq, r_base, t);
    // The first tile's scores, then for each next tile: issue its S = Q K^T
    // and the previous tile's O += P V together, wait for S only, and run
    // this tile's exponentials while P V is on the tensor cores. alpha
    // rescales O once P V is done; the previous stage then goes back to the
    // producer.
    mbar_wait(smem_u32(&full[0]), 0);
    issue_qk<D>(s_acc, qf, ring_addr);
    wgmma_wait0();
    fence_regs(s_acc);
    softmax_step(s_acc, sbias, unbiased[0], t, a.scale_log2, m_run, l_run, alpha);
    pack_p(p, s_acc);
    for (int i = 1; i < nk; ++i) {
        const int s = i % STAGES, sp = (i - 1) % STAGES;
        mbar_wait(smem_u32(&full[s]), (i / STAGES) & 1);
        issue_qk<D>(s_acc, qf, ring_addr + s * C::STAGE_BYTES);
        issue_pv<D>(o, p, ring_addr + sp * C::STAGE_BYTES + C::KV_BYTES);
        wgmma_wait1();                                    // S of tile i; P V still running
        fence_regs(s_acc);
        softmax_step(s_acc, sbias + s * BN, unbiased[s], t, a.scale_log2, m_run, l_run, alpha);
        wgmma_wait0();
        fence_regs(p);
        fence_regs(o);
        release(sp);
        rescale<D>(o, alpha);
        pack_p(p, s_acc);
    }
    issue_pv<D>(o, p, ring_addr + ((nk - 1) % STAGES) * C::STAGE_BYTES + C::KV_BYTES);
    wgmma_wait0();
    fence_regs(p);
    fence_regs(o);

    // epilogue: O / l in bf16, staged in the (now unread) Q tile with the
    // 128-byte swizzle (conflict-free: the 8 rows g of a warp's store land in
    // 8 different 16-byte chunks), then one TMA store per 64-column
    // sub-tile, which leaves out the rows at or past Lq
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float l = l_run[hh];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[hh] = 1.f / l;
        const int row = q0 + r_base + 8 * hh;
        if (a.stat_m != nullptr && t == 0 && row < a.Lq) {
            const long long at = (static_cast<long long>(b) * a.H + h) * a.Lq + row;
            a.stat_m[at] = m_run[hh];
            a.stat_l[at] = l;
        }
    }
#pragma unroll
    for (int sd = 0; sd < SUB; ++sd) {
        uint8_t* dst = sq + sd * BM * 128;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int r = r_base + 8 * hh;
                *reinterpret_cast<uint32_t*>(dst + r * 128 + ((j ^ g) << 4) + 4 * t) =
                    pack_bf16(o[sd][4 * j + 2 * hh] * inv[hh], o[sd][4 * j + 2 * hh + 1] * inv[hh]);
            }
    }
    fence_async_shared();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");       // the consumer warpgroup's 128 threads
    if (tid == 0) {
#pragma unroll
        for (int sd = 0; sd < SUB; ++sd)
            tma_store_4d(&tmap_o, smem_u32(sq + sd * BM * 128), 64 * sd, q0, h, b);
        tma_store_commit_and_wait();
    }
}

// --------------------------------------------------------------- launch ---

// the map of a bf16 [B, H, L, D] tensor (strides in elements, D dense) as
// four dimensions (D, L, H, B), read or written in boxes of 64 columns x 64 rows
int attn_map(CUtensorMap* map, const void* ptr, int B, int H, int L, int D,
             long long sb, long long sh, long long sl) {
    const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(L),
                              static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
    const uint64_t strides[3] = {static_cast<uint64_t>(sl) * 2, static_cast<uint64_t>(sh) * 2,
                                 static_cast<uint64_t>(sb) * 2};
    const uint32_t box[4] = {64, 64, 1, 1};
    return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box);
}

struct Bf16Call {
    const void *q, *k, *v, *o;
    int B;
    long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl;
    AttnArgs args;
};

template <int D>
int launch_bf16(const Bf16Call& c, cudaStream_t stream) {
    using C = Tile<D>;
    static bool ready[64] = {};
    const AttnArgs& a = c.args;
    CUtensorMap mq, mk, mv, mo;
    int rc = attn_map(&mq, c.q, c.B, a.H, a.Lq, D, c.q_sb, c.q_sh, c.q_sl);
    if (rc == 0) rc = attn_map(&mk, c.k, c.B, a.H, a.Lk, D, c.k_sb, c.k_sh, c.k_sl);
    if (rc == 0) rc = attn_map(&mv, c.v, c.B, a.H, a.Lk, D, c.v_sb, c.v_sh, c.v_sl);
    if (rc == 0) rc = attn_map(&mo, c.o, c.B, a.H, a.Lq, D, c.o_sb, c.o_sh, c.o_sl);
    if (rc != 0) return rc;
    const auto kernel = flash_bf16_kernel<D>;
    const int e = set_smem_once(reinterpret_cast<const void*>(kernel), C::SMEM, ready);
    if (e != 0) return e;
    const dim3 grid((a.Lq + BM - 1) / BM, c.B * a.H);
    kernel<<<grid, THREADS, C::SMEM, stream>>>(mq, mk, mv, mo, a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 forward; dtype must be 0 (bf16: the fp32 forward is
// csrc/flash_attention_tf32.cu's stk_flash_attention_f32). Strides are in
// elements; the last dimension (D, 64 or 128) is dense. mask may be null;
// stat_m / stat_l ([B, H, Lq] fp32 each) may both be null. Returns a
// cudaError_t, -1 for arguments the kernel does not take, -2 if
// cuTensorMapEncodeTiled is not found in libcuda, -1000 - CUresult if it fails.
extern "C" int stk_flash_attention(
        const void* q, const void* k, const void* v, void* o, const void* mask,
        int B, int H, int Lq, int Lk, int D, int dtype,
        long long q_sb, long long q_sh, long long q_sl,
        long long k_sb, long long k_sh, long long k_sl,
        long long v_sb, long long v_sh, long long v_sl,
        long long o_sb, long long o_sh, long long o_sl,
        long long mask_sb, void* stat_m, void* stat_l, void* stream) {
    if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || (long long)B * H > 65535 || dtype != 0
            || ((stat_m == nullptr) != (stat_l == nullptr)))
        return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
    const Bf16Call c = {q, k, v, o, B, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl,
                        o_sb, o_sh, o_sl,
                        {static_cast<const unsigned char*>(mask), mask_sb, H, Lq, Lk, scale_log2,
                         static_cast<float*>(stat_m), static_cast<float*>(stat_l)}};
    if (D == 64) return launch_bf16<64>(c, s);
    if (D == 128) return launch_bf16<128>(c, s);
    return -1;
}
