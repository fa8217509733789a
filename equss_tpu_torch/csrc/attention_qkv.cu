// Multi-head softmax attention, read straight off the packed qkv projection
// or off separate q, k and v tensors, for Hopper (sm_90a).
//
// Replaces the TPU kernels equss_tpu/ops/attention.py::fused_attention_qkv
// (kernel body _attn_qkv_kernel) and ::fused_attention (_attn_kernel).
// Row by row it computes
//   logits = (q . k) accumulated in f32, times scale
//   keys at index >= n_real contribute exactly 0
//   p = exp(logit - max);  out = (bf16(p) . v) accumulated in f32,
//   times 1 / sum(p) in f32, stored as bf16.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s, 132 SMs whose
// exponential unit does 16 per clock): at the serving shape B = 128,
// N = 785, H = 6, hd = 64 one layer does 4*B*H*N^2*hd = 121 GFLOP
// (0.12 ms), moves 0.31 GB (0.09 ms) and takes B*H*N^2 = 473 M
// exponentials (0.11-0.13 ms at SM clocks of 1.98-1.75 GHz).  The tensor
// cores and the exponential unit are two bounds of the same size, so the
// design has to overlap the softmax of one tile with the products of
// another.
//
// Design (one templated body for hd = 64 and hd = 32, two C entries):
// * A block of 384 threads owns one 128-row q tile of one (head, batch
//   item): warpgroup 0 is the producer, warpgroups 1 and 2 are consumers
//   of 64 q rows each.  A consumer whose rows all lie at or past N does no
//   work (832 q rows computed for N = 785, 1664 for N = 1601).  Two blocks
//   fit an SM (__launch_bounds__(384, 2)); setmaxnreg gives the producer
//   24 registers and each consumer thread 104.
// * Keys go in tiles of 64 (13 tiles, 832 keys, for n_real = 785; 26,
//   1664, for 1601).  Tiles wholly at or past n_real are skipped; in the
//   last, ragged tile the keys at or past n_real are set to -inf, so their
//   exponential is exactly 0.
// * One thread of the producer loads q once and streams k and v through a
//   3-stage ring in shared memory with TMA, each stage guarded by a full
//   and an empty mbarrier.  The packed entry reads the (B, N, 3C) tensor
//   through one 3-D tensor map {3C, N, B}: q, k and v of head h are the
//   column coordinates h*hd, C + h*hd and 2C + h*hd.  The separate entry
//   has one map {H*hd, N, B} per tensor.  Rows past N are zero-filled
//   per batch item, so no row of the next item is ever read.  Tiles are
//   128-byte swizzled at hd = 64 and 64-byte swizzled at hd = 32.
// * Both products run on wgmma with f32 accumulators: S = Q K^T as
//   m64n64k16 with both operands in shared memory (K-major), O += P V as
//   m64n{hd}k16 with P from registers (the S accumulator converted to
//   bf16 is the A fragment) and V from shared memory as the MN-major
//   (transposed) B operand.  A ring stage is released only after the
//   wgmma that read its v has completed.  Each product is waited for in
//   its own iteration: one left in flight across the loop's back edge
//   makes ptxas serialize every wgmma of the kernel (warning C7515), which
//   measured slower.  The overlap of softmax and products comes from
//   the four consumer warpgroups resident on an SM (two per block, two
//   blocks), whose tiles interleave on the tensor cores and the
//   exponential unit.
// * One-pass softmax: a running row max m and sum l; when m grows, O and
//   l are rescaled by exp2(m_old - m_new).  Exponentials are ex2 with
//   scale * log2(e) folded into one FMA.  The max is taken on the
//   unscaled logits, which saves a multiply per logit and is the max of
//   the scaled ones only for scale > 0: both entries take only that (the
//   TPU kernel takes any scale; every caller passes hd^-0.5).  1/l in f32
//   is applied to O after the last P V product, then O is rounded once to
//   bf16 and stored with plain stores, rows >= N skipped.
//
// Rounding point that moved relative to _attn_qkv_kernel
// (equss_tpu/ops/attention.py:116-142): the TPU kernel casts
// p = exp(logit - m_final) to bf16; here bf16(p) is taken against the
// running max of the tiles seen so far, and the product is rescaled in
// f32 by exp(m_running - m_final) afterwards.  Both cast a value within
// the same relative rounding step, so the output moves by far less than
// its bf16 rounding step; the kernel is held to 1 bf16 ulp of the output's
// scale against the plain version, including inputs whose row max sits in
// the last, ragged key tile.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;              // q rows per block
constexpr int BN = 64;               // keys per tile
constexpr int STAGES = 3;            // k/v ring depth
constexpr int THREADS = 384;         // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 104;

template <int HD>
struct Tiles {
    static constexpr int HALF_Q_BYTES = 64 * HD * 2;     // one consumer's q rows
    static constexpr int TILE_BYTES = BN * HD * 2;       // one k or v tile
    static constexpr int ATOM_BYTES = 8 * HD * 2;        // eight swizzled rows
    static constexpr int LAYOUT = HD == 64 ? 1 : 2;      // wgmma: 1 = 128B, 2 = 64B
    static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
    static constexpr int SMEM = 1024 + 2 * HALF_Q_BYTES + 2 * STAGES * TILE_BYTES
                                + BAR_BYTES;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// ---------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int item) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(col), "r"(row), "r"(item)
        : "memory");
}

// ---------------------------------------------------------------- wgmma

// shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
           | (static_cast<uint64_t>(lbo >> 4) << 16)
           | (static_cast<uint64_t>(sbo >> 4) << 32)
           | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}

// pins the registers' values at this point of the instruction stream: no
// read moves above a wgmma wait, no write sinks below a wgmma fence (ptxas
// serializes every wgmma of the function if one does)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][C]) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// d (+)= A (64x16, shared, K-major) * B (16x64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A (64x16, registers) * B (16x64, shared, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A (64x16, registers) * B (16x32, shared, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
    if constexpr (HD == 64) wgmma_rs_n64(o, a, db, accumulate);
    else wgmma_rs_n32(o, a, db, accumulate);
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// q, k and v of head 0 sit at columns col_q, col_k and col_v of their
// tensor maps ({width, N, B}); head h adds h*HD.  out: (B, N, C), C = H*HD.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
attention_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 int col_q, int col_k, int col_v,
                 __nv_bfloat16* __restrict__ out, int N, int C, int n_real,
                 float scale_log2) {
    using T = Tiles<HD>;
    extern __shared__ uint8_t smem_raw[];
    // 1024-byte alignment: the swizzle pattern repeats every 1024 bytes
    const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
    const uint32_t sk = sq + 2 * T::HALF_Q_BYTES;
    const uint32_t sv = sk + STAGES * T::TILE_BYTES;
    const uint32_t bar_q = sv + STAGES * T::TILE_BYTES;
    auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
    auto full_v = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
    auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };

    const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const int consumers = q0 + 64 < N ? 2 : 1;
    const int n_tiles = (n_real + BN - 1) / BN;

    if (threadIdx.x == 0) {
        bar_init(bar_q, 1);
        for (int s = 0; s < STAGES; ++s) {
            bar_init(full_k(s), 1);
            bar_init(full_v(s), 1);
            bar_init(empty(s), 4 * consumers);     // one arrival per consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // ---------------------------------------------------- producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
        if (threadIdx.x == 0) {
            const int col = h * HD;
            bar_expect_tx(bar_q, consumers * T::HALF_Q_BYTES);
            tma_load(sq, &map_q, bar_q, col_q + col, q0, b);
            if (consumers == 2)
                tma_load(sq + T::HALF_Q_BYTES, &map_q, bar_q, col_q + col, q0 + 64, b);
            for (int kt = 0; kt < n_tiles; ++kt) {
                const int s = kt % STAGES, round = kt / STAGES;
                if (round > 0) bar_wait(empty(s), (round - 1) & 1);
                bar_expect_tx(full_k(s), T::TILE_BYTES);
                tma_load(sk + s * T::TILE_BYTES, &map_k, full_k(s), col_k + col, kt * BN, b);
                bar_expect_tx(full_v(s), T::TILE_BYTES);
                tma_load(sv + s * T::TILE_BYTES, &map_v, full_v(s), col_v + col, kt * BN, b);
            }
        }
        return;
    }

    // -------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int cw = wg - 1;
    if (q0 + 64 * cw >= N) return;                 // all its rows lie past N
    const int t = threadIdx.x - 128 * wg;
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, qd = lane & 3;

    // K-major q and k: rows of HD bf16, eight rows per swizzle atom; a k16
    // step moves 32 bytes along the row.  MN-major v: keys are rows, a k16
    // step is 16 keys, two atoms.
    const uint64_t dq = make_desc(sq + cw * T::HALF_Q_BYTES, 16, T::ATOM_BYTES, T::LAYOUT);
    const uint64_t dk = make_desc(sk, 16, T::ATOM_BYTES, T::LAYOUT);
    const uint64_t dv = make_desc(sv, T::TILE_BYTES, T::ATOM_BYTES, T::LAYOUT);
    constexpr uint64_t TILE_STEP = T::TILE_BYTES >> 4, V_STEP = (2 * T::ATOM_BYTES) >> 4;

    float o[HD / 2], sc[32];
    uint32_t pf[BN / 16][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

    bar_wait(bar_q, 0);
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES, phase = (kt / STAGES) & 1;
        bar_wait(full_k(s), phase);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < HD / 16; ++k)
            wgmma_ss_n64(sc, dq + 2 * k, dk + s * TILE_STEP + 2 * k, k);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // s[4j + e]: row g (e < 2) or g + 8, key kt*BN + 8j + 2qd + (e & 1)
        if (kt == n_tiles - 1 && n_real % BN) {
            const int lim = n_real - kt * BN;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (8 * j + 2 * qd + (e & 1) >= lim) sc[4 * j + e] = -INFINITY;
        }
        float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
            mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
            mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
            mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
        }
        const float a_lo = ex2((m_lo - mx_lo) * scale_log2);
        const float a_hi = ex2((m_hi - mx_hi) * scale_log2);
        m_lo = mx_lo;
        m_hi = mx_hi;
        const float mc_lo = mx_lo * scale_log2, mc_hi = mx_hi * scale_log2;
        float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -mc_lo));
            sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -mc_lo));
            sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -mc_hi));
            sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -mc_hi));
            s_lo += sc[4 * j] + sc[4 * j + 1];
            s_hi += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l_lo = l_lo * a_lo + s_lo;
        l_hi = l_hi * a_hi + s_hi;
        // the accumulator layout of 16 keys is the A fragment of one k16 step
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            pf[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
            pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
            pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
            pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            o[4 * j] *= a_lo;
            o[4 * j + 1] *= a_lo;
            o[4 * j + 2] *= a_hi;
            o[4 * j + 3] *= a_hi;
        }

        fence_regs(o);
        fence_regs(pf);
        bar_wait(full_v(s), phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
            wgmma_pv<HD>(o, pf[kk], dv + s * TILE_STEP + kk * V_STEP, 1);
        wgmma_commit();
        // waited for here, not across the loop's back edge: a product in
        // flight there makes ptxas serialize every wgmma (C7515)
        wgmma_wait<0>();
        fence_regs(pf);
        fence_regs(o);
        if (lane == 0) bar_arrive(empty(s));     // its k and v are read
    }

#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
    }
    const float r_lo = 1.f / l_lo, r_hi = 1.f / l_hi;
    const int row_lo = q0 + 64 * cw + 16 * warp + g, row_hi = row_lo + 8;
    __nv_bfloat16* o_lo = out + (static_cast<size_t>(b) * N + row_lo) * C + h * HD + 2 * qd;
    __nv_bfloat16* o_hi = o_lo + static_cast<size_t>(8) * C;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
        if (row_lo < N)
            *reinterpret_cast<uint32_t*>(o_lo + 8 * j) =
                pack_bf16(o[4 * j] * r_lo, o[4 * j + 1] * r_lo);
        if (row_hi < N)
            *reinterpret_cast<uint32_t*>(o_hi + 8 * j) =
                pack_bf16(o[4 * j + 2] * r_hi, o[4 * j + 3] * r_hi);
    }
}

// ------------------------------------------------------------------ host

// Error codes of the C entries beside cudaError_t values
constexpr int ERR_NO_ENCODER = -1;     // libcuda has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = -2;         // libcuda refused a tensor map

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's encoder, reached through the runtime: the library does not
// link libcuda
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return e == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// a {width, N, B} bf16 tensor map with (HD, BN, 1) boxes; rows past N
// read as zero
template <int HD>
int encode(CUtensorMap* map, const void* base, int width, int N, int B) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return ERR_NO_ENCODER;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[2] = {2ull * width, 2ull * width * N};     // bytes
    const cuuint32_t box[3] = {HD, BN, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          HD == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// once per device: the dynamic shared-memory limit, and a check that the
// kernel's register allocation covers what setmaxnreg hands out (a
// consumer asking for more than the block holds would wait forever)
template <int HD>
int prepare() {
    constexpr int MAX_DEVICES = 64;
    static int status[MAX_DEVICES];
    static bool done[MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    if (!done[dev]) {
        e = cudaFuncSetAttribute(attention_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<HD>::SMEM);
        cudaFuncAttributes attr;
        if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, attention_kernel<HD>);
        if (e == cudaSuccess
            && attr.numRegs * THREADS < 128 * PRODUCER_REGS + 256 * CONSUMER_REGS)
            e = cudaErrorInvalidConfiguration;
        status[dev] = static_cast<int>(e);
        done[dev] = true;
    }
    return status[dev];
}

template <int HD>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           int col_q, int col_k, int col_v, void* out, int B, int N, int H,
           int n_real, float scale, void* stream) {
    const int err = prepare<HD>();
    if (err) return err;
    const dim3 grid((N + BM - 1) / BM, H, B);
    attention_kernel<HD><<<grid, THREADS, Tiles<HD>::SMEM, static_cast<cudaStream_t>(stream)>>>(
        mq, mk, mv, col_q, col_k, col_v, static_cast<__nv_bfloat16*>(out), N, H * HD,
        n_real, scale * 1.4426950408889634f);
    return static_cast<int>(cudaGetLastError());
}

// scale > 0: the running max is taken on unscaled logits
bool bad_args(int B, int N, int H, int n_real, float scale) {
    return B < 0 || N < 0 || H < 1 || B > 65535 || H > 65535 || n_real < 1 || n_real > N
           || !(scale > 0.f);
}

}  // namespace

// qkv (B, N, 3*H*64) bf16 contiguous, 16-byte aligned -> out (B, N, H*64)
// bf16 contiguous, on `stream`; keys at index >= n_real are masked and
// scale > 0.  Returns 0, a cudaError_t, or a negative code: -1 libcuda
// has no tensor-map encoder, -2 it refused the map.
extern "C" int attention_qkv_launch(const void* qkv, void* out, int B, int N,
                                    int H, int n_real, float scale,
                                    void* stream) {
    if (B == 0 || N == 0) return 0;
    if (bad_args(B, N, H, n_real, scale)) return static_cast<int>(cudaErrorInvalidValue);
    const int C = H * 64;
    CUtensorMap map;
    const int err = encode<64>(&map, qkv, 3 * C, N, B);
    if (err) return err;
    return launch<64>(map, map, map, 0, C, 2 * C, out, B, N, H, n_real, scale, stream);
}

// q, k, v (B, N, H, hd) bf16 contiguous, 16-byte aligned -> out
// (B, N, H, hd) bf16 contiguous, hd 32 or 64, on `stream`.  Returns as
// attention_qkv_launch.
extern "C" int attention_launch(const void* q, const void* k, const void* v,
                                void* out, int B, int N, int H, int hd,
                                int n_real, float scale, void* stream) {
    if (B == 0 || N == 0) return 0;
    if (bad_args(B, N, H, n_real, scale) || (hd != 32 && hd != 64))
        return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap mq, mk, mv;
    int err = 0;
    if (hd == 64) {
        if ((err = encode<64>(&mq, q, H * hd, N, B)) || (err = encode<64>(&mk, k, H * hd, N, B))
            || (err = encode<64>(&mv, v, H * hd, N, B)))
            return err;
        return launch<64>(mq, mk, mv, 0, 0, 0, out, B, N, H, n_real, scale, stream);
    }
    if ((err = encode<32>(&mq, q, H * hd, N, B)) || (err = encode<32>(&mk, k, H * hd, N, B))
        || (err = encode<32>(&mv, v, H * hd, N, B)))
        return err;
    return launch<32>(mq, mk, mv, 0, 0, 0, out, B, N, H, n_real, scale, stream);
}
