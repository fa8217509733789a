// Multi-head softmax attention read straight off the packed qkv projection.
//
// Replaces the TPU kernel equss_tpu/ops/attention.py::fused_attention_qkv
// (kernel body _attn_qkv_kernel).  Same arithmetic, row by row:
//   logits = (q . k) accumulated in f32, times scale
//   keys at index >= n_real are masked to -1e30
//   m = row max;  p = exp(logit - m) in f32;  r = 1 / sum(p) in f32
//   out = (bf16(p) . v) accumulated in f32, times r, stored as bf16
// q, k and v of head h are read in place from the (B, N, 3C) bf16 tensor at
// columns h*hd, C + h*hd and 2C + h*hd; the output is (B, N, C) bf16 with
// head h at columns h*hd.  No transpose and no padded copy exist.
//
// Design: one block of 4 warps per (q tile of 64 rows, head, batch item);
// each warp owns 16 q rows.  The q tile, one 64-key k tile and one v tile
// sit in shared memory (8 KB each at hd = 64, rows padded to 144 bytes so
// the ldmatrix reads are free of bank conflicts).  Products run on the
// tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate).
// Two passes over the key tiles: the first finds the row max, the second
// forms p against that final max, sums it and accumulates p.v.  Taking p
// against the final max before its bf16 cast keeps the TPU kernel's
// rounding points, so no online-softmax rescaling enters the result.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at B = 128,
// N = 785, H = 6, hd = 64 one layer does 4*B*H*N^2*hd = 121 GFLOP
// (0.12 ms) and moves 0.31 GB (0.09 ms), so it is bound by operations.
// This first version loads tiles synchronously and re-reads k in the
// second pass; TMA, wgmma and a pipelined ring are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // head dim the kernel takes
constexpr int BQ = 64;          // q rows per block, 16 per warp
constexpr int BK = 64;          // keys per tile
constexpr int LDS = HD + 8;     // shared row stride in bf16 elements (144 B)
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows x 64 bf16 from global rows [r0, r0 + 64) into shared memory;
// rows at or past N are zero
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g,
                                          int row_stride, int r0, int N) {
    for (int c = threadIdx.x; c < 64 * (HD / 8); c += THREADS) {
        const int r = c / (HD / 8), ch = c % (HD / 8);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < N)
            v = *reinterpret_cast<const uint4*>(
                g + static_cast<size_t>(r0 + r) * row_stride + ch * 8);
        *reinterpret_cast<uint4*>(s + r * LDS + ch * 8) = v;
    }
}

// s[j] = this warp's 16 q rows against keys [8j, 8j + 8) of the k tile
__device__ __forceinline__ void qk_tile(const uint32_t (&qf)[HD / 16][4],
                                        const __nv_bfloat16* sK, int lane,
                                        float (&s)[BK / 8][4]) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
        for (int jp = 0; jp < BK / 16; ++jp) {
            // matrices: (keys +0, hd +0), (keys +0, hd +8),
            //           (keys +8, hd +0), (keys +8, hd +8)
            const __nv_bfloat16* p =
                sK + (jp * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * LDS
                + ks * 16 + ((lane >> 3) & 1) * 8;
            uint32_t kb[4];
            ldsm_x4(kb, p);
            mma_bf16(s[2 * jp], qf[ks], kb[0], kb[1]);
            mma_bf16(s[2 * jp + 1], qf[ks], kb[2], kb[3]);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
attention_qkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out,
                     int N, int C, int n_real, float scale) {
    __shared__ __align__(16) __nv_bfloat16 sQ[BQ * LDS];
    __shared__ __align__(16) __nv_bfloat16 sK[BK * LDS];
    __shared__ __align__(16) __nv_bfloat16 sV[BK * LDS];

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int C3 = 3 * C;
    const __nv_bfloat16* base =
        qkv + static_cast<size_t>(blockIdx.z) * N * C3;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;

    load_tile(sQ, base + h * HD, C3, q0, N);
    __syncthreads();
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
        ldsm_x4(qf[ks], sQ + (warp * 16 + (lane & 15)) * LDS
                            + ks * 16 + (lane >> 4) * 8);

    // key tiles wholly at or past n_real hold only masked keys, whose
    // exp(-1e30 - m) is exactly 0: they are skipped
    const int n_tiles = (n_real + BK - 1) / BK;

    // pass 1: row max of the scaled, masked logits (rows g and g + 8)
    float m_lo = -INFINITY, m_hi = -INFINITY;
    for (int kt = 0; kt < n_tiles; ++kt) {
        __syncthreads();
        load_tile(sK, base + C + h * HD, C3, kt * BK, N);
        __syncthreads();
        float s[BK / 8][4];
        qk_tile(qf, sK, lane, s);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = kt * BK + j * 8 + 2 * t + (e & 1);
                const float v = key < n_real ? __fmul_rn(s[j][e], scale) : -1e30f;
                if (e < 2) m_lo = fmaxf(m_lo, v);
                else m_hi = fmaxf(m_hi, v);
            }
        }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
        m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
    }

    // pass 2: p against the final max, its f32 sum, and bf16(p) . v
    float l_lo = 0.f, l_hi = 0.f;
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
        __syncthreads();
        load_tile(sK, base + C + h * HD, C3, kt * BK, N);
        load_tile(sV, base + 2 * C + h * HD, C3, kt * BK, N);
        __syncthreads();
        float s[BK / 8][4];
        qk_tile(qf, sK, lane, s);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = kt * BK + j * 8 + 2 * t + (e & 1);
                const float m = e < 2 ? m_lo : m_hi;
                // __fmul_rn keeps the scaled logit rounded before the
                // subtraction, as the TPU kernel rounds it
                const float p = key < n_real ? expf(__fmul_rn(s[j][e], scale) - m) : 0.f;
                s[j][e] = p;
                if (e < 2) l_lo += p;
                else l_hi += p;
            }
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            // the accumulator layout of two n8 tiles is the A layout of
            // one 16-key k step
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int dp = 0; dp < HD / 16; ++dp) {
                // matrices: (keys +0, hd +0), (keys +8, hd +0),
                //           (keys +0, hd +8), (keys +8, hd +8)
                const __nv_bfloat16* p =
                    sV + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS
                    + dp * 16 + ((lane >> 4) & 1) * 8;
                uint32_t vb[4];
                ldsm_x4_trans(vb, p);
                mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
                mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
            }
        }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
    }
    const float r_lo = 1.f / l_lo, r_hi = 1.f / l_hi;

    const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
    __nv_bfloat16* o_lo = out + (static_cast<size_t>(blockIdx.z) * N + row_lo) * C + h * HD;
    __nv_bfloat16* o_hi = out + (static_cast<size_t>(blockIdx.z) * N + row_hi) * C + h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (row_lo < N)
            *reinterpret_cast<uint32_t*>(o_lo + col) =
                pack_bf16(acc[j][0] * r_lo, acc[j][1] * r_lo);
        if (row_hi < N)
            *reinterpret_cast<uint32_t*>(o_hi + col) =
                pack_bf16(acc[j][2] * r_hi, acc[j][3] * r_hi);
    }
}

}  // namespace

// qkv (B, N, 3*H*64) bf16 contiguous -> out (B, N, H*64) bf16 contiguous,
// on `stream`.  Returns the cudaError_t of the launch (0 = success).
extern "C" int attention_qkv_launch(const void* qkv, void* out, int B, int N,
                                    int H, int n_real, float scale,
                                    void* stream) {
    if (B == 0 || N == 0) return 0;
    const dim3 grid((N + BQ - 1) / BQ, H, B);
    attention_qkv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(qkv),
        static_cast<__nv_bfloat16*>(out), N, H * HD, n_real, scale);
    return static_cast<int>(cudaGetLastError());
}
