// Row LayerNorm, and residual add + LayerNorm, on bf16 rows with f32
// statistics.
//
// Replaces the TPU kernels equss_tpu/ops/layernorm.py::fused_layernorm
// (kernel body _ln_kernel) and ::fused_add_layernorm (_add_ln_kernel).
// Same arithmetic, row by row over C channels:
//   [add only] s = bf16(x + y), stored; the statistics read the ROUNDED s
//   mean = sum(x) / C in f32
//   var  = sum((x - mean)^2) / C in f32 (two passes over the centred row,
//          the biased estimator; not E[x^2] - mean^2)
//   y    = ((x - mean) * rsqrt(var + eps)) * scale + bias in f32, stored bf16
// No fused multiply-add joins the affine steps, so each rounds as the
// plain version's separate tensor ops round.
//
// Design: one warp per row, 4 rows per 128-thread block.  A lane holds
// its share of the row in registers as 4-element (8-byte) chunks, chunk
// lane + 32 i for i < NCH, so neighbouring lanes read neighbouring
// addresses; the row is read once and written once.  Sums go through warp
// shuffles.  NCH = ceil(C / 128) is a template argument (C <= 1024).
//
// Bound on an H100 SXM (3.35 TB/s): LayerNorm moves 4 bytes per element
// (bf16 in, bf16 out), add + LayerNorm 8 (two in, two out); the f32 work
// per element is a few operations, far below the compute roof.  At the
// pqgo train shape (32 * 785 rows, C = 384) that is 0.012 ms and 0.024 ms.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS_PER_BLOCK = 4;
constexpr int THREADS = 32 * ROWS_PER_BLOCK;
constexpr int MAX_NCH = 8;

__device__ __forceinline__ void unpack4(uint2 raw, float (&f)[4]) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    f[0] = __low2float(a);
    f[1] = __high2float(a);
    f[2] = __low2float(b);
    f[3] = __high2float(b);
}

__device__ __forceinline__ uint2 pack4(const float (&f)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&a);
    raw.y = *reinterpret_cast<const uint32_t*>(&b);
    return raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <int NCH, bool ADD>
__global__ void __launch_bounds__(THREADS)
layernorm_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ y,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ sum_out,
                 __nv_bfloat16* __restrict__ out,
                 int rows, int C, float eps) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= rows) return;
    const int n_chunks = C >> 2;
    const size_t base = static_cast<size_t>(row) * C;

    float v[NCH][4];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
        const int ch = lane + 32 * i;
        if (ch < n_chunks) {
            unpack4(*reinterpret_cast<const uint2*>(x + base + 4 * ch), v[i]);
            if (ADD) {
                float w[4];
                unpack4(*reinterpret_cast<const uint2*>(y + base + 4 * ch), w);
#pragma unroll
                for (int e = 0; e < 4; ++e) v[i][e] = __fadd_rn(v[i][e], w[e]);
                const uint2 rounded = pack4(v[i]);
                *reinterpret_cast<uint2*>(sum_out + base + 4 * ch) = rounded;
                unpack4(rounded, v[i]);     // statistics of the bf16 sum
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) s += v[i][e];
        }
    }
    const float mean = __fdiv_rn(warp_sum(s), static_cast<float>(C));

    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
        if (lane + 32 * i < n_chunks) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                v[i][e] = __fsub_rn(v[i][e], mean);
                ss = __fadd_rn(ss, __fmul_rn(v[i][e], v[i][e]));
            }
        }
    }
    const float var = __fdiv_rn(warp_sum(ss), static_cast<float>(C));
    const float r = rsqrtf(__fadd_rn(var, eps));

#pragma unroll
    for (int i = 0; i < NCH; ++i) {
        const int ch = lane + 32 * i;
        if (ch < n_chunks) {
            const float4 sc = *reinterpret_cast<const float4*>(scale + 4 * ch);
            const float4 bi = *reinterpret_cast<const float4*>(bias + 4 * ch);
            const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
            const float biv[4] = {bi.x, bi.y, bi.z, bi.w};
            float o[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                o[e] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][e], r), scv[e]), biv[e]);
            *reinterpret_cast<uint2*>(out + base + 4 * ch) = pack4(o);
        }
    }
}

template <bool ADD>
int launch(const void* x, const void* y, const void* scale, const void* bias,
           void* sum_out, void* out, int rows, int C, float eps, void* stream) {
    if (rows == 0) return 0;
    if (C <= 0 || C % 8 != 0 || C > 128 * MAX_NCH)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* yb = static_cast<const __nv_bfloat16*>(y);
    const auto* sc = static_cast<const float*>(scale);
    const auto* bi = static_cast<const float*>(bias);
    auto* sb = static_cast<__nv_bfloat16*>(sum_out);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    switch ((C + 127) / 128) {
#define LN_CASE(n)                                                            \
    case n:                                                                   \
        layernorm_kernel<n, ADD><<<grid, THREADS, 0, st>>>(                   \
            xb, yb, sc, bi, sb, ob, rows, C, eps);                            \
        break;
        LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4)
        LN_CASE(5) LN_CASE(6) LN_CASE(7) LN_CASE(8)
#undef LN_CASE
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (rows, C) bf16 contiguous, scale/bias (C,) f32 -> out (rows, C) bf16,
// on `stream`.  C a multiple of 8, at most 1024.  Returns the cudaError_t
// of the launch (0 = success).
extern "C" int layernorm_launch(const void* x, const void* scale,
                                const void* bias, void* out, int rows,
                                int C, float eps, void* stream) {
    return launch<false>(x, nullptr, scale, bias, nullptr, out, rows, C, eps,
                         stream);
}

// (x, y) (rows, C) bf16 -> sum_out = bf16(x + y) and out = LN(sum_out).
extern "C" int add_layernorm_launch(const void* x, const void* y,
                                    const void* scale, const void* bias,
                                    void* sum_out, void* out, int rows,
                                    int C, float eps, void* stream) {
    return launch<true>(x, y, scale, bias, sum_out, out, rows, C, eps, stream);
}
