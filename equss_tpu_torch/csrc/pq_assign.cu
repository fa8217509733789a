// Fused product-quantization assignment: per-subspace normalisation ->
// distances to every codeword -> first-minimum argmin -> codeword gather.
//
// Replaces the TPU kernel equss_tpu/ops/pq_pallas.py::pq_assign_pallas
// (kernel body _pq_kernel).  The (n, M, K) distance tensor is never
// written: each row keeps a running minimum in registers.
//
// Arithmetic kept from the TPU kernel:
//   normalisation   none | l2: z / max(sqrt(sum z^2), 1e-12)
//                   | z_norm: (z - mean) / (sqrt(unbiased var) + 1e-5)
//                   | z_trainable: (z - z_mean) / (z_std + 1e-5)
//   exact mode      dist = (z_sq + c_sq[k]) - 2 * cross in f32, in that
//                   association (keeping z_sq decides which near-equal
//                   distances round to ties); strict-< scan = first minimum;
//                   z_q is the raw f32 codeword, bit for bit
//   fast mode       zn and c_norm rounded to bf16, products summed in f32;
//                   l2 with K <= 256: dist = 1 - cross, else the full form;
//                   K <= 256: argmin over (bits(dist) & ~0xFF) | k as int32,
//                   sub-ulp negatives included; z_q is the bf16-rounded
//                   codeword
// The TPU's block-diagonal group dots, 0/1 segment matrices and 3-way bf16
// codebook split existed to feed its matrix unit; a direct f32 load from
// shared memory is exact, so none of them is carried over.
//
// Design: one block per (tile of ROWS_PER_BLOCK rows, subspace m).  The
// subspace's distance codebook (K x d f32), its squared norms and the raw
// codebook it gathers from sit in shared memory (33 KB at K = 256,
// d = 16).  One thread per row: it loads its d floats, normalises them,
// walks the K codewords (broadcast reads from shared memory) and writes
// idx, z_norm and z_q.
//
// Bound on an H100 SXM at n = 100 352, M = 64, K = 256, d = 16: 0.41 GB of
// z read and 0.82 GB of z_norm and z_q written plus 26 MB of idx, 0.37 ms
// at 3.35 TB/s; the distances are 2*n*M*K*d = 53 GFLOP, 0.79 ms on the
// 67 TFLOP/s f32 CUDA cores in exact mode (bf16 inputs in fast mode could
// use the tensor cores, which this version does not).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 1024;

enum Mode { NONE = 0, L2 = 1, Z_NORM = 2, Z_TRAINABLE = 3 };

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <int D>
__device__ __forceinline__ float dot(const float (&v)[D], const float* c) {
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
        const float4 cq = reinterpret_cast<const float4*>(c)[q];
        acc = fmaf(v[4 * q + 0], cq.x, acc);
        acc = fmaf(v[4 * q + 1], cq.y, acc);
        acc = fmaf(v[4 * q + 2], cq.z, acc);
        acc = fmaf(v[4 * q + 3], cq.w, acc);
    }
    return acc;
}

template <int D, int MODE, bool EXACT>
__global__ void __launch_bounds__(THREADS)
pq_assign_kernel(const float* __restrict__ z, const float* __restrict__ c_norm,
                 const float* __restrict__ c_raw,
                 const float* __restrict__ z_mean,
                 const float* __restrict__ z_std, int n, int M, int K,
                 int* __restrict__ idx, float* __restrict__ zn_out,
                 float* __restrict__ zq_out) {
    extern __shared__ __align__(16) float smem[];
    float* s_c = smem;                  // K x D distance codebook
    float* s_raw = smem + K * D;        // K x D gather source
    float* s_csq = smem + 2 * K * D;    // K squared norms of c_norm
    const int m = blockIdx.y;
    const float* cn = c_norm + static_cast<size_t>(m) * K * D;
    const float* cr = c_raw + static_cast<size_t>(m) * K * D;
    for (int i = threadIdx.x; i < K * D; i += THREADS) {
        s_c[i] = EXACT ? cn[i] : bf16_round(cn[i]);
        s_raw[i] = EXACT ? cr[i] : bf16_round(cr[i]);
    }
    for (int k = threadIdx.x; k < K; k += THREADS) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) acc += cn[k * D + j] * cn[k * D + j];
        s_csq[k] = acc;
    }
    float zm[D], zs[D];
    if (MODE == Z_TRAINABLE) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
            zm[j] = z_mean[m * D + j];
            zs[j] = z_std[m * D + j] + 1e-5f;
        }
    }
    __syncthreads();

    const int row_end = min(n, (blockIdx.x + 1) * ROWS_PER_BLOCK);
    for (int r = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x; r < row_end;
         r += THREADS) {
        const size_t off = (static_cast<size_t>(r) * M + m) * D;
        float v[D];
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
            const float4 f = reinterpret_cast<const float4*>(z + off)[q];
            v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
        }
        if (MODE == L2) {
            float ss = 0.f;
#pragma unroll
            for (int j = 0; j < D; ++j) ss += v[j] * v[j];
            const float denom = fmaxf(sqrtf(ss), 1e-12f);
#pragma unroll
            for (int j = 0; j < D; ++j) v[j] = v[j] / denom;
        } else if (MODE == Z_NORM) {
            float mu = 0.f;
#pragma unroll
            for (int j = 0; j < D; ++j) mu += v[j];
            mu = mu / D;
            float var = 0.f;
#pragma unroll
            for (int j = 0; j < D; ++j) {
                v[j] = v[j] - mu;
                var += v[j] * v[j];
            }
            var = var / (D > 1 ? D - 1 : 1);
            const float denom = sqrtf(var) + 1e-5f;
#pragma unroll
            for (int j = 0; j < D; ++j) v[j] = v[j] / denom;
        } else if (MODE == Z_TRAINABLE) {
#pragma unroll
            for (int j = 0; j < D; ++j) v[j] = (v[j] - zm[j]) / zs[j];
        }
#pragma unroll
        for (int q = 0; q < D / 4; ++q)
            reinterpret_cast<float4*>(zn_out + off)[q] =
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);

        float z_sq = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) z_sq += v[j] * v[j];

        int best = 0;
        if (EXACT) {
            float best_d = INFINITY;
            for (int k = 0; k < K; ++k) {
                const float dist = (z_sq + s_csq[k]) - 2.f * dot<D>(v, s_c + k * D);
                if (dist < best_d) { best_d = dist; best = k; }
            }
        } else {
            float vb[D];
#pragma unroll
            for (int j = 0; j < D; ++j) vb[j] = bf16_round(v[j]);
            const bool l2_short = MODE == L2 && K <= 256;
            if (K <= 256) {
                // low 8 mantissa bits carry the index: one int min gives
                // the minimum with first-index tie-break
                int best_p = INT_MAX;
                for (int k = 0; k < K; ++k) {
                    const float cross = dot<D>(vb, s_c + k * D);
                    const float dist = l2_short ? 1.f - cross
                                                : (z_sq + s_csq[k]) - 2.f * cross;
                    best_p = min(best_p, (__float_as_int(dist) & ~0xFF) | k);
                }
                best = best_p & 0xFF;
            } else {
                float best_d = INFINITY;
                for (int k = 0; k < K; ++k) {
                    const float dist =
                        (z_sq + s_csq[k]) - 2.f * dot<D>(vb, s_c + k * D);
                    if (dist < best_d) { best_d = dist; best = k; }
                }
            }
        }
        idx[static_cast<size_t>(r) * M + m] = best;
#pragma unroll
        for (int q = 0; q < D / 4; ++q)
            reinterpret_cast<float4*>(zq_out + off)[q] =
                reinterpret_cast<const float4*>(s_raw + best * D)[q];
    }
}

template <int D, int MODE, bool EXACT>
int launch(const float* z, const float* c_norm, const float* c_raw,
           const float* z_mean, const float* z_std, int* idx, float* zn,
           float* zq, int n, int M, int K, cudaStream_t stream) {
    auto kernel = pq_assign_kernel<D, MODE, EXACT>;
    const size_t smem = (2 * static_cast<size_t>(K) * D + K) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, M);
    kernel<<<grid, THREADS, smem, stream>>>(z, c_norm, c_raw, z_mean, z_std,
                                            n, M, K, idx, zn, zq);
    return static_cast<int>(cudaGetLastError());
}

template <int D, int MODE>
int launch_exact(bool exact, const float* z, const float* c_norm,
                 const float* c_raw, const float* z_mean, const float* z_std,
                 int* idx, float* zn, float* zq, int n, int M, int K,
                 cudaStream_t s) {
    return exact ? launch<D, MODE, true>(z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s)
                 : launch<D, MODE, false>(z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
}

template <int D>
int launch_mode(int mode, bool exact, const float* z, const float* c_norm,
                const float* c_raw, const float* z_mean, const float* z_std,
                int* idx, float* zn, float* zq, int n, int M, int K,
                cudaStream_t s) {
    switch (mode) {
        case NONE: return launch_exact<D, NONE>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
        case L2: return launch_exact<D, L2>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
        case Z_NORM: return launch_exact<D, Z_NORM>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
        case Z_TRAINABLE: return launch_exact<D, Z_TRAINABLE>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// z (n, M, d), c_norm and c_raw (M, K, d), z_mean and z_std (M, d) or null,
// all f32 contiguous -> idx (n, M) int32, z_norm and z_q (n, M, d) f32, on
// `stream`.  mode: 0 none, 1 l2, 2 z_norm, 3 z_trainable; d in {8, 16, 32}.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int pq_assign_launch(const void* z, const void* c_norm,
                                const void* c_raw, const void* z_mean,
                                const void* z_std, void* idx, void* zn,
                                void* zq, int n, int M, int K, int d, int mode,
                                int exact, void* stream) {
    if (n == 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* zf = static_cast<const float*>(z);
    const auto* cn = static_cast<const float*>(c_norm);
    const auto* cr = static_cast<const float*>(c_raw);
    const auto* zm = static_cast<const float*>(z_mean);
    const auto* zs = static_cast<const float*>(z_std);
    auto* ip = static_cast<int*>(idx);
    auto* znp = static_cast<float*>(zn);
    auto* zqp = static_cast<float*>(zq);
    switch (d) {
        case 8: return launch_mode<8>(mode, exact != 0, zf, cn, cr, zm, zs, ip, znp, zqp, n, M, K, s);
        case 16: return launch_mode<16>(mode, exact != 0, zf, cn, cr, zm, zs, ip, znp, zqp, n, M, K, s);
        case 32: return launch_mode<32>(mode, exact != 0, zf, cn, cr, zm, zs, ip, znp, zqp, n, M, K, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
