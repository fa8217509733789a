// Fused product-quantization assignment: per-subspace normalisation ->
// distances to every codeword -> first-minimum argmin -> codeword gather.
//
// Replaces the TPU kernel equss_tpu/ops/pq_pallas.py::pq_assign_pallas
// (kernel body _pq_kernel).  The (n, M, K) distance tensor is never
// written: each row keeps a running minimum in registers (the exact wide
// body: in shared memory, then a 64-bit key per row).
//
// Domain: every d with d % 8 == 0 and every K >= 1, in both modes; this
// holds every shape the JAX package sends to its kernel (d % 8 == 0 and
// K % 128 == 0).  Four bodies share it:
//   narrow (pq_exact_kernel, pq_fast_kernel): d in {8, 16, 32} where one
//     subspace's codebooks fit a block's 227 KB of shared memory:
//     (8d + 4) * K bytes in exact mode (K <= 1760 at d = 16; the
//     routing rule, unchanged since the exact body staged c_raw too: it
//     now stages (4d + 4) * K);
//     (4d + 4) * roundup(K, 256 / d) bytes beside the 43 008 bytes of
//     staging tiles in fast mode (K <= 2784 at d = 16);
//   wide (pq_wide_exact_kernel exact, pq_wide_fast_kernel fast, each
//     with its passes): every other shape of the domain, among them the
//     VQ baseline's d = 1024, K = 256 and the variants' d = 64 .. 384.
// ops/pq_assign.py::kernel_domain_error and kernel_body state the same
// domain and the same choice of body for the wrapper and the eligibility
// predicate.
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
//                   sub-ulp negatives included; K > 256: strict-< first
//                   minimum; z_q is the bf16-rounded codeword
// The TPU's block-diagonal group dots, 0/1 segment matrices and 3-way bf16
// codebook split existed to feed its matrix unit; none is carried over.
//
// Bound on an H100 SXM at n = 100 352, M = 64, K = 256, d = 16: 0.41 GB of
// z read and 0.82 GB of z_norm and z_q written plus 26 MB of idx, 0.376 ms
// at 3.35 TB/s.  The distances are 2*n*M*K*d = 53 GFLOP: 0.79 ms on the
// 67 TFLOP/s f32 CUDA cores (exact mode, operations-bound), 0.05 ms on the
// bf16 tensor cores (fast mode, bytes-bound).  In fast mode the argmin
// epilogue, 1.64 G (row, codeword) elements of three float and integer
// operations each, is the work that has to hide under the bytes.
//
// Fast mode (pq_fast_kernel).  A block owns a group of G = 32 / d
// neighbouring subspaces (128 bytes of each row: one cache line) and a run
// of at least MIN_ROWS rows; WAVES blocks per resident slot balance the
// SMs.  It loads the group's codebooks into shared memory once: c_norm as
// bf16 in mma fragment order (one 16-byte load per lane per chunk of
// codewords), the raw codeword as bf16 for the gather, and the f32 squared
// norms where the distance needs them.  A warp takes 16-row tiles in turn:
// it reads the tile's lines into its staging tile with 16-byte loads
// (the next tile's loads are issued before the current one is worked on)
// and works through the group's subspaces one after the other.  Each lane
// of a quad holds d/4 of a row's values in the mma A layout: the
// normalisation is f32 work on those with two quad shuffles per sum, and
// z_norm goes back into the staging tile; the rounded values are the A
// fragment, kept in registers.  The distances are mma.sync m16n8k16
// (m16n8k8 at d = 8) with f32 accumulators, and the epilogue reduces each
// 16 x 8 tile straight into the running minimum: the packed integer
// minimum where it applies (one mask-or and one integer min per element),
// else (value, index) with strict <.  The quad then agrees on the row's
// minimum by shuffles; the gather writes z_q into a second staging tile.
// z_norm and z_q leave as whole lines, idx as one vector per row.
//
// Exact mode (pq_exact_kernel).  The distances are f32 FMAs on the CUDA
// cores: the body is bound by its operations (0.79 ms above, against
// 0.376 ms of bytes).  A block owns one subspace and 256 R rows (128 R
// at d = 8 and 32); it stages the subspace's c_norm and c_sq (a thread
// per codeword, K (4d + 4) bytes) in shared memory.  Each thread holds R
// normalised rows in registers (R = 4 at d = 16: 64 floats; 8 at d = 8,
// 3 at d = 32) and scans the K codewords in order: one broadcast read of
// a codeword (d / 4 float4s and its c_sq) serves the R rows, so at
// d = 16 a codeword costs 5 shared loads for 64 FMAs and 24 epilogue
// operations, where one row per thread spent 5 loads on 16 FMAs.  z_q
// is gathered from c_raw in device memory (L2: 1 MB at 64 x 256 x 16),
// which halves the shared memory of the body it replaced (one thread per
// row, c_norm, c_raw and c_sq staged by every 1024-row block).  Block b
// takes subspace b % M of row range b / M, so the M blocks of a row
// range start together and the range's lines are read and written whole.
// What limits the loop is the shared-memory reads and the epilogue's
// compare and selects around the FMAs, not their count: more rows per
// thread (fewer warps), a prefetched next codeword and a chunked minimum
// with a recompute were all slower on an H100 (PERF.md, Findings).
//   Same bits as that body on every input: each row's normalisation
// and |z_norm|^2, and each codeword's c_sq, are one thread's sequential
// sums in j order; each (row, codeword) cross product is one fmaf chain
// from 0 over j; dist = (z_sq + c_sq) - 2 * cross; each row's strict-<
// scan runs in codeword order in one thread (first minimum, NaN never
// taken, -0 equal to +0, index 0 when nothing is below +inf); z_q is the
// raw f32 codeword.
//
// Wide bodies: every other shape of the domain.  A subspace's codebook
// need not fit shared memory: it is streamed through it in tiles.
//
// Exact mode (pq_wide_exact_kernel after a pre-pass, and where it runs
// split, before a gather pass: two or three kernels of one launch).  The
// distances are f32 FMAs on the CUDA cores, so the body is bound by its
// operations: 2 n M K d, at unseg's n = 12 800, 1 x 2048 x 384
// 20.1 GFLOP, 0.30 ms at 67 TFLOP/s; at the VQ baseline's predictor call
// (n = 100 352, 1 x 256 x 1024) 52.6 GFLOP, 0.79 ms.
//   Pre-pass (pq_wide_exact_prep_kernel): a warp per codeword writes c_sq
//   into the caller's workspace (pq_assign_workspace_bytes: M x K f32),
//   once per launch; split launches also give it a warp per (row,
//   subspace), which normalises the row, writes z_norm and puts
//   |z_norm|^2 and the row's key (all ones) into its z_q slot.
//   Body: a block owns 128 rows of one subspace and a range of 128-codeword
//   tiles; its 256 threads each hold 4 rows x 16 codewords of f32
//   accumulators.  z_norm (read back from device memory, mostly from L2)
//   and c_norm stream through a 2-stage cp.async ring, 32 dimensions deep,
//   row-major with rows padded to 36 floats: a thread reads 4 depths of
//   each of its rows and codewords as float4s free of bank conflicts,
//   20 loads of 16 bytes for 256 FMAs, one barrier per stage.  Pieces past
//   d are zeros (d % 32 != 0 adds exact zeros); rows past n and codewords
//   past K repeat the last one and are never read back.  After a tile's
//   last stage each thread folds its 64 distances into its running
//   minima in shared memory; at the end a thread per row combines the
//   row's 8 threads.
//   The grid: where the (n / 128) x M row tiles fill the resident slots
//   (2 per SM) in whole waves to 90% (the predictor call: 784 blocks on
//   264 slots), a block takes all of its row tile's codewords and runs
//   fused: its warps normalise the 128 rows first (z_norm to device
//   memory, |z_norm|^2 to shared memory) and at the end write idx and
//   gather the raw f32 codewords into z_q.  Else (M = 1 at n = 12 800:
//   100 row tiles) each row tile's codeword tiles are split into ranges
//   over up to WX_WAVES blocks per slot (2 ranges at K = 256, 16 at
//   K = 2048), each block's minimum goes into the row's 64-bit key by
//   atomicMin, and a gather pass (pq_wide_exact_gather_kernel, a warp per
//   row) reads the key, writes idx and the codeword as 16-byte lines.
//   Same bits as the body it replaced (pq_wide_kernel: 64 x 64 x 8 tiles,
//   no split) on every input: the normalisation, |z_norm|^2 and c_sq are
//   the same warp sums (lane-strided partial sums, then the xor
//   butterfly); each (row, codeword)'s cross product is one fmaf chain
//   from 0 over the depth in order, never split across threads or blocks
//   (the build's flags, which decide how the sums contract into FMAs, are
//   unchanged); dist = (z_sq + c_sq) - 2 * cross; each
//   thread scans its codewords in increasing order with strict <, and the
//   combines take the lower index on equal distances.
//   The key is ordered(dist) << 32 | k, ordered() the unsigned order of
//   floats (sign bit set if positive, all bits flipped if negative), so
//   atomicMin keeps the least distance and on equal ones the lower index.
//   dist + 0.f first makes -0 equal to +0, as strict < has it; every NaN
//   maps above +inf, and a key at or above +inf's (no distance below +inf,
//   as the strict-< scan from +inf never takes one) gives index 0, as
//   before.  ops/pq_assign.py::key_argmin is its plain version.

// Fast mode (pq_wide_fast_kernel, after a pre-pass).  The distances are
// bf16 mma.sync products with f32 sums, so the body is bound by its bytes:
// at the VQ baseline's valid call (n = 12 800, M = 1, K = 256, d = 1024)
// 157 MB of z, z_norm and z_q, 0.047 ms at 3.35 TB/s, against 6.7 GFLOP,
// 0.007 ms on the bf16 tensor cores.
//   Pre-pass (pq_wide_prep_kernel, the same C entry, one launch before the
//   body): a warp per codeword writes c_norm rounded to bf16, padded with
//   zeros to k_pad = roundup(K, 128) codewords of d_pad = roundup(d, 64)
//   dimensions, and the f32 squared norm of the unrounded values, into the
//   caller's workspace (pq_assign_workspace_bytes); so no block rounds or
//   sums the codebook again.
//   Body: a block of 8 warps owns 32 rows of one subspace, so at M = 1 and
//   n = 12 800 400 blocks share out over the 132 SMs (2 resident per SM at
//   d = 1024).  It first issues the cp.async loads of the ring's first
//   codebook stages; then each warp normalises rows in f32 (float4 loads,
//   warp sums), writes z_norm to device memory in 16-byte stores, keeps
//   |z_norm|^2 in shared memory and the bf16 row, zero-padded to d_pad, in
//   a shared row tile (32 x d_pad x 2 bytes, 64 KB at d = 1024), whose
//   16-byte pieces are swizzled by row so that ldmatrix reads are free of
//   bank conflicts.  Past d = 2816 the tile does not fit beside the ring:
//   then each 64-deep chunk of it is read back from z_norm and rounded
//   before the chunk's products (the same arithmetic).  The codebook
//   streams through a 3-stage cp.async ring of 128 codewords x 64
//   dimensions; warp (slab, group) multiplies rows 16 slab.. by codewords
//   32 group.. of each tile with mma.sync m16n8k16 (A and B by ldmatrix,
//   four f32 accumulator fragments over the whole depth; zero padding adds
//   exact zeros, so d % 16 == 8 needs no other path).  After a tile's last
//   chunk the fragments fold into the running minima by the narrow
//   bodies' rules, codewords past K skipped; the quads, then the four
//   warp groups of a slab agree through shuffles and shared memory (equal
//   keys: the lower index), and the warps write idx and gather z_q (the
//   raw codeword rounded to bf16) as whole lines.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <climits>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int SMEM_MAX = 232448;    // bytes of shared memory a block can use

enum Mode { NONE = 0, L2 = 1, Z_NORM = 2, Z_TRAINABLE = 3 };

// ------------------------------------------------------------ exact mode

// rows a thread holds in registers, threads per block and the resident
// blocks per SM its registers must allow, per width (chosen by A/B on an
// H100: d = 8 and 32 gain from smaller blocks, whose registers leave
// room for more warps)
template <int D>
__host__ __device__ constexpr int exact_rows() { return D == 8 ? 8 : D == 16 ? 4 : 3; }
template <int D>
__host__ __device__ constexpr int exact_threads() { return D == 16 ? 256 : 128; }
template <int D>
__host__ __device__ constexpr int exact_min_blocks() { return D == 8 ? 4 : D == 16 ? 2 : 3; }

// The cross product of one (row, codeword): one fmaf chain from 0 over
// j in order.
template <int D>
__device__ __forceinline__ float dot(const float (&v)[D], const float (&c)[D]) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) acc = fmaf(v[j], c[j], acc);
    return acc;
}

// (z_sq + c_sq) - 2 cross as the body it replaced compiled it: three
// rounded adds (2 cross as cross + cross), never contracted into an FMA.
__device__ __forceinline__ float exact_dist(float z_sq, float c_sq, float cross) {
    return __fadd_rn(__fadd_rn(z_sq, c_sq), -__fadd_rn(cross, cross));
}

// One row of one subspace normalised in place by one thread, each sum
// sequential in j order.
template <int D, int MODE>
__device__ __forceinline__ void normalise(float (&v)[D], const float* __restrict__ z_mean,
                                          const float* __restrict__ z_std, int m) {
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
        var = var / (D - 1);
        const float denom = sqrtf(var) + 1e-5f;
#pragma unroll
        for (int j = 0; j < D; ++j) v[j] = v[j] / denom;
    } else if (MODE == Z_TRAINABLE) {
#pragma unroll
        for (int j = 0; j < D; ++j)
            v[j] = (v[j] - __ldg(z_mean + m * D + j)) / (__ldg(z_std + m * D + j) + 1e-5f);
    }
}

// A block owns one subspace and 256 R rows, thread t the R consecutive
// rows R t .. of them.  Blocks start in the order of their index, and
// the M blocks of a row range have neighbouring ones, so they run
// together and read and write its rows' lines whole.
template <int D, int MODE>
__global__ void __launch_bounds__(exact_threads<D>(), exact_min_blocks<D>())
pq_exact_kernel(const float* __restrict__ z, const float* __restrict__ c_norm,
                const float* __restrict__ c_raw,
                const float* __restrict__ z_mean,
                const float* __restrict__ z_std, int n, int M, int K,
                int* __restrict__ idx, float* __restrict__ zn_out,
                float* __restrict__ zq_out) {
    constexpr int R = exact_rows<D>();
    constexpr int THREADS = exact_threads<D>();
    extern __shared__ __align__(16) float smem[];
    float* s_c = smem;                  // K x D distance codebook
    float* s_csq = smem + K * D;        // K squared norms of c_norm
    const int m = blockIdx.x % M;
    const float* cn = c_norm + static_cast<size_t>(m) * K * D;
    // a thread per codeword: stage it and sum its squares
    for (int k = threadIdx.x; k < K; k += THREADS) {
        float c[D];
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(cn + k * D) + q);
            reinterpret_cast<float4*>(s_c + k * D)[q] = f;
            c[4 * q] = f.x; c[4 * q + 1] = f.y; c[4 * q + 2] = f.z; c[4 * q + 3] = f.w;
        }
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) acc += c[j] * c[j];
        s_csq[k] = acc;
    }

    const int r0 = (blockIdx.x / M * THREADS + threadIdx.x) * R;
    float v[R][D], z_sq[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        // rows past n repeat the last one and are never written
        const size_t off = (static_cast<size_t>(min(r0 + i, n - 1)) * M + m) * D;
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(z + off) + q);
            v[i][4 * q] = f.x; v[i][4 * q + 1] = f.y;
            v[i][4 * q + 2] = f.z; v[i][4 * q + 3] = f.w;
        }
        normalise<D, MODE>(v[i], z_mean, z_std, m);
        if (r0 + i < n) {
#pragma unroll
            for (int q = 0; q < D / 4; ++q)
                reinterpret_cast<float4*>(zn_out + off)[q] =
                    make_float4(v[i][4 * q], v[i][4 * q + 1], v[i][4 * q + 2], v[i][4 * q + 3]);
        }
        z_sq[i] = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) z_sq[i] += v[i][j] * v[i][j];
    }
    __syncthreads();
    if (r0 >= n) return;

    int best[R];
    float best_d[R];
#pragma unroll
    for (int i = 0; i < R; ++i) { best[i] = 0; best_d[i] = INFINITY; }
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
        // one broadcast read of the codeword serves the R rows
        float c[D];
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
            const float4 f = reinterpret_cast<const float4*>(s_c + k * D)[q];
            c[4 * q] = f.x; c[4 * q + 1] = f.y; c[4 * q + 2] = f.z; c[4 * q + 3] = f.w;
        }
        const float csq = s_csq[k];
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const float dist = exact_dist(z_sq[i], csq, dot<D>(v[i], c));
            if (dist < best_d[i]) { best_d[i] = dist; best[i] = k; }
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
        if (r0 + i >= n) break;
        const size_t row = static_cast<size_t>(r0 + i) * M + m;
        idx[row] = best[i];
        const float4* src = reinterpret_cast<const float4*>(
            c_raw + (static_cast<size_t>(m) * K + best[i]) * D);
#pragma unroll
        for (int q = 0; q < D / 4; ++q)
            reinterpret_cast<float4*>(zq_out + row * D)[q] = __ldg(src + q);
    }
}

template <int D, int MODE>
int launch_exact(const float* z, const float* c_norm, const float* c_raw,
                 const float* z_mean, const float* z_std, int* idx, float* zn,
                 float* zq, int n, int M, int K, cudaStream_t stream) {
    auto kernel = pq_exact_kernel<D, MODE>;
    const size_t smem = (static_cast<size_t>(K) * D + K) * sizeof(float);
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int threads = exact_threads<D>();
    constexpr int rows = threads * exact_rows<D>();
    const long long blocks = M * ((static_cast<long long>(n) + rows - 1) / rows);
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
        z, c_norm, c_raw, z_mean, z_std, n, M, K, idx, zn, zq);
    return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- fast mode

constexpr int FAST_WARPS = 8;
constexpr int FAST_THREADS = 32 * FAST_WARPS;
constexpr int FAST_MIN_BLOCKS = 3;  // resident blocks per SM the registers allow
constexpr int WAVES = 4;            // blocks per resident slot, for balance
constexpr int MIN_ROWS = 1024;      // rows that pay for a block's codebook load

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_k16(float (&c)[4], uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3, uint32_t b0,
                                        uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k8(float (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Lane (g = lane / 4, t = lane % 4) of a warp holds, of each of its two
// rows g and g + 8 of a 16-row tile, the P = D / 8 column pairs
// 8p + 2t, 8p + 2t + 1: the mma A layout.  B per 8-codeword n-tile is one
// register per pair (codeword 8j + g, the same columns); a lane's 16-byte
// chunk word w holds n-tile w / P, pair w % P, so a chunk covers
// CW = 256 / D codewords.
//
// z, z_norm and z_q move between device memory and a per-warp staging
// tile of 16 rows x STAGE_STRIDE floats, as whole 128-byte lines (a lane
// per 16 bytes, eight lanes per row); the stride of 40 floats keeps the
// fragment reads and writes free of bank conflicts.
constexpr int STAGE_STRIDE = 40;
constexpr int STAGE_BYTES = FAST_WARPS * (2 * 16 * STAGE_STRIDE * 4 + 16 * 4 * 4);

template <int D, int MODE, bool PACKED>
__global__ void __launch_bounds__(FAST_THREADS, D == 32 ? 2 : FAST_MIN_BLOCKS)
pq_fast_kernel(const float* __restrict__ z, const float* __restrict__ c_norm,
               const float* __restrict__ c_raw, const float* __restrict__ z_mean,
               const float* __restrict__ z_std, int n, int M, int K, int G,
               int rows_per_block, int* __restrict__ idx,
               float* __restrict__ zn_out, float* __restrict__ zq_out) {
    constexpr int P = D / 8;
    constexpr int TPC = 4 / P;          // n-tiles per chunk
    constexpr int CW = 8 * TPC;         // codewords per chunk
    constexpr bool L2_SHORT = MODE == L2 && PACKED;
    extern __shared__ __align__(16) unsigned char fast_smem[];
    const int m0 = blockIdx.x * G;
    const int gs = min(G, M - m0);
    const int chunks = (K + CW - 1) / CW;
    const int k_pad = chunks * CW;
    uint4* s_b = reinterpret_cast<uint4*>(fast_smem);                        // [gs][chunks][32]
    uint32_t* s_raw = reinterpret_cast<uint32_t*>(s_b + gs * chunks * 32);  // [gs][K][D / 2]
    float* s_csq = reinterpret_cast<float*>(s_raw + gs * K * (D / 2));      // [gs][k_pad]
    float* s_stage = s_csq + (L2_SHORT ? 0 : gs * k_pad);

    const int tid = threadIdx.x;
    for (int s = 0; s < gs; ++s) {
        const float* cn = c_norm + static_cast<size_t>(m0 + s) * K * D;
        const float* cr = c_raw + static_cast<size_t>(m0 + s) * K * D;
        uint32_t* sb = reinterpret_cast<uint32_t*>(s_b + s * chunks * 32);
        for (int i = tid; i < chunks * 128; i += FAST_THREADS) {
            const int lane = (i >> 2) & 31, w = i & 3;
            const int k = (i >> 7) * CW + 8 * (w / P) + (lane >> 2);
            const int col = 8 * (w % P) + 2 * (lane & 3);
            sb[i] = k < K ? pack_bf16(cn[k * D + col], cn[k * D + col + 1]) : 0u;
        }
        uint32_t* sr = s_raw + s * K * (D / 2);
        for (int i = tid; i < K * D / 2; i += FAST_THREADS)
            sr[i] = pack_bf16(cr[2 * i], cr[2 * i + 1]);
        if (!L2_SHORT) {
            for (int k = tid; k < k_pad; k += FAST_THREADS) {
                float acc = 0.f;
                if (k < K) {
#pragma unroll
                    for (int j = 0; j < D; ++j) acc += cn[k * D + j] * cn[k * D + j];
                }
                s_csq[s * k_pad + k] = acc;
            }
        }
    }
    __syncthreads();

    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    float* s_zn = s_stage + warp * 2 * 16 * STAGE_STRIDE;   // z, then z_norm
    float* s_zq = s_zn + 16 * STAGE_STRIDE;
    int* s_idx = reinterpret_cast<int*>(s_stage + FAST_WARPS * 2 * 16 * STAGE_STRIDE)
                 + warp * 16 * 4;                         // [16][gs]
    const int row_begin = blockIdx.y * rows_per_block;
    const int row_end = min(n, row_begin + rows_per_block);
    const int tiles = (row_end - row_begin + 15) / 16;
    const size_t row_stride = static_cast<size_t>(M) * D;
    const int width4 = gs * D / 4;      // 16-byte pieces of a row's group
    // this lane's four pieces of a tile: row q / 8 (+ 4 i), piece q % 8
    const int q_row = lane >> 3, q_col = lane & 7;

    auto load = [&](int tile, float4 (&buf)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = (row_begin + tile * 16) + q_row + 4 * i;
            buf[i] = tile < tiles && row < row_end && q_col < width4
                         ? __ldcs(reinterpret_cast<const float4*>(
                               z + static_cast<size_t>(row) * row_stride + m0 * D) + q_col)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    };

    float4 pre[4];
    load(warp, pre);
    for (int tile = warp; tile < tiles; tile += FAST_WARPS) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(s_zn + (q_row + 4 * i) * STAGE_STRIDE + 4 * q_col) = pre[i];
        __syncwarp();
        load(tile + FAST_WARPS, pre);

#pragma unroll 1
        for (int sub = 0; sub < gs; ++sub) {
            const int m = m0 + sub;
            float2 v[2][P];
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int p = 0; p < P; ++p)
                    v[r][p] = *reinterpret_cast<const float2*>(
                        s_zn + (g + 8 * r) * STAGE_STRIDE + sub * D + 8 * p + 2 * t);
            float2 mu[P], sd[P];
            if (MODE == Z_TRAINABLE) {
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    mu[p] = *reinterpret_cast<const float2*>(z_mean + m * D + 8 * p + 2 * t);
                    const float2 s2 = *reinterpret_cast<const float2*>(z_std + m * D + 8 * p + 2 * t);
                    sd[p] = make_float2(s2.x + 1e-5f, s2.y + 1e-5f);
                }
            }
            float z_sq[2];
            uint32_t a[2][P];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                if (MODE == L2) {
                    float ss = 0.f;
#pragma unroll
                    for (int p = 0; p < P; ++p) ss += v[r][p].x * v[r][p].x + v[r][p].y * v[r][p].y;
                    const float denom = fmaxf(sqrtf(quad_sum(ss)), 1e-12f);
#pragma unroll
                    for (int p = 0; p < P; ++p)
                        v[r][p] = make_float2(v[r][p].x / denom, v[r][p].y / denom);
                } else if (MODE == Z_NORM) {
                    float s1 = 0.f;
#pragma unroll
                    for (int p = 0; p < P; ++p) s1 += v[r][p].x + v[r][p].y;
                    const float mean = quad_sum(s1) / D;
                    float s2 = 0.f;
#pragma unroll
                    for (int p = 0; p < P; ++p) {
                        v[r][p] = make_float2(v[r][p].x - mean, v[r][p].y - mean);
                        s2 += v[r][p].x * v[r][p].x + v[r][p].y * v[r][p].y;
                    }
                    const float denom = sqrtf(quad_sum(s2) / (D - 1)) + 1e-5f;
#pragma unroll
                    for (int p = 0; p < P; ++p)
                        v[r][p] = make_float2(v[r][p].x / denom, v[r][p].y / denom);
                } else if (MODE == Z_TRAINABLE) {
#pragma unroll
                    for (int p = 0; p < P; ++p)
                        v[r][p] = make_float2((v[r][p].x - mu[p].x) / sd[p].x,
                                              (v[r][p].y - mu[p].y) / sd[p].y);
                }
#pragma unroll
                for (int p = 0; p < P; ++p)
                    *reinterpret_cast<float2*>(s_zn + (g + 8 * r) * STAGE_STRIDE + sub * D
                                               + 8 * p + 2 * t) = v[r][p];
                if (!L2_SHORT) {
                    float s2 = 0.f;
#pragma unroll
                    for (int p = 0; p < P; ++p) s2 += v[r][p].x * v[r][p].x + v[r][p].y * v[r][p].y;
                    z_sq[r] = quad_sum(s2);
                }
#pragma unroll
                for (int p = 0; p < P; ++p) a[r][p] = pack_bf16(v[r][p].x, v[r][p].y);
            }

            // running minima per (row r, column parity c): packed keys carry
            // the even column k0 of their tile; column 1's index is k0 + 1
            int best_p[2][2] = {{INT_MAX, INT_MAX}, {INT_MAX, INT_MAX}};
            float best_d[2] = {INFINITY, INFINITY};
            int best_k[2] = {0, 0};
            const uint4* sb = s_b + sub * chunks * 32 + lane;
            const float2* csq2 = reinterpret_cast<const float2*>(s_csq + sub * k_pad);
            auto chunk = [&](int c, auto masked) {
                const uint4 bw = sb[c * 32];
                const uint32_t w[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
                for (int jj = 0; jj < TPC; ++jj) {
                    float acc[4] = {0.f, 0.f, 0.f, 0.f};
                    if constexpr (D == 8) {
                        mma_k8(acc, a[0][0], a[1][0], w[jj]);
                    } else {
#pragma unroll
                        for (int s = 0; s < P / 2; ++s)
                            mma_k16(acc, a[0][2 * s], a[1][2 * s], a[0][2 * s + 1],
                                    a[1][2 * s + 1], w[jj * P + 2 * s], w[jj * P + 2 * s + 1]);
                    }
                    const int k0 = c * CW + 8 * jj + 2 * t;
                    float2 cs = make_float2(0.f, 0.f);
                    if (!L2_SHORT) cs = csq2[k0 / 2];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int r = e >> 1, par = e & 1;
                        if constexpr (decltype(masked)::value) {
                            if (k0 + par >= K) continue;
                        }
                        const float dist = L2_SHORT ? 1.f - acc[e]
                                                    : (z_sq[r] + (par ? cs.y : cs.x)) - 2.f * acc[e];
                        if (PACKED) {
                            best_p[r][par] = min(best_p[r][par], (__float_as_int(dist) & ~0xFF) | k0);
                        } else if (dist < best_d[r]) {
                            best_d[r] = dist;
                            best_k[r] = k0 + par;
                        }
                    }
                }
            };
            const int full = K / CW;
#pragma unroll 4
            for (int c = 0; c < full; ++c) chunk(c, std::false_type{});
            if (full < chunks) chunk(full, std::true_type{});

#pragma unroll
            for (int r = 0; r < 2; ++r) {
                int best;
                if (PACKED) {
                    // column 1's keys carry k0; k0 + 1 <= 255 keeps them in the byte
                    int key = min(best_p[r][0],
                                  best_p[r][1] == INT_MAX ? INT_MAX : best_p[r][1] + 1);
                    key = min(key, __shfl_xor_sync(0xffffffffu, key, 1));
                    key = min(key, __shfl_xor_sync(0xffffffffu, key, 2));
                    best = key & 0xFF;
                } else {
                    float bd = best_d[r];
                    best = best_k[r];
#pragma unroll
                    for (int off = 1; off <= 2; off <<= 1) {
                        const float od = __shfl_xor_sync(0xffffffffu, bd, off);
                        const int ok = __shfl_xor_sync(0xffffffffu, best, off);
                        if (od < bd || (od == bd && ok < best)) { bd = od; best = ok; }
                    }
                }
                if (t == 0) s_idx[(g + 8 * r) * gs + sub] = best;
                const uint32_t* cw = s_raw + (sub * K + best) * (D / 2) + t;
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    const uint32_t wv = cw[4 * p];
                    *reinterpret_cast<float2*>(s_zq + (g + 8 * r) * STAGE_STRIDE + sub * D
                                               + 8 * p + 2 * t) =
                        make_float2(__uint_as_float(wv << 16), __uint_as_float(wv & 0xFFFF0000u));
                }
            }
        }
        __syncwarp();

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = (row_begin + tile * 16) + q_row + 4 * i;
            if (row < row_end && q_col < width4) {
                const size_t off = static_cast<size_t>(row) * row_stride + m0 * D + 4 * q_col;
                const int so = (q_row + 4 * i) * STAGE_STRIDE + 4 * q_col;
                __stcs(reinterpret_cast<float4*>(zn_out + off),
                       *reinterpret_cast<const float4*>(s_zn + so));
                __stcs(reinterpret_cast<float4*>(zq_out + off),
                       *reinterpret_cast<const float4*>(s_zq + so));
            }
        }
        if (lane < 16 && (row_begin + tile * 16) + lane < row_end) {
            int* dst = idx + static_cast<size_t>((row_begin + tile * 16) + lane) * M + m0;
            const int* src = s_idx + lane * gs;
            if (D == 16 && gs == 2 && M % 2 == 0)       // row * M + m0 is even
                *reinterpret_cast<int2*>(dst) = make_int2(src[0], src[1]);
            else if (D == 8 && gs == 4 && M % 4 == 0)
                *reinterpret_cast<int4*>(dst) = make_int4(src[0], src[1], src[2], src[3]);
            else
                for (int s = 0; s < gs; ++s) dst[s] = src[s];
        }
        __syncwarp();
    }
}

template <int D, int MODE, bool PACKED>
int launch_fast(const float* z, const float* c_norm, const float* c_raw,
                const float* z_mean, const float* z_std, int* idx, float* zn,
                float* zq, int n, int M, int K, cudaStream_t stream) {
    auto kernel = pq_fast_kernel<D, MODE, PACKED>;
    constexpr int CW = 256 / D;
    const size_t k_pad = (static_cast<size_t>(K) + CW - 1) / CW * CW;
    const size_t per_sub = k_pad * D * 2 + static_cast<size_t>(K) * D * 2
                           + (MODE == L2 && PACKED ? 0 : k_pad * 4);
    int G = min(32 / D, M);             // 128 bytes of each row
    while (G > 1 && G * per_sub + STAGE_BYTES > SMEM_MAX) --G;
    const size_t smem = G * per_sub + STAGE_BYTES;
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FAST_THREADS,
                                                             smem)) != cudaSuccess)
        return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    // WAVES waves of resident blocks, each of at least MIN_ROWS rows
    const int groups = (M + G - 1) / G;
    const int row_runs = max(1, min(WAVES * sms * per_sm / groups, n / MIN_ROWS));
    const int rows = ((n + row_runs - 1) / row_runs + 15) / 16 * 16;
    const dim3 grid(groups, (n + rows - 1) / rows);
    kernel<<<grid, FAST_THREADS, smem, stream>>>(z, c_norm, c_raw, z_mean, z_std, n, M,
                                                 K, G, rows, idx, zn, zq);
    return static_cast<int>(cudaGetLastError());
}

template <int D, int MODE>
int launch_precision(bool exact, const float* z, const float* c_norm,
                     const float* c_raw, const float* z_mean, const float* z_std,
                     int* idx, float* zn, float* zq, int n, int M, int K,
                     cudaStream_t s) {
    if (exact)
        return launch_exact<D, MODE>(z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
    if (K <= 256)
        return launch_fast<D, MODE, true>(z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
    return launch_fast<D, MODE, false>(z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
}

// ------------------------------------------------------------- wide body

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// Fast mode (pq_wide_fast_kernel; the header says why and how).
constexpr int WF_THREADS = 256;
constexpr int WF_ROWS = 32;             // rows of one subspace per block: two 16-row slabs
constexpr int WF_CODES = 128;           // codewords per tile: four warp groups of 32
constexpr int WF_DEPTH = 64;            // dimensions per ring stage: 128 bytes of bf16
constexpr int WF_STAGES = 3;
constexpr int WF_STAGE_BYTES = WF_CODES * WF_DEPTH * 2;
constexpr int WF_RING_BYTES = WF_STAGES * WF_STAGE_BYTES;
constexpr int WF_SMALL_BYTES = 2 * WF_ROWS * 4;     // |z_norm|^2 and the row's index

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// z_norm stays in shared memory as bf16 when the row tile fits beside the
// ring (d <= 2816); past that it is streamed over depth from z_norm.
__host__ __device__ constexpr bool wide_fast_resident(int d_pad) {
    return WF_RING_BYTES + WF_ROWS * d_pad * 2 + WF_SMALL_BYTES <= SMEM_MAX;
}

size_t wide_fast_smem(int d) {
    const int d_pad = round_up(d, WF_DEPTH);
    return WF_RING_BYTES + WF_SMALL_BYTES
           + static_cast<size_t>(WF_ROWS) * (wide_fast_resident(d_pad) ? d_pad : WF_DEPTH) * 2;
}

// workspace: the bf16 codebook (M, k_pad, d_pad), then c_sq (M, k_pad) in f32
size_t wide_fast_workspace(int M, int K, int d) {
    const size_t words = static_cast<size_t>(M) * round_up(K, WF_CODES);
    return words * round_up(d, WF_DEPTH) * 2 + words * 4;
}

// element offset of the 16-byte piece q (8 bf16) of row r in rows of ld
// elements (ld % 64 == 0): pieces swap within each 128-byte line by
// q ^ (r % 8), so the eight rows an ldmatrix phase reads hit eight
// different bank groups
__device__ __forceinline__ int swz(int r, int q, int ld) {
    return r * ld + (((q & ~7) | ((q ^ r) & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, global -> the shared-memory byte address dst
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices from the shared-memory byte address each lane gives
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// four f32 -> four bf16 at element offset o of s (o % 4 == 0)
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* s, int o, float4 v) {
    *reinterpret_cast<uint2*>(s + o) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// The pre-pass: a warp per codeword of the padded codebook writes c_norm
// rounded to bf16 (zeros past d and past K) and the f32 squared norm of
// the unrounded values.
__global__ void __launch_bounds__(256)
pq_wide_prep_kernel(const float* __restrict__ c_norm, int M, int K, int d, int k_pad,
                    int d_pad, __nv_bfloat16* __restrict__ cb, float* __restrict__ csq) {
    const int w = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (w >= M * k_pad) return;
    const int m = w / k_pad, k = w - m * k_pad;
    const float* src = c_norm + (static_cast<size_t>(m) * K + k) * d;
    __nv_bfloat16* dst = cb + static_cast<size_t>(w) * d_pad;
    float acc = 0.f;
    for (int j = 4 * lane; j < d_pad; j += 128) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < K && j < d) {
            v = __ldg(reinterpret_cast<const float4*>(src + j));
            acc += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
        }
        store_bf16x4(dst, j, v);
    }
    acc = warp_sum(acc);
    if (lane == 0) csq[w] = acc;
}

template <int MODE, bool PACKED>
__global__ void __launch_bounds__(WF_THREADS, 2)
pq_wide_fast_kernel(const float* __restrict__ z, const __nv_bfloat16* __restrict__ cb,
                    const float* __restrict__ csq, const float* __restrict__ c_raw,
                    const float* __restrict__ z_mean, const float* __restrict__ z_std,
                    int n, int M, int K, int d, int k_pad, int d_pad, int resident,
                    int* __restrict__ idx, float* zn_out, float* __restrict__ zq_out) {
    constexpr bool L2_SHORT = MODE == L2 && PACKED;
    extern __shared__ __align__(128) unsigned char wf_smem[];
    __nv_bfloat16* s_ring = reinterpret_cast<__nv_bfloat16*>(wf_smem);   // [STAGES][CODES][DEPTH]
    __nv_bfloat16* s_a = s_ring + WF_STAGES * WF_CODES * WF_DEPTH;       // [ROWS][a_ld]
    const int a_ld = resident ? d_pad : WF_DEPTH;
    float* s_zsq = reinterpret_cast<float*>(s_a + WF_ROWS * a_ld);       // [ROWS]
    int* s_best = reinterpret_cast<int*>(s_zsq + WF_ROWS);               // [ROWS]
    // once the ring has drained: each (row, warp group)'s minimum
    int* s_key = reinterpret_cast<int*>(wf_smem);                        // [ROWS][4]
    float* s_kd = reinterpret_cast<float*>(s_key + WF_ROWS * 4);         // [ROWS][4]

    const int m = blockIdx.y, row0 = blockIdx.x * WF_ROWS;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const size_t row_stride = static_cast<size_t>(M) * d;
    const size_t col0 = static_cast<size_t>(m) * d;
    const int chunks = d_pad / WF_DEPTH, steps = chunks * (k_pad / WF_CODES);
    const __nv_bfloat16* cbm = cb + static_cast<size_t>(m) * k_pad * d_pad;

    // the ring: step s holds codeword tile s / chunks, depth chunk
    // s % chunks in stage s % STAGES.  This thread copies the 16-byte piece
    // tid % 8 of codewords tid / 8 + 32 u (u < 4) of each step: its shared
    // and global offsets are fixed, a step adds its stage and its place.
    const uint32_t ring = smem_addr(s_ring);
    const int ld_cw = tid >> 3, ld_q = tid & 7;
    const uint32_t ld_dst = ring + ld_cw * (WF_DEPTH * 2) + ((ld_q ^ (ld_cw & 7)) << 4);
    const __nv_bfloat16* ld_src = cbm + static_cast<size_t>(ld_cw) * d_pad + 8 * ld_q;
    constexpr int LD_ROWS = WF_THREADS / 8;     // codewords one pass of the block copies
    int ld_step = 0, ld_tile = 0, ld_c = 0, ld_stage = 0;
    auto load_next = [&]() {
        if (ld_step < steps) {
            const uint32_t dst = ld_dst + ld_stage * WF_STAGE_BYTES;
            const __nv_bfloat16* src = ld_src + static_cast<size_t>(ld_tile) * WF_CODES * d_pad
                                       + ld_c * WF_DEPTH;
#pragma unroll
            for (int u = 0; u < WF_CODES / LD_ROWS; ++u)
                cp_async16(dst + u * LD_ROWS * (WF_DEPTH * 2),
                           src + static_cast<size_t>(u) * LD_ROWS * d_pad);
            if (++ld_c == chunks) { ld_c = 0; ++ld_tile; }
            if (++ld_stage == WF_STAGES) ld_stage = 0;
        }
        ++ld_step;
        cp_async_commit();
    };
    // the first codebook stages load while the rows are normalised
    for (int s = 0; s < WF_STAGES - 1; ++s) load_next();

    // normalise: a warp per row, z_norm to device memory as f32, |z_norm|^2
    // and (resident) the bf16 row with zeros past d into shared memory
    const int a_end = resident ? d_pad : 0;
    for (int r = warp; r < WF_ROWS; r += WF_THREADS / 32) {
        const int row = row0 + r;
        if (row >= n) {
            for (int j = 4 * lane; j < a_end; j += 128)
                store_bf16x4(s_a, swz(r, j >> 3, a_ld) + (j & 4), make_float4(0.f, 0.f, 0.f, 0.f));
            if (lane == 0) s_zsq[r] = 0.f;
            continue;
        }
        const float* zr = z + row * row_stride + col0;
        float* zo = zn_out + row * row_stride + col0;
        float shift = 0.f, denom = 1.f;
        if (MODE == L2) {
            float ss = 0.f;
#pragma unroll 4
            for (int j = 4 * lane; j < d; j += 128) {
                const float4 v = *reinterpret_cast<const float4*>(zr + j);
                ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
            }
            denom = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
        } else if (MODE == Z_NORM) {
            float s1 = 0.f;
#pragma unroll 4
            for (int j = 4 * lane; j < d; j += 128) {
                const float4 v = *reinterpret_cast<const float4*>(zr + j);
                s1 += v.x + v.y + v.z + v.w;
            }
            shift = warp_sum(s1) / d;
            float s2 = 0.f;
#pragma unroll 4
            for (int j = 4 * lane; j < d; j += 128) {
                const float4 v = *reinterpret_cast<const float4*>(zr + j);
                const float x0 = v.x - shift, x1 = v.y - shift, x2 = v.z - shift, x3 = v.w - shift;
                s2 += x0 * x0 + x1 * x1 + x2 * x2 + x3 * x3;
            }
            denom = sqrtf(warp_sum(s2) / (d - 1)) + 1e-5f;
        }
        float zsq = 0.f;
#pragma unroll 4
        for (int j = 4 * lane; j < max(d, a_end); j += 128) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (j < d) {
                v = __ldcs(reinterpret_cast<const float4*>(zr + j));
                if (MODE == L2) {
                    v = make_float4(v.x / denom, v.y / denom, v.z / denom, v.w / denom);
                } else if (MODE == Z_NORM) {
                    v = make_float4((v.x - shift) / denom, (v.y - shift) / denom,
                                    (v.z - shift) / denom, (v.w - shift) / denom);
                } else if (MODE == Z_TRAINABLE) {
                    const float4 mu = __ldg(reinterpret_cast<const float4*>(z_mean + col0 + j));
                    const float4 sd = __ldg(reinterpret_cast<const float4*>(z_std + col0 + j));
                    v = make_float4((v.x - mu.x) / (sd.x + 1e-5f), (v.y - mu.y) / (sd.y + 1e-5f),
                                    (v.z - mu.z) / (sd.z + 1e-5f), (v.w - mu.w) / (sd.w + 1e-5f));
                }
                *reinterpret_cast<float4*>(zo + j) = v;
                zsq += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
            }
            if (j < a_end) store_bf16x4(s_a, swz(r, j >> 3, a_ld) + (j & 4), v);
        }
        zsq = warp_sum(zsq);
        if (lane == 0) s_zsq[r] = zsq;
    }
    __syncthreads();        // z_norm rows, s_zsq and s_a are visible to the block

    // warp (slab, grp): rows 16 slab.., codewords 32 grp.. of each tile
    const int slab = warp >> 2, grp = warp & 3, g = lane >> 2, t = lane & 3;
    const float zsq_r[2] = {s_zsq[16 * slab + g], s_zsq[16 * slab + g + 8]};
    int best_p[2] = {INT_MAX, INT_MAX};
    float best_d[2] = {INFINITY, INFINITY};
    int best_k[2] = {0, 0};
    // ldmatrix rows: A rows 16 slab + lane % 16, piece lane / 16 of each
    // 16-deep step; B codewords 8 (lane / 16) + lane % 8 (and 16 more),
    // piece (lane / 8) % 2.  Rows r of A and B sit r % 8 pieces swizzled
    // (swz); a chunk is 8 pieces, so the swizzle never leaves it.
    const int a_row = 16 * slab + (lane & 15), a_q = lane >> 4;
    const int b_cw = 32 * grp + (lane & 7) + ((lane >> 4) << 3), b_q = (lane >> 3) & 1;
    const uint32_t a_base = smem_addr(s_a) + a_row * a_ld * 2;
    const uint32_t b_base = ring + b_cw * (WF_DEPTH * 2);
    const float* csq_m = csq + static_cast<size_t>(m) * k_pad;
    float acc[4][4] = {};

    int tile = 0, c = 0, stage = 0;     // of step s
    for (int s = 0; s < steps; ++s) {
        if (!resident) {
            __syncthreads();        // every warp is done with the last chunk's rows
            for (int i = tid; i < WF_ROWS * 16; i += WF_THREADS) {
                const int r = i >> 4, j = c * WF_DEPTH + 4 * (i & 15);
                float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
                if (row0 + r < n && j < d)
                    v = *reinterpret_cast<const float4*>(zn_out + (row0 + r) * row_stride + col0 + j);
                store_bf16x4(s_a, swz(r, (j >> 3) & 7, WF_DEPTH) + (j & 4), v);
            }
        }
        cp_async_wait<WF_STAGES - 2>();
        __syncthreads();            // stage s has landed; stage s - 1 is free
        load_next();
        const uint32_t sa = a_base + (resident ? c * (WF_DEPTH * 2) : 0);
        const uint32_t sb = b_base + stage * WF_STAGE_BYTES;
#pragma unroll
        for (int ks = 0; ks < WF_DEPTH / 16; ++ks) {
            uint32_t a[4], b0[4], b1[4];
            ldsm_x4(a, sa + (((2 * ks + a_q) ^ (a_row & 7)) << 4));
            ldsm_x4(b0, sb + (((2 * ks + b_q) ^ (b_cw & 7)) << 4));
            ldsm_x4(b1, sb + 16 * (WF_DEPTH * 2) + (((2 * ks + b_q) ^ (b_cw & 7)) << 4));
            mma_k16(acc[0], a[0], a[1], a[2], a[3], b0[0], b0[1]);
            mma_k16(acc[1], a[0], a[1], a[2], a[3], b0[2], b0[3]);
            mma_k16(acc[2], a[0], a[1], a[2], a[3], b1[0], b1[1]);
            mma_k16(acc[3], a[0], a[1], a[2], a[3], b1[2], b1[3]);
        }
        if (c == chunks - 1) {
            // fold the tile into the running minima, codewords in order
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kc = tile * WF_CODES + 32 * grp + 8 * j + 2 * t;
                float2 cs = make_float2(0.f, 0.f);
                if (!L2_SHORT) cs = __ldg(reinterpret_cast<const float2*>(csq_m + kc));
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = e >> 1, k = kc + (e & 1);
                    if (k >= K) continue;
                    const float dist = L2_SHORT ? 1.f - acc[j][e]
                                                : (zsq_r[r] + ((e & 1) ? cs.y : cs.x)) - 2.f * acc[j][e];
                    if (PACKED) {
                        best_p[r] = min(best_p[r], (__float_as_int(dist) & ~0xFF) | k);
                    } else if (dist < best_d[r]) {
                        best_d[r] = dist;
                        best_k[r] = k;
                    }
                }
                acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
            }
        }
        if (++c == chunks) { c = 0; ++tile; }
        if (++stage == WF_STAGES) stage = 0;
    }
    cp_async_wait<0>();
    __syncthreads();                // the ring is free for s_key

    // the quad of a row agrees, then the four warp groups of its slab
    // (equal distances: the lower index)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = 16 * slab + g + 8 * r;
        if (PACKED) {
            int key = best_p[r];
            key = min(key, __shfl_xor_sync(0xffffffffu, key, 1));
            key = min(key, __shfl_xor_sync(0xffffffffu, key, 2));
            if (t == 0) s_key[4 * row + grp] = key;
        } else {
            float bd = best_d[r];
            int bk = best_k[r];
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
                const float od = __shfl_xor_sync(0xffffffffu, bd, off);
                const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
                if (od < bd || (od == bd && ok < bk)) { bd = od; bk = ok; }
            }
            if (t == 0) {
                s_key[4 * row + grp] = bk;
                s_kd[4 * row + grp] = bd;
            }
        }
    }
    __syncthreads();
    if (tid < WF_ROWS) {
        int best;
        if (PACKED) {
            int key = s_key[4 * tid];
#pragma unroll
            for (int q = 1; q < 4; ++q) key = min(key, s_key[4 * tid + q]);
            best = key & 0xFF;
        } else {
            float bd = s_kd[4 * tid];
            best = s_key[4 * tid];
#pragma unroll
            for (int q = 1; q < 4; ++q) {
                const float od = s_kd[4 * tid + q];
                const int ok = s_key[4 * tid + q];
                if (od < bd || (od == bd && ok < best)) { bd = od; best = ok; }
            }
        }
        s_best[tid] = best;
    }
    __syncthreads();

    // idx and z_q (the bf16-rounded raw codeword), a warp per row
    for (int r = warp; r < WF_ROWS; r += WF_THREADS / 32) {
        const int row = row0 + r;
        if (row >= n) continue;
        const int best = s_best[r];
        if (lane == 0) idx[static_cast<size_t>(row) * M + m] = best;
        const float* src = c_raw + (static_cast<size_t>(m) * K + best) * d;
        float* dst = zq_out + row * row_stride + col0;
#pragma unroll 4
        for (int j = 4 * lane; j < d; j += 128) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src + j));
            __stcs(reinterpret_cast<float4*>(dst + j),
                   make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w)));
        }
    }
}

// blocks, resident blocks per SM and dynamic shared memory of a fast
// wide launch on the current device
template <int MODE, bool PACKED>
int wide_fast_config(int n, int M, int d, int* blocks, int* per_sm, size_t* smem) {
    auto kernel = pq_wide_fast_kernel<MODE, PACKED>;
    *smem = wide_fast_smem(d);
    *blocks = (n + WF_ROWS - 1) / WF_ROWS * M;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(*smem));
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, WF_THREADS, *smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    return *per_sm < 1 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

template <int MODE, bool PACKED>
int launch_wide_fast(const float* z, const float* c_norm, const float* c_raw,
                     const float* z_mean, const float* z_std, int* idx, float* zn,
                     float* zq, int n, int M, int K, int d, void* workspace,
                     cudaStream_t stream) {
    if (M > 65535 || workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int k_pad = round_up(K, WF_CODES), d_pad = round_up(d, WF_DEPTH);
    auto* cb = static_cast<__nv_bfloat16*>(workspace);
    auto* csq = reinterpret_cast<float*>(cb + static_cast<size_t>(M) * k_pad * d_pad);
    int blocks = 0, per_sm = 0;
    size_t smem = 0;
    int err = wide_fast_config<MODE, PACKED>(n, M, d, &blocks, &per_sm, &smem);
    if (err) return err;
    pq_wide_prep_kernel<<<(M * k_pad + 7) / 8, 256, 0, stream>>>(c_norm, M, K, d, k_pad, d_pad,
                                                                  cb, csq);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    const dim3 grid((n + WF_ROWS - 1) / WF_ROWS, M);
    pq_wide_fast_kernel<MODE, PACKED><<<grid, WF_THREADS, smem, stream>>>(
        z, cb, csq, c_raw, z_mean, z_std, n, M, K, d, k_pad, d_pad,
        wide_fast_resident(d_pad) ? 1 : 0, idx, zn, zq);
    return static_cast<int>(cudaGetLastError());
}

// Exact mode (the header's "exact wide body"): the distance body between a
// pre-pass and a gather pass, or with both inside it.
constexpr int WX_THREADS = 256;
constexpr int WX_ROWS = 128;            // rows of one subspace per block
constexpr int WX_CODES = 128;           // codewords per tile
constexpr int WX_DEPTH = 32;            // dimensions per ring stage
constexpr int WX_LD = WX_DEPTH + 4;     // floats per staged row: 144 bytes, so that the float4
                                        // reads of 8 neighbouring rows hit 32 different banks
constexpr int WX_STAGES = 2;
constexpr int WX_STAGE_FLOATS = (WX_ROWS + WX_CODES) * WX_LD;
constexpr int WX_TM = 4, WX_TN = 16;    // rows and codewords of a thread
constexpr int WX_WAVES = 16;            // blocks per resident slot the codeword split aims at
// the ring, |z_norm|^2 of the rows, the running minima (WX_TM rows per thread)
constexpr int WX_SMEM = (WX_STAGES * WX_STAGE_FLOATS + WX_ROWS + 2 * WX_TM * WX_THREADS) * 4;
constexpr uint32_t KEY_INF = 0xFF800000u;   // ordered(+inf): keys at or above it mean "none"

// the order of floats as unsigned integers: -0 counts as +0, every NaN
// above +inf
__device__ __forceinline__ uint32_t ordered(float x) {
    if (isnan(x)) return 0xFFFFFFFFu;
    const uint32_t b = __float_as_uint(x + 0.f);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// 16 bytes, global -> shared, or 16 zero bytes where !valid (src not read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

// One warp normalises the row zr (d floats of subspace m) into zo and
// returns |z_norm|^2: f32 warp sums of lane-strided partial sums (the
// unrolling only brings the loads forward; each lane's sums stay in order).
template <int MODE>
__device__ __forceinline__ float normalise_row(const float* __restrict__ zr,
                                               float* __restrict__ zo,
                                               const float* __restrict__ z_mean,
                                               const float* __restrict__ z_std, int m, int d,
                                               int lane) {
    float shift = 0.f, denom = 1.f;
    if (MODE == L2) {
        float ss = 0.f;
#pragma unroll 8
        for (int j = lane; j < d; j += 32) ss += zr[j] * zr[j];
        denom = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
    } else if (MODE == Z_NORM) {
        float s1 = 0.f;
#pragma unroll 8
        for (int j = lane; j < d; j += 32) s1 += zr[j];
        shift = warp_sum(s1) / d;
        float s2 = 0.f;
#pragma unroll 8
        for (int j = lane; j < d; j += 32) {
            const float xc = zr[j] - shift;
            s2 += xc * xc;
        }
        denom = sqrtf(warp_sum(s2) / (d - 1)) + 1e-5f;
    }
    float zsq = 0.f;
#pragma unroll 8
    for (int j = lane; j < d; j += 32) {
        float v = zr[j];
        if (MODE == L2) v = v / denom;
        else if (MODE == Z_NORM) v = (v - shift) / denom;
        else if (MODE == Z_TRAINABLE)
            v = (v - z_mean[m * d + j]) / (z_std[m * d + j] + 1e-5f);
        zo[j] = v;
        zsq += v * v;
    }
    return warp_sum(zsq);
}

// One warp writes the raw codeword src into dst, 16 bytes a lane.
__device__ __forceinline__ void gather_row(const float* __restrict__ src, float* dst, int d,
                                           int lane) {
#pragma unroll 4
    for (int j = 4 * lane; j < d; j += 128)
        __stcs(reinterpret_cast<float4*>(dst + j), __ldg(reinterpret_cast<const float4*>(src + j)));
}

// Pre-pass: a warp per (row, subspace) normalises it and puts |z_norm|^2
// and the row's key (all ones) into its z_q slot, words 0..2, until the
// gather pass overwrites it (n = 0: no rows); then a warp per codeword:
// c_sq into the workspace.
template <int MODE>
__global__ void __launch_bounds__(256)
pq_wide_exact_prep_kernel(const float* __restrict__ z, const float* __restrict__ c_norm,
                          const float* __restrict__ z_mean, const float* __restrict__ z_std,
                          int n, int M, int K, int d, float* __restrict__ zn_out,
                          float* __restrict__ zq_out, float* __restrict__ csq) {
    const long long w = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    const long long rows = static_cast<long long>(n) * M;
    if (w >= rows) {
        const long long c = w - rows;
        if (c >= static_cast<long long>(M) * K) return;
        const float* cw = c_norm + c * d;
        float acc = 0.f;
        for (int j = lane; j < d; j += 32) acc += cw[j] * cw[j];
        acc = warp_sum(acc);
        if (lane == 0) csq[c] = acc;
        return;
    }
    // (row * M + m) * d = w * d
    const float zsq = normalise_row<MODE>(z + w * d, zn_out + w * d, z_mean, z_std,
                                          static_cast<int>(w % M), d, lane);
    if (lane == 0) {
        float* slot = zq_out + w * d;
        *reinterpret_cast<unsigned long long*>(slot) = ~0ull;
        slot[2] = zsq;
    }
}

// The distance body: a block owns 128 rows of one subspace and a range of
// 128-codeword tiles; thread (tx, ty) the rows ty + 32 i (i < 4) and
// codewords tx + 8 j (j < 16) of each tile, each an fmaf chain over the
// depth in order.  FUSED (the range is every tile): the block normalises
// its rows first and gathers their codewords last; else the pre-pass did
// the first and its minimum over the range goes into the row's key.
template <int MODE, bool FUSED>
__global__ void __launch_bounds__(WX_THREADS, 2)
pq_wide_exact_kernel(const float* __restrict__ z, const float* __restrict__ c_norm,
                     const float* __restrict__ c_raw, const float* __restrict__ csq,
                     const float* __restrict__ z_mean, const float* __restrict__ z_std,
                     int n, int M, int K, int d, int splits, int tiles_per_block,
                     int* __restrict__ idx, float* zn, float* zq_out) {
    extern __shared__ __align__(16) float wx_smem[];
    float* s_zsq = wx_smem + WX_STAGES * WX_STAGE_FLOATS;           // [ROWS]
    float* s_bd = s_zsq + WX_ROWS;                                  // [TM][THREADS]
    int* s_bk = reinterpret_cast<int*>(s_bd + WX_TM * WX_THREADS);  // [TM][THREADS]
    int* s_best = reinterpret_cast<int*>(wx_smem);  // [ROWS], once the ring has drained
    const int m = blockIdx.y;
    const int row_tile = blockIdx.x / splits;
    const int row0 = row_tile * WX_ROWS;
    const int tile0 = (blockIdx.x - row_tile * splits) * tiles_per_block;
    const int tile_end = min((K + WX_CODES - 1) / WX_CODES, tile0 + tiles_per_block);
    const int chunks = (d + WX_DEPTH - 1) / WX_DEPTH;
    const int steps = (tile_end - tile0) * chunks;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const size_t row_stride = static_cast<size_t>(M) * d;
    const size_t col0 = static_cast<size_t>(m) * d;
    const float* cn = c_norm + static_cast<size_t>(m) * K * d;
    const float* csq_m = csq + static_cast<size_t>(m) * K;

    if (FUSED) {
        for (int r = warp; r < WX_ROWS; r += WX_THREADS / 32) {
            const size_t off = (row0 + r) * row_stride + col0;
            const float zsq = row0 + r < n
                ? normalise_row<MODE>(z + off, zn + off, z_mean, z_std, m, d, lane) : 0.f;
            if (lane == 0) s_zsq[r] = zsq;
        }
        __syncthreads();            // the tile's z_norm rows are in device memory
    } else {
        for (int r = tid; r < WX_ROWS; r += WX_THREADS)
            s_zsq[r] = row0 + r < n ? zq_out[(row0 + r) * row_stride + col0 + 2] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < WX_TM; ++i) {
        s_bd[i * WX_THREADS + tid] = INFINITY;
        s_bk[i * WX_THREADS + tid] = 0;
    }

    // the ring: step s holds codeword tile tile0 + s / chunks, depth chunk
    // s % chunks, in stage s % STAGES: rows then codewords, WX_LD floats
    // each.  This thread copies the 16-byte piece ld_q of rows and of
    // codewords ld_r + 32 u (u < 4).  Pieces past d are zeros; rows past n
    // and codewords past K repeat the last one (no result of theirs is used).
    const int ld_r = tid >> 3, ld_q = tid & 7;
    const uint32_t ld_dst = smem_addr(wx_smem) + (ld_r * WX_LD + 4 * ld_q) * 4;
    int ld_t = 0, ld_c = 0, ld_stage = 0;     // of the next step to load
    auto load = [&](int s) {
        if (s < steps) {
            const int j = ld_c * WX_DEPTH + 4 * ld_q;
            const bool in_d = j < d;
            const uint32_t dst = ld_dst + ld_stage * (WX_STAGE_FLOATS * 4);
            const int k0 = (tile0 + ld_t) * WX_CODES + ld_r;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int row = min(row0 + ld_r + 32 * u, n - 1);
                cp_async16_zfill(dst + u * (32 * WX_LD * 4),
                                 in_d ? zn + row * row_stride + col0 + j : zn, in_d);
                const int k = min(k0 + 32 * u, K - 1);
                cp_async16_zfill(dst + (WX_ROWS + 32 * u) * (WX_LD * 4),
                                 in_d ? cn + static_cast<size_t>(k) * d + j : cn, in_d);
            }
            if (++ld_c == chunks) { ld_c = 0; ++ld_t; }
            if (++ld_stage == WX_STAGES) ld_stage = 0;
        }
        cp_async_commit();
    };
    for (int s = 0; s < WX_STAGES - 1; ++s) load(s);

    // warp w covers rows 4 w.. and every codeword group: a float4 read of
    // A touches 4 rows, one of B 8 codewords
    const int tx = lane & 7, ty = (lane >> 3) + 4 * warp;
    float acc[WX_TM][WX_TN];
#pragma unroll
    for (int i = 0; i < WX_TM; ++i)
#pragma unroll
        for (int j = 0; j < WX_TN; ++j) acc[i][j] = 0.f;

    int stage = 0, c = 0, t = 0;              // of step s
    for (int s = 0; s < steps; ++s) {
        cp_async_wait<WX_STAGES - 2>();
        __syncthreads();            // stage s has landed; stage s - 1 is free
        load(s + WX_STAGES - 1);
        const float* sa = wx_smem + stage * WX_STAGE_FLOATS + ty * WX_LD;
        const float* sb = wx_smem + stage * WX_STAGE_FLOATS + (WX_ROWS + tx) * WX_LD;
#pragma unroll 1
        for (int g = 0; g < WX_DEPTH / 4; ++g) {
            float4 a[WX_TM];
#pragma unroll
            for (int i = 0; i < WX_TM; ++i)
                a[i] = *reinterpret_cast<const float4*>(sa + i * 32 * WX_LD + 4 * g);
#pragma unroll
            for (int j = 0; j < WX_TN; ++j) {
                const float4 b = *reinterpret_cast<const float4*>(sb + j * 8 * WX_LD + 4 * g);
#pragma unroll
                for (int i = 0; i < WX_TM; ++i) {
                    acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
                    acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
                    acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
                    acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
                }
            }
        }
        if (c == chunks - 1) {
            // fold the tile into this thread's running minima, codewords in order
            const int k0 = (tile0 + t) * WX_CODES + tx;
            float cs[WX_TN];
#pragma unroll
            for (int j = 0; j < WX_TN; ++j) cs[j] = k0 + 8 * j < K ? csq_m[k0 + 8 * j] : 0.f;
#pragma unroll
            for (int i = 0; i < WX_TM; ++i) {
                const float zs = s_zsq[ty + 32 * i];
                float bd = s_bd[i * WX_THREADS + tid];
                int bk = s_bk[i * WX_THREADS + tid];
#pragma unroll
                for (int j = 0; j < WX_TN; ++j) {
                    const int k = k0 + 8 * j;
                    const float dist = (zs + cs[j]) - 2.f * acc[i][j];
                    if (k < K && dist < bd) {
                        bd = dist;
                        bk = k;
                    }
                    acc[i][j] = 0.f;
                }
                s_bd[i * WX_THREADS + tid] = bd;
                s_bk[i * WX_THREADS + tid] = bk;
            }
        }
        if (++c == chunks) { c = 0; ++t; }
        if (++stage == WX_STAGES) stage = 0;
    }
    cp_async_wait<0>();
    __syncthreads();                // every running minimum is in place; the ring is free

    // a thread per row: the row's 8 threads agree (equal distances: the
    // lower index); the row's key takes the minimum, or (FUSED) its warp
    // writes idx and z_q
    if (tid < WX_ROWS && row0 + tid < n) {
        const int r_ty = tid & 31, i = tid >> 5;
        float bd = INFINITY;
        int bk = 0;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
            const int th = (r_ty >> 2) * 32 + (r_ty & 3) * 8 + t;
            const float od = s_bd[i * WX_THREADS + th];
            const int ok = s_bk[i * WX_THREADS + th];
            if (od < bd || (od == bd && ok < bk)) { bd = od; bk = ok; }
        }
        if (FUSED)
            s_best[tid] = bk;
        else
            atomicMin(reinterpret_cast<unsigned long long*>(zq_out + (row0 + tid) * row_stride + col0),
                      (static_cast<unsigned long long>(ordered(bd)) << 32) | static_cast<uint32_t>(bk));
    }
    if (FUSED) {
        __syncthreads();
        for (int r = warp; r < WX_ROWS; r += WX_THREADS / 32) {
            const int row = row0 + r;
            if (row >= n) break;
            const int best = s_best[r];
            if (lane == 0) idx[static_cast<size_t>(row) * M + m] = best;
            gather_row(c_raw + (static_cast<size_t>(m) * K + best) * d,
                       zq_out + row * row_stride + col0, d, lane);
        }
    }
}

// Gather pass: a warp per (row, subspace): the index from the row's key (0
// where no distance was below +inf) into idx, the raw codeword over the key
// in z_q.
__global__ void __launch_bounds__(256)
pq_wide_exact_gather_kernel(const float* __restrict__ c_raw, int n, int M, int K, int d,
                            int* __restrict__ idx, float* zq_out) {
    const long long w = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (w >= static_cast<long long>(n) * M) return;
    float* dst = zq_out + w * d;
    unsigned long long key = 0;
    if (lane == 0) key = *reinterpret_cast<const unsigned long long*>(dst);
    key = __shfl_sync(0xffffffffu, key, 0);     // read before any lane writes the slot
    const int best = static_cast<uint32_t>(key >> 32) >= KEY_INF ? 0 : static_cast<int>(key & 0xFFFFFFFFu);
    if (lane == 0) idx[w] = best;
    gather_row(c_raw + (static_cast<size_t>(w % M) * K + best) * d, dst, d, lane);
}

// blocks, resident blocks per SM, codeword splits, tiles per block and
// whether the body runs fused, for an exact wide launch on the current
// device.  Fused (one block per row tile, no passes) where the row tiles
// fill the resident slots in whole waves to 90%; else each row tile's
// codeword tiles are split into ranges for WX_WAVES blocks per slot.
int wide_exact_config(int n, int M, int K, int* blocks, int* per_sm, int* splits,
                      int* tiles_per_block, bool* fused) {
    auto kernel = pq_wide_exact_kernel<NONE, false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           WX_SMEM);
    int device = 0, sms = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, WX_THREADS, WX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (*per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long slots = static_cast<long long>(sms) * *per_sm;
    const long long row_blocks = static_cast<long long>((n + WX_ROWS - 1) / WX_ROWS) * M;
    const int tiles = (K + WX_CODES - 1) / WX_CODES;
    const long long waves = (row_blocks + slots - 1) / slots;
    *fused = 10 * row_blocks >= 9 * waves * slots;
    const long long want = *fused ? 1 : (WX_WAVES * slots + row_blocks - 1) / row_blocks;
    const int split = static_cast<int>(std::min<long long>(tiles, std::max(1LL, want)));
    *tiles_per_block = (tiles + split - 1) / split;
    *splits = (tiles + *tiles_per_block - 1) / *tiles_per_block;
    *blocks = static_cast<int>(row_blocks * *splits);
    return 0;
}

template <int MODE>
int launch_wide_exact(const float* z, const float* c_norm, const float* c_raw,
                      const float* z_mean, const float* z_std, int* idx, float* zn,
                      float* zq, int n, int M, int K, int d, void* workspace,
                      cudaStream_t stream) {
    if (M > 65535 || workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    auto* csq = static_cast<float*>(workspace);
    int blocks = 0, per_sm = 0, splits = 0, per_block = 0;
    bool fused = false;
    int err = wide_exact_config(n, M, K, &blocks, &per_sm, &splits, &per_block, &fused);
    if (err) return err;
    if (fused) {
        auto kernel = pq_wide_exact_kernel<MODE, true>;
        err = static_cast<int>(cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WX_SMEM));
        if (err) return err;
    }
    // the pre-pass: the rows (split launches only) and c_sq
    const long long rows = fused ? 0 : static_cast<long long>(n) * M;
    const auto prep_blocks = static_cast<unsigned>((rows + static_cast<long long>(M) * K + 7) / 8);
    pq_wide_exact_prep_kernel<MODE><<<prep_blocks, 256, 0, stream>>>(
        z, c_norm, z_mean, z_std, fused ? 0 : n, M, K, d, zn, zq, csq);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    const dim3 grid((n + WX_ROWS - 1) / WX_ROWS * splits, M);
    if (fused) {
        pq_wide_exact_kernel<MODE, true><<<grid, WX_THREADS, WX_SMEM, stream>>>(
            z, c_norm, c_raw, csq, z_mean, z_std, n, M, K, d, splits, per_block, idx, zn, zq);
        return static_cast<int>(cudaGetLastError());
    }
    pq_wide_exact_kernel<NONE, false><<<grid, WX_THREADS, WX_SMEM, stream>>>(
        z, c_norm, c_raw, csq, z_mean, z_std, n, M, K, d, splits, per_block, idx, zn, zq);
    if ((err = static_cast<int>(cudaGetLastError()))) return err;
    pq_wide_exact_gather_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
        c_raw, n, M, K, d, idx, zq);
    return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_wide_precision(bool exact, const float* z, const float* c_norm,
                          const float* c_raw, const float* z_mean, const float* z_std,
                          int* idx, float* zn, float* zq, int n, int M, int K, int d,
                          void* ws, cudaStream_t s) {
    if (exact)
        return launch_wide_exact<MODE>(z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, d, ws, s);
    if (K <= 256)
        return launch_wide_fast<MODE, true>(z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, d, ws, s);
    return launch_wide_fast<MODE, false>(z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, d, ws, s);
}

int launch_wide_mode(int mode, bool exact, const float* z, const float* c_norm,
                     const float* c_raw, const float* z_mean, const float* z_std,
                     int* idx, float* zn, float* zq, int n, int M, int K, int d,
                     void* ws, cudaStream_t s) {
    switch (mode) {
        case NONE: return launch_wide_precision<NONE>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, d, ws, s);
        case L2: return launch_wide_precision<L2>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, d, ws, s);
        case Z_NORM: return launch_wide_precision<Z_NORM>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, d, ws, s);
        case Z_TRAINABLE: return launch_wide_precision<Z_TRAINABLE>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, d, ws, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The narrow bodies take d in {8, 16, 32} where one subspace's codebooks
// fit shared memory (the header's rule); the wide bodies everything else.
bool narrow_fits(int d, int K, bool exact) {
    if (d != 8 && d != 16 && d != 32) return false;
    const size_t chunk = 256 / d;
    const size_t need = exact ? (8 * static_cast<size_t>(d) + 4) * K
                              : (4 * static_cast<size_t>(d) + 4) * ((K + chunk - 1) / chunk * chunk)
                                    + STAGE_BYTES;
    return need <= SMEM_MAX;
}

template <int D>
int launch_mode(int mode, bool exact, const float* z, const float* c_norm,
                const float* c_raw, const float* z_mean, const float* z_std,
                int* idx, float* zn, float* zq, int n, int M, int K,
                cudaStream_t s) {
    switch (mode) {
        case NONE: return launch_precision<D, NONE>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
        case L2: return launch_precision<D, L2>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
        case Z_NORM: return launch_precision<D, Z_NORM>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
        case Z_TRAINABLE: return launch_precision<D, Z_TRAINABLE>(exact, z, c_norm, c_raw, z_mean, z_std, idx, zn, zq, n, M, K, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Bytes of device workspace pq_assign_launch needs for (M, K, d) in this
// mode: for the wide bodies, the fast one's bf16 codebook and squared
// norms or the exact one's squared norms (M x K f32); else 0.
extern "C" size_t pq_assign_workspace_bytes(int M, int K, int d, int exact) {
    if (M < 1 || K < 1 || d < 8 || d % 8 != 0 || narrow_fits(d, K, exact != 0)) return 0;
    return exact ? static_cast<size_t>(M) * K * 4 : wide_fast_workspace(M, K, d);
}

// A wide launch on the current device: out[0] blocks, out[1] resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[2]
// dynamic shared memory bytes and out[3] codeword splits (1 in fast mode)
// of its main kernel, out[4] 1 where the exact body runs fused (without
// its pre-pass rows and gather pass).  Returns a cudaError_t (0 = success).
extern "C" int pq_assign_wide_config(int n, int M, int K, int d, int mode, int exact, int* out) {
    int blocks = 0, per_sm = 0;
    size_t smem = 0;
    int err;
    if (exact) {
        int splits = 0, per_block = 0;
        bool fused = false;
        err = wide_exact_config(n, M, K, &blocks, &per_sm, &splits, &per_block, &fused);
        out[0] = blocks;
        out[1] = per_sm;
        out[2] = WX_SMEM;
        out[3] = splits;
        out[4] = fused ? 1 : 0;
        return err;
    }
    const bool packed = K <= 256;
    switch (mode) {
        case NONE: err = packed ? wide_fast_config<NONE, true>(n, M, d, &blocks, &per_sm, &smem)
                                : wide_fast_config<NONE, false>(n, M, d, &blocks, &per_sm, &smem); break;
        case L2: err = packed ? wide_fast_config<L2, true>(n, M, d, &blocks, &per_sm, &smem)
                              : wide_fast_config<L2, false>(n, M, d, &blocks, &per_sm, &smem); break;
        case Z_NORM: err = packed ? wide_fast_config<Z_NORM, true>(n, M, d, &blocks, &per_sm, &smem)
                                  : wide_fast_config<Z_NORM, false>(n, M, d, &blocks, &per_sm, &smem); break;
        case Z_TRAINABLE: err = packed ? wide_fast_config<Z_TRAINABLE, true>(n, M, d, &blocks, &per_sm, &smem)
                                       : wide_fast_config<Z_TRAINABLE, false>(n, M, d, &blocks, &per_sm, &smem); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    out[0] = blocks;
    out[1] = per_sm;
    out[2] = static_cast<int>(smem);
    out[3] = 1;
    out[4] = 0;
    return err;
}

// z (n, M, d), c_norm and c_raw (M, K, d), z_mean and z_std (M, d) or null,
// all f32 contiguous and 16-byte aligned -> idx (n, M) int32, z_norm and
// z_q (n, M, d) f32, on `stream`.  mode: 0 none, 1 l2, 2 z_norm,
// 3 z_trainable; d % 8 == 0, K >= 1 (the header's domain).  `workspace`:
// pq_assign_workspace_bytes(M, K, d, exact) bytes of device memory,
// 16-byte aligned (null where that is 0).  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int pq_assign_launch(const void* z, const void* c_norm,
                                const void* c_raw, const void* z_mean,
                                const void* z_std, void* idx, void* zn,
                                void* zq, int n, int M, int K, int d, int mode,
                                int exact, void* stream, void* workspace) {
    if (n == 0) return 0;
    if (K < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* zf = static_cast<const float*>(z);
    const auto* cn = static_cast<const float*>(c_norm);
    const auto* cr = static_cast<const float*>(c_raw);
    const auto* zm = static_cast<const float*>(z_mean);
    const auto* zs = static_cast<const float*>(z_std);
    auto* ip = static_cast<int*>(idx);
    auto* znp = static_cast<float*>(zn);
    auto* zqp = static_cast<float*>(zq);
    if (d < 8 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (!narrow_fits(d, K, exact != 0))
        return launch_wide_mode(mode, exact != 0, zf, cn, cr, zm, zs, ip, znp, zqp, n, M, K, d,
                                workspace, s);
    switch (d) {
        case 8: return launch_mode<8>(mode, exact != 0, zf, cn, cr, zm, zs, ip, znp, zqp, n, M, K, s);
        case 16: return launch_mode<16>(mode, exact != 0, zf, cn, cr, zm, zs, ip, znp, zqp, n, M, K, s);
        case 32: return launch_mode<32>(mode, exact != 0, zf, cn, cr, zm, zs, ip, znp, zqp, n, M, K, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
