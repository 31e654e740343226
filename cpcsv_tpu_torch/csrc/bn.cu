// Train-mode BatchNorm channel reductions, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of cpcsv_tpu/ops/pallas/bn.py:
//
//   bn_stats (_stats_kernel):        a[c] = sum x[n, c, i]     b[c] = sum x[n, c, i]^2
//   bn_grad_reduce (_grad_kernel):   a[c] = sum dy[n, c, i]    b[c] = sum dy[n, c, i] * xhat
//                                    xhat = (x[n, c, i] - mean[c]) * invstd[c]
//
// over a float32 NCHW tensor viewed as (N, C, S), S = H*W (S = 1 for the
// BatchNorm1d of the generator's dense heads), sums in float32.
//
// Bound: bytes. Each input element is read once and takes one or two
// multiply-adds, far below the card's operations-per-byte line. The largest
// shape of a final.yml training step is the generator's upsample4 output,
// (90, 128, 64*64) float32 = 188.7 MB: bn_stats reads it once, 56 us at
// 3.35 TB/s; bn_grad_reduce reads x and dy, 377.5 MB, 113 us.
//
// Design. The TPU kernels stream (block, C) tiles of an (M, C) view through
// one core, carrying the sums across sequential grid steps, with the rows
// zero-padded to the block size. Here blocks run in parallel and in no
// order, so nothing is carried between them and no row is padded:
//   * S > 1: block (c, p) reduces channel c over the rows n of chunk p; its
//     threads walk the rows' S contiguous elements, several rows at once
//     when S is short. When a channel is split into P > 1 chunks, the
//     blocks write per-chunk partials and a second kernel sums each
//     channel's P partials in chunk order. No float atomics: two runs give
//     the same bits.
//   * S = 1: x is (N, C) row-major; a block of 32 x 8 threads takes 32
//     neighbouring channels (coalesced loads) and splits the rows in 8.
// Within a block the sums are combined in a fixed order (warp shuffles,
// then shared memory). The wrapper (ops/cuda/bn.py) checks shapes and
// dtypes, picks P and allocates the outputs and the partials; the kernels
// launch on the caller's stream, do not synchronise and allocate nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool GRAD>
__device__ __forceinline__ void accumulate(const float* __restrict__ x, const float* __restrict__ dy,
                                           long long i, float mean, float inv, float& a, float& b) {
    const float v = x[i];
    if constexpr (GRAD) {
        const float g = dy[i];
        a += g;
        b = fmaf(g, (v - mean) * inv, b);
    } else {
        a += v;
        b = fmaf(v, v, b);
    }
}

// Sum of (a, b) over the block, in a fixed order; the result is in thread 0.
__device__ __forceinline__ void block_sum(float& a, float& b) {
    __shared__ float sa[32], sb[32];
    for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, off);
        b += __shfl_down_sync(0xffffffffu, b, off);
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        sa[warp] = a;
        sb[warp] = b;
    }
    __syncthreads();
    if (warp == 0) {
        const int warps = blockDim.x >> 5;
        a = lane < warps ? sa[lane] : 0.0f;
        b = lane < warps ? sb[lane] : 0.0f;
        for (int off = 16; off > 0; off >>= 1) {
            a += __shfl_down_sync(0xffffffffu, a, off);
            b += __shfl_down_sync(0xffffffffu, b, off);
        }
    }
}

// S > 1. Grid (C, P); block (c, p) writes out_a/out_b[c * P + p].
template <bool GRAD>
__global__ void reduce_maps(const float* __restrict__ x, const float* __restrict__ dy,
                            const float* __restrict__ mean, const float* __restrict__ inv,
                            float* __restrict__ out_a, float* __restrict__ out_b, int N, int C,
                            int S, int P) {
    const int c = blockIdx.x, p = blockIdx.y;
    const int n0 = (int)((long long)N * p / P), n1 = (int)((long long)N * (p + 1) / P);
    const int along = S < (int)blockDim.x ? S : (int)blockDim.x;  // threads along a row
    const int rows = blockDim.x / along;                             // rows in flight
    const int tr = threadIdx.x / along, tc = threadIdx.x - tr * along;
    float m = 0.0f, iv = 0.0f;
    if constexpr (GRAD) {
        m = mean[c];
        iv = inv[c];
    }
    float a = 0.0f, b = 0.0f;
    if (tr < rows) {
        for (int n = n0 + tr; n < n1; n += rows) {
            const long long base = ((long long)n * C + c) * S;
            for (int s = tc; s < S; s += along) accumulate<GRAD>(x, dy, base + s, m, iv, a, b);
        }
    }
    block_sum(a, b);
    if (threadIdx.x == 0) {
        out_a[(long long)c * P + p] = a;
        out_b[(long long)c * P + p] = b;
    }
}

// Second pass for P > 1: each thread sums one channel's P partials in order.
__global__ void finish(const float* __restrict__ part_a, const float* __restrict__ part_b,
                       float* __restrict__ out_a, float* __restrict__ out_b, int C, int P) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    float a = 0.0f, b = 0.0f;
    for (int p = 0; p < P; ++p) {
        a += part_a[(long long)c * P + p];
        b += part_b[(long long)c * P + p];
    }
    out_a[c] = a;
    out_b[c] = b;
}

// S = 1. Grid ceil(C / 32), block (32, 8).
template <bool GRAD>
__global__ void reduce_rows(const float* __restrict__ x, const float* __restrict__ dy,
                            const float* __restrict__ mean, const float* __restrict__ inv,
                            float* __restrict__ out_a, float* __restrict__ out_b, int N, int C) {
    __shared__ float sa[8][33], sb[8][33];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int c = blockIdx.x * 32 + tx;
    float a = 0.0f, b = 0.0f;
    if (c < C) {
        float m = 0.0f, iv = 0.0f;
        if constexpr (GRAD) {
            m = mean[c];
            iv = inv[c];
        }
        for (int n = ty; n < N; n += 8) accumulate<GRAD>(x, dy, (long long)n * C + c, m, iv, a, b);
    }
    sa[ty][tx] = a;
    sb[ty][tx] = b;
    __syncthreads();
    if (ty == 0 && c < C) {
        a = 0.0f;
        b = 0.0f;
        for (int y = 0; y < 8; ++y) {
            a += sa[y][tx];
            b += sb[y][tx];
        }
        out_a[c] = a;
        out_b[c] = b;
    }
}

template <bool GRAD>
cudaError_t launch(const float* x, const float* dy, const float* mean, const float* inv,
                   float* out_a, float* out_b, float* partial, int N, int C, int S, int P,
                   cudaStream_t stream) {
    if (N < 1 || C < 1 || S < 1 || P < 1 || P > N || (S == 1 && P != 1) ||
        (P > 1 && partial == nullptr))
        return cudaErrorInvalidValue;
    if (S == 1) {
        reduce_rows<GRAD><<<(C + 31) / 32, dim3(32, 8), 0, stream>>>(x, dy, mean, inv, out_a,
                                                                     out_b, N, C);
        return cudaGetLastError();
    }
    if (P == 1) {
        reduce_maps<GRAD><<<dim3(C, 1), kThreads, 0, stream>>>(x, dy, mean, inv, out_a, out_b, N,
                                                               C, S, 1);
        return cudaGetLastError();
    }
    float* part_a = partial;
    float* part_b = partial + (long long)C * P;
    reduce_maps<GRAD><<<dim3(C, P), kThreads, 0, stream>>>(x, dy, mean, inv, part_a, part_b, N, C,
                                                           S, P);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    finish<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(part_a, part_b, out_a, out_b,
                                                                   C, P);
    return cudaGetLastError();
}

}  // namespace

// x (N, C, S) float32 -> sum[C], sumsq[C]. `partial` holds 2 * C * P floats
// when P > 1 (else it may be null). Returns the cudaError_t of the launches.
extern "C" int bn_stats(const void* x, void* sum, void* sumsq, void* partial, int N, int C,
                        int S, int P, void* stream) {
    return (int)launch<false>(static_cast<const float*>(x), nullptr, nullptr, nullptr,
                              static_cast<float*>(sum), static_cast<float*>(sumsq),
                              static_cast<float*>(partial), N, C, S, P,
                              static_cast<cudaStream_t>(stream));
}

// x, dy (N, C, S) float32, mean and invstd [C] -> sum_dy[C], sum_dy_xhat[C].
extern "C" int bn_grad_reduce(const void* x, const void* dy, const void* mean, const void* invstd,
                              void* sum_dy, void* sum_dy_xhat, void* partial, int N, int C, int S,
                              int P, void* stream) {
    return (int)launch<true>(static_cast<const float*>(x), static_cast<const float*>(dy),
                             static_cast<const float*>(mean), static_cast<const float*>(invstd),
                             static_cast<float*>(sum_dy), static_cast<float*>(sum_dy_xhat),
                             static_cast<float*>(partial), N, C, S, P,
                             static_cast<cudaStream_t>(stream));
}
