// Train-mode BatchNorm channel reductions, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of cpcsv_tpu/ops/pallas/bn.py:
//
//   bn_stats (_stats_kernel):        a[c] = sum x[n, c, i]     b[c] = sum x[n, c, i]^2
//   bn_grad_reduce (_grad_kernel):   a[c] = sum dy[n, c, i]    b[c] = sum dy[n, c, i] * xhat
//                                    xhat = (x[n, c, i] - mean[c]) * invstd[c]
//
// over an NCHW tensor viewed as (N, C, S), S = H*W (S = 1 for the
// BatchNorm1d of the generator's dense heads), float32 or bfloat16 (x and dy
// of one type, as the Pallas kernels take them at COMPUTE_DTYPE float32 or
// bfloat16), mean and invstd float32, sums in float32.
//
// Bound: bytes. Each input element is read once and takes one or two
// multiply-adds, far below the card's operations-per-byte line. The largest
// shape of a final.yml training step is the generator's upsample4 output,
// (90, 128, 64*64) float32 = 188.7 MB: bn_stats reads it once, 56 us at
// 3.35 TB/s; bn_grad_reduce reads x and dy, 377.5 MB, 113 us. At
// throughput.yml's bfloat16 the same map at IM_BATCH 360 is (360, 128, 4096)
// bfloat16, 377.5 MB: 113 us and 226 us. The step's other shapes are a few
// MB, where one launch is most of the time.
//
// Design. The TPU kernels stream (block, C) tiles of an (M, C) view through
// one core and carry the sums across sequential grid steps. Here one launch
// does all the work, and what each block does is planned on the host from
// the shape and the SM count (ops/cuda/bn.py:plan), which passes the plan
// in as plain ints; `launch` refuses a plan that does not fit the shape.
//   * Streaming: loads are 16 bytes (4 floats or 8 bfloat16s, `VEC`
//     elements) wherever the row length (S, or C when S = 1) is a multiple
//     of VEC and the inputs are 16-byte aligned, else one element;
//     read-only (__ldg). Each element is widened to float32 as it is added
//     (a bfloat16 is the high half of a float32). A reduce_maps thread
//     starts 8 loads (bn_stats; bn_grad_reduce 4 of x and 4 of dy) before
//     it adds, into two accumulator pairs that it combines in a fixed
//     order, so enough bytes are in flight to stream at the card's rate.
//   * S > 1 (reduce_maps): a channel's N*S/vec loads are one flat range;
//     thread t of the channel takes loads t, t + T, t + 2T, ... (T the
//     channel's threads), stepping its row and column without a division.
//     The plan gives the card about two 256-thread blocks an SM: short maps
//     a warp or a few a channel and several channels a block, long maps a
//     block a channel, and where C is too small for that (C = 64 at 64x64,
//     C = 128 at 64x64 and 32x32) a thread block cluster of 4 or 2 blocks a
//     channel. In a cluster each block puts its partial in its own shared
//     memory; after cluster.sync() rank 0 reads them in rank order through
//     distributed shared memory and writes the channel's sums; a second
//     cluster.sync() keeps every block alive until then. No partial buffer,
//     no second kernel, no atomics. Measured on an H100 (sweep_bn.py),
//     more and smaller blocks, or larger clusters, cost more in launch and
//     reduction than they add in bytes in flight.
//   * S = 1 (reduce_rows): x is (N, C) row-major; a block takes 32
//     neighbouring channels, as 8 float4s over 32 row groups (3 rows of
//     N = 90 a thread), 4 loads of 8 bfloat16s over 64 row groups, or 32
//     elements over 8 row groups.
// Within a block the sums are combined in a fixed order (warp shuffles,
// then shared memory), so two launches on one input give the same bits.
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // a block
constexpr int kWarps = kThreads / 32;
constexpr int kRowChannels = 32;  // reduce_rows: channels a block
constexpr int kMaxCluster = 8;

// reduce_rows: rows a thread loads per input before it adds; 2 for loads of
// 8 bfloat16s, whose 8 channels a thread keeps 4 sums each
template <int VEC>
constexpr int kRowUnroll = VEC == 8 ? 2 : 4;

// reduce_maps: loads a thread starts per input before it adds, 8 in all
template <bool GRAD>
constexpr int kUnroll = GRAD ? 4 : 8;

// What one load of VEC elements of T reads: 16 bytes (float4, or uint4 of 8
// bfloat16s) or one element (a bfloat16 as its 16 bits).
template <typename T, int VEC>
using vec_t = std::conditional_t<
    std::is_same_v<T, float>, std::conditional_t<VEC == 4, float4, float>,
    std::conditional_t<VEC == 8, uint4, unsigned short>>;

template <typename T>
constexpr bool vec_ok(int vec) {
    return vec == 1 || vec == 16 / (int)sizeof(T);
}

__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ uint4 load(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ unsigned short load(const unsigned short* p) { return __ldg(p); }

// element k of a load, as a float32 (k is a constant after unrolling)
__device__ __forceinline__ float lane(float v, int) { return v; }
__device__ __forceinline__ float lane(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane(unsigned short v, int) {
    return __uint_as_float((unsigned)v << 16);
}
__device__ __forceinline__ float lane(const uint4& v, int k) {
    const unsigned w = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));  // little-endian pairs
}

// (a, b) += one element's terms; g is dy (GRAD) and unused otherwise
template <bool GRAD>
__device__ __forceinline__ void add(float v, float g, float m, float iv, float& a, float& b) {
    if constexpr (GRAD) {
        a += g;
        b = fmaf(g, (v - m) * iv, b);
    } else {
        a += v;
        b = fmaf(v, v, b);
    }
}

// S > 1. Block = kThreads threads, `cpb` channels of kThreads / cpb threads
// each; `cluster` consecutive blocks (one cluster) share one channel, and
// then cpb == 1. Block g * cluster + r holds channels g * cpb ...
template <bool GRAD, typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
reduce_maps(const T* __restrict__ x, const T* __restrict__ dy,
            const float* __restrict__ mean, const float* __restrict__ inv,
            float* __restrict__ out_a, float* __restrict__ out_b, int N, int C, int S, int cpb,
            int cluster) {
    using V = vec_t<T, VEC>;
    constexpr int U = kUnroll<GRAD>;
    const int tpc = kThreads / cpb;  // threads a channel has in this block
    const int group = blockIdx.x / cluster, rank = blockIdx.x - group * cluster;
    const int lc = threadIdx.x / tpc, lt = threadIdx.x - lc * tpc;
    const int c = group * cpb + lc;
    float a0 = 0.0f, b0 = 0.0f, a1 = 0.0f, b1 = 0.0f;
    if (c < C) {
        float m = 0.0f, iv = 0.0f;
        if constexpr (GRAD) {
            m = mean[c];
            iv = inv[c];
        }
        const long long sv = S / VEC;            // loads a row
        const long long row = (long long)C * sv;  // from row n to row n + 1
        const long long items = (long long)N * sv;
        const long long stride = (long long)cluster * tpc;
        const V* xv = reinterpret_cast<const V*>(x) + (long long)c * sv;
        const V* dv = GRAD ? reinterpret_cast<const V*>(dy) + (long long)c * sv : nullptr;
        const long long j = (long long)rank * tpc + lt;  // this thread's first load
        const long long dn = stride / sv, ds = stride - dn * sv;
        long long s = j % sv;
        long long off = (j / sv) * row + s;
        // batches of U loads, the last one short: a batch's loads are all
        // started before its adds wait on them
        for (long long left = j < items ? (items - j + stride - 1) / stride : 0; left > 0;
             left -= U) {
            const int here = left < U ? (int)left : U;
            V v[U], g[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (u < here) {
                    v[u] = load(xv + off);
                    if constexpr (GRAD) g[u] = load(dv + off);
                    off += dn * row + ds;
                    s += ds;
                    if (s >= sv) {
                        s -= sv;
                        off += row - sv;
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (u < here) {
#pragma unroll
                    for (int k = 0; k < VEC; ++k) {
                        const float gk = GRAD ? lane(g[u], k) : 0.0f;
                        if (u & 1)
                            add<GRAD>(lane(v[u], k), gk, m, iv, a1, b1);
                        else
                            add<GRAD>(lane(v[u], k), gk, m, iv, a0, b0);
                    }
                }
            }
        }
    }
    float a = a0 + a1, b = b0 + b1;
    // a channel's threads are whole warps (tpc >= 32): sum each warp, then
    // the first thread of each channel sums its warps in order
    for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, o);
        b += __shfl_down_sync(0xffffffffu, b, o);
    }
    __shared__ float sa[kWarps], sb[kWarps];
    __shared__ float part[2];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        sa[warp] = a;
        sb[warp] = b;
    }
    __syncthreads();
    if (lt == 0) {
        const int wpc = tpc >> 5;
        a = 0.0f;
        b = 0.0f;
        for (int w = lc * wpc; w < (lc + 1) * wpc; ++w) {
            a += sa[w];
            b += sb[w];
        }
        if (cluster == 1) {
            if (c < C) {
                out_a[c] = a;
                out_b[c] = b;
            }
        } else {
            part[0] = a;
            part[1] = b;
        }
    }
    if (cluster > 1) {  // the same for every block of the launch
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();  // every block's part is in its shared memory
        if (cl.block_rank() == 0 && threadIdx.x == 0 && c < C) {
            a = 0.0f;
            b = 0.0f;
            for (int r = 0; r < cluster; ++r) {
                const float* p = cl.map_shared_rank(part, r);
                a += p[0];
                b += p[1];
            }
            out_a[c] = a;
            out_b[c] = b;
        }
        cl.sync();  // no block leaves while rank 0 reads its shared memory
    }
}

// S = 1. Grid ceil(C / kRowChannels), 1-D blocks of kThreads seen as
// (Q, R): Q = kRowChannels / VEC lanes along the channels and R row
// groups. Thread (tx, ty) loads channels VEC * q ... VEC * q + VEC - 1,
// q = blockIdx.x * Q + tx, from rows ty, ty + R, ...; float4 loads (Q = 8,
// R = 32) leave a thread 3 rows of N = 90, one batch. At most 64 registers
// a thread, so that an SM holds 4 blocks: the 1,024 blocks of the widest
// dense head (C = 32,768) then run in 2 waves, not 3.
template <bool GRAD, typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
reduce_rows(const T* __restrict__ x, const T* __restrict__ dy,
            const float* __restrict__ mean, const float* __restrict__ inv,
            float* __restrict__ out_a, float* __restrict__ out_b, int N, int C) {
    using V = vec_t<T, VEC>;
    constexpr int U = kRowUnroll<VEC>;
    constexpr int Q = kRowChannels / VEC, R = kThreads / Q;
    __shared__ float sa[R][kRowChannels + 1], sb[R][kRowChannels + 1];
    const int tx = threadIdx.x % Q, ty = threadIdx.x / Q;
    const int cv = C / VEC;
    const int q = blockIdx.x * Q + tx;
    float a[VEC], b[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = b[k] = 0.0f;
    if (q < cv) {
        float m[VEC], iv[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            m[k] = GRAD ? mean[q * VEC + k] : 0.0f;
            iv[k] = GRAD ? inv[q * VEC + k] : 0.0f;
        }
        const V* xv = reinterpret_cast<const V*>(x) + q;
        const V* dv = GRAD ? reinterpret_cast<const V*>(dy) + q : nullptr;
        // batches of kRowUnroll rows, the last one short, as in reduce_maps
        for (int n = ty; n < N; n += U * R) {
            V v[U], g[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (n + u * R < N) {
                    const long long off = (long long)(n + u * R) * cv;
                    v[u] = load(xv + off);
                    if constexpr (GRAD) g[u] = load(dv + off);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (n + u * R < N) {
#pragma unroll
                    for (int k = 0; k < VEC; ++k)
                        add<GRAD>(lane(v[u], k), GRAD ? lane(g[u], k) : 0.0f, m[k], iv[k],
                                  a[k], b[k]);
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        sa[ty][tx * VEC + k] = a[k];
        sb[ty][tx * VEC + k] = b[k];
    }
    __syncthreads();
    // thread t < kRowChannels sums channel t's R row groups in order
    const int c = blockIdx.x * kRowChannels + threadIdx.x;
    if (threadIdx.x < kRowChannels && c < C) {
        float sum_a = 0.0f, sum_b = 0.0f;
        for (int y = 0; y < R; ++y) {
            sum_a += sa[y][threadIdx.x];
            sum_b += sb[y][threadIdx.x];
        }
        out_a[c] = sum_a;
        out_b[c] = sum_b;
    }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <bool GRAD, typename T, int VEC>
cudaError_t launch_maps(const T* x, const T* dy, const float* mean, const float* inv,
                        float* out_a, float* out_b, int N, int C, int S, int grid, int cluster,
                        int cpb, cudaStream_t stream) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(grid);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = 0;
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = cluster > 1 ? 1 : 0;
    return cudaLaunchKernelEx(&config, reduce_maps<GRAD, T, VEC>, x, dy, mean, inv, out_a, out_b,
                              N, C, S, cpb, cluster);
}

// The plan's ints, checked against the shape: vec elements a load, 16
// bytes (4 floats, 8 bfloat16s) or 1; grid blocks; cluster blocks a channel
// (maps); channels a block.
template <bool GRAD, typename T>
cudaError_t launch(const T* x, const T* dy, const float* mean, const float* inv,
                   float* out_a, float* out_b, int N, int C, int S, int vec, int grid,
                   int cluster, int channels, cudaStream_t stream) {
    constexpr int W = 16 / (int)sizeof(T);  // elements of a 16-byte load
    if (N < 1 || C < 1 || S < 1 || !vec_ok<T>(vec)) return cudaErrorInvalidValue;
    if (vec == W && !(aligned16(x) && (!GRAD || aligned16(dy)) && (S == 1 ? C : S) % W == 0))
        return cudaErrorInvalidValue;
    if (S == 1) {
        if (cluster != 1 || channels != kRowChannels || grid != (C + channels - 1) / channels)
            return cudaErrorInvalidValue;
        if (vec == W)
            reduce_rows<GRAD, T, W><<<grid, kThreads, 0, stream>>>(x, dy, mean, inv, out_a, out_b,
                                                                   N, C);
        else
            reduce_rows<GRAD, T, 1><<<grid, kThreads, 0, stream>>>(x, dy, mean, inv, out_a, out_b,
                                                                   N, C);
        return cudaGetLastError();
    }
    const bool cpb_ok = channels == 1 || channels == 2 || channels == 4 || channels == 8;
    if (!cpb_ok || cluster < 1 || cluster > kMaxCluster || (cluster > 1 && channels != 1) ||
        (long long)grid != (long long)((C + channels - 1) / channels) * cluster)
        return cudaErrorInvalidValue;
    const cudaError_t err = vec == W
        ? launch_maps<GRAD, T, W>(x, dy, mean, inv, out_a, out_b, N, C, S, grid, cluster,
                                  channels, stream)
        : launch_maps<GRAD, T, 1>(x, dy, mean, inv, out_a, out_b, N, C, S, grid, cluster,
                                  channels, stream);
    const cudaError_t last = cudaGetLastError();  // read, so that it does not linger
    return err != cudaSuccess ? err : last;
}

// dtype 0: float32, 1: bfloat16 (x and dy); mean and invstd float32
template <bool GRAD>
cudaError_t dispatch(int dtype, const void* x, const void* dy, const void* mean,
                     const void* inv, void* out_a, void* out_b, int N, int C, int S, int vec,
                     int grid, int cluster, int channels, void* stream) {
    const float* m = static_cast<const float*>(mean);
    const float* iv = static_cast<const float*>(inv);
    float* a = static_cast<float*>(out_a);
    float* b = static_cast<float*>(out_b);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch<GRAD, float>(static_cast<const float*>(x), static_cast<const float*>(dy), m,
                                   iv, a, b, N, C, S, vec, grid, cluster, channels, s);
    if (dtype == 1)
        return launch<GRAD, __nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                                           static_cast<const __nv_bfloat16*>(dy), m, iv, a, b, N,
                                           C, S, vec, grid, cluster, channels, s);
    return cudaErrorInvalidValue;
}

}  // namespace

// x (N, C, S) of `dtype` -> sum[C], sumsq[C] float32, one launch of the plan
// (vec, grid, cluster, channels) from ops/cuda/bn.py:plan. Returns the
// cudaError_t of the launch.
extern "C" int bn_stats(const void* x, void* sum, void* sumsq, int N, int C, int S, int dtype,
                        int vec, int grid, int cluster, int channels, void* stream) {
    return (int)dispatch<false>(dtype, x, nullptr, nullptr, nullptr, sum, sumsq, N, C, S, vec,
                                grid, cluster, channels, stream);
}

// x, dy (N, C, S) of `dtype`, mean and invstd [C] float32 -> sum_dy[C],
// sum_dy_xhat[C] float32.
extern "C" int bn_grad_reduce(const void* x, const void* dy, const void* mean, const void* invstd,
                              void* sum_dy, void* sum_dy_xhat, int N, int C, int S, int dtype,
                              int vec, int grid, int cluster, int channels, void* stream) {
    return (int)dispatch<true>(dtype, x, dy, mean, invstd, sum_dy, sum_dy_xhat, N, C, S, vec,
                               grid, cluster, channels, stream);
}
