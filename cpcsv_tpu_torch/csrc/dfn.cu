// Per-sample dynamic-filter 1-D cross-correlation, forward and backward, for
// Hopper (sm_90a).
//
// dfn_forward replaces the TPU kernel cpcsv_tpu/ops/pallas/dfn.py:dfn_pallas
// (body _dfn_kernel):
//
//   out[b, x] = sum_c sum_k pad(img)[b, c, x + k] * filt[b, 0, c, k]
//   img (B, C, L), filt (B, 1, C, K), out (B, 1, L_out), L_out = L + 2*pad - K + 1
//
// dfn_backward has no Pallas counterpart (the JAX package differentiates its
// einsum path, cpcsv_tpu/ops/dynamic_filter.py, through XLA):
//
//   dfilt[b, 0, c, k] = sum_x dout[b, x] * pad(img)[b, c, x + k]
//   dimg[b, c, j]     = sum_k dout[b, j + pad - k] * filt[b, 0, c, k]
//
// Both take float32 or bfloat16 (one type for all of a call's tensors, as
// the JAX package runs the op at COMPUTE_DTYPE), sum in float32 and round
// each output once. The generator calls them with C = 3, L = 124, K = 21,
// pad = 10 and B = 90 (360 at throughput.yml's IM_BATCH, 1440 in the largest
// serving call). Bound: bytes, 0.06 us (forward) and
// 0.11 us (backward) at B = 90 over 3.35 TB/s, far below the card's cost of
// one launch (chip_smoke.py measures it: an empty kernel in a CUDA graph).
// So both kernels are latency- and launch-bound: what counts is the critical
// path of one sample, not throughput. The design shortens that path:
//
// - One warp owns one sample (forward) or one (sample, channel) (backward),
//   several warps a block (`warps`, chosen with `grid` by ops/cuda/dfn.py:plan
//   from B and the SM count). A warp stages its zero-padded rows in its own
//   slice of shared memory, so only __syncwarp orders staging and compute;
//   no block-wide barrier. A lane issues all of its global loads before it
//   stores any of them, so the warp waits on memory once, not once a row.
// - Rows are read with 16-byte loads (8 bytes for bfloat16) where the rows
//   start aligned and L % 4 == 0 (`vec` == 4), else element by element.
// - Each lane computes kR = 4 adjacent outputs from a register window of
//   kR + K - 1 row values (float4 loads from shared memory, conflict-free),
//   so kR independent accumulators and no serial chain over K loads.
// - The tap loops are instantiated for (C, K) = (3, 21) and (3, 7), so they
//   unroll with the taps in registers; any other (C, K) runs the runtime-K
//   instantiation (`taps` == 0), the same scheme with a sliding window.
// - dfilt: each lane sums its stripe of x for all K taps in registers, then
//   the warp reduce-scatters them in a fixed butterfly order
//   (__shfl_xor_sync); no float atomics, so two launches give the same bits.
// - dimg correlates dout, zero-padded, with the reversed taps: the same
//   register window as the forward.
// - dout may have any row stride (`dout_stride`, elements), with unit stride
//   along x: the G step's dout is a column slice of the gradient of a
//   (B, 613) concatenation and reaches the kernel without a copy.
//
// It launches on the caller's stream, does not synchronise and allocates
// nothing; the Python wrapper (ops/cuda/dfn.py) checks shapes, dtypes and
// strides, picks the plan and allocates the outputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kR = 4;                    // adjacent outputs a lane
constexpr int kChunk = kLanes * kR;      // outputs a warp pass
constexpr int kMaxWarps = 32;            // 1,024 threads a block

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int chunks(int n) { return (n + kChunk - 1) / kChunk; }

// One warp's slice of shared memory, in floats; every part starts 16-byte
// aligned. Mirrored by ops/cuda/dfn.py:warp_floats.
struct Layout {
    int L_out;
    int row;          // one zero-padded image row: pad(img)[p] at p
    int og;           // backward: dout[x] at g[og + x], zeros around it
    int db;           // backward: dimg window of j starts at g[db + j]
    int g;            // backward: length of the staged dout
    int warp_floats;  // forward: C rows + C*K taps; backward: a row, g, K taps
};

__host__ __device__ inline Layout layout(int C, int L, int K, int pad, bool backward) {
    Layout s;
    s.L_out = L + 2 * pad - K + 1;
    // windows read [x0, x0 + round4(kR + K - 1)), x0 < chunks * kChunk
    s.row = chunks(s.L_out) * kChunk + round4(K + 3);
    const int front = K - 1 - pad;  // dout's offset in its padded row
    s.og = front >= 0 ? front : ((front % 4) + 4) % 4;
    s.db = s.og - front;  // a multiple of 4, >= 0
    const int reach = s.og + chunks(s.L_out) * kChunk > s.db + chunks(L) * kChunk
                          ? s.og + chunks(s.L_out) * kChunk
                          : s.db + chunks(L) * kChunk;
    s.g = round4(reach + K + 3);
    s.warp_floats = backward ? s.row + s.g + round4(K) : C * s.row + round4(C * K);
    return s;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// four elements from an address aligned to four elements
__device__ __forceinline__ void load4(const float* p, float v[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<unsigned*>(&lo);
    q.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
}

// kR outputs from o[0, n): four at once where the row allows, else masked
template <typename T>
__device__ __forceinline__ void store_outputs(T* o, const float acc[kR], int n, bool aligned4) {
    if (aligned4 && n >= kR) {
        store4(o, acc);
    } else {
#pragma unroll
        for (int r = 0; r < kR; ++r)
            if (r < n) o[r] = from_float<T>(acc[r]);
    }
}

// Staging. A warp waits on device memory once, not once a row: every lane
// first issues all of its loads of a row's first kChunk elements (rows
// apart by L in src), the first kHead·32 taps and the first kChunk dout
// values, into registers, then stores them to shared memory. What lies
// beyond (longer rows, more taps) is copied after, one element a lane at a
// time; at the model's shapes there is nothing beyond.
constexpr int kHead = 2;  // tap loads a lane in the first round

// this lane's 4 of the first kChunk elements of each of NC rows: one
// 16-byte load (vec) at 4·lane, else 4 loads at lane + 32u
template <typename T, int NC>
__device__ __forceinline__ void load_heads(const T* src, int L, bool vec, int lane,
                                           float (&v)[NC][4]) {
    if (vec) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
            if (4 * lane < L) load4(src + c * L + 4 * lane, v[c]);
    } else {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int i = lane + u * kLanes;
                v[c][u] = i < L ? to_float(src[c * L + i]) : 0.0f;
            }
    }
}

// stores what load_heads loaded at s[c·row + pad + i]
template <int NC>
__device__ __forceinline__ void store_heads(float* s, int row, int L, int pad, bool vec, int lane,
                                            const float (&v)[NC][4]) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        float* r = s + c * row + pad;
        if (vec) {
            if (4 * lane < L) {
#pragma unroll
                for (int j = 0; j < 4; ++j) r[4 * lane + j] = v[c][j];
            }
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (lane + u * kLanes < L) r[lane + u * kLanes] = v[c][u];
        }
    }
}

// rows from element kChunk on
template <typename T>
__device__ __forceinline__ void stage_tails(float* s, int row, const T* src, int C, int L, int pad,
                                            int lane) {
    for (int c = 0; c < C; ++c)
        for (int i = kChunk + lane; i < L; i += kLanes) s[c * row + pad + i] = to_float(src[c * L + i]);
}

// zeros at [0, pad) and [pad + L, row) of each of C rows
__device__ __forceinline__ void zero_pads(float* s, int row, int C, int L, int pad, int lane) {
    for (int c = 0; c < C; ++c)
        for (int t = lane; t < row; t += kLanes)
            if (t < pad || t >= pad + L) s[c * row + t] = 0.0f;
}

// acc[r] += sum_k s[r + k] * f[k], r < kR; s is 16-byte aligned in shared
// memory. KT > 0: K = KT taps, unrolled, the window in registers; KT == 0:
// runtime K, the window slides one value a tap.
template <int KT>
__device__ __forceinline__ void correlate(const float* s, const float* f, int K, float acc[kR]) {
    if constexpr (KT > 0) {
        constexpr int NW = round4(kR + KT - 1);
        float w[NW];
#pragma unroll
        for (int v = 0; v < NW / 4; ++v) {
            const float4 q = reinterpret_cast<const float4*>(s)[v];
            w[4 * v] = q.x; w[4 * v + 1] = q.y; w[4 * v + 2] = q.z; w[4 * v + 3] = q.w;
        }
#pragma unroll
        for (int k = 0; k < KT; ++k) {
            const float fk = f[k];
#pragma unroll
            for (int r = 0; r < kR; ++r) acc[r] = fmaf(w[r + k], fk, acc[r]);
        }
    } else {
        float w[kR];
#pragma unroll
        for (int r = 0; r < kR - 1; ++r) w[r] = s[r];
        for (int k = 0; k < K; ++k) {
            w[kR - 1] = s[k + kR - 1];
            const float fk = f[k];
#pragma unroll
            for (int r = 0; r < kR; ++r) acc[r] = fmaf(w[r], fk, acc[r]);
#pragma unroll
            for (int r = 0; r < kR - 1; ++r) w[r] = w[r + 1];
        }
    }
}

// Sums a[0, N) over the warp's 32 lanes in a fixed butterfly order, lane
// bit O = 16, 8, ..., 1; after it, a[0] of lane l holds the sum of index
// l % N. N is a power of two <= 32: across lane bits >= N every lane adds its
// partner's N values, below N each step keeps half of the values and adds
// the partner's copy of that half. O is a template argument so that every
// index is a constant and a[] stays in registers: written as a loop over O,
// nvcc kept part of it a loop and indexed a[] through chains of predicated
// moves.
template <int O, int N>
__device__ __forceinline__ void reduce_scatter(float (&a)[N], int lane) {
    if constexpr (O >= N) {
#pragma unroll
        for (int i = 0; i < N; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], O);
    } else {
        const bool up = (lane & O) != 0;
#pragma unroll
        for (int i = 0; i < O; ++i) {
            const float send = up ? a[i] : a[i + O];
            const float keep = up ? a[i + O] : a[i];
            a[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
        }
    }
    if constexpr (O > 1) reduce_scatter<O / 2, N>(a, lane);
}

__host__ __device__ constexpr int pow2_at_least(int n) {
    return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// One warp a sample. KT, CT > 0: the compile-time taps and channels.
template <typename T, int KT, int CT>
__global__ void dfn_forward_kernel(const T* __restrict__ img, const T* __restrict__ filt,
                                   T* __restrict__ out, int B, int C_, int L, int K_, int pad,
                                   int vec) {
    const int C = CT > 0 ? CT : C_;
    const int K = KT > 0 ? KT : K_;
    const Layout lay = layout(C, L, K, pad, false);
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
    const long long b = (long long)blockIdx.x * (blockDim.x / kLanes) + warp;
    if (b >= B) return;  // the whole warp
    float* rows = smem + (size_t)warp * lay.warp_floats;
    float* f = rows + C * lay.row;
    const T* img_b = img + b * C * L;
    const T* filt_b = filt + b * C * K;
    float fv[kHead];
#pragma unroll
    for (int u = 0; u < kHead; ++u) {
        const int i = lane + u * kLanes;
        fv[u] = i < C * K ? to_float(filt_b[i]) : 0.0f;
    }
    if constexpr (CT > 0) {  // all C rows' loads in flight at once
        float v[CT][4];
        load_heads<T, CT>(img_b, L, vec == 4, lane, v);
        zero_pads(rows, lay.row, C, L, pad, lane);
        store_heads<CT>(rows, lay.row, L, pad, vec == 4, lane, v);
    } else {
        zero_pads(rows, lay.row, C, L, pad, lane);
        for (int c = 0; c < C; ++c) {
            float v[1][4];
            load_heads<T, 1>(img_b + c * L, L, vec == 4, lane, v);
            store_heads<1>(rows + c * lay.row, lay.row, L, pad, vec == 4, lane, v);
        }
    }
#pragma unroll
    for (int u = 0; u < kHead; ++u)
        if (lane + u * kLanes < C * K) f[lane + u * kLanes] = fv[u];
    stage_tails(rows, lay.row, img_b, C, L, pad, lane);
    for (int i = kHead * kLanes + lane; i < C * K; i += kLanes) f[i] = to_float(filt_b[i]);
    __syncwarp();

    for (int x0 = lane * kR; x0 < lay.L_out; x0 += kChunk) {
        float acc[kR] = {};
#pragma unroll
        for (int c = 0; c < C; ++c) correlate<KT>(rows + c * lay.row + x0, f + c * K, K, acc);
        store_outputs(out + b * lay.L_out + x0, acc, lay.L_out - x0, lay.L_out % 4 == 0);
    }
}

// One warp a (sample, channel).
template <typename T, int KT, int CT>
__global__ void dfn_backward_kernel(const T* __restrict__ img, const T* __restrict__ filt,
                                    const T* __restrict__ dout, T* __restrict__ dimg,
                                    T* __restrict__ dfilt, int B, int C_, int L, int K_,
                                    int pad, long long dout_stride, int vec) {
    const int C = CT > 0 ? CT : C_;
    const int K = KT > 0 ? KT : K_;
    const Layout lay = layout(C, L, K, pad, true);
    extern __shared__ __align__(16) float smem[];
    const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
    const long long item = (long long)blockIdx.x * (blockDim.x / kLanes) + warp;
    if (item >= (long long)B * C) return;  // the whole warp
    const long long b = item / C;
    float* row = smem + (size_t)warp * lay.warp_floats;
    float* g = row + lay.row;
    float* fr = g + lay.g;  // the taps reversed
    const T* img_i = img + item * L;
    const T* filt_i = filt + item * K;
    const T* d = dout + b * dout_stride;
    // the row, dout and the taps: all loads in flight before any store
    float v[1][4], gv[4], fv[kHead];
    load_heads<T, 1>(img_i, L, vec == 4, lane, v);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int x = lane + u * kLanes;
        gv[u] = x < lay.L_out ? to_float(d[x]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kHead; ++u) {
        const int k = lane + u * kLanes;
        fv[u] = k < K ? to_float(filt_i[k]) : 0.0f;
    }
    zero_pads(row, lay.row, 1, L, pad, lane);
    zero_pads(g, lay.g, 1, lay.L_out, lay.og, lane);
    store_heads<1>(row, lay.row, L, pad, vec == 4, lane, v);
#pragma unroll
    for (int u = 0; u < 4; ++u)
        if (lane + u * kLanes < lay.L_out) g[lay.og + lane + u * kLanes] = gv[u];
#pragma unroll
    for (int u = 0; u < kHead; ++u)
        if (lane + u * kLanes < K) fr[K - 1 - lane - u * kLanes] = fv[u];
    stage_tails(row, lay.row, img_i, 1, L, pad, lane);
    for (int x = kChunk + lane; x < lay.L_out; x += kLanes) g[lay.og + x] = to_float(d[x]);
    for (int k = kHead * kLanes + lane; k < K; k += kLanes) fr[K - 1 - k] = to_float(filt_i[k]);
    __syncwarp();

    // dimg[j] = sum_k' g[db + j + k'] * fr[k']
    for (int j0 = lane * kR; j0 < L; j0 += kChunk) {
        float acc[kR] = {};
        correlate<KT>(g + lay.db + j0, fr, K, acc);
        store_outputs(dimg + item * L + j0, acc, L - j0, L % 4 == 0);
    }

    // dfilt[k] = sum_x g[og + x] * row[x + k], each lane over its stripes of x
    if constexpr (KT > 0) {
        constexpr int NP = pow2_at_least(KT);
        static_assert(NP <= kLanes, "compile-time taps take K <= 32");
        constexpr int NW = round4(kR + KT - 1);
        float acc[NP] = {};
        for (int x0 = lane * kR; x0 < lay.L_out; x0 += kChunk) {
            float w[NW];
#pragma unroll
            for (int i = 0; i < NW / 4; ++i) {
                const float4 q = reinterpret_cast<const float4*>(row + x0)[i];
                w[4 * i] = q.x; w[4 * i + 1] = q.y; w[4 * i + 2] = q.z; w[4 * i + 3] = q.w;
            }
            float gx[kR];
#pragma unroll
            for (int r = 0; r < kR; ++r) gx[r] = g[lay.og + x0 + r];
#pragma unroll
            for (int k = 0; k < KT; ++k)
#pragma unroll
                for (int r = 0; r < kR; ++r) acc[k] = fmaf(gx[r], w[r + k], acc[k]);
        }
        reduce_scatter<kLanes / 2, NP>(acc, lane);
        if (lane < KT) dfilt[item * K + lane] = from_float<T>(acc[0]);
    } else {
        for (int k = 0; k < K; ++k) {
            float p = 0.0f;
            for (int x0 = lane * kR; x0 < lay.L_out; x0 += kChunk)
#pragma unroll
                for (int r = 0; r < kR; ++r) p = fmaf(g[lay.og + x0 + r], row[x0 + r + k], p);
#pragma unroll
            for (int o = kLanes / 2; o >= 1; o /= 2) p += __shfl_xor_sync(0xffffffffu, p, o);
            if (lane == 0) dfilt[item * K + k] = from_float<T>(p);
        }
    }
}

template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// what every launch checks of the plan: a block of 1-32 warps, enough
// warps for the items, 16-byte rows only where they are aligned, and an
// instantiation that exists for (C, K)
bool plan_fits(long long items, int C, int L, int K, int warps, int grid, int vec, int taps,
               const void* rows, size_t vec_bytes) {
    if (warps < 1 || warps > kMaxWarps || grid < 1 || (long long)grid * warps < items) return false;
    if (vec != 1 && vec != 4) return false;
    if (vec == 4 && (L % 4 != 0 || reinterpret_cast<uintptr_t>(rows) % vec_bytes != 0)) return false;
    return taps == 0 || (C == 3 && taps == K && (K == 21 || K == 7));
}

template <typename T, int KT, int CT>
cudaError_t launch_forward(const void* img, const void* filt, void* out, int B, int C, int L,
                           int K, int pad, int warps, int grid, int vec, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)layout(C, L, K, pad, false).warp_floats * warps;
    const cudaError_t err = reserve_smem(dfn_forward_kernel<T, KT, CT>, smem);
    if (err != cudaSuccess) return err;
    dfn_forward_kernel<T, KT, CT><<<grid, warps * kLanes, smem, stream>>>(
        static_cast<const T*>(img), static_cast<const T*>(filt), static_cast<T*>(out), B, C, L, K,
        pad, vec);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_forward(const void* img, const void* filt, void* out, int B, int C, int L,
                             int K, int pad, int warps, int grid, int vec, int taps,
                             cudaStream_t s) {
    if (!plan_fits(B, C, L, K, warps, grid, vec, taps, img, 4 * sizeof(T)))
        return cudaErrorInvalidValue;
    if (taps == 21) return launch_forward<T, 21, 3>(img, filt, out, B, C, L, K, pad, warps, grid, vec, s);
    if (taps == 7) return launch_forward<T, 7, 3>(img, filt, out, B, C, L, K, pad, warps, grid, vec, s);
    return launch_forward<T, 0, 0>(img, filt, out, B, C, L, K, pad, warps, grid, vec, s);
}

template <typename T, int KT, int CT>
cudaError_t launch_backward(const void* img, const void* filt, const void* dout, void* dimg,
                            void* dfilt, int B, int C, int L, int K, int pad,
                            long long dout_stride, int warps, int grid, int vec,
                            cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)layout(C, L, K, pad, true).warp_floats * warps;
    const cudaError_t err = reserve_smem(dfn_backward_kernel<T, KT, CT>, smem);
    if (err != cudaSuccess) return err;
    dfn_backward_kernel<T, KT, CT><<<grid, warps * kLanes, smem, stream>>>(
        static_cast<const T*>(img), static_cast<const T*>(filt), static_cast<const T*>(dout),
        static_cast<T*>(dimg), static_cast<T*>(dfilt), B, C, L, K, pad, dout_stride, vec);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_backward(const void* img, const void* filt, const void* dout, void* dimg,
                              void* dfilt, int B, int C, int L, int K, int pad,
                              long long dout_stride, int warps, int grid, int vec, int taps,
                              cudaStream_t s) {
    if (!plan_fits((long long)B * C, C, L, K, warps, grid, vec, taps, img, 4 * sizeof(T)))
        return cudaErrorInvalidValue;
    if (taps == 21)
        return launch_backward<T, 21, 3>(img, filt, dout, dimg, dfilt, B, C, L, K, pad,
                                          dout_stride, warps, grid, vec, s);
    if (taps == 7)
        return launch_backward<T, 7, 3>(img, filt, dout, dimg, dfilt, B, C, L, K, pad,
                                         dout_stride, warps, grid, vec, s);
    return launch_backward<T, 0, 0>(img, filt, dout, dimg, dfilt, B, C, L, K, pad, dout_stride,
                                    warps, grid, vec, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; warps, grid, vec, taps: the plan
// (ops/cuda/dfn.py:plan). Returns the cudaError_t of the launch.
extern "C" int dfn_forward(const void* img, const void* filt, void* out, int B, int C, int L,
                           int K, int pad, int dtype, int warps, int grid, int vec, int taps,
                           void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)dispatch_forward<float>(img, filt, out, B, C, L, K, pad, warps, grid, vec,
                                            taps, s);
    if (dtype == 1)
        return (int)dispatch_forward<__nv_bfloat16>(img, filt, out, B, C, L, K, pad, warps, grid,
                                                    vec, taps, s);
    return (int)cudaErrorInvalidValue;
}

// dtype as dfn_forward's, for every tensor: img (B, C, L), filt (B, 1, C, K),
// dout (B, 1, L_out) with unit stride along x and rows dout_stride elements
// apart -> dimg (B, C, L), dfilt (B, 1, C, K). Returns the cudaError_t of
// the launch.
extern "C" int dfn_backward(const void* img, const void* filt, const void* dout, void* dimg,
                            void* dfilt, int B, int C, int L, int K, int pad,
                            long long dout_stride, int dtype, int warps, int grid, int vec,
                            int taps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)dispatch_backward<float>(img, filt, dout, dimg, dfilt, B, C, L, K, pad,
                                             dout_stride, warps, grid, vec, taps, s);
    if (dtype == 1)
        return (int)dispatch_backward<__nv_bfloat16>(img, filt, dout, dimg, dfilt, B, C, L, K,
                                                     pad, dout_stride, warps, grid, vec, taps, s);
    return (int)cudaErrorInvalidValue;
}
