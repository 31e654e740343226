// Per-sample dynamic-filter 1-D cross-correlation, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel cpcsv_tpu/ops/pallas/dfn.py:_dfn_kernel (dfn_pallas):
//
//   out[b, x] = sum_c sum_k pad(img)[b, c, x + k] * filt[b, 0, c, k]
//   img (B, C, L), filt (B, 1, C, K), out (B, 1, L_out), L_out = L + 2*pad - K + 1
//
// The generator calls it once per forward with C = 3, L = 124, K = 21, pad = 10
// and B = frames (stories * 5).
//
// Bound: the work is tiny, B * L_out * C * K multiply-adds (B * 7,812 at the
// model's shape, 1.4 MFLOP at B = 90), against B * (C*L + C*K + L_out) elements
// moved (B * 559; 201,240 bytes in f32 at B = 90, 60 ns at 3.35 TB/s; 3.2 MB,
// 0.96 us at B = 1440). So the kernel is bound by memory and, at these sizes,
// by launch latency. Design: one block per sample; the block stages the
// zero-padded row C x (L + 2*pad) and the C x K filter in shared memory as
// float (each input element is read from device memory once), then each thread
// computes output positions x = tid, tid + blockDim, ... with a float
// accumulator. No TPU tiling (batch padding, (8, 128) blocks) is carried over.
//
// It launches on the caller's stream, does not synchronise and allocates
// nothing; the Python wrapper (ops/cuda/dfn.py) checks shapes and dtypes and
// allocates the output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

template <typename T>
__global__ void dfn_forward_kernel(const T* __restrict__ img, const T* __restrict__ filt,
                                   T* __restrict__ out, int C, int L, int K, int pad, int L_out) {
    extern __shared__ float smem[];
    const int Lp = L + 2 * pad;
    float* row = smem;         // C * Lp, zero-padded
    float* f = smem + C * Lp;  // C * K
    const long long b = blockIdx.x;
    const T* img_b = img + b * C * L;
    const T* filt_b = filt + b * C * K;

    for (int i = threadIdx.x; i < C * Lp; i += blockDim.x) {
        const int c = i / Lp;
        const int x = i - c * Lp - pad;
        row[i] = (x >= 0 && x < L) ? to_float(img_b[c * L + x]) : 0.0f;
    }
    for (int i = threadIdx.x; i < C * K; i += blockDim.x) f[i] = to_float(filt_b[i]);
    __syncthreads();

    for (int x = threadIdx.x; x < L_out; x += blockDim.x) {
        float acc = 0.0f;
        for (int c = 0; c < C; ++c) {
            const float* r = row + c * Lp + x;
            const float* fc = f + c * K;
            for (int k = 0; k < K; ++k) acc = fmaf(r[k], fc[k], acc);
        }
        out[b * L_out + x] = from_float<T>(acc);
    }
}

template <typename T>
cudaError_t launch(const void* img, const void* filt, void* out, int B, int C, int L, int K,
                   int pad, cudaStream_t stream) {
    const int L_out = L + 2 * pad - K + 1;
    const size_t smem = sizeof(float) * ((size_t)C * (L + 2 * pad) + (size_t)C * K);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            dfn_forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    int threads = ((L_out + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    dfn_forward_kernel<T><<<B, threads, smem, stream>>>(
        static_cast<const T*>(img), static_cast<const T*>(filt), static_cast<T*>(out), C, L, K,
        pad, L_out);
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int dfn_forward(const void* img, const void* filt, void* out, int B, int C, int L,
                           int K, int pad, int dtype, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch<float>(img, filt, out, B, C, L, K, pad, s);
    if (dtype == 1) return (int)launch<__nv_bfloat16>(img, filt, out, B, C, L, K, pad, s);
    return (int)cudaErrorInvalidValue;
}
