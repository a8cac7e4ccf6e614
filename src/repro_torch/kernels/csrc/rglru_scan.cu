// RG-LRU scan (diagonal linear recurrence) for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel rglru_scan (_rglru_kernel) of
// src/repro/kernels/rglru_scan.py:
//
//   h_t = a_t * h_{t-1} + b_t        per channel, a clamped to [1e-37, 1]
//
// over a, b (B, T, W) in fp32 or bf16 and h0 (B, W) fp32 (or none: zero);
// h (B, T, W) in a's type, h_T (B, W) fp32. The clamp is the TPU kernel's
// (it clamps before taking logs); within the contract a in (0, 1] it
// changes nothing.
//
// What is ported is the function. The TPU kernel's chunked form (a (C, C)
// tile of exp(cum_t - cum_s) per channel block, which gives the MXU a
// matrix product) is a TPU adaptation and is not carried over: here each
// thread walks one channel serially in fp32, the product and the sum
// rounded separately (__fmul_rn / __fadd_rn, so nvcc cannot contract them
// into an FMA) and the kernel's bits equal the plain version's.
//
// Bound on this card: bytes (a and b read once, h written once; two flops
// an element). Design: one thread per (b, w) channel, neighbouring threads
// on neighbouring w, so each warp-wide load or store is 128 contiguous
// bytes; a CTA is one warp, so the (W/32, B) grid spreads evenly over the
// SMs. A thread keeps the loads of the next RUN steps in flight while it
// walks the current RUN steps' dependent chain. Nothing is padded in device
// memory: ragged T and W are bounds in the loops. Launchers return the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;
constexpr int RUN = 16;  // steps whose loads are issued ahead of the chain

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ a,
                                         const T* __restrict__ b, size_t off,
                                         size_t stride, int steps,
                                         float (&av)[RUN], float (&bv)[RUN]) {
#pragma unroll
  for (int j = 0; j < RUN; ++j) {
    if (j < steps) {
      av[j] = to_f(a[off + j * stride]);
      bv[j] = to_f(b[off + j * stride]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ h0, T* __restrict__ h,
             float* __restrict__ h_last, int t_len, int w_len) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= w_len) return;
  const size_t chan = (size_t)blockIdx.y * w_len + w;
  const size_t stride = (size_t)w_len;
  size_t off = (size_t)blockIdx.y * t_len * stride + w;
  float hc = h0 ? h0[chan] : 0.0f;

  float an[RUN], bn[RUN];
  load_run(a, b, off, stride, t_len < RUN ? t_len : RUN, an, bn);
  for (int t0 = 0; t0 < t_len; t0 += RUN) {
    float av[RUN], bv[RUN];
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      av[j] = an[j];
      bv[j] = bn[j];
    }
    const int steps = t_len - t0 < RUN ? t_len - t0 : RUN;
    const int next = t_len - t0 - RUN;  // steps left after this run
    if (next > 0)
      load_run(a, b, off + RUN * stride, stride, next < RUN ? next : RUN, an, bn);
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (j < steps) {
        const float at = fminf(fmaxf(av[j], 1e-37f), 1.0f);
        hc = __fadd_rn(__fmul_rn(at, hc), bv[j]);
        store(h + off + j * stride, hc);
      }
    }
    off += RUN * stride;
  }
  h_last[chan] = hc;
}

template <typename T>
int launch(const T* a, const T* b, const float* h0, T* h, float* h_last,
           int batch, int t_len, int w_len, void* stream) {
  if (batch < 0 || batch > 65535 || t_len < 0 || w_len < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || w_len == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((w_len + THREADS - 1) / THREADS), (unsigned)batch);
  rglru_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, h, h_last, t_len, w_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rglru_scan_f32(const float* a, const float* b, const float* h0, float* h,
                   float* h_last, int batch, int t_len, int w_len,
                   void* stream) {
  return launch<float>(a, b, h0, h, h_last, batch, t_len, w_len, stream);
}
int rglru_scan_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                    const float* h0, __nv_bfloat16* h, float* h_last,
                    int batch, int t_len, int w_len, void* stream) {
  return launch<__nv_bfloat16>(a, b, h0, h, h_last, batch, t_len, w_len,
                               stream);
}

}  // extern "C"
