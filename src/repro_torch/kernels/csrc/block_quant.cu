// Block quantise -> dequantise for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel block_quant (_bq_kernel) of
// src/repro/kernels/block_quant.py. For each run of `block` consecutive
// values along the last axis (K % block == 0, so the runs tile the flat
// array and scale b belongs to values [b * block, (b + 1) * block)):
//
//   scale = max(max |x|, 1e-30) / qmax,        qmax = 2^(n_bits-1) - 1
//   out   = clamp(rint(x / scale), -qmax - 1, qmax) * scale
//
// in fp32 for fp32 or bf16 input; out in the input's type, scales fp32.
//
// Bound on this card: bytes. Each value is read once and written once
// (plus 4 bytes of scale per block) against a handful of flops, far below
// the ridge. The TPU kernel tiles rows through VMEM; here one warp owns one
// block: each lane loads its values (neighbouring lanes on neighbouring
// addresses, so every load of the warp is one contiguous run) and keeps
// them in registers while a shuffle butterfly forms the block's max, so
// device memory is passed over once. Blocks longer than 256 values take a
// loop that reads each value a second time, from L1.
//
// Numerics: both divisions are IEEE divisions (nvcc's default
// -prec-div=true; this file must not be built with --use_fast_math) and the
// rounding is rintf, half to even as jnp.round and torch.round, so the
// kernel's bits equal the plain version's. The max of |x| is exact in any
// order. Launchers return the cudaError_t of the launch.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // warps (blocks of values) per CTA

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dequant(float x, float scale, float qmax) {
  const float q = fminf(fmaxf(rintf(x / scale), -qmax - 1.0f), qmax);
  return q * scale;
}

// V > 0: a lane holds its V values in registers (block <= 32 V);
// V == 0: any block length, each value read twice.
template <typename T, int V>
__global__ void __launch_bounds__(WARPS * 32)
block_quant_kernel(const T* __restrict__ x, T* __restrict__ out,
                   float* __restrict__ scales, long long n_blocks, int block,
                   float qmax) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= n_blocks) return;  // the whole warp leaves together
  const T* xb = x + (size_t)b * block;
  T* ob = out + (size_t)b * block;

  float v[V > 0 ? V : 1];
  float amax = 0.0f;
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = lane + 32 * j;
      v[j] = i < block ? to_f(xb[i]) : 0.0f;
      amax = fmaxf(amax, fabsf(v[j]));
    }
  } else {
    for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(to_f(xb[i])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax, 1e-30f) / qmax;
  if (lane == 0) scales[b] = scale;

  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = lane + 32 * j;
      if (i < block) store(ob + i, dequant(v[j], scale, qmax));
    }
  } else {
    for (int i = lane; i < block; i += 32)
      store(ob + i, dequant(to_f(xb[i]), scale, qmax));
  }
}

template <typename T>
int launch(const T* x, T* out, float* scales, long long n_blocks, int block,
           float qmax, void* stream) {
  if (n_blocks < 0 || block < 1 || !(qmax >= 1.0f))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return (int)cudaSuccess;
  const long long grid = (n_blocks + WARPS - 1) / WARPS;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 g((unsigned)grid), t(WARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block <= 32)
    block_quant_kernel<T, 1><<<g, t, 0, s>>>(x, out, scales, n_blocks, block, qmax);
  else if (block <= 64)
    block_quant_kernel<T, 2><<<g, t, 0, s>>>(x, out, scales, n_blocks, block, qmax);
  else if (block <= 128)
    block_quant_kernel<T, 4><<<g, t, 0, s>>>(x, out, scales, n_blocks, block, qmax);
  else if (block <= 256)
    block_quant_kernel<T, 8><<<g, t, 0, s>>>(x, out, scales, n_blocks, block, qmax);
  else
    block_quant_kernel<T, 0><<<g, t, 0, s>>>(x, out, scales, n_blocks, block, qmax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* block_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int block_quant_f32(const float* x, float* out, float* scales,
                    long long n_blocks, int block, float qmax, void* stream) {
  return launch<float>(x, out, scales, n_blocks, block, qmax, stream);
}
int block_quant_bf16(const __nv_bfloat16* x, __nv_bfloat16* out, float* scales,
                     long long n_blocks, int block, float qmax, void* stream) {
  return launch<__nv_bfloat16>(x, out, scales, n_blocks, block, qmax, stream);
}

}  // extern "C"
