// WKV6 scan (the RWKV-6 recurrence) for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel rwkv6_scan (_wkv6_kernel) of
// src/repro/kernels/rwkv6_scan.py. Per (batch, head), with the state S
// (N, N), rows i over r, k and w, columns j over v:
//
//   out_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
//   S[i, j]  = w_t[i] * S[i, j] + k_t[i] * v_t[j]
//
// over r, k, v, w (B, T, H, N) and u (H, N) in fp32 or bf16, s0 (B, H, N,
// N) fp32 (or none: zero), w clamped to [1e-37, 1] as the TPU kernel clamps
// it before its logs; out (B, T, H, N) in r's type, S_T (B, H, N, N) fp32.
// N <= 64, RWKV-6's head size.
//
// What is ported is the function. The TPU kernel's chunked matrix form
// (pairwise exponentials of cumulative log-decays, so the MXU does the
// work) is a TPU adaptation and is not carried over: here the state is
// walked one step at a time in fp32, as the recurrence is written.
//
// Bound on this card: at RWKV-6 7B's shapes the bytes (r, k, v, w read
// once, out written once) and the ~5 N^2 flops per token and head take
// about the same time, so neither may be wasted. Design: one CTA per (b,
// h) of NP >= N threads (16, 32 or 64); thread j holds column j of S in
// registers for the whole sequence. Runs of RUN steps of r, k and w are
// staged in shared memory (thread j loads element j of each, so every
// warp-wide load is contiguous; thread j keeps its own v_t[j] in
// registers); the loads of the next run are in flight while the current
// run is walked, and the out_t[j] sum is split over four partial sums so
// its chain does not serialise the step. Nothing is padded in device
// memory: threads j >= N stage zeros, and a ragged last run is bounded.
// Launchers return the cudaError_t of the launch.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int RUN = 8;  // steps staged per round
constexpr int MAX_N = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// element j of r, k, v, w for `steps` steps from `off` (zero past them)
template <typename T>
__device__ __forceinline__ void load_run(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, size_t off, size_t stride, int steps,
    float (&rr)[RUN], float (&kk)[RUN], float (&vv)[RUN], float (&ww)[RUN]) {
#pragma unroll
  for (int c = 0; c < RUN; ++c) {
    const bool in = c < steps;
    const size_t o = off + c * stride;
    rr[c] = in ? to_f(r[o]) : 0.0f;
    kk[c] = in ? to_f(k[o]) : 0.0f;
    vv[c] = in ? to_f(v[o]) : 0.0f;
    ww[c] = in ? to_f(w[o]) : 0.0f;
  }
}

// one row i of one step for column j
__device__ __forceinline__ void row(float r, float k, float w, float u,
                                    float vj, float& s, float& acc) {
  const float kv = k * vj;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
}

template <typename T, int NP>
__global__ void __launch_bounds__(NP)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             const T* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ out, float* __restrict__ s_last, int t_len,
             int h_len, int n) {
  __shared__ __align__(16) float r_s[RUN][NP];
  __shared__ __align__(16) float k_s[RUN][NP];
  __shared__ __align__(16) float w_s[RUN][NP];
  __shared__ __align__(16) float u_s[NP];

  const int j = threadIdx.x;
  const long long bh = blockIdx.x;
  const int hi = (int)(bh % h_len);
  const long long bi = bh / h_len;
  const bool live = j < n;
  u_s[j] = live ? to_f(u[(size_t)hi * n + j]) : 0.0f;

  const size_t nn = (size_t)n * n;
  float S[NP];  // S[i] is S[i, j]
#pragma unroll
  for (int i = 0; i < NP; ++i)
    S[i] = (s0 != nullptr && live && i < n) ? s0[bh * nn + (size_t)i * n + j]
                                            : 0.0f;

  const size_t stride = (size_t)h_len * n;  // from step t to step t + 1
  const size_t off0 = (size_t)bi * t_len * stride + (size_t)hi * n + j;
  float pr[RUN], pk[RUN], pv[RUN], pw[RUN];
  load_run(r, k, v, w, off0, stride, live ? min(t_len, RUN) : 0, pr, pk, pv,
           pw);

  for (int t0 = 0; t0 < t_len; t0 += RUN) {
    __syncthreads();  // every thread is done with the previous run
    float vv[RUN];
#pragma unroll
    for (int c = 0; c < RUN; ++c) {
      r_s[c][j] = pr[c];
      k_s[c][j] = pk[c];
      w_s[c][j] = fminf(fmaxf(pw[c], 1e-37f), 1.0f);
      vv[c] = pv[c];
    }
    __syncthreads();
    const int steps = min(RUN, t_len - t0);
    const int next = t_len - t0 - RUN;
    if (next > 0)
      load_run(r, k, v, w, off0 + (size_t)(t0 + RUN) * stride, stride,
               live ? min(next, RUN) : 0, pr, pk, pv, pw);

#pragma unroll
    for (int c = 0; c < RUN; ++c) {
      if (c < steps) {
        const float vj = vv[c];
        float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
#pragma unroll
        for (int i = 0; i < NP; i += 4) {
          const float4 rq = *reinterpret_cast<const float4*>(&r_s[c][i]);
          const float4 kq = *reinterpret_cast<const float4*>(&k_s[c][i]);
          const float4 wq = *reinterpret_cast<const float4*>(&w_s[c][i]);
          const float4 uq = *reinterpret_cast<const float4*>(&u_s[i]);
          row(rq.x, kq.x, wq.x, uq.x, vj, S[i], acc0);
          row(rq.y, kq.y, wq.y, uq.y, vj, S[i + 1], acc1);
          row(rq.z, kq.z, wq.z, uq.z, vj, S[i + 2], acc2);
          row(rq.w, kq.w, wq.w, uq.w, vj, S[i + 3], acc3);
        }
        if (live)
          store(out + off0 + (size_t)(t0 + c) * stride,
                (acc0 + acc1) + (acc2 + acc3));
      }
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i < n) s_last[bh * nn + (size_t)i * n + j] = S[i];
  }
}

template <typename T>
int launch(const T* r, const T* k, const T* v, const T* w, const T* u,
           const float* s0, T* out, float* s_last, int batch, int t_len,
           int h_len, int n, void* stream) {
  if (batch < 0 || t_len < 0 || h_len < 1 || n < 1 || n > MAX_N)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const long long grid = (long long)batch * h_len;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)grid;
  if (n <= 16)
    rwkv6_kernel<T, 16><<<g, 16, 0, s>>>(r, k, v, w, u, s0, out, s_last, t_len,
                                          h_len, n);
  else if (n <= 32)
    rwkv6_kernel<T, 32><<<g, 32, 0, s>>>(r, k, v, w, u, s0, out, s_last, t_len,
                                          h_len, n);
  else
    rwkv6_kernel<T, 64><<<g, 64, 0, s>>>(r, k, v, w, u, s0, out, s_last, t_len,
                                          h_len, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rwkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rwkv6_scan_f32(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* out,
                   float* s_last, int batch, int t_len, int h_len, int n,
                   void* stream) {
  return launch<float>(r, k, v, w, u, s0, out, s_last, batch, t_len, h_len, n,
                       stream);
}
int rwkv6_scan_bf16(const __nv_bfloat16* r, const __nv_bfloat16* k,
                    const __nv_bfloat16* v, const __nv_bfloat16* w,
                    const __nv_bfloat16* u, const float* s0,
                    __nv_bfloat16* out, float* s_last, int batch, int t_len,
                    int h_len, int n, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, out, s_last, batch, t_len,
                               h_len, n, stream);
}

}  // extern "C"
