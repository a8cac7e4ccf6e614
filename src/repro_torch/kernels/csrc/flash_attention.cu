// Flash attention for NVIDIA Hopper (sm_90a), plain C interface.
//
//   o = softmax(q k^T / sqrt(D) + mask) v      per (batch, head)
//
// over (B, H, T, D) contiguous operands, fp32 or bf16 I/O, with fp32
// scores, a running (max, sum, acc) online softmax in fp32 and the result
// acc / max(l, 1e-30) cast back to the input dtype. Masks are built from
// coordinates: causal (k <= q), sliding window (k > q - window) and the
// ragged key tail (k >= Tk), so any Tk works, causal or not.
//
// It replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py (_flash_kernel). What is kept from it
// is the function and its arithmetic order per key tile (tile max, one
// rescale of (l, acc), then the tile's exp-weighted sum); its tiling is not:
// the TPU version stages the whole K/V sequence of a head in VMEM and needs
// Tk % block_k == 0 when not causal; here K/V stream through shared memory
// in tiles of BK keys and the tail is masked.
//
// Bound on this card: at the codec's shape (4096, 2, 232, 16) a (q, k) pair
// costs 2 * D FMAs against no device-memory traffic beyond one read of q,
// k, v and one write of o, so the kernel is bound by fp32 operations on the
// CUDA cores (TF32 tensor cores are not allowed on this path: they keep
// about three decimal digits). Design:
//
// * One CTA of 128 threads owns one (batch, head) and a tile of query rows.
//   A query row belongs to G = DP / 16 neighbouring threads, each holding 16
//   of its head dims of q and of the accumulator in registers; a score is
//   their partial dot products summed by an xor butterfly of shuffles,
//   which leaves the same bits in every thread of the group. DP, D rounded
//   up to 16, 32, 64 or 128, is a template argument; dims past D are zero.
// * Each key tile (BK = 32 keys of K and V) is loaded once by the whole CTA
//   into shared memory, converted to fp32, zero filled past Tk; every thread
//   then reads the same key row (a broadcast, no bank conflict at D <= 32).
// * Per tile: scores into 32 registers, masked to -1e30 as the reference
//   does, the tile max, one correction exp(m - m_new) of (l, acc), then
//   p = exp(s - m_new) per key with full-precision expf (no fast math); keys
//   past Tk get p = 0. When causal, tiles whose first key lies past the
//   CTA's last row are skipped, as the reference's loop bound does.
// * Fixed reduction order and no atomics: the same inputs give the same
//   bits on every launch, which the codec's encode and decode sides rely on.
//
// Launchers return the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int DPT = 16;   // head dims per thread
constexpr int BK = 32;    // keys per shared-memory tile
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int tq, int tk,
             int d, int causal, int window, float scale) {
  constexpr int G = DP / DPT;          // threads per query row
  constexpr int ROWS = THREADS / G;    // query rows per CTA
  __shared__ float sk[BK][DP];
  __shared__ float sv[BK][DP];

  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * ROWS;
  const int row = q0 + threadIdx.x / G;
  const int d0 = (threadIdx.x % G) * DPT;
  const bool live = row < tq;
  const T* qb = q + (bh * tq + (live ? row : 0)) * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = (live && d0 + i < d) ? to_f32(qb[d0 + i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  // keys past the tile's last row are masked for every row of it
  const int hi = causal ? min(tk, q0 + ROWS) : tk;

  for (int k0 = 0; k0 < hi; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < BK * DP; e += THREADS) {
      const int j = e / DP, c = e % DP, key = k0 + j;
      const bool in = key < tk && c < d;
      sk[j][c] = in ? to_f32(kb[(long long)key * d + c]) : 0.f;
      sv[j][c] = in ? to_f32(vb[(long long)key * d + c]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dot = fmaf(qr[i], sk[j][d0 + i], dot);
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2)
        dot += __shfl_xor_sync(FULL, dot, off);
      const int key = k0 + j;
      bool keep = true;
      if (causal) keep = keep && key <= row;
      if (window > 0) keep = keep && key > row - window;
      s[j] = keep ? dot * scale : NEG_INF;
      if (key < tk) mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = (k0 + j < tk) ? expf(s[j] - m_new) : 0.f;
      ls += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, sv[j][d0 + i], acc[i]);
    }
    l += ls;
    m = m_new;
  }

  if (live) {
    T* ob = o + (bh * tq + row) * d;
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (d0 + i < d) store(ob + d0 + i, acc[i] / lc);
  }
}

template <typename T, int DP>
int launch_as(const T* q, const T* k, const T* v, T* o, long long bh, int tq,
              int tk, int d, int causal, int window, float scale,
              void* stream) {
  constexpr int ROWS = THREADS / (DP / DPT);
  const long long q_tiles = (tq + ROWS - 1) / ROWS;
  if (bh > 0x7fffffffLL || q_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)bh, (unsigned)q_tiles);
  flash_kernel<T, DP><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, tq, tk, d, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, long long bh, int tq,
           int tk, int d, int causal, int window, float scale, void* stream) {
  if (d < 1 || d > MAX_D || bh < 0 || tq < 0 || tk < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || tq == 0) return (int)cudaSuccess;
  if (d <= 16)
    return launch_as<T, 16>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                            stream);
  if (d <= 32)
    return launch_as<T, 32>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                            stream);
  if (d <= 64)
    return launch_as<T, 64>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                            stream);
  return launch_as<T, 128>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                           stream);
}

}  // namespace

extern "C" {

int flash_max_d() { return MAX_D; }

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* o, long long bh, int tq, int tk, int d,
                        int causal, int window, float scale, void* stream) {
  return launch<float>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                       stream);
}

int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o,
                         long long bh, int tq, int tk, int d, int causal,
                         int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, tq, tk, d, causal, window,
                               scale, stream);
}

}  // extern "C"
