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
// is the function, the whole K/V sequence of a head held on chip, and its
// arithmetic order per block of keys (block max, one rescale of (l, acc),
// then the block's exp-weighted sum); the TPU's need for Tk % block_k == 0
// when not causal is not: the ragged tail is masked here.
//
// Bound on this card: at the codec's shape (4096, 2, 232, 16) a (q, k) pair
// costs 2 * D FMAs against no device-memory traffic beyond one read of q,
// k, v and one write of o, so the kernel is bound by fp32 operations on the
// CUDA cores (0.42 ms; TF32 tensor cores are not allowed on this path: they
// keep about three decimal digits). What limits it is instruction issue:
// per key a thread's 64 FMAs share the issue slots with 8 shared loads and
// the softmax's maxima, subtractions, exponentials and sums. Design:
//
// * One CTA of 128 threads owns one (batch, head) and a tile of query rows.
//   A thread holds R = 2 neighbouring query rows; a row belongs to G = DP /
//   16 neighbouring threads, each holding 16 of its head dims of q and of
//   the accumulator in registers (at D <= 16, G = 1 and one CTA covers 256
//   rows: the codec's 232 in one CTA). Each broadcast shared load of a K or
//   V row feeds both rows' FMAs: two independent chains, half the loads per
//   FMA of one row a thread. With G > 1 a score is the group's partial dot
//   products summed by an xor butterfly of shuffles, which leaves the same
//   bits in every thread of the group. DP, D rounded up to 16, 32, 64,
//   128 or 256, is a template argument; dims past D are zero. At DP = 256
//   (RecurrentGemma's local attention) a row spans G = 16 lanes, a CTA
//   holds 16 rows and a 48 KB K/V chunk 24 keys: the same design, more
//   K/V re-reads from L2 per row.
// * K and V stay resident in shared memory, converted to fp32: the whole
//   head (28 KB at T = 232, D = 16) is loaded once, with 16-byte cp.async
//   copies where the layout allows, behind one barrier. Where Tk * DP does
//   not fit in the CTA's 48 KB the keys come in chunks of that size, the
//   same chunking for every CTA.
// * q is pre-scaled by scale * log2(e) once, so a score is a dot product
//   and p = exp2f(s - m), full precision (no fast math).
// * Keys go in blocks of 8: scores into registers, masked to -1e30 as the
//   reference does, the block max, one correction exp2f(m - m_new) of
//   (l, acc), then the block's p and its V rows. Blocks with no masked key
//   (every block of a non-causal call but the ragged last one) run with no
//   mask logic. The key loop stops at the last live key's block (that
//   block's dead keys get p = 0); when causal, keys past the CTA's last
//   row are not visited, which changes no bit (they would add 0 after a
//   rescale by 1).
// * Fixed reduction order and no atomics, and a row's arithmetic depends
//   only on its own q and its head's K/V: the same inputs give the same bits
//   on every launch and in any batch, which the codec's encode and decode
//   sides rely on.
//
// Launchers return the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int DPT = 16;     // head dims per thread
constexpr int R = 2;        // query rows per thread
constexpr int BLOCK_KEYS = 8;  // keys per online-softmax block
constexpr int KV_BYTES = 48 * 1024;  // shared memory for one K/V chunk
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// 16 consecutive shared floats (16-byte aligned) into registers
__device__ __forceinline__ void load16(const float* p, float (&out)[DPT]) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const float4 t = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = t.x;
    out[4 * i + 1] = t.y;
    out[4 * i + 2] = t.z;
    out[4 * i + 3] = t.w;
  }
}

// One block of KB keys starting at j0 (relative to the chunk) for a
// thread's R rows: scores, the block max, one rescale of (l, acc), then the
// block's p and its V rows. MASKED applies the causal and window masks and
// the dead tail (keys at or past n); otherwise every key is live for every
// row and the block runs with no mask logic.
template <int DP, int KB, bool MASKED>
__device__ __forceinline__ void key_block(
    const float* sk, const float* sv, int j0, int n, int key0, int row0,
    int d0, int causal, int window, const float (&qr)[R][DPT],
    float (&acc)[R][DPT], float (&m)[R], float (&l)[R]) {
  constexpr int G = DP / DPT;
  float s[R][KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    float kk[DPT];
    load16(sk + (j0 + j) * DP + d0, kk);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dot = fmaf(qr[r][i], kk[i], dot);
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2)
        dot += __shfl_xor_sync(FULL, dot, off);
      s[r][j] = dot;
      if (MASKED) {
        const int key = key0 + j0 + j, row = row0 + r;
        bool keep = true;
        if (causal) keep = keep && key <= row;
        if (window > 0) keep = keep && key > row - window;
        if (!keep) s[r][j] = NEG_INF;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < KB; ++j)
      if (!MASKED || j0 + j < n) mt = fmaxf(mt, s[r][j]);
    const float m_new = fmaxf(m[r], mt);
    const float corr = exp2f(m[r] - m_new);
    l[r] *= corr;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[r][i] *= corr;
    m[r] = m_new;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      s[r][j] = (!MASKED || j0 + j < n) ? exp2f(s[r][j] - m_new) : 0.f;
      ls += s[r][j];
    }
    l[r] += ls;
  }
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    float vv[DPT];
    load16(sv + (j0 + j) * DP + d0, vv);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[r][i] = fmaf(s[r][j], vv[i], acc[r][i]);
  }
}

template <typename T, int DP, int KB>
__global__ void __launch_bounds__(THREADS, 4)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int tq, int tk,
             int d, int causal, int window, float scale, int chunk, int vec) {
  constexpr int G = DP / DPT;                // threads per query row
  constexpr int ROWS = THREADS / G * R;      // query rows per CTA
  extern __shared__ __align__(16) float kv_s[];
  float* sk = kv_s;              // (chunk, DP)
  float* sv = kv_s + chunk * DP;  // (chunk, DP)

  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * ROWS;
  const int row0 = q0 + (threadIdx.x / G) * R;
  const int d0 = (threadIdx.x % G) * DPT;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;

  float qr[R][DPT], acc[R][DPT], m[R], l[R];
  const float qscale = scale * LOG2E;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool live = row0 + r < tq;
    const T* qb = q + (bh * tq + (live ? row0 + r : 0)) * d;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      qr[r][i] = (live && d0 + i < d) ? to_f32(qb[d0 + i]) * qscale : 0.f;
      acc[r][i] = 0.f;
    }
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  // keys past the tile's last row are masked for every row of it
  const int hi = causal ? min(tk, q0 + ROWS) : tk;
  const bool any_mask = causal || window > 0;

  for (int c0 = 0; c0 < hi; c0 += chunk) {
    const int n = min(chunk, hi - c0);        // live keys of the chunk
    const int np = (n + KB - 1) / KB * KB;    // ... and its dead tail
    if (c0 > 0) __syncthreads();  // every thread is done with the last chunk
    if (vec) {  // fp32, D == DP, 16-byte aligned: copy the rows as they are
      const float* ks =
          reinterpret_cast<const float*>(kb) + (long long)c0 * DP;
      const float* vs =
          reinterpret_cast<const float*>(vb) + (long long)c0 * DP;
      for (int e = threadIdx.x * 4; e < n * DP; e += THREADS * 4) {
        cp_async16(sk + e, ks + e);
        cp_async16(sv + e, vs + e);
      }
      for (int e = n * DP + threadIdx.x; e < np * DP; e += THREADS)
        sk[e] = sv[e] = 0.f;
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                       "memory");
    } else {
      for (int e = threadIdx.x; e < np * DP; e += THREADS) {
        const int j = e / DP, c = e % DP;
        const bool in = j < n && c < d;
        const long long at = (long long)(c0 + j) * d + c;
        sk[e] = in ? to_f32(kb[at]) : 0.f;
        sv[e] = in ? to_f32(vb[at]) : 0.f;
      }
    }
    __syncthreads();

    for (int j0 = 0; j0 < np; j0 += KB) {
      if (any_mask || j0 + KB > n)  // uniform over the CTA
        key_block<DP, KB, true>(sk, sv, j0, n, c0, row0, d0, causal, window,
                                qr, acc, m, l);
      else
        key_block<DP, KB, false>(sk, sv, j0, n, c0, row0, d0, causal, window,
                                 qr, acc, m, l);
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r >= tq) continue;
    T* ob = o + (bh * tq + row0 + r) * d;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (d0 + i < d) store(ob + d0 + i, acc[r][i] / lc);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int DP>
int launch_as(const T* q, const T* k, const T* v, T* o, long long bh, int tq,
              int tk, int d, int causal, int window, float scale,
              void* stream) {
  constexpr int ROWS = THREADS / (DP / DPT) * R;
  const long long q_tiles = (tq + ROWS - 1) / ROWS;
  if (bh > 0x7fffffffLL || q_tiles > 65535) return (int)cudaErrorInvalidValue;
  // the whole head when it fits, else chunks of the same size for every CTA
  const int max_chunk =
      KV_BYTES / (2 * DP * (int)sizeof(float)) / BLOCK_KEYS * BLOCK_KEYS;
  const int whole = (tk + BLOCK_KEYS - 1) / BLOCK_KEYS * BLOCK_KEYS;
  const int chunk = whole < max_chunk ? whole : max_chunk;
  const size_t smem = 2 * (size_t)chunk * DP * sizeof(float);
  const int vec = sizeof(T) == sizeof(float) && d == DP && aligned16(k) &&
                  aligned16(v);
  dim3 grid((unsigned)bh, (unsigned)q_tiles);
  flash_kernel<T, DP, BLOCK_KEYS>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          q, k, v, o, tq, tk, d, causal, window, scale, chunk, vec);
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
  if (d <= 128)
    return launch_as<T, 128>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                             stream);
  return launch_as<T, 256>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
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
