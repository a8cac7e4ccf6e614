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
// Any N >= 1: the design below to N = 256 (one CTA a (b, h) to N = 64,
// RWKV-6's head size; past it one a (b, h) and slab of 64 columns), and
// rwkv6_wide, with S in device memory, past it (see there).
//
// What is ported is the function. The TPU kernel's chunked matrix form
// (pairwise exponentials of cumulative log-decays, so the MXU does the
// work) is a TPU adaptation and is not carried over: here the state is
// walked in fp32, two steps at a time, as the recurrence is written.
//
// Bound on this card: at RWKV-6 7B's shapes (8, 1024, 64, 64) the bytes (r,
// k, v, w read once, out written once) take 0.205 ms at 3.35 TB/s, and the
// arithmetic about as long: written step by step, every (i, j, t) costs a
// multiply (k_i v_j) and two FMAs (the output sum, the state update), 6.4
// G instructions a call. One CTA per (b, h) gives only 512 CTAs, so the
// card holds few warps and the kernel is held by how fully they issue.
// Design:
//
// * The bonus term is factored out: sum_i r_i u_i k_i v_j = v_j b_t with
//   b_t = sum_i r_t[i] u[i] k_t[i], one scalar a step, computed once while
//   the run is prepared; u is not read in the inner loop.
// * Steps go in pairs (t, t+1) from the state S before t:
//     out_t    = sum_i r0_i S_ij + v0_j b0
//     out_t+1  = sum_i (r1_i w0_i) S_ij + v0_j c + v1_j b1
//     S_ij    <- (w0_i w1_i) S_ij + (w1_i k0_i) v0_j + k1_i v1_j
//   with c = sum_i r1_i k0_i. The per-row products r1 w0, w1 k0 and w0 w1
//   and the scalars b0, c, b1 are made once a pair while the run is
//   prepared, so the inner loop costs five FP instructions an element a
//   pair (2.5 a step, against 3 stepwise) and five 16-byte shared loads a
//   4-row chunk a pair (against six). Every product is of decays in [1e-37,
//   1], so nothing overflows; what underflows is below the result's ulp.
// * Rows are split over lanes: the G = 4 lanes of a column group (lanes
//   gi * 8 + c of a warp) each hold N / 4 rows of CPL = 2 adjacent columns
//   of S in registers (32 a lane at N = 64), so one CTA of 128 threads
//   serves a (b, h) and the card holds about 16 warps an SM, twice as many
//   as with a column a thread. The partial sums of an output are added
//   with two __shfl_xor_sync. A lane's rows are 4-row chunks gi, gi + G,
//   ... so the G 16-byte shared loads a warp makes at once fall on
//   distinct banks, and each load feeds both columns.
// * Past N = 64 the columns go in slabs of CP = 64 to separate CTAs (grid
//   y): the columns of S are independent, so a CTA walks its 64 columns
//   over all N rows with the same code, and holds v for its slab only.
//   G grows with N (NP / 32 lanes a column group), so that a lane keeps at
//   most 32 rows of its 2 columns; every CTA makes the pair products and
//   the scalars b0, c, b1 of all rows itself, in the same order, and runs
//   of RUN = 8 steps at NP = 256 keep the ring in shared memory.
// * Runs of RUN = 16 steps of r, k, w and v stream through a ring of three
//   shared buffers filled with cp.async (16-byte copies where N and the
//   pointers allow, 4-byte ones otherwise; bf16 rows that allow neither
//   are loaded plainly). One barrier a run: after it, run n + 2 is issued
//   into the buffer run n - 1 left, the warps prepare run n + 1 (w clamped,
//   bf16 converted to fp32, the pair products and scalars, a pair a warp),
//   and run n is walked. A ragged last run is bounded (its missing step is
//   w = 1, r = k = v = 0); nothing is padded in device memory (rows j >= N
//   are zero in shared memory only).
// * The state stays fp32 for bf16 inputs; s0 = nullptr means zero.
//   Launchers return the cudaError_t of the launch.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_NP = 256;  // past it rwkv6_wide
constexpr int CPL = 2;       // adjacent columns a lane holds
constexpr int STAGES = 3;    // runs in the ring
constexpr int NARR = 4;      // r, k, w, v

// The tile at each padded N: lanes sharing a column group (rows split), the
// columns a CTA, and the steps a run
template <int NP>
__host__ __device__ constexpr int lanes_of() { return NP <= 64 ? 4 : NP / 32; }
template <int NP>
__host__ __device__ constexpr int cols_of() { return NP <= 64 ? NP : 64; }
template <int NP>
__host__ __device__ constexpr int run_of() { return NP <= 128 ? 16 : 8; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float clamp_w(float w) {
  return fminf(fmaxf(w, 1e-37f), 1.0f);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2 or 4 consecutive staged floats (16-byte aligned for 4), one load
__device__ __forceinline__ void load_cols(const float* p, float (&x)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  x[0] = t.x, x[1] = t.y;
}
__device__ __forceinline__ void load_cols(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
}

template <int NP>
__host__ __device__ constexpr int threads_of() {
  return cols_of<NP>() / CPL * lanes_of<NP>();
}

// floats of one ring stage: r, k and w (RUN, NP) each, then v (RUN, CP)
template <int NP>
__host__ __device__ constexpr int stage_of() {
  return (3 * NP + cols_of<NP>()) * run_of<NP>();
}

// shared memory: fp32 runs (STAGES, stage_of), the scalars of each step
// pair (2, RUN / 2, 4), and for bf16 the raw runs the copies land in
// (STAGES, stage_of)
template <typename T, int NP>
constexpr size_t smem_of() {
  return (size_t)STAGES * stage_of<NP>() * sizeof(float) +
         4 * run_of<NP>() * sizeof(float) +
         (sizeof(T) == 4 ? 0 : (size_t)STAGES * stage_of<NP>() * sizeof(T));
}

template <typename T, int NP>
__global__ void __launch_bounds__(NP <= 64 ? 2 * NP : NP, NP == 64 ? 4 : NP == 128 ? 2 : 1)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             const T* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ out, float* __restrict__ s_last, int t_len,
             int h_len, int n, int vec) {
  constexpr int THREADS = threads_of<NP>();
  static_assert(THREADS == (NP <= 64 ? 2 * NP : NP), "the launch bounds' threads");
  constexpr int WARPS = THREADS / 32 > 0 ? THREADS / 32 : 1;
  constexpr int G = lanes_of<NP>();    // lanes sharing a column group
  constexpr int CW = 32 / G;           // column groups a warp
  constexpr int CP = cols_of<NP>();    // columns a CTA
  constexpr int RUN = run_of<NP>();    // steps a run
  constexpr bool SLAB = CP < NP;       // columns in slabs, one a CTA
  constexpr int RPL = NP / G;          // rows a lane
  constexpr int UQ = (NP + 31) / 32;   // u values a lane (b_t)
  constexpr int ARR = RUN * NP;        // one array of one run (r, k, w)
  constexpr int SF = stage_of<NP>();   // floats of a stage
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fb = reinterpret_cast<float*>(smem_raw);  // (STAGES, SF)
  float* b_s = fb + STAGES * SF;                    // (2, RUN / 2, 4)
  T* raw = F32 ? reinterpret_cast<T*>(fb) : reinterpret_cast<T*>(b_s + 4 * RUN);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane / CW;                    // row group
  const int col0 = SLAB ? (int)blockIdx.y * CP : 0;  // the slab's first column
  const int vcols = SLAB ? min(CP, n - col0) : n;    // its columns
  // first of this lane's columns
  const int j0 = col0 + (warp * CW + lane % CW) * CPL;
  const long long bh = blockIdx.x;
  const int hi = (int)(bh % h_len);
  const long long bi = bh / h_len;
  const size_t nn = (size_t)n * n;
  const size_t stride = (size_t)h_len * n;  // from step t to step t + 1
  const size_t off0 = (size_t)bi * t_len * stride + (size_t)hi * n;
  const int nruns = (t_len + RUN - 1) / RUN;

  // row of chunk position q, element e of this lane
  auto row_of = [&](int q, int e) { return (q * G + gi) * 4 + e; };

  float S[CPL][RPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int q = 0; q < RPL / 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row_of(q, e), j = j0 + c;
        S[c][q * 4 + e] = (s0 != nullptr && i < n && j < n)
                              ? s0[bh * nn + (size_t)i * n + j] : 0.0f;
      }
  float ub[UQ];
#pragma unroll
  for (int q = 0; q < UQ; ++q) {
    const int i = lane + 32 * q;
    ub[q] = i < n ? to_f(u[(size_t)hi * n + i]) : 0.0f;
  }

  // rows n .. NP-1 (and v's columns past the slab's) of every run are
  // zero (the copies never write them)
  if (F32 && (n < NP || vcols < CP)) {
    for (int x = tid; x < STAGES * SF; x += THREADS) fb[x] = 0.0f;
    __syncthreads();
  }

  // copies of run `run` into stage st: the chunk (array a, step c, chunk
  // ch of the step's row) of flat index tid, then every THREADS-th, found
  // by stepping (the divisions are made once a run)
  auto issue = [&](int run, int st) {
    const int t0 = run * RUN, steps = min(RUN, t_len - t0);
    if (steps <= 0) return;
    T* dst = raw + (size_t)st * SF;
    const int per = vec ? 16 / (int)sizeof(T) : 1;  // elements a copy
    const int q = n / per;                          // copies a step row
    int a = tid / (steps * q);
    int c = (tid - a * steps * q) / q;
    int ch = tid - (a * steps + c) * q;
    const int dc = THREADS / q, dch = THREADS - dc * q;
    constexpr int NA = SLAB ? 3 : NARR;  // arrays of whole rows
    while (a < NA) {
      const T* src = (a == 0 ? r : a == 1 ? k : a == 2 ? w : v) + off0 +
                     (size_t)(t0 + c) * stride + ch * per;
      T* d = dst + a * ARR + c * NP + ch * per;
      if (vec) cp_async16(d, src);  // n * sizeof(T) % 16 == 0, aligned
      else if (F32) cp_async4(d, src);
      else *d = *src;
      ch += dch;
      c += dc;
      if (ch >= q) ch -= q, ++c;
      while (c >= steps) c -= steps, ++a;
    }
    if constexpr (SLAB) {  // v: the slab's columns of each step
      const int qv = vcols / per;
      for (int x = tid; x < steps * qv; x += THREADS) {
        const int cv = x / qv, chv = x - cv * qv;
        const T* src = v + off0 + (size_t)(t0 + cv) * stride + col0 + chv * per;
        T* d = dst + 3 * ARR + cv * CP + chv * per;
        if (vec) cp_async16(d, src);
        else if (F32) cp_async4(d, src);
        else *d = *src;
      }
    }
  };

  // run `run` in stage st, once it is whole in shared memory, prepared for
  // the step-pair form (a pair a warp): for the pair (t, t+1) = (c0, c1),
  // w clamped and bf16 converted, then in place r[c1] = r1 w0, k[c0] = w1
  // k0, w[c0] = w0 w1, and the scalars b0 = sum r0 u k0, c = sum r1 k0, b1
  // = sum r1 u k1. A ragged run's missing last step is w = 1, r = k = v = 0.
  auto prep = [&](int run, int st) {
    const int steps = min(RUN, t_len - run * RUN);
    float* f = fb + (size_t)st * SF;
    const T* rw = raw + (size_t)st * SF;
    for (int pr = warp; 2 * pr < steps; pr += WARPS) {
      const int c0 = 2 * pr, c1 = c0 + 1;
      const bool has1 = c1 < steps;
      float b0 = 0.0f, b1 = 0.0f, cr = 0.0f;
#pragma unroll
      for (int q = 0; q < UQ; ++q) {
        const int i = lane + 32 * q;
        if (i < NP) {
          const int o0 = c0 * NP + i, o1 = c1 * NP + i;
          const bool in0 = F32 || i < n, in1 = has1 && (F32 || i < n);
          const float r0 = in0 ? (F32 ? f[o0] : to_f(rw[o0])) : 0.0f;
          const float k0 = in0 ? (F32 ? f[ARR + o0] : to_f(rw[ARR + o0])) : 0.0f;
          const float w0 = clamp_w(in0 ? (F32 ? f[2 * ARR + o0] : to_f(rw[2 * ARR + o0])) : 0.0f);
          const float r1 = in1 ? (F32 ? f[o1] : to_f(rw[o1])) : 0.0f;
          const float k1 = in1 ? (F32 ? f[ARR + o1] : to_f(rw[ARR + o1])) : 0.0f;
          const float w1 = has1 ? clamp_w(in1 ? (F32 ? f[2 * ARR + o1] : to_f(rw[2 * ARR + o1])) : 0.0f) : 1.0f;
          b0 = fmaf(r0 * ub[q], k0, b0);
          b1 = fmaf(r1 * ub[q], k1, b1);
          cr = fmaf(r1, k0, cr);
          f[o0] = r0;
          f[o1] = r1 * w0;
          f[ARR + o0] = w1 * k0;
          f[ARR + o1] = k1;
          f[2 * ARR + o0] = w0 * w1;
          if constexpr (!SLAB) {
            if (!F32) f[3 * ARR + o0] = i < n ? to_f(rw[3 * ARR + o0]) : 0.0f;
            if (!F32 || !has1) f[3 * ARR + o1] = in1 ? to_f(rw[3 * ARR + o1]) : 0.0f;
          }
        }
      }
      if constexpr (SLAB) {  // v, the slab's columns
        for (int i = lane; i < CP; i += 32) {
          const int o0 = c0 * CP + i, o1 = c1 * CP + i;
          const bool in = i < vcols;
          if (!F32) f[3 * ARR + o0] = in ? to_f(rw[3 * ARR + o0]) : 0.0f;
          if (!F32 || !has1)
            f[3 * ARR + o1] = has1 && in ? to_f(rw[3 * ARR + o1]) : 0.0f;
        }
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        b0 += __shfl_xor_sync(0xffffffffu, b0, m);
        cr += __shfl_xor_sync(0xffffffffu, cr, m);
        b1 += __shfl_xor_sync(0xffffffffu, b1, m);
      }
      if (lane == 0)
        reinterpret_cast<float4*>(b_s)[(run & 1) * (RUN / 2) + pr] =
            make_float4(b0, cr, b1, 0.0f);
    }
  };

  issue(0, 0);
  cp_async_commit();
  if (nruns > 1) issue(1, 1);
  cp_async_commit();
  cp_async_wait<1>();  // run 0 (this thread's copies)
  __syncthreads();
  if (nruns > 0) prep(0, 0);

  for (int run = 0; run < nruns; ++run) {
    cp_async_wait<0>();  // run + 1 (this thread's copies)
    __syncthreads();     // run + 1 whole; run prepared; run - 1 walked
    if (run + 2 < nruns) issue(run + 2, (run + 2) % STAGES);
    cp_async_commit();
    if (run + 1 < nruns) prep(run + 1, (run + 1) % STAGES);

    const int t0 = run * RUN, steps = min(RUN, t_len - t0);
    const float* base = fb + (size_t)(run % STAGES) * SF;
    const float4* bs = reinterpret_cast<const float4*>(b_s) + (run & 1) * (RUN / 2);
    // a pair of steps: out_t = sum_i r0 S + v0 b0, out_t+1 = sum_i (r1 w0) S
    // + v0 c + v1 b1, S = (w0 w1) S + (w1 k0) v0 + k1 v1: five FP
    // instructions an element a pair
#pragma unroll 2
    for (int c0 = 0; c0 < steps; c0 += 2) {
      const float* rs = base + c0 * NP;  // step c0; step c1 is NP further
      float v0[CPL], v1[CPL];
      const float* vs = base + 3 * ARR + c0 * CP + (j0 - col0);
      load_cols(vs, v0);
      load_cols(vs + CP, v1);
      float a0[CPL][2], a1[CPL][2];
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) a0[cc][0] = a0[cc][1] = a1[cc][0] = a1[cc][1] = 0.0f;
#pragma unroll
      for (int q = 0; q < RPL / 4; ++q) {
        const int i0 = row_of(q, 0);
        float r0[4], r1w0[4], w1k0[4], k1[4], w01[4];
        load_cols(rs + i0, r0);
        load_cols(rs + NP + i0, r1w0);
        load_cols(rs + ARR + i0, w1k0);
        load_cols(rs + ARR + NP + i0, k1);
        load_cols(rs + 2 * ARR + i0, w01);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc) {
            float& x = S[cc][q * 4 + e];
            a0[cc][e & 1] = fmaf(r0[e], x, a0[cc][e & 1]);
            a1[cc][e & 1] = fmaf(r1w0[e], x, a1[cc][e & 1]);
            const float kv = fmaf(w1k0[e], v0[cc], k1[e] * v1[cc]);
            x = fmaf(w01[e], x, kv);
          }
      }
      const float4 bc = bs[c0 / 2];  // b0, c, b1
      const size_t o = off0 + (size_t)(t0 + c0) * stride + j0;
      const bool has1 = c0 + 1 < steps;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        float y0 = a0[cc][0] + a0[cc][1], y1 = a1[cc][0] + a1[cc][1];
#pragma unroll
        for (int m = CW; m < 32; m <<= 1) {
          y0 += __shfl_xor_sync(0xffffffffu, y0, m);
          y1 += __shfl_xor_sync(0xffffffffu, y1, m);
        }
        y0 = fmaf(v0[cc], bc.x, y0);
        y1 = fmaf(v1[cc], bc.z, fmaf(v0[cc], bc.y, y1));
        if (cc % G == gi && j0 + cc < n) {
          store(out + o + cc, y0);
          if (has1) store(out + o + stride + cc, y1);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int q = 0; q < RPL / 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row_of(q, e), j = j0 + c;
        if (i < n && j < n) s_last[bh * nn + (size_t)i * n + j] = S[c][q * 4 + e];
      }
}

// Past N = 256: rwkv6_wide. S of a (b, h) does not fit on chip at any N
// (64 KB of registers a CTA hold 2 columns x 256 rows x 32 lanes), so it
// lives in S_T's own device memory, which the kernel fills from s0 (or
// zeros) and updates in place; the last step leaves S_T there. A CTA owns
// one (b, h) and a slab of WW_COLS = 32 columns (grid y), lane = column;
// warp wp walks rows wp, wp + 8, ... of its column, stepwise:
//   y_j = sum_i r_i S[i, j] (its rows), S[i, j] = fmaf(w_i, S[i, j], k_i v_j)
// and the 8 warps' partial sums are added in warp order through shared
// memory, with v_j b_t (b_t = sum_i r_i u_i k_i, made by every CTA of the
// (b, h) in the same order). Each element of S is one thread's, so no two
// threads touch it; two barriers a step. Bound by the state's round trip
// to L2 a step, far from the kernel above; right first, for the shapes no
// configuration reaches.
constexpr int WW_COLS = 32;
constexpr int WW_WARPS = 8;
constexpr int WW_THREADS = 32 * WW_WARPS;

template <typename T>
__global__ void __launch_bounds__(WW_THREADS)
rwkv6_wide(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const T* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ out, float* __restrict__ s_last, int t_len,
           int h_len, int n) {
  __shared__ float part[WW_WARPS][WW_COLS];
  __shared__ float bpart[WW_WARPS];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const long long bh = blockIdx.x;
  const int hi = (int)(bh % h_len);
  const long long bi = bh / h_len;
  const int slabs = (n + WW_COLS - 1) / WW_COLS;
  const size_t nn = (size_t)n * n;
  const size_t stride = (size_t)h_len * n;
  const size_t off0 = (size_t)bi * t_len * stride + (size_t)hi * n;
  float* S = s_last + bh * nn;
  const T* ub = u + (size_t)hi * n;

  // slabs blockIdx.y, + gridDim.y, ... (a grid's y stops at 65,535)
  for (int slab = blockIdx.y; slab < slabs; slab += gridDim.y) {
    const int j = slab * WW_COLS + lane;
    const bool live = j < n;
    if (live)
      for (int i = wp; i < n; i += WW_WARPS)
        S[(size_t)i * n + j] = s0 != nullptr ? s0[bh * nn + (size_t)i * n + j] : 0.0f;
    for (int t = 0; t < t_len; ++t) {
      const size_t o = off0 + (size_t)t * stride;
      // b_t over the CTA: thread x takes rows x, x + 256, ...
      float b = 0.0f;
      for (int i = threadIdx.x; i < n; i += WW_THREADS)
        b = fmaf(to_f(r[o + i]) * to_f(ub[i]), to_f(k[o + i]), b);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) b += __shfl_xor_sync(0xffffffffu, b, m);
      const float vj = live ? to_f(v[o + j]) : 0.0f;
      float y = 0.0f;
      if (live)
        for (int i = wp; i < n; i += WW_WARPS) {
          float& x = S[(size_t)i * n + j];
          const float wi = clamp_w(to_f(w[o + i]));
          y = fmaf(to_f(r[o + i]), x, y);
          x = fmaf(wi, x, to_f(k[o + i]) * vj);
        }
      part[wp][lane] = y;
      if (lane == 0) bpart[wp] = b;
      __syncthreads();
      if (wp == 0) {
        float yt = 0.0f, bt = 0.0f;
#pragma unroll
        for (int q = 0; q < WW_WARPS; ++q) {
          yt += part[q][lane];
          bt += bpart[q];
        }
        if (live) store(out + o + j, fmaf(vj, bt, yt));
      }
      __syncthreads();  // part and bpart are free for the next step
    }
  }
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int NP>
int launch_np(const T* r, const T* k, const T* v, const T* w, const T* u,
              const float* s0, T* out, float* s_last, unsigned grid,
              int t_len, int h_len, int n, cudaStream_t s) {
  constexpr size_t smem = smem_of<T, NP>();
  auto kernel = rwkv6_kernel<T, NP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = (n * sizeof(T)) % 16 == 0 && aligned16(r) && aligned16(k) &&
                  aligned16(v) && aligned16(w);
  // past N = 64, a CTA a slab of cols_of<NP>() columns (grid y)
  const dim3 blocks(grid, (unsigned)((n + cols_of<NP>() - 1) / cols_of<NP>()));
  kernel<<<blocks, threads_of<NP>(), smem, s>>>(r, k, v, w, u, s0, out, s_last,
                                                t_len, h_len, n, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* r, const T* k, const T* v, const T* w, const T* u,
           const float* s0, T* out, float* s_last, int batch, int t_len,
           int h_len, int n, void* stream) {
  if (batch < 0 || t_len < 0 || h_len < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const long long grid = (long long)batch * h_len;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned g = (unsigned)grid;
  if (n <= 16)
    return launch_np<T, 16>(r, k, v, w, u, s0, out, s_last, g, t_len, h_len, n, s);
  if (n <= 32)
    return launch_np<T, 32>(r, k, v, w, u, s0, out, s_last, g, t_len, h_len, n, s);
  if (n <= 64)
    return launch_np<T, 64>(r, k, v, w, u, s0, out, s_last, g, t_len, h_len, n, s);
  if (n <= 128)
    return launch_np<T, 128>(r, k, v, w, u, s0, out, s_last, g, t_len, h_len, n, s);
  if (n <= MAX_NP)
    return launch_np<T, 256>(r, k, v, w, u, s0, out, s_last, g, t_len, h_len, n, s);
  const int slabs = (n + WW_COLS - 1) / WW_COLS;
  const dim3 blocks(g, (unsigned)(slabs < 65535 ? slabs : 65535));
  rwkv6_wide<T><<<blocks, WW_THREADS, 0, s>>>(r, k, v, w, u, s0, out, s_last,
                                              t_len, h_len, n);
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
