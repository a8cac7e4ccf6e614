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
// Any N >= 1: rwkv6_kernel to N = 64 (RWKV-6's head size; one CTA a (b, h),
// the state walked step by step on the CUDA cores), rwkv6_chunked past it
// (the TPU kernel's chunked matrix form on the tensor cores). Launchers
// return the cudaError_t of the launch.
//
// -- N <= 64: rwkv6_kernel --------------------------------------------------
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
//
// -- N > 64: rwkv6_chunked --------------------------------------------------
//
// What bounds it, at the two timed shapes (fp32, random s0): at (8, 1024,
// 32, 128) the bytes (r, k, v, w read, out written, s0 read, S_T written:
// 705 MB) take 0.210 ms at 3.35 TB/s, and the matrix products of the
// chunked form below, 4 N^2 + 2 C N = 69,632 flops a token and head (18.3
// GFLOP), 0.111 ms at 165 TFLOP/s (3xTF32: three TF32 products at 495); at
// (2, 1024, 8, 512) the bytes (201 MB) take 0.060 ms and the products
// (1.065 M flops a token and head, 17.4 GFLOP) 0.106 ms. The step form's
// 2.5 FP instructions an element a step (rwkv6_kernel) need 0.321 ms on
// the CUDA cores at both, so the step form cannot come near the bytes;
// the chunked form moves the work onto the tensor cores.
//
// The chunked form (the TPU kernel's; src/repro/kernels/rwkv6_scan.py:4-19):
// per chunk of C = 16 tokens, with P_t = prod_{j<t} w_j and Q_t =
// prod_{t<j<C} w_j (per row i, within the chunk), and S^T the state
// transposed (columns j of a slab by rows i):
//
//   out^T = S^T (r P)^T + v^T A^T                    state term, intra + bonus
//   A[t, s] = sum_i r_t[i] prod_{s<j<t} w_j[i] k_s[i]   (s < t), the bonus
//             sum_i r_t[i] u[i] k_t[i] on the diagonal (s = t), 0 above
//   S^T = S^T diag(P_C) + v^T (k Q)                  the chunk-boundary update
//
// Stability: every factor is a product of decays in [1e-37, 1], so each is
// in [0, 1]: nothing overflows, what underflows is 0 (and then below the
// result's ulp), never inf or NaN. The TPU kernel writes the same factors
// as exp(cum_prev), exp(cum_C - cum) and pairwise exp(cum_prev_t - cum_s),
// all with exponents <= 0; here P, Q and P_C are running products, and A
// is cut into 2 x 2 blocks of (t, s): a block below the diagonal, rows t1 =
// 2 tb, t2 = t1 + 1 and columns s1 = 2 sb, s2 = s1 + 1 (tb > sb), takes one
// exponential e = 2^(L_{t1-1} - L_{s2}) = prod_{s2<j<t1} w_j (L the
// inclusive prefix of log2 w; lg2 / ex2 on the MUFU unit, the exponent <= 0
// up to its rounding) and factors the other three by its decays: e w_{t1}
// for (t2, s2), e w_{s2} for (t1, s1), e w_{t1} w_{s2} for (t2, s1), each
// factor <= 1; a diagonal block's pair (t2, t1) has no decay between. C =
// 16 is one sub-chunk of the TPU's 64-token chunks cut into 16s, so A is
// one 16 x 16 diagonal block, made on the CUDA cores, and no off-diagonal
// block of A needs the tensor cores: at C = 64 with sub-chunks of 16, the
// prepared operands of a chunk (r P and k Q split into tf32 hi / lo, 64 x
// N each) would take 128 KB at N = 128, and two CTAs an SM hold 113 KB
// each. The tensor-core work a token is the same at any C but the intra
// product's 2 C N; C sets only how often S is split and scaled.
//
// Precision: every product runs on mma.sync.m16n8k8 TF32 with fp32
// accumulate as 3xTF32 (x = hi + lo, hi = cvt.rna.tf32(x), lo = x - hi read
// by the tensor cores to 19 bits; a_lo b_hi + a_hi b_lo + a_hi b_hi), each
// k pair (16 k, two m16n8k8 steps) of the state term and the intra product
// into a partial sum from +0 that an fp32 add folds into its accumulator,
// as gbatc_wide_3xtf32 in gbatc_kernels.cu does (the update's single k pair
// a partial a step, the two added before the fmaf with P_C); single-pass
// TF32 misses RWKV_LIMIT (tests/test_torch_rwkv6_chunks.py). bf16 inputs
// are converted to fp32 as they are read from shared memory; S and every
// sum stay fp32; out is rounded once to r's type.
//
// Tile and warp roles: a CTA of 8 warps owns one (b, h) and a slab of CP
// columns j of S (grid y; a y past 65,535 is walked), CP = 16 MT with MT =
// 8 x 128 / NP m tiles (NP: N rounded up to 128, 256, 512 or 1024), so
// CP = 128, 64, 32, 16 and one slab is the whole (b, h) to N = 128. The
// rows i go in panels of KP = 128; warp (mt, ip) (mt = warp % MT, ip =
// warp / MT) holds in registers S^T's m tile mt (16 columns) over rows ip
// 16 MT .. + 16 MT - 1 of every panel: 64 floats a lane at every NP, the
// accumulator fragments of m16n8 tiles, which are the A fragments of the
// state term with its k (rows i) permuted within each 8 (k q <-> i 2q, q +
// 4 <-> 2q + 1), so S never leaves the registers between chunks. Past N =
// 1024 (NP = 0 below) the slab is 16 columns and S lives in S_T's own
// device memory, each warp reading its fragments of a panel before the
// panel's products and writing them back after (a round trip a chunk, not
// a step); its RWKV_WIDE case in chip_smoke.py is N = 1100.
//
// A chunk's panels stream through a ring of two raw slots (r, k, w of a
// panel; v of the slab a chunk, in two slots of its own) filled with
// cp.async by all 256 threads one panel ahead (16-byte copies where N and
// the pointers allow, 4-byte ones otherwise, bf16 rows that allow neither
// loaded plainly); a ragged last chunk is masked in shared memory (w = 1,
// r = k = v = 0), rows past N too, and nothing is padded in device memory.
// A panel: barrier (its copies landed, the panel before done); the next
// panel's copies start; threads 0-127 (row i each) walk the chunk's
// 16 steps forward for r P (split into hi / lo planes, stored in MMA
// fragment order so every B fragment is one 16-byte load a lane, swizzled
// so neither side conflicts on banks), L and P_C, threads 128-255 backward
// for k Q (likewise); barrier; then even warps make their share of A and
// run their products, odd warps the other way round (the MUFU unit and
// the tensor cores overlap): A's 28 blocks take 8 lanes each (rows 4 part
// + 32 m of the panel), the 8 diagonal blocks and the bonuses 4 lanes each,
// partials that carry over the chunk's panels; a warp's products are the
// out^T partials of its m tile over its k pairs (12 MT MMAs) and its S^T
// fragments' update (12 MT). At the chunk's end A's row parts are added by
// shuffles, the WP = 8 / MT warps of an m tile add their out^T partials in
// warp order through shared memory, and warp ip = 0 adds v^T A^T (12 MMAs)
// and stores out. Shared memory: 110,912 bytes at N = 128 in fp32, so two
// CTAs fit on an SM; __launch_bounds__ keeps 128 registers, 64 of them S.
//
// What a CTA repeats: every slab CTA of a (b, h) prepares r P, k Q, L and
// P_C and makes A over all N rows itself (N / CP CTAs do it: 1 at N = 128,
// 4 at 256, 16 at 512, 64 at 1024). A chunk of one CTA runs 1,632 MMAs
// (3xTF32) at any NP; A takes 28 N exponentials and about 16 x 28 N FP
// instructions, the prep 2 N walks of 16 steps. Measured on an H100
// (tools/rwkv6_wide_timing.py --probes, the rest of a piece taken out), a
// CTA's phases barely overlap: at (8, 1024, 32, 128) the frame (barriers,
// chunk end, stores) takes about 0.2 ms, the state term and the update
// 0.13 each (bound by the shared loads of their B fragments: every warp
// reads all 32 KB of planes a chunk), A, the prep and the copies about
// 0.09 each; at (2, 1024, 8, 512), where 16 CTAs repeat A and the prep,
// those two take 0.36 and 0.40 ms of 1.5.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPL = 2;       // adjacent columns a lane holds
constexpr int G4 = 4;        // lanes sharing a column group (rows split)
constexpr int RUN = 16;      // steps a run
constexpr int STAGES = 3;    // runs in the ring
constexpr int NARR = 4;      // r, k, w, v

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
  return NP / CPL * G4;
}

// floats of one ring stage: r, k, w and v (RUN, NP) each
template <int NP>
__host__ __device__ constexpr int stage_of() {
  return NARR * NP * RUN;
}

// shared memory: fp32 runs (STAGES, stage_of), the scalars of each step
// pair (2, RUN / 2, 4), and for bf16 the raw runs the copies land in
// (STAGES, stage_of)
template <typename T, int NP>
constexpr size_t smem_of() {
  return (size_t)STAGES * stage_of<NP>() * sizeof(float) +
         4 * RUN * sizeof(float) +
         (sizeof(T) == 4 ? 0 : (size_t)STAGES * stage_of<NP>() * sizeof(T));
}

template <typename T, int NP>
__global__ void __launch_bounds__(2 * NP, NP == 64 ? 4 : 1)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             const T* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ out, float* __restrict__ s_last, int t_len,
             int h_len, int n, int vec) {
  static_assert(NP <= 64, "past N = 64: rwkv6_chunked");
  constexpr int THREADS = threads_of<NP>();
  constexpr int WARPS = THREADS / 32 > 0 ? THREADS / 32 : 1;
  constexpr int G = G4;                // lanes sharing a column group
  constexpr int CW = 32 / G;           // column groups a warp
  constexpr int RPL = NP / G;          // rows a lane
  constexpr int UQ = (NP + 31) / 32;   // u values a lane (b_t)
  constexpr int ARR = RUN * NP;        // one array of one run
  constexpr int SF = stage_of<NP>();   // floats of a stage
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fb = reinterpret_cast<float*>(smem_raw);  // (STAGES, SF)
  float* b_s = fb + STAGES * SF;                    // (2, RUN / 2, 4)
  T* raw = F32 ? reinterpret_cast<T*>(fb) : reinterpret_cast<T*>(b_s + 4 * RUN);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gi = lane / CW;                    // row group
  // first of this lane's columns
  const int j0 = (warp * CW + lane % CW) * CPL;
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

  // rows n .. NP-1 of every run are zero (the copies never write them)
  if (F32 && n < NP) {
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
    while (a < NARR) {
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
          if (!F32) f[3 * ARR + o0] = i < n ? to_f(rw[3 * ARR + o0]) : 0.0f;
          if (!F32 || !has1) f[3 * ARR + o1] = in1 ? to_f(rw[3 * ARR + o1]) : 0.0f;
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
      const float* vs = base + 3 * ARR + c0 * NP + j0;
      load_cols(vs, v0);
      load_cols(vs + NP, v1);
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

// ---- N > 64: rwkv6_chunked (see the note at the top) ----------------------

constexpr int CK_C = 16;        // tokens a chunk
constexpr int CK_KP = 128;      // rows i a panel
constexpr int CK_WARPS = 8;
constexpr int CK_THREADS = 32 * CK_WARPS;
constexpr int CK_MAX_NP = 1024;  // S in registers to here; past it NP = 0
constexpr int CK_BLOCKS = (CK_C / 2) * (CK_C / 2 - 1) / 2;  // A's 2 x 2 blocks below
constexpr int CK_BPARTS = 8;   // lanes (row parts) a block
constexpr int CK_DPARTS = 4;   // lanes (row parts) a diagonal block
static_assert(CK_BLOCKS * CK_BPARTS + CK_C / 2 * CK_DPARTS == CK_THREADS, "A's roles");

// The tile at each NP (N rounded up to 128, 256, 512 or 1024; 0 past 1024)
template <int NP>
struct Ck {
  static_assert(NP == 0 || (NP % CK_KP == 0 && NP <= CK_MAX_NP), "NP");
  static constexpr bool GLOBAL = NP == 0;  // S in S_T's device memory
  static constexpr int MT = GLOBAL ? 1 : CK_WARPS * CK_KP / NP;  // m tiles a slab
  static constexpr int WP = CK_WARPS / MT;   // warps an m tile (row parts)
  static constexpr int CP = 16 * MT;         // columns j a slab
  static constexpr int RP = GLOBAL ? 1 : NP / CK_KP;  // panels in registers
  static constexpr int FP = 2 * MT;          // S^T fragments a warp a panel
};

// Shared memory (byte offsets): the r P planes [k pair][t tile][hi, lo][32
// lanes] and k Q planes [i tile][hi, lo][32 lanes] of uint4, the m tiles'
// out^T partials [warp part][m tile][t tile][32] float4, L [C][LDL], P_C
// and u of the panel [KP], A [C][C + 1], then the raw slots: r, k, w
// [2][3][C][LDR] and v [2][C][LDV] in T (rows padded so the 16-byte loads
// of A's lanes, 4 blocks a warp, spread over the banks)
template <typename T, int NP>
struct CkSmem {
  static constexpr int PAD = sizeof(T) == 4 ? 4 : 8;
  static constexpr int LDR = CK_KP + PAD;
  static constexpr int LDV = Ck<NP>::CP + PAD;
  static constexpr int LDL = CK_KP + 4;
  static constexpr int RAW = 3 * CK_C * LDR;
  static constexpr int VRAW = CK_C * LDV;
  static constexpr int RED = Ck<NP>::WP > 1 ? Ck<NP>::WP * Ck<NP>::MT * 2 * 32 : 0;
  static constexpr size_t R_OFF = 0;
  static constexpr size_t K_OFF = R_OFF + (size_t)CK_KP / 16 * 2 * 2 * 32 * 16;
  static constexpr size_t RED_OFF = K_OFF + (size_t)CK_KP / 8 * 2 * 32 * 16;
  static constexpr size_t L_OFF = RED_OFF + (size_t)RED * 16;
  static constexpr size_t DECAY_OFF = L_OFF + (size_t)CK_C * LDL * 4;
  static constexpr size_t U_OFF = DECAY_OFF + (size_t)CK_KP * 4;
  static constexpr size_t A_OFF = U_OFF + (size_t)CK_KP * 4;
  static constexpr size_t RAW_OFF = A_OFF + (size_t)CK_C * (CK_C + 1) * 4;
  static constexpr size_t V_OFF = RAW_OFF + (size_t)2 * RAW * sizeof(T);
  static constexpr size_t BYTES = V_OFF + (size_t)2 * VRAW * sizeof(T);
  static_assert(RAW_OFF % 16 == 0 && V_OFF % 16 == 0 && LDR * sizeof(T) % 16 == 0 &&
                LDV * sizeof(T) % 16 == 0, "16-byte copies land aligned");
};

// x = hi + lo: hi = cvt.rna.tf32(x) (an integer add of half a tf32 ulp and
// a mask), lo = x - hi, exact in fp32, which the tensor cores read to 19
// bits (as gbatc_kernels.cu's split_plane)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & ~0x1fffu;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a . b over one m16n8k8 step, tf32 operands, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a pair's six products into part: step st of the k pair takes b's (x, y)
// for st = 0 and (z, w) for st = 1
__device__ __forceinline__ void mma_3x(float (&c)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint4& bh,
                                       const uint4& bl, int st) {
  const uint32_t h0 = st ? bh.z : bh.x, h1 = st ? bh.w : bh.y;
  const uint32_t l0 = st ? bl.z : bl.x, l1 = st ? bl.w : bl.y;
  mma_tf32(c, al, h0, h1);
  mma_tf32(c, ah, l0, l1);
  mma_tf32(c, ah, h0, h1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4 consecutive staged values as fp32 (16 bytes of fp32, 8 of bf16)
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  load_cols(p, x);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0.0f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

template <typename T>
__device__ __forceinline__ void copy_elems(T* d, const T* s, int vec) {
  if (vec) cp_async16(d, s);  // N * sizeof(T) % 16 == 0, aligned
  else if (sizeof(T) == 4) cp_async4(d, s);
  else *d = *s;
}

// The copies of piece (chunk c, panel p) into raw slot `slot`: r, k and w
// at the chunk's steps and the panel's rows, and with panel 0 the chunk's
// v at the slab's columns into v slot c % 2
template <typename T, int NP>
__device__ __noinline__ void ck_copy(const T* r, const T* k, const T* v, const T* w,
                                     unsigned char* smem, size_t off0, size_t stride,
                                     int c, int p, int slot, int t_len, int n, int col0,
                                     int vec) {
  using L = CkSmem<T, NP>;
  const int t0 = c * CK_C, steps = min(CK_C, t_len - t0);
  const int i0 = p * CK_KP, cols = min(CK_KP, n - i0);
  const int per = vec ? 16 / (int)sizeof(T) : 1;
  T* dst = reinterpret_cast<T*>(smem + L::RAW_OFF) + (size_t)slot * L::RAW;
  if (vec && steps == CK_C && cols == CK_KP) {  // a whole panel: constant divisors
    constexpr int PER = 16 / sizeof(T), QR = CK_KP / PER;
#pragma unroll
    for (int x = threadIdx.x; x < 3 * CK_C * QR; x += CK_THREADS) {
      const int row = x / QR, ch = x % QR, a = row / CK_C, t = row % CK_C;
      cp_async16(dst + row * L::LDR + ch * PER,
                 (a == 0 ? r : a == 1 ? k : w) + off0 + (size_t)(t0 + t) * stride + i0 +
                     ch * PER);
    }
  } else {  // a ragged chunk or panel, or element copies
    const int qr = (cols + per - 1) / per;  // copies a row
    for (int x = threadIdx.x; x < 3 * steps * qr; x += CK_THREADS) {
      const int row = x / qr, ch = x - row * qr;  // row = a * steps + t
      const int a = row / steps, t = row - a * steps;
      const T* src = (a == 0 ? r : a == 1 ? k : w) + off0 + (size_t)(t0 + t) * stride +
                     i0 + ch * per;
      copy_elems(dst + (a * CK_C + t) * L::LDR + ch * per, src, vec);
    }
  }
  if (p == 0) {
    T* dv = reinterpret_cast<T*>(smem + L::V_OFF) + (size_t)(c & 1) * L::VRAW;
    const int vcols = min(Ck<NP>::CP, n - col0), qv = (vcols + per - 1) / per;
    for (int x = threadIdx.x; x < steps * qv; x += CK_THREADS) {
      const int t = x / qv, ch = x - t * qv;
      copy_elems(dv + t * L::LDV + ch * per,
                 v + off0 + (size_t)(t0 + t) * stride + col0 + ch * per, vec);
    }
  }
}

// Prepare piece (chunk c, panel p) from raw slot `slot`: thread i < KP
// walks row i forward (R_t = r_t P_t into the r P planes, L_t, P_C, u),
// thread KP + i backward (K_t = k_t Q_t into the k Q planes); steps past
// the chunk's and rows past N are w = 1, r = k = 0 (written into the raw
// slot for A's lanes)
template <typename T, int NP>
__device__ __noinline__ void ck_prep(unsigned char* smem, const T* __restrict__ u,
                                     int hi, int c, int p, int slot, int t_len, int n) {
  using L = CkSmem<T, NP>;
  const int steps = min(CK_C, t_len - c * CK_C);
  T* rr = reinterpret_cast<T*>(smem + L::RAW_OFF) + (size_t)slot * L::RAW;
  T* kr = rr + CK_C * L::LDR;
  const T* wr = kr + CK_C * L::LDR;
  const int tid = threadIdx.x;
  if (tid < CK_KP) {
    const int i = tid, gi = p * CK_KP + i;
    const bool row_live = gi < n;
    uint32_t* rp = reinterpret_cast<uint32_t*>(smem + L::R_OFF);
    float* lcum = reinterpret_cast<float*>(smem + L::L_OFF);
    // R[t][i] is word 2 (i / 8 % 2) + i % 2 of lane (t % 8) 4 + i / 2 % 4 of
    // plane (k pair i / 16, t tile t / 8), the lane XOR-ed with 4 on odd
    // k pairs (so the two k pairs a warp writes fall on distinct banks)
    const int kp = i >> 4, word = 2 * ((i >> 3) & 1) + (i & 1), qq = (i >> 1) & 3;
    float P = 1.0f, lsum = 0.0f;
#pragma unroll
    for (int t = 0; t < CK_C; ++t) {
      const bool live = row_live && t < steps;
      const float wv = live ? clamp_w(to_f(wr[t * L::LDR + i])) : 1.0f;
      float rv = 0.0f;
      if (live) rv = to_f(rr[t * L::LDR + i]);
      else rr[t * L::LDR + i] = zero_of<T>();
      uint32_t h, lo;
      split_tf32(rv * P, h, lo);
      const int slot_lane = (((t & 7) * 4 + qq) ^ ((kp & 1) << 2));
      const int plane = (kp * 2 + (t >> 3)) * 2;
      rp[(plane * 32 + slot_lane) * 4 + word] = h;
      rp[((plane + 1) * 32 + slot_lane) * 4 + word] = lo;
      lsum += lg2(wv);
      lcum[t * L::LDL + i] = lsum;
      P *= wv;
    }
    reinterpret_cast<float*>(smem + L::DECAY_OFF)[i] = P;
    reinterpret_cast<float*>(smem + L::U_OFF)[i] = row_live ? to_f(u[(size_t)hi * n + gi]) : 0.0f;
  } else {
    const int i = tid - CK_KP, gi = p * CK_KP + i;
    const bool row_live = gi < n;
    uint4* kq = reinterpret_cast<uint4*>(smem + L::K_OFF);
    // K[4 tq .. 4 tq + 3][i] is the uint4 of lane (i % 8) 4 + tq of plane i /
    // 8, the lane XOR-ed with its eighth (conflict-free on both sides)
    const int fi = i >> 3, m = i & 7;
    float Q = 1.0f;
#pragma unroll
    for (int tq = CK_C / 4 - 1; tq >= 0; --tq) {
      uint32_t h[4], lo[4];
#pragma unroll
      for (int cc = 3; cc >= 0; --cc) {
        const int t = 4 * tq + cc;
        const bool live = row_live && t < steps;
        const float wv = live ? clamp_w(to_f(wr[t * L::LDR + i])) : 1.0f;
        float kv = 0.0f;
        if (live) kv = to_f(kr[t * L::LDR + i]);
        else kr[t * L::LDR + i] = zero_of<T>();
        split_tf32(kv * Q, h[cc], lo[cc]);
        Q *= wv;
      }
      const int l = m * 4 + tq, sl = l ^ (l >> 3);
      kq[(fi * 2) * 32 + sl] = make_uint4(h[0], h[1], h[2], h[3]);
      kq[(fi * 2 + 1) * 32 + sl] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

template <typename T, int NP>
__global__ void __launch_bounds__(CK_THREADS, 2)
rwkv6_chunked(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ w,
              const T* __restrict__ u, const float* __restrict__ s0,
              T* __restrict__ out, float* __restrict__ s_last, int t_len,
              int h_len, int n, int vec) {
  using K = Ck<NP>;
  using L = CkSmem<T, NP>;
  constexpr int C = CK_C, KP = CK_KP, MT = K::MT, WP = K::WP, CP = K::CP;
  constexpr int RP = K::RP, FP = K::FP;
  constexpr bool GLOBAL = K::GLOBAL;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint4* rplane = reinterpret_cast<const uint4*>(smem + L::R_OFF);
  const uint4* kplane = reinterpret_cast<const uint4*>(smem + L::K_OFF);
  float4* red = reinterpret_cast<float4*>(smem + L::RED_OFF);
  const float* lcum = reinterpret_cast<const float*>(smem + L::L_OFF);
  const float* decay = reinterpret_cast<const float*>(smem + L::DECAY_OFF);
  const float* u_s = reinterpret_cast<const float*>(smem + L::U_OFF);
  float* ab = reinterpret_cast<float*>(smem + L::A_OFF);  // [t][s], row C + 1
  const T* raw = reinterpret_cast<const T*>(smem + L::RAW_OFF);
  const T* vraw = reinterpret_cast<const T*>(smem + L::V_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mt = warp % MT, ip = warp / MT;
  const long long bh = blockIdx.x;
  const int hi = (int)(bh % h_len);
  const long long bi = bh / h_len;
  const size_t nn = (size_t)n * n;
  const size_t stride = (size_t)h_len * n;  // from step t to step t + 1
  const size_t off0 = (size_t)bi * t_len * stride + (size_t)hi * n;
  const int nchunks = (t_len + C - 1) / C;
  const int npan = GLOBAL ? (n + KP - 1) / KP : RP;
  const int slabs = (n + CP - 1) / CP;
  float* s_mem = s_last + bh * nn;
  const float* s_init = s0 != nullptr ? s0 + bh * nn : nullptr;

  // A's roles: lane 8 x + part of warps 0-6 the 2 x 2 block x of A below
  // the diagonal (rows tb, columns sb of blocks, tb > sb), over rows 4 part
  // + 32 m of each panel; lane 4 tb + part of warp 7 the pair (2 tb + 1, 2
  // tb) and the bonus of 2 tb and 2 tb + 1, over rows 4 part + 16 m
  const bool block = warp < CK_BLOCKS * CK_BPARTS / 32;
  const int apart = block ? lane % CK_BPARTS : lane % CK_DPARTS;
  int tb = lane / CK_DPARTS, sb = tb;
  if (block) {
    const int x = tid / CK_BPARTS;
    tb = 1;
    while (tb * (tb + 1) / 2 <= x) ++tb;
    sb = x - tb * (tb - 1) / 2;
  }

  // element e of this warp's S^T fragment f of panel p: row i, column j
  auto frag_i = [&](int p, int f, int e) { return p * KP + (ip * FP + f) * 8 + 2 * q + (e & 1); };
  auto frag_j = [&](int col0, int e) { return col0 + mt * 16 + g + 8 * (e >> 1); };
  auto load_frags = [&](float (&s)[FP][4], const float* src, int p, int col0) {
#pragma unroll
    for (int f = 0; f < FP; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = frag_i(p, f, e), j = frag_j(col0, e);
        s[f][e] = src != nullptr && i < n && j < n ? src[(size_t)i * n + j] : 0.0f;
      }
  };
  auto store_frags = [&](const float (&s)[FP][4], int p, int col0) {
#pragma unroll
    for (int f = 0; f < FP; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = frag_i(p, f, e), j = frag_j(col0, e);
        if (i < n && j < n) s_mem[(size_t)i * n + j] = s[f][e];
      }
  };

  // slabs blockIdx.y, + gridDim.y, ... (a grid's y stops at 65,535)
  for (int slab = blockIdx.y; slab < slabs; slab += gridDim.y) {
    const int col0 = slab * CP;
    float S[RP][FP][4];  // S^T: this warp's fragments of each panel
    if constexpr (!GLOBAL) {
#pragma unroll
      for (int p = 0; p < RP; ++p) load_frags(S[p], s_init, p, col0);
    } else if (nchunks == 0) {  // S_T = s0
      for (int p = 0; p < npan; ++p) {
        load_frags(S[0], s_init, p, col0);
        store_frags(S[0], p, col0);
      }
    }
    float acc[2][4];        // out^T of this warp's m tile, t tiles 0 and 1
    float da[4];            // this lane's partials of A (see a_share)

    // v^T's A fragments of chunk c, hi / lo (m = column j of m tile mt, k =
    // step t within the pair: k q <-> t = 4q + 2st, q + 4 <-> 4q + 2st + 1)
    auto v_frags = [&](int c, uint32_t (&vh)[2][4], uint32_t (&vl)[2][4]) {
      const int steps = min(C, t_len - c * C);
      const T* vr = vraw + (size_t)(c & 1) * L::VRAW;
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 4 * q + 2 * st + (e >> 1), j = mt * 16 + g + 8 * (e & 1);
          const float x = t < steps && col0 + j < n ? to_f(vr[t * L::LDV + j]) : 0.0f;
          split_tf32(x, vh[st][e], vl[st][e]);
        }
    };

    // A's share of piece n from raw slot `slot`. A block (t1, t2) x (s1,
    // s2) = (2 tb, 2 tb + 1) x (2 sb, 2 sb + 1) takes one exponential a row,
    // e = 2^(L_{t1-1} - L_{s2}) = prod_{s2<j<t1} w_j, and the rest by its
    // decays: e w_{t1} for (t2, s2), e w_{s2} for (t1, s1), e w_{t1} w_{s2}
    // for (t2, s1); da = A[t1][s1], A[t1][s2], A[t2][s1], A[t2][s2]. A
    // diagonal block's pair has no decay between (e = 1); da = A[t2][t1],
    // the bonuses r_t u k_t of t1 and t2. w is clamped here, and 1 at steps
    // past the chunk's and rows past N (r and k are 0 there: the prep).
    auto a_share = [&](int c, int p, int slot) {
      const T* rr = raw + (size_t)slot * L::RAW;
      const T* kr = rr + C * L::LDR;
      const T* wr = kr + C * L::LDR;
      const int steps = min(C, t_len - c * C), rows = n - p * KP;
      const bool whole = steps == C && rows >= KP;
      const int t1 = 2 * tb, t2 = t1 + 1, s1 = 2 * sb, s2 = s1 + 1;
      auto wv = [&](int t, int i, float x) {
        return whole || (t < steps && i < rows) ? clamp_w(x) : 1.0f;
      };
      if (block) {
#pragma unroll 2
        for (int m = 0; m < KP / (4 * CK_BPARTS); ++m) {
          const int i = 4 * apart + 4 * CK_BPARTS * m;
          float la[4], lb[4], w1[4], w2[4], ra[4], rb[4], ka[4], kb[4];
          load_cols(lcum + (t1 - 1) * L::LDL + i, la);
          load_cols(lcum + s2 * L::LDL + i, lb);
          load4(wr + t1 * L::LDR + i, w1);
          load4(wr + s2 * L::LDR + i, w2);
          load4(rr + t1 * L::LDR + i, ra);
          load4(rr + t2 * L::LDR + i, rb);
          load4(kr + s1 * L::LDR + i, ka);
          load4(kr + s2 * L::LDR + i, kb);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float e12 = ex2(la[e] - lb[e]);
            const float e22 = e12 * wv(t1, i + e, w1[e]);
            const float d2 = wv(s2, i + e, w2[e]);
            const float e11 = e12 * d2, e21 = e22 * d2;
            da[0] = fmaf(ra[e] * e11, ka[e], da[0]);
            da[1] = fmaf(ra[e] * e12, kb[e], da[1]);
            da[2] = fmaf(rb[e] * e21, ka[e], da[2]);
            da[3] = fmaf(rb[e] * e22, kb[e], da[3]);
          }
        }
      } else {
#pragma unroll 2
        for (int m = 0; m < KP / (4 * CK_DPARTS); ++m) {
          const int i = 4 * apart + 4 * CK_DPARTS * m;
          float uu[4], ra[4], rb[4], ka[4], kb[4];
          load_cols(u_s + i, uu);
          load4(rr + t1 * L::LDR + i, ra);
          load4(rr + t2 * L::LDR + i, rb);
          load4(kr + t1 * L::LDR + i, ka);
          load4(kr + t2 * L::LDR + i, kb);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            da[0] = fmaf(rb[e], ka[e], da[0]);
            da[1] = fmaf(ra[e] * uu[e], ka[e], da[1]);
            da[2] = fmaf(rb[e] * uu[e], kb[e], da[2]);
          }
        }
      }
    };

    // the products of piece (c, p) with this warp's S^T fragments s
    auto products = [&](int c, int p, float (&s)[FP][4]) {
      if constexpr (GLOBAL) load_frags(s, c == 0 ? s_init : s_mem, p, col0);

      // state term: out^T += S^T (r P)^T over this warp's k pairs of the
      // panel, each pair's six products into a partial from +0
#pragma unroll
      for (int kk = 0; kk < MT; ++kk) {
        const int kp = ip * MT + kk, sl = lane ^ ((kp & 1) << 2);
        uint4 bh[2], bl[2];
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          bh[tt] = rplane[((kp * 2 + tt) * 2) * 32 + sl];
          bl[tt] = rplane[((kp * 2 + tt) * 2 + 1) * 32 + sl];
        }
        float part[2][4];
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[tt][e] = 0.0f;
#pragma unroll
        for (int st = 0; st < 2; ++st) {
          // the accumulator fragment (j g / g + 8, i 2q / 2q + 1) as an A
          // fragment: a0 = c0, a1 = c2, a2 = c1, a3 = c3
          const float* sf = s[2 * kk + st];
          uint32_t ah[4], al[4];
          split_tf32(sf[0], ah[0], al[0]);
          split_tf32(sf[2], ah[1], al[1]);
          split_tf32(sf[1], ah[2], al[2]);
          split_tf32(sf[3], ah[3], al[3]);
#pragma unroll
          for (int tt = 0; tt < 2; ++tt) mma_3x(part[tt], ah, al, bh[tt], bl[tt], st);
        }
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[tt][e] += part[tt][e];
      }

      // update: S^T = S^T diag(P_C) + v^T (k Q), the chunk's steps one k pair
      uint32_t vh[2][4], vl[2][4];
      v_frags(c, vh, vl);
#pragma unroll
      for (int f = 0; f < FP; ++f) {
        const int fi = ip * FP + f, sl = lane ^ (lane >> 3);
        const uint4 bh = kplane[(fi * 2) * 32 + sl], bl = kplane[(fi * 2 + 1) * 32 + sl];
        float part[2][4] = {};
#pragma unroll
        for (int st = 0; st < 2; ++st) mma_3x(part[st], vh[st], vl[st], bh, bl, st);
        const float2 d = *reinterpret_cast<const float2*>(decay + fi * 8 + 2 * q);
        s[f][0] = fmaf(d.x, s[f][0], part[0][0] + part[1][0]);
        s[f][1] = fmaf(d.y, s[f][1], part[0][1] + part[1][1]);
        s[f][2] = fmaf(d.x, s[f][2], part[0][2] + part[1][2]);
        s[f][3] = fmaf(d.y, s[f][3], part[0][3] + part[1][3]);
      }
      if constexpr (GLOBAL) store_frags(s, p, col0);
    };

    // piece (c, p): panel p of chunk c
    auto piece = [&](int c, int p, float (&s)[FP][4]) {
      const int n_piece = c * npan + p, slot = n_piece & 1;
      if (p == 0) {
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[tt][e] = 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) da[e] = 0.0f;
      }
      cp_async_wait<0>();  // piece n (this thread's copies)
      __syncthreads();     // piece n whole; piece n - 1 done with the planes
      if (n_piece + 1 < nchunks * npan) {
        const int c1 = p + 1 < npan ? c : c + 1, p1 = p + 1 < npan ? p + 1 : 0;
        ck_copy<T, NP>(r, k, v, w, smem, off0, stride, c1, p1, slot ^ 1, t_len, n,
                       col0, vec);
      }
      cp_async_commit();
      ck_prep<T, NP>(smem, u, hi, c, p, slot, t_len, n);
      __syncthreads();     // the planes, L, P_C and u of piece n ready
      // A's share, then the products on even warps, the other way round on
      // odd ones, so that the MUFU unit and the tensor cores overlap
#pragma unroll 1
      for (int ph = 0; ph < 2; ++ph) {
        if (ph == (warp & 1)) a_share(c, p, slot);
        else products(c, p, s);
      }
    };

    // the chunk's end: the m tile's partials in warp order, + v^T A^T, out
    auto chunk_end = [&](int c) {
      const int t0 = c * C, steps = min(C, t_len - t0);
      if (WP > 1 && ip > 0) {
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
          red[((ip * MT + mt) * 2 + tt) * 32 + lane] =
              make_float4(acc[tt][0], acc[tt][1], acc[tt][2], acc[tt][3]);
      }
      // A: each block's row parts added by shuffles, then written once
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int m = 1; m < CK_BPARTS; m <<= 1)
          if (block || m < CK_DPARTS) da[e] += __shfl_xor_sync(0xffffffffu, da[e], m);
      if (apart == 0) {
        const int t1 = 2 * tb, t2 = t1 + 1, s1 = 2 * sb, s2 = s1 + 1;
        if (block) {
          ab[t1 * (C + 1) + s1] = da[0];
          ab[t1 * (C + 1) + s2] = da[1];
          ab[t2 * (C + 1) + s1] = da[2];
          ab[t2 * (C + 1) + s2] = da[3];
        } else {
          ab[t2 * (C + 1) + t1] = da[0];
          ab[t1 * (C + 1) + t1] = da[1];
          ab[t2 * (C + 1) + t2] = da[2];
        }
      }
      __syncthreads();
      if (ip != 0) return;
#pragma unroll
      for (int wp = 1; wp < WP; ++wp)
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          const float4 x = red[((wp * MT + mt) * 2 + tt) * 32 + lane];
          acc[tt][0] += x.x, acc[tt][1] += x.y, acc[tt][2] += x.z, acc[tt][3] += x.w;
        }
      // A^T's B fragments (k = s, n = t): b0 = A[8 tt + g][4q + 2st], b1 =
      // A[8 tt + g][4q + 2st + 1]; 0 above the diagonal
      auto a_at = [&](int t, int s) { return s > t ? 0.0f : ab[t * (C + 1) + s]; };
      uint32_t vh[2][4], vl[2][4];
      v_frags(c, vh, vl);
      float part[2][4];
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[tt][e] = 0.0f;
        uint32_t b[4], bl4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a_at(8 * tt + g, 4 * q + e), b[e], bl4[e]);
        const uint4 bh = make_uint4(b[0], b[1], b[2], b[3]);
        const uint4 bl = make_uint4(bl4[0], bl4[1], bl4[2], bl4[3]);
#pragma unroll
        for (int st = 0; st < 2; ++st) mma_3x(part[tt], vh[st], vl[st], bh, bl, st);
      }
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 8 * tt + 2 * q + (e & 1), j = frag_j(col0, 2 * (e >> 1));
          if (t < steps && j < n)
            store(out + off0 + (size_t)(t0 + t) * stride + j, acc[tt][e] + part[tt][e]);
        }
    };

    if (nchunks > 0)
      ck_copy<T, NP>(r, k, v, w, smem, off0, stride, 0, 0, 0, t_len, n, col0, vec);
    cp_async_commit();
    for (int c = 0; c < nchunks; ++c) {
      if constexpr (GLOBAL) {
        for (int p = 0; p < npan; ++p) piece(c, p, S[0]);
      } else {
#pragma unroll
        for (int p = 0; p < RP; ++p) piece(c, p, S[p]);
      }
      chunk_end(c);
    }
    cp_async_wait<0>();
    if constexpr (!GLOBAL) {
#pragma unroll
      for (int p = 0; p < RP; ++p) store_frags(S[p], p, col0);
    }
    __syncthreads();  // the shared buffers are free for the next slab
  }
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int vec_of(const T* r, const T* k, const T* v, const T* w, int n) {
  return (n * sizeof(T)) % 16 == 0 && aligned16(r) && aligned16(k) &&
         aligned16(v) && aligned16(w);
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
  kernel<<<grid, threads_of<NP>(), smem, s>>>(r, k, v, w, u, s0, out, s_last,
                                              t_len, h_len, n, vec_of(r, k, v, w, n));
  return (int)cudaGetLastError();
}

template <typename T, int NP>
int launch_chunked(const T* r, const T* k, const T* v, const T* w, const T* u,
                   const float* s0, T* out, float* s_last, unsigned grid,
                   int t_len, int h_len, int n, cudaStream_t s) {
  constexpr size_t smem = CkSmem<T, NP>::BYTES;
  auto kernel = rwkv6_chunked<T, NP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // two CTAs an SM need the whole carveout
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int slabs = (n + Ck<NP>::CP - 1) / Ck<NP>::CP;
  const dim3 blocks(grid, (unsigned)(slabs < 65535 ? slabs : 65535));
  kernel<<<blocks, CK_THREADS, smem, s>>>(r, k, v, w, u, s0, out, s_last, t_len,
                                          h_len, n, vec_of(r, k, v, w, n));
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
    return launch_chunked<T, 128>(r, k, v, w, u, s0, out, s_last, g, t_len, h_len, n, s);
  if (n <= 256)
    return launch_chunked<T, 256>(r, k, v, w, u, s0, out, s_last, g, t_len, h_len, n, s);
  if (n <= 512)
    return launch_chunked<T, 512>(r, k, v, w, u, s0, out, s_last, g, t_len, h_len, n, s);
  if (n <= CK_MAX_NP)
    return launch_chunked<T, CK_MAX_NP>(r, k, v, w, u, s0, out, s_last, g, t_len, h_len,
                                        n, s);
  return launch_chunked<T, 0>(r, k, v, w, u, s0, out, s_last, g, t_len, h_len, n, s);
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
