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
// Four kernels: fp32 at D <= 32 runs flash_kernel on the CUDA cores (the
// design below; its bits are the codec attention family's), fp32 at 32 < D
// <= 256 runs flash_f32_3xtf32 on the tensor cores in 3xTF32, bf16 at D <=
// 256 runs flash_bf16_mma on the tensor cores, and both dtypes past D = 256
// run flash_wide_mma on the tensor cores, fp32 in 3xTF32 (their designs are
// further down, each above its kernel). Any D >= 1 and any number of query
// tiles: a grid's y stops at 65,535, so past that each CTA loops over tiles
// blockIdx.y, blockIdx.y + gridDim.y, ..., each with the arithmetic of one
// tile (flash_wide_mma loops alike over its y and z).
//
// It replaces the Pallas TPU kernel flash_attention of
// src/repro/kernels/flash_attention.py (_flash_kernel). What is kept from it
// is the function, the whole K/V sequence of a head held on chip, and its
// arithmetic order per block of keys (block max, one rescale of (l, acc),
// then the block's exp-weighted sum); the TPU's need for Tk % block_k == 0
// when not causal is not: the ragged tail is masked here.
//
// fp32, D <= 32. Bound on this card: at the codec's shape (4096, 2, 232, 16) a
// (q, k) pair costs 2 * D FMAs against no device-memory traffic beyond one
// read of q, k, v and one write of o, so the kernel is bound by fp32
// operations on the CUDA cores (0.42 ms; TF32 tensor cores are not allowed
// on this path: they keep about three decimal digits). What limits it is
// instruction issue: per key a thread's 64 FMAs share the issue slots with
// 8 shared loads and the softmax's maxima, subtractions, exponentials and
// sums. Design:
//
// * One CTA of 128 threads owns one (batch, head) and a tile of query rows.
//   A thread holds R = 2 neighbouring query rows; a row belongs to G = DP /
//   16 neighbouring threads, each holding 16 of its head dims of q and of
//   the accumulator in registers (at D <= 16, G = 1 and one CTA covers 256
//   rows: the codec's 232 in one CTA). Each broadcast shared load of a K or
//   V row feeds both rows' FMAs: two independent chains, half the loads per
//   FMA of one row a thread. With G > 1 a score is the group's partial dot
//   products summed by an xor butterfly of shuffles, which leaves the same
//   bits in every thread of the group. DP, D rounded up to 16 or 32, is a
//   template argument; dims past D are zero. (Wider heads, G >= 4, paid
//   2- to 4-way bank conflicts on every K and V read and ran the LM
//   shapes 2-6.5x behind SDPA: they go to flash_f32_3xtf32.)
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
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// Query tile yt of (batch, head) blockIdx.x.
template <typename T, int DP, int KB>
__device__ __forceinline__ void flash_tile(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int tq, int tk, int d, int causal, int window,
    float scale, int chunk, int vec, int yt) {
  constexpr int G = DP / DPT;                // threads per query row
  constexpr int ROWS = THREADS / G * R;      // query rows per CTA
  extern __shared__ __align__(16) float kv_s[];
  float* sk = kv_s;              // (chunk, DP)
  float* sv = kv_s + chunk * DP;  // (chunk, DP)

  const long long bh = blockIdx.x;
  const int q0 = yt * ROWS;
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

// A grid's y stops at 65,535: a CTA takes query tiles blockIdx.y,
// blockIdx.y + gridDim.y, ... of q_tiles (one, up to 65,535 tiles), each
// with the arithmetic of one tile a CTA.
template <typename T, int DP, int KB>
__global__ void __launch_bounds__(THREADS, 4)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int tq, int tk,
             int d, int causal, int window, float scale, int chunk, int vec,
             int q_tiles) {
  for (int yt = blockIdx.y; yt < q_tiles; yt += gridDim.y) {
    if (yt != (int)blockIdx.y) __syncthreads();  // shared memory is free
    flash_tile<T, DP, KB>(q, k, v, o, tq, tk, d, causal, window, scale, chunk,
                          vec, yt);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the grid's y (or z) for `tiles` tiles: every tile up to 65,535, else the
// CTAs loop over them
inline int grid_y(int tiles) { return tiles < 65535 ? tiles : 65535; }

template <typename T, int DP>
int launch_as(const T* q, const T* k, const T* v, T* o, long long bh, int tq,
              int tk, int d, int causal, int window, float scale,
              void* stream) {
  constexpr int ROWS = THREADS / (DP / DPT) * R;
  const int q_tiles = (tq + ROWS - 1) / ROWS;
  if (bh > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the whole head when it fits, else chunks of the same size for every CTA
  const int max_chunk =
      KV_BYTES / (2 * DP * (int)sizeof(float)) / BLOCK_KEYS * BLOCK_KEYS;
  const int whole = (tk + BLOCK_KEYS - 1) / BLOCK_KEYS * BLOCK_KEYS;
  const int chunk = whole < max_chunk ? whole : max_chunk;
  const size_t smem = 2 * (size_t)chunk * DP * sizeof(float);
  const int vec = sizeof(T) == sizeof(float) && d == DP && aligned16(k) &&
                  aligned16(v);
  dim3 grid((unsigned)bh, (unsigned)grid_y(q_tiles));
  flash_kernel<T, DP, BLOCK_KEYS>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          q, k, v, o, tq, tk, d, causal, window, scale, chunk, vec, q_tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: flash_bf16_mma
//
// A CTA of 4 warps owns 64 query rows of one (batch, head); a warp owns 16.
// Per tile of KN keys (64; 32 at DP = 256, so that two CTAs fit an SM):
//   S = Q K^T        mma.sync m16n8k16 bf16 x bf16 -> fp32: the products of
//                    bf16 values are exact in fp32, so S is the plain
//                    version's fp32 score up to the order of its sum;
//   s = S * scale * log2(e) in fp32 (q is not pre-scaled: scaling a bf16 q
//                    would round it), masked to -1e30 as the reference, the
//                    dead tail k >= Tk to -inf (p = 0 exactly);
//   online softmax   row max over the quad (2 shuffles), one correction
//                    exp2f(m - m_new) of (l, acc) a tile, p = exp2f(s - m),
//                    l summed from the fp32 p;
//   acc += P_hi V + P_lo V   P_hi = bf16(p), P_lo = bf16(p - P_hi), both
//                    with fp32 accumulate. One bf16 rounding of P is not
//                    enough: where a row's weighted sum cancels
//                    (|o| << sum p|v| / l) its error is a bf16 ulp of
//                    sum p|v|, tens of ulps of o, against the per-element
//                    gate |kernel - plain| <= 2^-7 |plain| + 4e-5. The pair
//                    carries p to about 2^-16, as close as the fp32 version.
// Fragments come from shared memory by ldmatrix (.trans for V, which is
// the row-major B operand of P V); Q's fragments stay in registers for the
// whole key loop at DP <= 128 and are re-read per tile at DP = 256, where
// the accumulator alone takes 128 registers a thread. K and V stay bf16 in
// shared memory: a 2-stage cp.async ring of (K, V) tiles, so the next
// tile's copy overlaps this tile's products. Rows are DP + 8 elements
// apart (an odd number of 16-byte units), so the 8 rows an ldmatrix reads
// fall in 8 different bank groups. Head dims d..DP-1 are zero in shared
// memory and add exactly 0 to a score; D = 8, 37, 80 ... run the next
// instantiation of DP in {16, 32, 64, 80, 128, 256}.
// Work: a CTA visits the key tiles that meet [lo, hi): hi = min(Tk, q0 +
// 64) when causal, else Tk; lo = q0 - window + 1 under a window (unless
// some row has no live key at all, when the reference's uniform weights
// over every key must be reproduced: then lo = 0). Only tiles at the
// diagonal, the window's edge or the ragged tail run mask logic.
// Bound: bf16 tensor-core operations (4 x live pairs x D at 989 TFLOP/s);
// the kernel issues 1.5 times that (Q K^T once, P V twice) plus the masked
// part of the edge tiles.
// Order: fixed, no atomics, no split over keys; a row's bits depend only on
// its q, its head's K/V and its 64-row tile's index, so the same inputs give
// the same bits on every launch and for any batch sub-range.

using bf16 = __nv_bfloat16;

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_ROWS = 16 * MMA_WARPS;  // query rows per CTA
constexpr int STAGES = 2;                 // K/V tiles in flight

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(unsigned dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x, y) as a bf16 pair hi and the pair of what hi leaves, lo
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Where (batch, head) bh's K and V start: the one place that knows K/V
// have as many heads as Q.
__device__ __forceinline__ long long kv_head_offset(long long bh, int tk,
                                                    int d) {
  return bh * tk * d;
}

// ROWS rows of d bf16 from g (row r0 on) into shared rows LDS elements
// apart, zero past nvalid rows; vec: 16-byte cp.async copies (d % 8 == 0,
// 16-byte aligned; dims d..DP-1 are zeroed once by the caller), else
// element loads that also write the zero dims.
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, int r0,
                                          int nvalid, int d, int vec) {
  constexpr int LDS = DP + 8;
  if (vec) {
    const int chunks = d / 8;
    for (int e = threadIdx.x; e < ROWS * chunks; e += MMA_THREADS) {
      const int r = e / chunks, c = (e - r * chunks) * 8;
      const bool ok = r0 + r < nvalid;
      cp_async16_zfill(smem_u32(s + r * LDS + c),
                       g + (ok ? (long long)(r0 + r) * d + c : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += MMA_THREADS) {
      const int r = e / DP, c = e - r * DP;
      s[r * LDS + c] = (r0 + r < nvalid && c < d)
                           ? g[(long long)(r0 + r) * d + c]
                           : __float2bfloat16_rn(0.f);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int DP>
__host__ __device__ constexpr int mma_keys() { return DP <= 128 ? 64 : 32; }

template <int DP>
constexpr size_t mma_smem_bytes() {
  return (size_t)(MMA_ROWS + STAGES * 2 * mma_keys<DP>()) * (DP + 8) *
         sizeof(bf16);
}

// Query tile yt of q_tiles of (batch, head) blockIdx.x.
template <int DP>
__device__ __forceinline__ void flash_bf16_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int tq, int tk, int d,
    int causal, int window, float scale, int skip_below_window, int vec,
    int yt, int q_tiles) {
  constexpr int KN = mma_keys<DP>();  // keys per tile
  constexpr int LDS = DP + 8;         // shared row stride, elements
  constexpr int KD = DP / 16;         // k-steps of Q K^T
  constexpr int NT = KN / 8;          // key n-tiles of S
  constexpr int DT = DP / 8;          // dim n-tiles of the accumulator
  constexpr bool QREG = DP <= 128;    // Q fragments held in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // (MMA_ROWS, LDS)
  bf16* skv = sq + MMA_ROWS * LDS;  // STAGES x {K (KN, LDS), V (KN, LDS)}

  const long long bh = blockIdx.x;
  // the heaviest causal tiles (the last rows) are scheduled first
  const int q0 = (q_tiles - 1 - yt) * MMA_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = q + bh * tq * d;
  const long long kv = kv_head_offset(bh, tk, d);
  const bf16* kb = k + kv;
  const bf16* vb = v + kv;

  const int lo = (window > 0 && skip_below_window) ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(tk, q0 + MMA_ROWS) : tk;
  const int t_lo = lo / KN, t_hi = (hi + KN - 1) / KN;

  if (vec && d < DP) {  // the padded dims of every shared row, once
    constexpr int ROWS_ALL = MMA_ROWS + STAGES * 2 * KN;
    const int pad = DP - d;
    for (int e = threadIdx.x; e < ROWS_ALL * pad; e += MMA_THREADS) {
      const int r = e / pad;
      sq[r * LDS + d + (e - r * pad)] = __float2bfloat16_rn(0.f);
    }
  }
  auto load_kv = [&](int stage, int t) {
    bf16* sk = skv + stage * 2 * KN * LDS;
    load_rows<DP, KN>(sk, kb, t * KN, tk, d, vec);
    load_rows<DP, KN>(sk + KN * LDS, vb, t * KN, tk, d, vec);
  };
  load_rows<DP, MMA_ROWS>(sq, qb, q0, tq, d, vec);
  cp_async_commit();
  load_kv(0, t_lo);
  cp_async_commit();

  // this thread's rows: ra and ra + 8 of the warp's 16
  const int ra = q0 + warp * 16 + lane / 4;
  const int kq = 2 * (lane % 4);  // its first key (column) of an n-tile
  // ldmatrix row addresses: Q as the A operand, K as the B operand of
  // Q K^T, V (transposed) as the B operand of P V
  const unsigned q_addr =
      smem_u32(sq + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
               (lane >> 4) * 8);
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;

  unsigned qf[QREG ? KD : 1][4];
  if (QREG) {
    cp_async_wait<1>();  // Q's group is done; the first K/V tile may not be
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < (QREG ? KD : 1); ++kd) ldsm_x4(q_addr + kd * 32, qf[kd]);
  }

  float acc[DT][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float sl2 = scale * LOG2E;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) % STAGES;
    if (t + 1 < t_hi) {
      load_kv((t + 1 - t_lo) % STAGES, t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sk = skv + stage * 2 * KN * LDS;
    const bf16* sv = sk + KN * LDS;

    // S = Q K^T for the warp's 16 rows x KN keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      unsigned a[4];
      if (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[QREG ? kd : 0][i];
      } else {
        ldsm_x4(q_addr + kd * 32, a);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned b[4];
        ldsm_x4(smem_u32(sk + (j * 8 + k_row) * LDS + kd * 16 + k_col), b);
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
      }
    }

    // scale into the log2 domain; masks only on edge tiles (uniform)
    const int k0 = t * KN;
    const bool edge = (causal && k0 + KN - 1 > q0) ||
                      (window > 0 && k0 <= q0 + MMA_ROWS - 1 - window) ||
                      k0 + KN > tk;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] *= sl2;
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + j * 8 + kq + (i & 1), row = ra + (i >> 1) * 8;
          if (key >= tk)
            s[j][i] = -INFINITY;
          else if ((causal && key > row) || (window > 0 && key <= row - window))
            s[j][i] = NEG_INF;
        }
    }

    // online softmax, rows ra (i = 0, 1) and ra + 8 (i = 2, 3)
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(FULL, mt[r], 2));
      corr[r] = exp2f(m[r] - mt[r]);
      m[r] = mt[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = exp2f(s[j][i] - m[i >> 1]);
        l[i >> 1] += s[j][i];
      }

    // acc += P_hi V + P_lo V, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        unsigned b[4];
        ldsm_x4_trans(smem_u32(sv + (kk * 16 + v_row) * LDS + j * 8 + v_col), b);
        mma_bf16(acc[j], ph, b[0], b[1]);
        mma_bf16(acc[j], pl, b[0], b[1]);
        mma_bf16(acc[j + 1], ph, b[2], b[3]);
        mma_bf16(acc[j + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + r * 8;
    if (row >= tq) continue;
    bf16* ob = o + (bh * tq + row) * d;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int c = j * 8 + kq;
      const float x = acc[j][2 * r] / l[r], y = acc[j][2 * r + 1] / l[r];
      if (c + 1 < d && !(d & 1)) {
        *reinterpret_cast<__nv_bfloat162*>(ob + c) = __floats2bfloat162_rn(x, y);
      } else {
        if (c < d) ob[c] = __float2bfloat16_rn(x);
        if (c + 1 < d) ob[c + 1] = __float2bfloat16_rn(y);
      }
    }
  }
}

// tiles blockIdx.y, + gridDim.y, ... of q_tiles (see flash_kernel)
template <int DP>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_bf16_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int tq,
               int tk, int d, int causal, int window, float scale,
               int skip_below_window, int vec, int q_tiles) {
  for (int yt = blockIdx.y; yt < q_tiles; yt += gridDim.y) {
    if (yt != (int)blockIdx.y) __syncthreads();  // shared memory is free
    flash_bf16_tile<DP>(q, k, v, o, tq, tk, d, causal, window, scale,
                        skip_below_window, vec, yt, q_tiles);
  }
}

template <int DP>
int launch_mma(const bf16* q, const bf16* k, const bf16* v, bf16* o,
               long long bh, int tq, int tk, int d, int causal, int window,
               float scale, void* stream) {
  const int q_tiles = (tq + MMA_ROWS - 1) / MMA_ROWS;
  if (bh > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = mma_smem_bytes<DP>();
  // above 48 KB only as dynamic shared memory, once allowed (per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  // a row with no live key (window > 0, q - window + 1 >= Tk) takes the
  // reference's uniform weights over every key: then visit them all
  const int skip = !(window > 0 && (long long)tq > (long long)tk + window - 1);
  dim3 grid((unsigned)bh, (unsigned)grid_y(q_tiles));
  flash_bf16_mma<DP>
      <<<grid, MMA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          q, k, v, o, tq, tk, d, causal, window, scale, skip, vec, q_tiles);
  return (int)cudaGetLastError();
}

// past D = 256, both dtypes (flash_wide_mma, below)
template <typename T>
int launch_wide_mma(const T* q, const T* k, const T* v, T* o, long long bh,
                    int tq, int tk, int d, int causal, int window, float scale,
                    void* stream);

int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                long long bh, int tq, int tk, int d, int causal, int window,
                float scale, void* stream) {
  if (d < 1 || bh < 0 || tq < 0 || tk < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || tq == 0) return (int)cudaSuccess;
  if (d <= 16)
    return launch_mma<16>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                          stream);
  if (d <= 32)
    return launch_mma<32>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                          stream);
  if (d <= 64)
    return launch_mma<64>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                          stream);
  if (d <= 80)
    return launch_mma<80>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                          stream);
  if (d <= 128)
    return launch_mma<128>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                           stream);
  if (d <= 256)
    return launch_mma<256>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                           stream);
  return launch_wide_mma<bf16>(q, k, v, o, bh, tq, tk, d, causal, window,
                               scale, stream);
}

// ---------------------------------------------------------------------------
// fp32 past D = 32 on the tensor cores: flash_f32_3xtf32
//
// It replaces the same Pallas kernel (_flash_kernel,
// src/repro/kernels/flash_attention.py:29) at the LM head dims (D = 64 to
// 256: Llama, StableLM, Yi, Qwen, RecurrentGemma, Whisper) and computes
// what flash_kernel computes: softmax(q k^T scale + mask) v with the same
// causal, window and ragged-tail masks (masked scores at -1e30) and the
// output acc / max(l, 1e-30).
//
// Bound on this card: the products. A live (query, key) pair costs 2 D
// multiply-adds (Q K^T, then P V), 4 pairs D FLOPs in all; in 3xTF32 the
// tensor cores run three times that, 12 pairs D at 495 TFLOP/s (1.05 ms at
// Yi-9B's causal (4, 32, 2304, 2304, 128)), against one read of q, k, v and
// one write of o at 3.35 TB/s (0.09 ms there) or 4 pairs D at the CUDA
// cores' 67 TFLOP/s (2.6 ms). Single-pass TF32 keeps about three decimal
// digits, too few for the 2e-5 the route is held to. Design:
//
// * Products are TF32 mma.sync.m16n8k8 with fp32 accumulate in the 3xTF32
//   form: each operand x = hi + lo, hi = cvt.rna.tf32(x), lo = x - hi as
//   the tensor cores read it (split_tf32), and each product a_lo b_hi +
//   a_hi b_lo + a_hi b_hi, the two small terms first, into one
//   accumulator. What is dropped (a_lo b_lo and lo's rounding) is about
//   2^-21 of a product.
// * A CTA of 4 warps owns 64 MT query rows of one (batch, head), a warp
//   16 MT (MT = 2 m-tiles to DP = 128, 1 at 256), and walks tiles of KN
//   keys (64, 32, 16, 32 at DP = 64, 80, 128, 256; tf_keys). A warp's K
//   and V fragments are loaded and split once for its MT m-tiles (with
//   MT = 1, where all four warps split the whole K/V tile for 16 rows
//   each, the Llama shape takes 18 % longer: tools/flash_f32_variants.py). q is pre-scaled by scale * log2(e) once, in
//   shared memory, so p = exp2f(s - m). Q stays there and is split as its
//   fragments are loaded, once a tile: held in registers, its split
//   fragments spilled beside the accumulator and the scores.
// * K and V stay fp32 in shared memory: a 2-stage cp.async ring of (K, V)
//   tiles, so the next tile's copy overlaps this tile's products. Rows are
//   DP + 4 floats apart, which puts the 8 rows of an ldmatrix (Q and K
//   fragments: a b16 8x8 matrix is an 8x4 fp32 one, lane (g, q) receiving
//   element (g, q)) and the words of a V fragment load on distinct banks.
//   Each warp splits the fragments it loads: four warps split the same
//   tile, but each value crosses the shared-memory port once (split copies
//   would double the port's traffic). Dims d..DP-1 and keys past Tk are
//   zero in shared memory, never padded in device memory; D in (64, 80]
//   runs DP = 80, so StableLM multiplies no padded dim.
// * P never leaves registers. A score fragment holds, per row, keys 2q and
//   2q + 1 of each 8-key n-tile; P V's k order is permuted alike in A and B
//   (fragment k = q is key 2q, k = q + 4 is key 2q + 1), so the score
//   fragment is the A fragment as it stands. Output dims are permuted over
//   pairs of n-tiles (column n of n-tile 2J is dim 16J + 2n, of 2J + 1 dim
//   16J + 2n + 1), so a V fragment pair is one 8-byte load and a lane
//   stores 4 consecutive dims of o.
// * The online softmax runs on the score fragments once a tile: the row max
//   over the quad of lanes that share a row (2 shuffles), one correction
//   exp2f(m - m_new) of (l, acc), each exp2f once, by the lane that holds
//   its score; l stays a lane's partial sum until the end.
// * A tile where every key is live for every row runs no mask logic; only
//   tiles at the diagonal, the window's edge or the ragged tail do (the
//   tail as -inf: exactly 0 weight). Causal tiles wholly above the diagonal
//   and window tiles wholly before the window are not visited, unless some
//   row has no live key at all: the reference's uniform weights over every
//   key are then reproduced by visiting every tile from key 0.
// * Order: fixed, no atomics, no split of a row over CTAs; a row's bits
//   depend only on its q, its head's K/V and its row tile's index, so
//   the same inputs give the same bits on every launch and for any batch
//   sub-range. The heaviest causal tiles (the last rows) go first.

constexpr int TF_WARPS = 4;
constexpr int TF_THREADS = 32 * TF_WARPS;
constexpr int TF_STAGES = 2;  // K/V tiles in flight

// The tile at each padded head dim: MT 16-row m-tiles a warp (a K or V
// fragment, loaded and split once, feeds MT products) and KN keys a tile,
// sized so that two CTAs fit an SM where the accumulator allows it: 104,
// 86 and 101 KB of shared memory at DP = 64, 80 and 128; 200 KB and one CTA
// at DP = 256, whose accumulator (128 registers) leaves no room for MT = 2.
template <int DP>
__host__ __device__ constexpr int tf_mtiles() { return DP <= 128 ? 2 : 1; }
template <int DP>
__host__ __device__ constexpr int tf_keys() {
  return DP <= 64 ? 64 : DP <= 80 ? 32 : DP <= 128 ? 16 : 32;
}
template <int DP>
__host__ __device__ constexpr int tf_rows() {  // query rows per CTA
  return 16 * TF_WARPS * tf_mtiles<DP>();
}

template <int DP>
constexpr size_t tf_smem_bytes() {
  return (size_t)(tf_rows<DP>() + TF_STAGES * 2 * tf_keys<DP>()) * (DP + 4) *
         sizeof(float);
}

constexpr unsigned TF32_HALF_ULP = 0x1000u, TF32_MASK = ~0x1fffu;

// x = hi + lo as two tf32 operands. hi is cvt.rna.tf32(x) (to nearest,
// ties away from zero) as an integer add of half a tf32 ulp: the tensor
// cores read only an operand's top 19 bits, so hi goes to the MMA unmasked
// and only its value for x - hi is masked. lo = x - hi is exact in fp32
// and goes as it is: the MMA reads it rounded toward zero, 2^-21 of x
// where cvt.rna would keep 2^-22, below the error of the tensor cores' own
// fp32 accumulation (leaving lo to cvt.rna as well costs 5-13 % of the
// time: tools/flash_f32_variants.py). Three instructions; the split is the
// loop's largest cost, and two cvt.rna.tf32 (with their NaN and infinity
// cases) made it several times that.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) + TF32_HALF_ULP;
  lo = __float_as_uint(x - __uint_as_float(hi & TF32_MASK));
}

// c += a b over one m16n8k8 step: a 16x8 (row), b 8x8 (col), tf32 in,
// fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: a_lo b_hi + a_hi b_lo, then a_hi b_hi; b = (b0, b1)
// split as bh, bl
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           unsigned bh0, unsigned bh1,
                                           unsigned bl0, unsigned bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// ROWS rows of d floats from g (row r0 on) into shared rows DP + 4 floats
// apart, zero past nvalid rows; vec: 16-byte cp.async copies (d % 4 == 0,
// 16-byte aligned; dims d..DP-1 are zeroed once by the caller), else
// element loads that also write the zero dims.
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows_f32(float* s, const float* g,
                                              int r0, int nvalid, int d,
                                              int vec) {
  constexpr int LDS = DP + 4;
  if (vec && d == DP) {
    constexpr int CH = DP / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWS * CH; e += TF_THREADS) {
      const int r = e / CH, c = (e - r * CH) * 4;
      const bool ok = r0 + r < nvalid;
      cp_async16_zfill(smem_u32(s + r * LDS + c),
                       g + (ok ? (long long)(r0 + r) * DP + c : 0), ok);
    }
  } else if (vec) {
    const int chunks = d / 4;
    for (int e = threadIdx.x; e < ROWS * chunks; e += TF_THREADS) {
      const int r = e / chunks, c = (e - r * chunks) * 4;
      const bool ok = r0 + r < nvalid;
      cp_async16_zfill(smem_u32(s + r * LDS + c),
                       g + (ok ? (long long)(r0 + r) * d + c : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DP; e += TF_THREADS) {
      const int r = e / DP, c = e - r * DP;
      s[r * LDS + c] =
          (r0 + r < nvalid && c < d) ? g[(long long)(r0 + r) * d + c] : 0.f;
    }
  }
}

// Query tile yt of q_tiles of (batch, head) blockIdx.x.
template <int DP>
__device__ __forceinline__ void flash_3xtf32_tile(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int tq, int tk, int d,
    int causal, int window, float scale, int skip_below_window, int vec,
    int yt, int q_tiles) {
  constexpr int MT = tf_mtiles<DP>();  // m-tiles a warp
  constexpr int ROWS = tf_rows<DP>();  // query rows per CTA
  constexpr int KN = tf_keys<DP>();    // keys per tile
  constexpr int LD = DP + 4;           // shared row stride, floats
  constexpr int KD = DP / 8;           // k-steps of Q K^T
  constexpr int NT = KN / 8;           // key n-tiles of S
  constexpr int DT = DP / 8;           // dim n-tiles of the accumulator
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // (ROWS, LD)
  float* skv = sq + ROWS * LD;  // TF_STAGES x {K (KN, LD), V (KN, LD)}

  const long long bh = blockIdx.x;
  // the heaviest causal tiles (the last rows) are scheduled first
  const int q0 = (q_tiles - 1 - yt) * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, qd = lane % 4;  // the fragments' group and lane in it
  const float* qb = q + bh * tq * d;
  const long long kv = kv_head_offset(bh, tk, d);
  const float* kb = k + kv;
  const float* vb = v + kv;

  const int lo = (window > 0 && skip_below_window) ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(tk, q0 + ROWS) : tk;
  const int t_lo = lo / KN, t_hi = (hi + KN - 1) / KN;

  if (vec && d < DP) {  // the padded dims of every shared row, once
    constexpr int ROWS_ALL = ROWS + TF_STAGES * 2 * KN;
    const int pad = DP - d;
    for (int e = threadIdx.x; e < ROWS_ALL * pad; e += TF_THREADS) {
      const int r = e / pad;
      sq[r * LD + d + (e - r * pad)] = 0.f;
    }
  }
  auto load_kv = [&](int stage, int t) {
    float* sk = skv + stage * 2 * KN * LD;
    load_rows_f32<DP, KN>(sk, kb, t * KN, tk, d, vec);
    load_rows_f32<DP, KN>(sk + KN * LD, vb, t * KN, tk, d, vec);
  };
  load_rows_f32<DP, ROWS>(sq, qb, q0, tq, d, vec);
  cp_async_commit();
  load_kv(0, t_lo);
  cp_async_commit();
  cp_async_wait<1>();  // Q's group is done; the first K/V tile may not be
  __syncthreads();
  const float qscale = scale * LOG2E;
  for (int e = threadIdx.x; e < ROWS * DP; e += TF_THREADS) {
    const int r = e / DP;
    sq[r * LD + e - r * DP] *= qscale;
  }
  __syncthreads();

  // this thread's rows: ra + 16 mt and ra + 16 mt + 8 of the warp's 16 MT
  const int ra = q0 + warp * 16 * MT + g;
  // ldmatrix row addresses: Q as the A operand (matrices: rows 0-7 and
  // 8-15 of an m-tile, then the same at dims 4-7 of the k-step), K as the
  // B operand of Q K^T (dims 0-3, 4-7 of key n-tile j, then of j + 1)
  const unsigned q_addr = smem_u32(
      sq + (warp * 16 * MT + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
      (lane >> 4) * 4);
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_col = ((lane >> 3) & 1) * 4;

  float acc[MT][DT][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) % TF_STAGES;
    if (t + 1 < t_hi) {
      load_kv((t + 1 - t_lo) % TF_STAGES, t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = skv + stage * 2 * KN * LD;
    const float* sv = sk + KN * LD;

    // S = Q K^T for the warp's 16 MT rows x KN keys, in the log2 domain
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      unsigned ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned a[4];
        ldsm_x4(q_addr + (mt * 16 * LD + kd * 8) * 4, a);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(__uint_as_float(a[i]), ah[mt][i], al[mt][i]);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned b[4], bh[4], bl[4];
        ldsm_x4(smem_u32(sk + (j * 8 + k_row) * LD + kd * 8 + k_col), b);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(b[i]), bh[i], bl[i]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_3xtf32(s[mt][j], ah[mt], al[mt], bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(s[mt][j + 1], ah[mt], al[mt], bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }

    // masks only on edge tiles (uniform over the CTA)
    const int k0 = t * KN;
    const bool edge = (causal && k0 + KN - 1 > q0) ||
                      (window > 0 && k0 <= q0 + ROWS - 1 - window) ||
                      k0 + KN > tk;
    if (edge) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + j * 8 + 2 * qd + (i & 1);
            const int row = ra + mt * 16 + (i >> 1) * 8;
            if (key >= tk)
              s[mt][j][i] = -INFINITY;
            else if ((causal && key > row) || (window > 0 && key <= row - window))
              s[mt][j][i] = NEG_INF;
          }
    }

    // online softmax, rows ra + 16 mt (i = 0, 1) and ra + 16 mt + 8 (i = 2, 3)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        corr[r] = exp2f(m[mt][r] - mx[r]);
        m[mt][r] = mx[r];
        l[mt][r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[mt][j][0] *= corr[0];
        acc[mt][j][1] *= corr[0];
        acc[mt][j][2] *= corr[1];
        acc[mt][j][3] *= corr[1];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[mt][j][i] = exp2f(s[mt][j][i] - m[mt][i >> 1]);
          l[mt][i >> 1] += s[mt][j][i];
        }
    }

    // acc += P V, 8 keys a k-step: A is the score fragment itself (k = qd
    // is key 2 qd, k = qd + 4 key 2 qd + 1), B one 8-byte load a row pair
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      unsigned ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(s[mt][kk][0], ph[mt][0], pl[mt][0]);
        split_tf32(s[mt][kk][2], ph[mt][1], pl[mt][1]);
        split_tf32(s[mt][kk][1], ph[mt][2], pl[mt][2]);
        split_tf32(s[mt][kk][3], ph[mt][3], pl[mt][3]);
      }
      const float* v0 = sv + (kk * 8 + 2 * qd) * LD + 2 * g;
#pragma unroll
      for (int jp = 0; jp < DT / 2; ++jp) {
        const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * jp);
        const float2 x1 = *reinterpret_cast<const float2*>(v0 + LD + 16 * jp);
        unsigned bh[4], bl[4];
        split_tf32(x0.x, bh[0], bl[0]);
        split_tf32(x1.x, bh[1], bl[1]);
        split_tf32(x0.y, bh[2], bl[2]);
        split_tf32(x1.y, bh[3], bl[3]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_3xtf32(acc[mt][2 * jp], ph[mt], pl[mt], bh[0], bh[1], bl[0], bl[1]);
          mma_3xtf32(acc[mt][2 * jp + 1], ph[mt], pl[mt], bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(FULL, lr, 1);
      lr += __shfl_xor_sync(FULL, lr, 2);
      lr = fmaxf(lr, 1e-30f);
      const int row = ra + mt * 16 + r * 8;
      if (row >= tq) continue;
      float* ob = o + (bh * tq + row) * d;
#pragma unroll
      for (int jp = 0; jp < DT / 2; ++jp) {
        const int c = 16 * jp + 4 * qd;  // dims c .. c + 3
        const float x[4] = {acc[mt][2 * jp][2 * r] / lr,
                            acc[mt][2 * jp + 1][2 * r] / lr,
                            acc[mt][2 * jp][2 * r + 1] / lr,
                            acc[mt][2 * jp + 1][2 * r + 1] / lr};
        if (vec && c + 3 < d) {
          *reinterpret_cast<float4*>(ob + c) = make_float4(x[0], x[1], x[2], x[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (c + i < d) ob[c + i] = x[i];
        }
      }
    }
}

// tiles blockIdx.y, + gridDim.y, ... of q_tiles (see flash_kernel)
template <int DP>
__global__ void __launch_bounds__(TF_THREADS, DP <= 128 ? 2 : 1)
flash_f32_3xtf32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int tq,
                 int tk, int d, int causal, int window, float scale,
                 int skip_below_window, int vec, int q_tiles) {
  for (int yt = blockIdx.y; yt < q_tiles; yt += gridDim.y) {
    if (yt != (int)blockIdx.y) __syncthreads();  // shared memory is free
    flash_3xtf32_tile<DP>(q, k, v, o, tq, tk, d, causal, window, scale,
                          skip_below_window, vec, yt, q_tiles);
  }
}

template <int DP>
int launch_3xtf32(const float* q, const float* k, const float* v, float* o,
                  long long bh, int tq, int tk, int d, int causal, int window,
                  float scale, void* stream) {
  constexpr int ROWS = tf_rows<DP>();
  const int q_tiles = (tq + ROWS - 1) / ROWS;
  if (bh > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = tf_smem_bytes<DP>();
  // above 48 KB only as dynamic shared memory, once allowed (per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_3xtf32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const int vec = d % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(o);
  // a row with no live key (window > 0, q - window + 1 >= Tk) takes the
  // reference's uniform weights over every key: then visit them all
  const int skip = !(window > 0 && (long long)tq > (long long)tk + window - 1);
  dim3 grid((unsigned)bh, (unsigned)grid_y(q_tiles));
  flash_f32_3xtf32<DP>
      <<<grid, TF_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          q, k, v, o, tq, tk, d, causal, window, scale, skip, vec, q_tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Past D = 256, fp32 and bf16, on the tensor cores: flash_wide_mma
//
// It replaces the same Pallas kernel (_flash_kernel,
// src/repro/kernels/flash_attention.py:29), which takes any head dim, at
// D > 256: an attention codec with wide heads (arch (512, 1, 1, 1024) has
// D = 512; the codec encodes in 512-block and decodes in 4096-block
// launches), and any head a caller brings. It computes what the kernels
// above compute, with the same causal, window and ragged-tail masks
// (masked scores at -1e30, the tail at -inf) and the output
// acc / max(l, 1e-30), rounded to the operands' type once.
//
// Bound on this card: at the wide codec's chunk (4096, 1, 232, 512)
// non-causal the function is 4 x 4096 x 232^2 x 512 = 0.45 TFLOP. fp32:
// operations, 2.7 ms at 3xTF32's 165 TFLOP/s (6.7 ms at the CUDA cores'
// 67), against 7.8 GB of operands (2.3 ms). bf16: bytes, 3.9 GB (1.16 ms),
// above its products even counted three times (Q K^T once, P V twice:
// 0.7 ms at 989 TFLOP/s).
// Arithmetic: that of the tensor-core kernels below D = 256. fp32 takes
// both products in 3xTF32 on mma.sync.m16n8k8 (split_tf32; per accumulator
// the terms a_lo b_hi, a_hi b_lo, a_hi b_hi; q scaled by scale * log2(e)
// in fp32 before it is split); bf16 takes Q K^T as exact bf16 products with
// fp32 accumulate on m16n8k16, the score scaled by scale * log2(e) in fp32,
// and P V as the bf16 pair P_hi, P_lo (flash_bf16_mma's note says why one
// rounding of P is not enough). Design:
//
// * A CTA of 8 warps owns one (batch, head), 64 query rows and a slab of
//   WM_SLAB = 512 output dims (one slab to D = 512). A warp owns MT m-tiles
//   (fp32 2, bf16 1: Wide<T>) and the 256 / MT output dims of its group
//   (fp32: 4 groups of 2 warps, 128 dims; bf16: 2 groups of 4 warps, 256
//   dims): an accumulator of 128 fp32 registers a thread, so one CTA fits
//   an SM. In fp32 each split K or V fragment then feeds two m-tiles, and
//   each 3xTF32 term is issued for 2 MT accumulators in turn (at the
//   codec's chunk on an H100 at 700 W, one m-tile a warp with 64-key tiles
//   took 17.5 ms in fp32 against 13.8: tools/flash_wide_timing.py); bf16
//   splits no fragment, and with MT = 2 it paid more for the larger
//   exchange than it saved (7.4 ms against 5.8).
// * Nothing of a head stays on chip (at D = 512 its fp32 K and V take 950
//   KB, the CTA's Q 128 KB): Q, K and V stream through one ring of
//   WM_STAGES slots filled by 16-byte cp.async copies (zfill past D, Tq
//   and Tk; element copies in the VEC = false instantiation, where D or a
//   base is not 16-byte aligned) three items ahead of the item the warps
//   work on, one barrier an item. A key tile of WM_KEYS = 32 keys is
//   ceil(D / PK) Q K^T items (the CTA's 64 query rows and the tile's 32
//   keys over PK head dims: 256 bytes a row) and then GDIMS / PVG V items
//   (the tile's 32 keys over PVG of each group's dims). Dims past D are
//   zero in shared memory and add exactly 0; nothing is padded in device
//   memory. Q is read again for each key tile, from L2 (a head's CTAs run
//   side by side, below). Neither the ring's depth (2 to 6 slots) nor
//   twice the item width moved either dtype by more than the noise: the
//   warps' own instruction latency, at 2 warps a scheduler, sets the time.
// * The scores once a (row tile, key tile): in each Q K^T item a group
//   takes its share of the PK dims, so a warp holds a partial S of its
//   16 MT rows x 32 keys. The groups' partials cross through shared memory
//   (behind the first V item's barrier) and every warp of a row block forms
//   S = (S_0 + S_1) + ... in group order, then runs the same masks and
//   online softmax in the same order: a row's m, l and p, and so every
//   column of its output, share one normaliser bit for bit. Past D = 512
//   each slab's CTA computes the scores again with the same code in the
//   same order (only V's columns and the output's differ), one Q K^T more a
//   slab.
// * P never leaves registers: the score fragment is P V's A fragment as it
//   stands (fp32: flash_f32_3xtf32's key permutation; bf16: the pair per
//   16-key step, as flash_bf16_mma), split again for each V item. A
//   group's V item wholly past D is not multiplied (warp-uniform).
// * The grid runs x over a head's query tiles, y over slabs and z over
//   (batch, head): a head's CTAs are adjacent and read its K and V from
//   L2 after the first. y and z stop at 65,535 and the CTAs loop over the
//   rest. The heaviest causal tiles (the last rows) go first.
// * Key tiles wholly above the diagonal or before the window are not
//   visited, unless some row has no live key at all (the reference's
//   uniform weights over every key): the rule of flash_f32_3xtf32. Only
//   tiles at the diagonal, the window's edge or the ragged tail run mask
//   logic.
// * Order: fixed, no atomics, no split of the key loop; a row's bits
//   depend only on its q, its head's K/V and its row tile's index, so the
//   same inputs give the same bits on every launch, for any batch or head
//   sub-range and on a CTA's second pass of the grid loops.

constexpr int WM_WARPS = 8;
constexpr int WM_THREADS = 32 * WM_WARPS;
constexpr int WM_ROWS = 64;                 // query rows a CTA
constexpr int WM_SLAB = 512;                // output dims a CTA
constexpr int WM_KEYS = 32;                 // keys a tile
constexpr int WM_STAGES = 4;                // ring slots
constexpr int WM_NT = WM_KEYS / 8;          // key n-tiles of S

// By operand type: MT, the m-tiles a warp owns (its rows: a row block of
// 16 MT, so 4 / MT warps a group; the CTA's 8 warps form 2 MT groups of
// 256 / MT output dims, and the accumulator is 128 fp32 registers a
// thread either way); in elements, a Q K^T item's head dims (PK: 256
// bytes a row, each group taking PK / (2 MT) of them), a V item's dims of
// each group (PVG), the row strides (an odd number of 16-byte units: the
// 8 rows of an ldmatrix fall in 8 bank groups, and fp32 V's 8-byte
// fragment loads on distinct banks) and one mma's k. fp32 takes MT = 2,
// so that each split K or V fragment feeds two m-tiles; bf16, whose
// fragments need no split, MT = 1 and half the groups to exchange
// partial scores between.
template <typename T>
struct Wide;
template <>
struct Wide<float> {
  static constexpr int MT = 2, PK = 64, LDQ = PK + 4, PVG = 64,
                       LDV = 2 * MT * PVG + 4, KSTEP = 8;
};
template <>
struct Wide<bf16> {
  static constexpr int MT = 1, PK = 128, LDQ = PK + 8, PVG = 128,
                       LDV = 2 * MT * PVG + 8, KSTEP = 16;
};
// a ring slot holds the larger of the two items; the exchange of the
// partial scores, (warp, element, lane) with MT x WM_NT x 4 elements a
// lane, follows the slots
template <typename T>
__host__ __device__ constexpr int wide_slot_bytes() {
  constexpr int qk = (WM_ROWS + WM_KEYS) * Wide<T>::LDQ * (int)sizeof(T);
  constexpr int pv = WM_KEYS * Wide<T>::LDV * (int)sizeof(T);
  return ((qk > pv ? qk : pv) + 127) / 128 * 128;
}
template <typename T>
constexpr size_t wide_smem_bytes() {
  return (size_t)WM_STAGES * wide_slot_bytes<T>() +
         (size_t)WM_WARPS * Wide<T>::MT * WM_NT * 4 * 32 * sizeof(float);
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Query tile yt of q_tiles, slab zs, of (batch, head) bh. VEC: D a
// multiple of 16 bytes and q, k, v, o 16-byte aligned (16-byte copies and
// stores); else element copies and stores.
template <typename T, bool VEC>
__device__ __forceinline__ void flash_wide_tile(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, long long bh, int tq, int tk, int d, int causal,
    int window, float scale, int skip_below_window, int yt, int q_tiles,
    int zs) {
  using W = Wide<T>;
  constexpr bool F32 = sizeof(T) == sizeof(float);
  constexpr int MT = W::MT;                      // m-tiles a warp
  constexpr int WPG = 4 / MT;                    // warps a group
  constexpr int GROUPS = WM_WARPS / WPG;
  constexpr int GDIMS = WM_SLAB / GROUPS;        // output dims a group
  constexpr int SLOT = wide_slot_bytes<T>();
  constexpr int EPC = 16 / (int)sizeof(T);       // elements a 16-byte copy
  constexpr int NPV = GDIMS / W::PVG;            // V items a key tile
  constexpr int GK = W::PK / GROUPS;             // a group's dims of a Q K^T item
  constexpr int KSTEPS = GK / W::KSTEP;          // ... in k-steps
  constexpr int JV = W::PVG / 8;                 // n-tiles of a group's V item
  constexpr int DT = GDIMS / 8;                  // n-tiles of the accumulator
  constexpr int XW = MT * WM_NT * 4 * 32;        // exchange floats a warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sx = reinterpret_cast<float*>(smem_raw + WM_STAGES * SLOT);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / WPG, rb = warp % WPG;  // the warp's group and row block
  const int g = lane / 4, qd = lane % 4;        // the fragments' group and lane in it
  const int q0 = (q_tiles - 1 - yt) * WM_ROWS;
  const T* qb = q + bh * tq * d;
  const long long kvo = kv_head_offset(bh, tk, d);
  const T* kb = k + kvo;
  const T* vb = v + kvo;
  const int gd0 = zs * WM_SLAB + grp * GDIMS;  // the group's first dim

  const int lo = (window > 0 && skip_below_window) ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(tk, q0 + WM_ROWS) : tk;
  const int t_lo = lo / WM_KEYS, t_hi = (hi + WM_KEYS - 1) / WM_KEYS;
  const int npq = (d + W::PK - 1) / W::PK;  // Q K^T items a key tile
  const int per_tile = npq + NPV;           // ring items a key tile

  // The ring: items go into slots 0, 1, ... in order, WM_STAGES - 1 ahead
  // of the item the warps take. A Q K^T item is Q's 64 rows then the
  // tile's 32 K rows over PK dims; a V item the tile's 32 V rows over the
  // groups' PVG dims side by side (column cc: group cc / PVG's dim).
  // With VEC (16-byte copies) a thread copies the same 16 bytes of every
  // row it takes: in a Q K^T item rows fq + RQ n, in a V item fv + RV n.
  int f_left = (t_hi - t_lo) * per_tile, f_r = 0, f_k0 = t_lo * WM_KEYS;
  int f_slot = 0, c_slot = 0;
  const unsigned ring = smem_u32(smem_raw);
  constexpr int CQ = W::PK / EPC, CV = GROUPS * W::PVG / EPC;  // copies a row
  constexpr int RQ = WM_THREADS / CQ, RV = WM_THREADS / CV;       // rows a pass
  const int fq = threadIdx.x / CQ, fcq = (threadIdx.x % CQ) * EPC;
  const int fv = threadIdx.x / CV, fcv = (threadIdx.x % CV) * EPC;
  // the thread's V column as a head dim, less the item's offset pv * PVG
  const int fdv = zs * WM_SLAB + fcv / W::PVG * GDIMS + fcv % W::PVG;
  const long long dq = (long long)RQ * d, dv = (long long)RV * d;
  const T* fqs = qb + (long long)(q0 + fq) * d + fcq;
  const T* fks = kb + (long long)fq * d + fcq;
  const T* fvs = vb + (long long)fv * d + fdv;
  auto fill = [&]() {
    if (f_left <= 0) return;
    --f_left;
    const unsigned slot = ring + f_slot * SLOT;
    T* s = reinterpret_cast<T*>(smem_raw + f_slot * SLOT);
    if (f_r < npq) {
      const int c0 = f_r * W::PK;
      if (VEC) {
        const bool cok = c0 + fcq < d;
        const T* qs = fqs + c0;
        const T* ks = fks + (long long)f_k0 * d + c0;
        const unsigned dst = slot + (fq * W::LDQ + fcq) * (int)sizeof(T);
#pragma unroll
        for (int n = 0; n < WM_ROWS / RQ; ++n) {
          const bool ok = cok && q0 + fq + RQ * n < tq;
          cp_async16_zfill(dst + RQ * n * W::LDQ * (int)sizeof(T),
                           ok ? qs + n * dq : qb, ok);
        }
#pragma unroll
        for (int n = 0; n < WM_KEYS / RQ; ++n) {
          const bool ok = cok && f_k0 + fq + RQ * n < tk;
          cp_async16_zfill(dst + (WM_ROWS + RQ * n) * W::LDQ * (int)sizeof(T),
                           ok ? ks + n * dq : kb, ok);
        }
      } else {
        for (int e = threadIdx.x; e < (WM_ROWS + WM_KEYS) * W::PK; e += WM_THREADS) {
          const int row = e / W::PK, cc = e - row * W::PK;
          const bool isq = row < WM_ROWS;
          const int at = isq ? q0 + row : f_k0 + row - WM_ROWS;
          const bool ok = at < (isq ? tq : tk) && c0 + cc < d;
          store(s + row * W::LDQ + cc,
                ok ? to_f32((isq ? qb : kb)[(long long)at * d + c0 + cc]) : 0.f);
        }
      }
    } else {
      const int c0 = (f_r - npq) * W::PVG;
      if (VEC) {
        const bool cok = fdv + c0 < d;
        const T* vs = fvs + (long long)f_k0 * d + c0;
        const unsigned dst = slot + (fv * W::LDV + fcv) * (int)sizeof(T);
#pragma unroll
        for (int n = 0; n < WM_KEYS / RV; ++n) {
          const bool ok = cok && f_k0 + fv + RV * n < tk;
          cp_async16_zfill(dst + RV * n * W::LDV * (int)sizeof(T),
                           ok ? vs + n * dv : vb, ok);
        }
      } else {
        for (int e = threadIdx.x; e < WM_KEYS * GROUPS * W::PVG; e += WM_THREADS) {
          const int row = e / (GROUPS * W::PVG), cc = e - row * (GROUPS * W::PVG);
          const int c = zs * WM_SLAB + cc / W::PVG * GDIMS + c0 + cc % W::PVG;
          const bool ok = f_k0 + row < tk && c < d;
          store(s + row * W::LDV + cc,
                ok ? to_f32(vb[(long long)(f_k0 + row) * d + c]) : 0.f);
        }
      }
    }
    if (++f_r == per_tile) {
      f_r = 0;
      f_k0 += WM_KEYS;
    }
    if (++f_slot == WM_STAGES) f_slot = 0;
  };
  for (int i = 0; i < WM_STAGES - 1; ++i) {
    fill();
    cp_async_commit();
  }
  // the next item's slot once it has landed for every thread; the slot the
  // warps left last is refilled, WM_STAGES - 1 items ahead
  auto next = [&]() -> const T* {
    cp_async_wait<WM_STAGES - 2>();
    __syncthreads();
    fill();
    cp_async_commit();
    const T* slot = reinterpret_cast<const T*>(smem_raw + c_slot * SLOT);
    if (++c_slot == WM_STAGES) c_slot = 0;
    return slot;
  };

  // this thread's rows: ra + 16 mt and ra + 16 mt + 8, mt < MT
  const int ra = q0 + rb * 16 * MT + g;
  // fragment offsets inside an item, elements: Q as the A operand at the
  // warp's first m-tile and its group's share of the dims; K as the B
  // operand (the k-step's first and second half of key n-tile j, then of
  // j + 1); V as P V's B operand (fp32: the 8-byte row-pair load; bf16:
  // ldmatrix .trans rows)
  constexpr int QC = F32 ? 4 : 8;
  const int qa = (rb * 16 * MT + (lane & 7) + ((lane >> 3) & 1) * 8) * W::LDQ +
                 (lane >> 4) * QC + grp * GK;
  const int ka = (WM_ROWS + (lane & 7) + (lane >> 4) * 8) * W::LDQ +
                 ((lane >> 3) & 1) * QC + grp * GK;
  const int va = F32 ? 2 * qd * W::LDV + 2 * g + grp * W::PVG
                     : ((lane & 7) + ((lane >> 3) & 1) * 8) * W::LDV +
                           (lane >> 4) * 8 + grp * W::PVG;
  float* mine = sx + warp * XW + lane;
  const float* part = sx + rb * XW + lane;  // group gg's: + gg WPG XW
  const float qscale = scale * LOG2E;  // fp32: q's; bf16: the score's

  float acc[MT][DT][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    // the group's partial S over its share of every Q K^T item's dims
    float s[MT][WM_NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < WM_NT; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
    for (int p = 0; p < npq; ++p) {
      const T* sp = next();
#pragma unroll
      for (int kd = 0; kd < KSTEPS; ++kd) {
        if constexpr (F32) {
          unsigned ah[MT][4], al[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            unsigned a[4];
            ldsm_x4(smem_u32(sp + qa + mt * 16 * W::LDQ + kd * 8), a);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              split_tf32(__uint_as_float(a[i]) * qscale, ah[mt][i], al[mt][i]);
          }
#pragma unroll
          for (int j = 0; j < WM_NT; j += 2) {
            unsigned b[4], bh[4], bl[4];
            ldsm_x4(smem_u32(sp + ka + j * 8 * W::LDQ + kd * 8), b);
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(b[i]), bh[i], bl[i]);
            // per score fragment a_lo b_hi, a_hi b_lo, a_hi b_hi (mma_3xtf32's
            // order), each term issued for the 2 MT fragments in turn
#pragma unroll
            for (int u = 0; u < 2 * MT; ++u)
              mma_tf32(s[u >> 1][j + (u & 1)], al[u >> 1], bh[2 * (u & 1)],
                       bh[2 * (u & 1) + 1]);
#pragma unroll
            for (int u = 0; u < 2 * MT; ++u)
              mma_tf32(s[u >> 1][j + (u & 1)], ah[u >> 1], bl[2 * (u & 1)],
                       bl[2 * (u & 1) + 1]);
#pragma unroll
            for (int u = 0; u < 2 * MT; ++u)
              mma_tf32(s[u >> 1][j + (u & 1)], ah[u >> 1], bh[2 * (u & 1)],
                       bh[2 * (u & 1) + 1]);
          }
        } else {
          unsigned a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(smem_u32(sp + qa + mt * 16 * W::LDQ + kd * 16), a[mt]);
#pragma unroll
          for (int j = 0; j < WM_NT; j += 2) {
            unsigned b[4];
            ldsm_x4(smem_u32(sp + ka + j * 8 * W::LDQ + kd * 16), b);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(s[mt][j], a[mt], b[0], b[1]);
              mma_bf16(s[mt][j + 1], a[mt], b[2], b[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < WM_NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) mine[((mt * WM_NT + j) * 4 + i) * 32] = s[mt][j][i];

#pragma unroll
    for (int pv = 0; pv < NPV; ++pv) {
      const T* sv = next();
      if (pv == 0) {
        // S = (S_0 + S_1) + ... in group order, in every group (the first
        // V item's barrier published the partials)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < WM_NT; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = ((mt * WM_NT + j) * 4 + i) * 32;
              float x = part[e];
#pragma unroll
              for (int gg = 1; gg < GROUPS; ++gg) x += part[gg * WPG * XW + e];
              s[mt][j][i] = F32 ? x : x * qscale;
            }
        // masks only on edge tiles (uniform over the CTA)
        const int k0 = t * WM_KEYS;
        const bool edge = (causal && k0 + WM_KEYS - 1 > q0) ||
                          (window > 0 && k0 <= q0 + WM_ROWS - 1 - window) ||
                          k0 + WM_KEYS > tk;
        if (edge) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int j = 0; j < WM_NT; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int key = k0 + j * 8 + 2 * qd + (i & 1);
                const int row = ra + mt * 16 + (i >> 1) * 8;
                if (key >= tk)
                  s[mt][j][i] = -INFINITY;
                else if ((causal && key > row) || (window > 0 && key <= row - window))
                  s[mt][j][i] = NEG_INF;
              }
        }
        // online softmax, rows ra + 16 mt (i = 0, 1) and ra + 16 mt + 8 (i = 2, 3)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
          for (int j = 0; j < WM_NT; ++j) {
            mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
          }
          float corr[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
            corr[r] = exp2f(m[mt][r] - mx[r]);
            m[mt][r] = mx[r];
            l[mt][r] *= corr[r];
          }
#pragma unroll
          for (int j = 0; j < DT; ++j) {
            acc[mt][j][0] *= corr[0];
            acc[mt][j][1] *= corr[0];
            acc[mt][j][2] *= corr[1];
            acc[mt][j][3] *= corr[1];
          }
#pragma unroll
          for (int j = 0; j < WM_NT; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              s[mt][j][i] = exp2f(s[mt][j][i] - m[mt][i >> 1]);
              l[mt][i >> 1] += s[mt][j][i];
            }
        }
      }
      if (gd0 + pv * W::PVG >= d) continue;  // the group's dims of it are past D
      if constexpr (F32) {
        // 8 keys a k-step: A is the score fragment (k = qd is key 2 qd,
        // k = qd + 4 key 2 qd + 1), B one 8-byte load a row pair, each
        // split B fragment feeding the MT m-tiles
#pragma unroll
        for (int kk = 0; kk < WM_NT; ++kk) {
          unsigned ph[MT][4], pl[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            split_tf32(s[mt][kk][0], ph[mt][0], pl[mt][0]);
            split_tf32(s[mt][kk][2], ph[mt][1], pl[mt][1]);
            split_tf32(s[mt][kk][1], ph[mt][2], pl[mt][2]);
            split_tf32(s[mt][kk][3], ph[mt][3], pl[mt][3]);
          }
          const float* v0 = reinterpret_cast<const float*>(sv) + kk * 8 * W::LDV + va;
#pragma unroll
          for (int jp = 0; jp < JV / 2; ++jp) {
            const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * jp);
            const float2 x1 = *reinterpret_cast<const float2*>(v0 + W::LDV + 16 * jp);
            unsigned bh[4], bl[4];  // n-tile 2 jp: [0], [1]; 2 jp + 1: [2], [3]
            split_tf32(x0.x, bh[0], bl[0]);
            split_tf32(x1.x, bh[1], bl[1]);
            split_tf32(x0.y, bh[2], bl[2]);
            split_tf32(x1.y, bh[3], bl[3]);
            const int n0 = pv * JV + 2 * jp;
            // per accumulator a_lo b_hi, a_hi b_lo, a_hi b_hi, each term
            // issued for the 2 MT accumulators in turn
#pragma unroll
            for (int u = 0; u < 2 * MT; ++u)
              mma_tf32(acc[u >> 1][n0 + (u & 1)], pl[u >> 1], bh[2 * (u & 1)],
                       bh[2 * (u & 1) + 1]);
#pragma unroll
            for (int u = 0; u < 2 * MT; ++u)
              mma_tf32(acc[u >> 1][n0 + (u & 1)], ph[u >> 1], bl[2 * (u & 1)],
                       bl[2 * (u & 1) + 1]);
#pragma unroll
            for (int u = 0; u < 2 * MT; ++u)
              mma_tf32(acc[u >> 1][n0 + (u & 1)], ph[u >> 1], bh[2 * (u & 1)],
                       bh[2 * (u & 1) + 1]);
          }
        }
      } else {
        // 16 keys a k-step: P_hi V + P_lo V, each B fragment feeding the
        // MT m-tiles
#pragma unroll
        for (int kk = 0; kk < WM_NT / 2; ++kk) {
          unsigned ph[MT][4], pl[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            split_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1], ph[mt][0], pl[mt][0]);
            split_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3], ph[mt][1], pl[mt][1]);
            split_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1], ph[mt][2], pl[mt][2]);
            split_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3], ph[mt][3], pl[mt][3]);
          }
#pragma unroll
          for (int j = 0; j < JV; j += 2) {
            unsigned b[4];
            ldsm_x4_trans(smem_u32(sv + kk * 16 * W::LDV + va + j * 8), b);
            const int n0 = pv * JV + j;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][n0], ph[mt], b[0], b[1]);
              mma_bf16(acc[mt][n0], pl[mt], b[0], b[1]);
              mma_bf16(acc[mt][n0 + 1], ph[mt], b[2], b[3]);
              mma_bf16(acc[mt][n0 + 1], pl[mt], b[2], b[3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(FULL, lr, 1);
      lr += __shfl_xor_sync(FULL, lr, 2);
      lr = fmaxf(lr, 1e-30f);
      const int row = ra + mt * 16 + r * 8;
      if (row >= tq) continue;
      T* ob = o + (bh * tq + row) * d;
      if constexpr (F32) {
#pragma unroll
        for (int jp = 0; jp < DT / 2; ++jp) {
          const int c = gd0 + 16 * jp + 4 * qd;  // dims c .. c + 3
          const float x[4] = {acc[mt][2 * jp][2 * r] / lr,
                              acc[mt][2 * jp + 1][2 * r] / lr,
                              acc[mt][2 * jp][2 * r + 1] / lr,
                              acc[mt][2 * jp + 1][2 * r + 1] / lr};
          if (VEC && c + 3 < d) {
            *reinterpret_cast<float4*>(ob + c) = make_float4(x[0], x[1], x[2], x[3]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (c + i < d) ob[c + i] = x[i];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          const int c = gd0 + j * 8 + 2 * qd;
          const float x = acc[mt][j][2 * r] / lr, y = acc[mt][j][2 * r + 1] / lr;
          if (c + 1 < d && !(d & 1)) {
            *reinterpret_cast<__nv_bfloat162*>(ob + c) = __floats2bfloat162_rn(x, y);
          } else {
            if (c < d) ob[c] = __float2bfloat16_rn(x);
            if (c + 1 < d) ob[c + 1] = __float2bfloat16_rn(y);
          }
        }
      }
    }
}

// x: query tiles blockIdx.x, + gridDim.x, ...; y: slabs alike; z: (batch,
// head) alike (see flash_kernel)
template <typename T, bool VEC>
__global__ void __launch_bounds__(WM_THREADS, 1)
flash_wide_mma(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, long long bh_n,
               int tq, int tk, int d, int causal, int window, float scale,
               int skip_below_window, int q_tiles, int slabs) {
  for (long long bh = blockIdx.z; bh < bh_n; bh += gridDim.z)
    for (int zs = blockIdx.y; zs < slabs; zs += gridDim.y)
      for (int yt = blockIdx.x; yt < q_tiles; yt += gridDim.x) {
        if (bh != (long long)blockIdx.z || zs != (int)blockIdx.y ||
            yt != (int)blockIdx.x)
          __syncthreads();  // shared memory is free
        flash_wide_tile<T, VEC>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                                skip_below_window, yt, q_tiles, zs);
      }
}

template <typename T>
int launch_wide_mma(const T* q, const T* k, const T* v, T* o, long long bh,
                    int tq, int tk, int d, int causal, int window, float scale,
                    void* stream) {
  const int q_tiles = (tq + WM_ROWS - 1) / WM_ROWS;
  const int slabs = (d + WM_SLAB - 1) / WM_SLAB;
  if (bh > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = d % (16 / (int)sizeof(T)) == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(o);
  auto kernel = vec ? flash_wide_mma<T, true> : flash_wide_mma<T, false>;
  // above 48 KB only as dynamic shared memory, once allowed (per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wide_smem_bytes<T>());
  if (attr != cudaSuccess) return (int)attr;
  // a row with no live key takes the reference's uniform weights over every
  // key: then visit them all
  const int skip = !(window > 0 && (long long)tq > (long long)tk + window - 1);
  dim3 grid((unsigned)q_tiles, (unsigned)grid_y(slabs), (unsigned)grid_y((int)bh));
  kernel<<<grid, WM_THREADS, wide_smem_bytes<T>(), static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, bh, tq, tk, d, causal, window, scale, skip, q_tiles, slabs);
  return (int)cudaGetLastError();
}

// fp32: the CUDA-core kernel at D <= 32 (the codec's bits), 3xTF32 to 256,
// flash_wide_mma past it
int launch_f32(const float* q, const float* k, const float* v, float* o,
               long long bh, int tq, int tk, int d, int causal, int window,
               float scale, void* stream) {
  if (d < 1 || bh < 0 || tq < 0 || tk < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || tq == 0) return (int)cudaSuccess;
  if (d <= 16)
    return launch_as<float, 16>(q, k, v, o, bh, tq, tk, d, causal, window,
                                scale, stream);
  if (d <= 32)
    return launch_as<float, 32>(q, k, v, o, bh, tq, tk, d, causal, window,
                                scale, stream);
  if (d <= 64)
    return launch_3xtf32<64>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                             stream);
  if (d <= 80)
    return launch_3xtf32<80>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                             stream);
  if (d <= 128)
    return launch_3xtf32<128>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                              stream);
  if (d <= 256)
    return launch_3xtf32<256>(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                              stream);
  return launch_wide_mma<float>(q, k, v, o, bh, tq, tk, d, causal, window,
                                scale, stream);
}

}  // namespace

extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int flash_attention_f32(const float* q, const float* k, const float* v,
                        float* o, long long bh, int tq, int tk, int d,
                        int causal, int window, float scale, void* stream) {
  return launch_f32(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                    stream);
}

int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o,
                         long long bh, int tq, int tk, int d, int causal,
                         int window, float scale, void* stream) {
  return launch_bf16(q, k, v, o, bh, tq, tk, d, causal, window, scale,
                     stream);
}

}  // extern "C"
