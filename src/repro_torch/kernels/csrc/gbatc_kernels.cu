// GBATC guarantee kernels for NVIDIA Hopper (sm_90a), plain C interface.
//
// Batched-over-species tall-skinny products over (S, NB, D) block vectors
// with one (D, D) basis per species:
//
//   project : C_s   = R_s @ U_s                          (fp32 or fp64)
//   correct : out_s = x_s + C_s @ U_s^T                   (decode replay)
//   select  : out_s = x_s + (C_s . [rank < m]) @ U_s^T    (Algorithm 1 tail)
//   masked  : out_s = x_s + (C_s . mask_s) @ U_s^T        (explicit mask)
//
// They replace the Pallas TPU kernels gbatc_project_batched,
// gbatc_correct_batched and gbatc_select_accumulate of
// src/repro/kernels/gbatc_project.py, and its 2D single-species pair:
// gbatc_project is the project mode at S = 1, gbatc_correct the masked
// mode at S = 1 (the mask an operand of the kernel's dtype, multiplied
// into the coefficients while they are staged, as the select mode forms
// rank < m there). What is kept from them is the
// function; their 128-lane padding, padded rows in device memory and the
// INT32_MAX rank sentinel are not: D is a runtime argument and ragged row
// tiles are masked here.
//
// Bound on this card: at D = 80 each output element costs 80 FMAs against
// 8 (fp32) or 16 (fp64) bytes moved, which sits near the ridge of the fp32
// CUDA-core roofline, so the kernels must neither re-read inputs nor stall
// on them. Design:
//
// * One CTA owns one species and a run of row tiles of 64 blocks; the
//   species' basis stays in shared memory for the CTA's life (transposed on
//   load for the two U^T products, so the inner loop reads it
//   conflict-free). Runs are short (the wrapper asks for 8 tiles), so the
//   grid is many waves deep and no SM idles through a long tail.
// * Each row tile is staged once through shared memory. Where D is a
//   multiple of 4 and the operands are 16-byte aligned, a thread starts all
//   its 16-byte global loads of a batch before the first shared-memory
//   store, so their latencies overlap; otherwise a scalar path does the
//   same work.
// * Every thread accumulates a 4 x CMAX register tile with plain FMAs over
//   k in ascending order (no TF32, no fast-math). Shared rows are padded to
//   a multiple of 4 (zero filled) so the thread's A values come as 16-byte
//   shared loads over four k at a time. CMAX, the columns per thread, is 5
//   for D <= 80 and 8 up to D = 128.
// * The result goes back through the same shared tile so the epilogue
//   (+ x) reads and writes device memory coalesced.
// * Registers are capped at 128 a thread (two CTAs per SM), so one CTA's
//   staging overlaps the other's FMAs; the three instantiations the main
//   path uses (D = 80) fit with at most 16 bytes of spill.
// * The select kernel reads its per-row cut m once per row and forms
//   rank < m in registers while staging; neither the mask nor the masked
//   coefficients are ever written to device memory.
//
// fp64 at D = 80 needs 51.2 KB for the basis alone, above the 48 KB static
// limit: all shared memory is dynamic and every launcher raises the
// function's limit first. Launchers return the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_ROWS = 64;
constexpr int TX = 16;                   // column lanes
constexpr int TY = 16;                   // row lanes
constexpr int THREADS = TX * TY;         // 256
constexpr int RM = TILE_ROWS / TY;       // rows per thread
constexpr int KU = 4;                    // k unroll = shared row padding
constexpr int MAX_D = 128;

constexpr int MODE_PROJECT = 0;
constexpr int MODE_CORRECT = 1;
constexpr int MODE_SELECT = 2;
constexpr int MODE_MASKED = 3;

// 16 bytes of T, and as many ints (the rank values of the same elements)
template <typename T>
struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};
template <int N>
struct alignas(4 * N) IntPack {
  int v[N];
};

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// KU consecutive shared values starting at a 16-byte aligned address
template <typename T>
__device__ __forceinline__ void load_ku(const T* p, T (&out)[KU]) {
  constexpr int N = Pack<T>::N;
#pragma unroll
  for (int q = 0; q < KU / N; ++q) {
    const Pack<T> t = reinterpret_cast<const Pack<T>*>(p)[q];
#pragma unroll
    for (int c = 0; c < N; ++c) out[q * N + c] = t.v[c];
  }
}

template <typename T, int MODE, int CMAX>
__global__ void __launch_bounds__(THREADS, 2)
gbatc_tile_kernel(const T* __restrict__ a,       // project: residual; else coefficients
                  const T* __restrict__ basis,   // (S, D, D)
                  const T* __restrict__ x,       // correct/select: x_rec; project: unused
                  const int* __restrict__ rank,  // select only, (S, NB, D)
                  const int* __restrict__ m,     // select only, (S, NB)
                  const T* __restrict__ mk,      // masked only, (S, NB, D)
                  T* __restrict__ out, long long nb, int d, int tiles_per_cta,
                  int vec_ok) {
  using P = Pack<T>;
  constexpr int N = P::N;
  // 16-byte global loads a thread keeps in flight while staging; the select
  // and masked kernels stage two operands, so half as many of each fit in
  // registers
  constexpr int BATCH = (MODE == MODE_SELECT || MODE == MODE_MASKED) ? 4 : 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = (d + KU - 1) / KU * KU;    // padded row length
  T* u_s = reinterpret_cast<T*>(smem_raw);  // (ld, ld), laid out [k][j]
  T* a_s = u_s + ld * ld;                   // (TILE_ROWS, ld)
  int* m_s = reinterpret_cast<int*>(a_s + TILE_ROWS * ld);  // (TILE_ROWS,)

  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  if (ld != d) {  // zero the padding once: padded k must add exactly 0
    for (int i = tid; i < ld * ld + TILE_ROWS * ld; i += THREADS) u_s[i] = T(0);
    __syncthreads();
  }
  // B[k][j] of acc = A @ B: U itself for the projection, U^T for the others
  const T* u_g = basis + (size_t)s * d * d;
  for (int i = tid; i < d * d; i += THREADS) {
    const int row = i / d, col = i - row * d;
    u_s[(MODE == MODE_PROJECT) ? row * ld + col : col * ld + row] = u_g[i];
  }

  const long long n_tiles = (nb + TILE_ROWS - 1) / TILE_ROWS;
  const size_t species_off = (size_t)s * (size_t)nb * (size_t)d;
  for (int t = 0; t < tiles_per_cta; ++t) {
    const long long tile = (long long)blockIdx.x * tiles_per_cta + t;
    if (tile >= n_tiles) break;
    const long long row0 = tile * TILE_ROWS;
    const long long left = nb - row0;
    const int rows = left < TILE_ROWS ? (int)left : TILE_ROWS;
    const size_t base = species_off + (size_t)row0 * d;
    const int n_el = rows * d;

    __syncthreads();  // basis visible; previous tile's epilogue done with a_s
    if (MODE == MODE_SELECT) {
      if (tid < TILE_ROWS)
        m_s[tid] = tid < rows ? m[(size_t)s * nb + row0 + tid] : 0;
      __syncthreads();
    }

    // ---- stage the tile: global -> (mask) -> shared ----------------------
    if (vec_ok) {  // ld == d; every row starts 16-byte aligned
      const int nvec = n_el / N, tile_vecs = TILE_ROWS * d / N;
      const P* a_v = reinterpret_cast<const P*>(a + base);
      const IntPack<N>* r_v =
          MODE == MODE_SELECT
              ? reinterpret_cast<const IntPack<N>*>(rank + base) : nullptr;
      const P* mk_v =
          MODE == MODE_MASKED ? reinterpret_cast<const P*>(mk + base) : nullptr;
      for (int v0 = 0; v0 * THREADS < tile_vecs; v0 += BATCH) {
        P val[BATCH];
        IntPack<N> rk[BATCH];
        P mv[BATCH];
#pragma unroll
        for (int v = 0; v < BATCH; ++v) {
          const int idx = tid + (v0 + v) * THREADS;
          if (idx < nvec) {
            val[v] = a_v[idx];
            if (MODE == MODE_SELECT) rk[v] = r_v[idx];
            if (MODE == MODE_MASKED) mv[v] = mk_v[idx];
          }
        }
#pragma unroll
        for (int v = 0; v < BATCH; ++v) {
          const int idx = tid + (v0 + v) * THREADS;
          if (idx < tile_vecs) {
            P w;
            if (idx < nvec) {
              w = val[v];
              if (MODE == MODE_SELECT) {
                const int cut = m_s[idx * N / d];
#pragma unroll
                for (int c = 0; c < N; ++c)
                  if (!(rk[v].v[c] < cut)) w.v[c] = T(0);
              }
              if (MODE == MODE_MASKED) {
#pragma unroll
                for (int c = 0; c < N; ++c) w.v[c] = w.v[c] * mv[v].v[c];
              }
            } else {
#pragma unroll
              for (int c = 0; c < N; ++c) w.v[c] = T(0);
            }
            reinterpret_cast<P*>(a_s)[idx] = w;
          }
        }
      }
    } else {
      for (int i = tid; i < TILE_ROWS * d; i += THREADS) {
        const int row = i / d, col = i - row * d;
        T v = T(0);
        if (i < n_el) {
          v = a[base + i];
          if (MODE == MODE_SELECT) {
            if (!(rank[base + i] < m_s[row])) v = T(0);
          }
          if (MODE == MODE_MASKED) v = v * mk[base + i];
        }
        a_s[row * ld + col] = v;
      }
    }
    __syncthreads();

    // ---- acc = A_tile @ B, k ascending -----------------------------------
    T acc[RM][CMAX];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int jj = 0; jj < CMAX; ++jj) acc[i][jj] = T(0);

    for (int k0 = 0; k0 < ld; k0 += KU) {
      T av[RM][KU];
#pragma unroll
      for (int i = 0; i < RM; ++i) load_ku(a_s + (ty + i * TY) * ld + k0, av[i]);
#pragma unroll
      for (int kk = 0; kk < KU; ++kk) {
#pragma unroll
        for (int jj = 0; jj < CMAX; ++jj) {
          const int j = tx + jj * TX;
          const T b = j < d ? u_s[(k0 + kk) * ld + j] : T(0);
#pragma unroll
          for (int i = 0; i < RM; ++i)
            acc[i][jj] = fma_t(av[i][kk], b, acc[i][jj]);
        }
      }
    }

    __syncthreads();  // every thread is done reading the staged tile
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int jj = 0; jj < CMAX; ++jj) {
        const int j = tx + jj * TX;
        if (j < d) a_s[(ty + i * TY) * ld + j] = acc[i][jj];
      }
    __syncthreads();

    // ---- epilogue: out = (x +) tile, coalesced ---------------------------
    if (vec_ok) {
      const int nvec = n_el / N;
      const P* x_v =
          MODE != MODE_PROJECT ? reinterpret_cast<const P*>(x + base) : nullptr;
      P* o_v = reinterpret_cast<P*>(out + base);
      for (int v0 = 0; v0 * THREADS < nvec; v0 += BATCH) {
        P xv[BATCH];
        if (MODE != MODE_PROJECT) {
#pragma unroll
          for (int v = 0; v < BATCH; ++v) {
            const int idx = tid + (v0 + v) * THREADS;
            if (idx < nvec) xv[v] = x_v[idx];
          }
        }
#pragma unroll
        for (int v = 0; v < BATCH; ++v) {
          const int idx = tid + (v0 + v) * THREADS;
          if (idx < nvec) {
            P w = reinterpret_cast<const P*>(a_s)[idx];
            if (MODE != MODE_PROJECT) {
#pragma unroll
              for (int c = 0; c < N; ++c) w.v[c] = xv[v].v[c] + w.v[c];
            }
            o_v[idx] = w;
          }
        }
      }
    } else {
      for (int i = tid; i < n_el; i += THREADS) {
        const int row = i / d, col = i - row * d;
        T v = a_s[row * ld + col];
        if (MODE != MODE_PROJECT) v = x[base + i] + v;
        out[base + i] = v;
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int MODE, int CMAX>
int launch_as(const T* a, const T* basis, const T* x, const int* rank,
              const int* m, const T* mk, T* out, int s, long long nb, int d,
              int tiles_per_cta, void* stream) {
  const int ld = (d + KU - 1) / KU * KU;
  const size_t smem = (size_t)(ld * ld + TILE_ROWS * ld) * sizeof(T) +
                      TILE_ROWS * sizeof(int);
  auto kernel = gbatc_tile_kernel<T, MODE, CMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_tiles = (nb + TILE_ROWS - 1) / TILE_ROWS;
  const long long grid_x = (n_tiles + tiles_per_cta - 1) / tiles_per_cta;
  const int vec_ok = d % KU == 0 && aligned16(a) && aligned16(x) &&
                     aligned16(rank) && aligned16(mk) && aligned16(out);
  dim3 grid((unsigned)grid_x, (unsigned)s);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, basis, x, rank, m, mk, out, nb, d, tiles_per_cta, vec_ok);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch(const T* a, const T* basis, const T* x, const int* rank,
           const int* m, const T* mk, T* out, int s, long long nb, int d,
           int tiles_per_cta, void* stream) {
  if (d < 1 || d > MAX_D || s < 0 || s > 65535 || nb < 0 || tiles_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  if (s == 0 || nb == 0) return (int)cudaSuccess;
  if (d <= 5 * TX)
    return launch_as<T, MODE, 5>(a, basis, x, rank, m, mk, out, s, nb, d,
                                 tiles_per_cta, stream);
  return launch_as<T, MODE, MAX_D / TX>(a, basis, x, rank, m, mk, out, s, nb,
                                        d, tiles_per_cta, stream);
}

}  // namespace

extern "C" {

const char* gbatc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gbatc_project_batched_f32(const float* r, const float* u, float* c, int s,
                              long long nb, int d, int tiles_per_cta,
                              void* stream) {
  return launch<float, MODE_PROJECT>(r, u, nullptr, nullptr, nullptr, nullptr,
                                     c, s, nb, d, tiles_per_cta, stream);
}
int gbatc_project_batched_f64(const double* r, const double* u, double* c,
                              int s, long long nb, int d, int tiles_per_cta,
                              void* stream) {
  return launch<double, MODE_PROJECT>(r, u, nullptr, nullptr, nullptr, nullptr,
                                      c, s, nb, d, tiles_per_cta, stream);
}
int gbatc_correct_batched_f32(const float* x, const float* c, const float* u,
                              float* out, int s, long long nb, int d,
                              int tiles_per_cta, void* stream) {
  return launch<float, MODE_CORRECT>(c, u, x, nullptr, nullptr, nullptr, out, s,
                                     nb, d, tiles_per_cta, stream);
}
int gbatc_correct_batched_f64(const double* x, const double* c,
                              const double* u, double* out, int s,
                              long long nb, int d, int tiles_per_cta,
                              void* stream) {
  return launch<double, MODE_CORRECT>(c, u, x, nullptr, nullptr, nullptr, out,
                                      s, nb, d, tiles_per_cta, stream);
}
int gbatc_select_accumulate_f32(const float* x, const float* c,
                                const int* rank, const int* m, const float* u,
                                float* out, int s, long long nb, int d,
                                int tiles_per_cta, void* stream) {
  return launch<float, MODE_SELECT>(c, u, x, rank, m, nullptr, out, s, nb, d,
                                    tiles_per_cta, stream);
}
int gbatc_select_accumulate_f64(const double* x, const double* c,
                                const int* rank, const int* m, const double* u,
                                double* out, int s, long long nb, int d,
                                int tiles_per_cta, void* stream) {
  return launch<double, MODE_SELECT>(c, u, x, rank, m, nullptr, out, s, nb, d,
                                     tiles_per_cta, stream);
}
int gbatc_correct_masked_f32(const float* x, const float* c, const float* mask,
                             const float* u, float* out, int s, long long nb,
                             int d, int tiles_per_cta, void* stream) {
  return launch<float, MODE_MASKED>(c, u, x, nullptr, nullptr, mask, out, s,
                                    nb, d, tiles_per_cta, stream);
}
int gbatc_correct_masked_f64(const double* x, const double* c,
                             const double* mask, const double* u, double* out,
                             int s, long long nb, int d, int tiles_per_cta,
                             void* stream) {
  return launch<double, MODE_MASKED>(c, u, x, nullptr, nullptr, mask, out, s,
                                     nb, d, tiles_per_cta, stream);
}

}  // extern "C"
