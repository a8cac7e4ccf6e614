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
// Six kernels serve these modes: four up to D = 128, and past it two that
// stage the basis in k panels ("Wide blocks" below).
//
// fp64 project (project_f64_dmma): at the main path's (58, 20480, 80) the
// work is 760 MB read, 760 MB written and 15.2 GFLOP, so bytes bound it
// (0.455 ms at 3.35 TB/s) as long as the products run on the fp64 tensor
// cores (0.23 ms at 67 TFLOP/s); scalar DFMAs alone would take as long as
// the bytes. What limits it now is the device-memory stream itself: the
// ring with its MMAs taken out moves the same bytes in about the same time.
// Design:
//
// * Products are DMMA, mma.sync.m16n8k8 in fp64 (IEEE fp64 products and
//   sums). A warp owns 16 rows of a 64-row tile and half of its n8 column
//   fragments (5 at D <= 80); its C fragments stay in registers over the
//   whole k loop and go straight to device memory, a 16-byte store a lane.
//   (The m8n8k4 shape of the same instruction issues more slowly.)
// * The basis is kept in shared memory in fragment order (slot (k step,
//   n fragment, lane) of two doubles), zero padded to k % 8 and n % 8, so
//   every B fragment is one conflict-free 16-byte load a lane. A tile's
//   rows are padded to ld = 4 or 12 (mod 16) doubles, so an A fragment's 8
//   rows fall on distinct banks; the pad columns are zeroed once.
// * Row tiles stream through a ring of STAGES buffers filled with
//   cp.async (16-byte copies, 8-byte ones where D is odd or unaligned):
//   while the warps run DMMA on tile t, the next STAGES-1 tiles are in
//   flight. One barrier a tile frees the buffer of tile t-1 for refill.
// * The grid is persistent: one CTA an SM walks a contiguous,
//   species-major range of tiles and reloads the basis only where its
//   range crosses a species boundary.
// * A row's k order is fixed (k steps ascending), so its bits do not
//   depend on which CTA or tile position computed it.
// * D <= 80 uses 64-row tiles and 3 stages (176 KB of shared memory at
//   D = 80; a fourth stage measured slower); 80 < D <= 128 uses 32-row
//   tiles and 3 stages (227 KB at D = 128).
//
// fp32 project (project_f32_3xtf32; it replaces the Pallas gbatc_project,
// src/repro/kernels/gbatc_project.py:105, and the fp32 gbatc_project_batched,
// :207): at the 2D shape (1187840, 80) the work is 380 MB read, 380 MB
// written (0.227 ms at 3.35 TB/s) and 7.6 G FMAs (0.227 ms at the 67
// TFLOP/s FFMA peak). Bytes and FFMAs have equal bounds, and FFMA loops run
// well below their peak here (see correct_f32_ring), so no FFMA design
// reaches half the bound: the products leave the CUDA cores. Design, on the
// skeleton of project_f64_dmma:
//
// * Products are TF32 mma.sync.m16n8k8 (fp32 accumulate) in the 3xTF32
//   form. Each operand is split as x = hi + lo, hi = cvt.rna.tf32(x), lo =
//   cvt.rna.tf32(x - hi); a_lo . b_hi and a_hi . b_lo go into a correction
//   accumulator of their own, a_hi . b_hi into the main one, and the two
//   are added once, after the k loop. What is dropped (a_lo . b_lo, and lo's
//   own rounding) is about 2^-22 of a product, so the result keeps an fp32
//   level of error; single-pass TF32 (about 3 digits) would not. The three
//   products are 46 GFLOP at (1187840, 80), 0.09 ms at the tensor cores'
//   495 TFLOP/s, under the byte stream.
// * The basis is split once, at load, and kept in shared memory as hi and
//   lo planes in fragment order, zero padded to k % 16 and n % 8, so every
//   B load is one conflict-free 16-byte load a lane. A is split as each
//   fragment is loaded: a k pair of 16 is two m16n8k8 steps, and a lane
//   loads 4 consecutive k of each of its two rows as one 16-byte load (the
//   k order inside a step is permuted alike in A and B). Tile rows are
//   padded to 16 mod 32 floats (none at D = 80), so the two rows a quarter
//   warp loads fall on distinct banks.
// * The grid, the ring of 64-row tiles, the basis reloaded only where a
//   CTA's range crosses a species, and the epilogue from registers are
//   project_f64_dmma's. Where a tile is contiguous in shared memory too (ld
//   == D, as at D = 80), one thread moves it with one bulk copy (the TMA
//   engine, completion on an mbarrier a stage); elsewhere the threads copy
//   it with cp.async (16-byte copies, 4-byte ones where D % 4 != 0 or an
//   operand is not 16-byte aligned). The bulk copy streams faster and takes
//   the copies off the warps. Two stages and two CTAs of 8 warps an SM at
//   D <= 80 (92 KB of shared memory each; a third stage measured slower);
//   32-row tiles, three stages and one CTA at D <= 128.
// * Within a k pair, each of the six products is issued for all n
//   fragments back to back, so no MMA waits on the one before it.
// * k pairs run ascending and each output's three products in one order,
//   so a row's bits do not depend on its tile position. No TF32 anywhere
//   else: cuBLAS and cuDNN stay in full fp32 (device.py::strict_fp32).
//
// fp32 correct and select (correct_f32_ring; they replace the Pallas
// gbatc_correct_batched, src/repro/kernels/gbatc_project.py:240, and
// gbatc_select_accumulate, :288): at the main path's (58, 20480, 80) select
// reads x, c and rank and writes out (1.52 GB, 0.455 ms at 3.35 TB/s),
// correct reads x and c (1.14 GB, 0.341 ms); either does 7.6 G FFMA, 0.227
// ms on the CUDA cores at 67 TFLOP/s. What bounds them on this card is the
// FFMAs as much as the bytes: the compiler's outer-product FFMAs issue well
// below the FFMA peak (each reads two fresh registers), so the FMA loop
// alone takes about as long as correct's byte stream, and the design's aim
// is to keep both going at once. Design:
//
// * Both modes keep one order of arithmetic, the tile kernel's before
//   them: acc = +0, acc = fmaf(c'_k, U[j][k], acc) for k ascending (k
//   padded with zeros to a multiple of 4), out = x + acc, where c'_k is
//   +0 in select when rank >= m. Select on (c, rank, m) is therefore
//   bitwise correct on where(rank < m, c, 0): the encode side's
//   reconstruction and the decode side's replay agree bit for bit. No
//   split-k, no TF32, no fast-math.
// * The grid is persistent (two CTAs an SM at D <= 80); a CTA walks a
//   contiguous, species-major range of 64-row tiles and reloads the basis,
//   transposed to [k][j] and zero padded, only where its range crosses a
//   species.
// * Row tiles of c stream through a ring of STAGES shared buffers filled
//   with cp.async (16-byte copies, 4-byte ones where D % 4 != 0 or an
//   operand is not 16-byte aligned): while a tile is computed the next
//   STAGES-1 are in flight. A thread copies the same chunks of every tile.
//   Select copies rank into one more tile buffer and masks the
//   coefficients a thread copied itself once they land, against cuts that
//   landed a tile earlier; a thread reads only its own rank chunks, so it
//   refills them for the next tile right after masking, and one barrier a
//   tile serves both modes. Neither mask nor masked coefficients reach
//   device memory.
// * A thread owns 4 rows (16 apart) by 4 contiguous columns. Per 4 k it
//   issues 4 16-byte loads of A (rows padded to an odd number of 16-byte
//   chunks, so 8 rows fall on distinct banks), 4 16-byte broadcast loads of
//   B (row length fixed at compile time, so their offsets are immediates)
//   and 64 FFMAs; no bound test is left in the loop. A CTA has 64 threads
//   per 16 columns (320 at D = 80). Larger thread tiles (8 x 4, 8 x 8)
//   measured no faster: the loop's rate is the FFMAs', not the loads'.
// * x is loaded into registers before the FMA loop, and out = x + acc goes
//   from registers to device memory, a 16-byte store a row; a warp covers
//   8 rows by 64 contiguous bytes, whole 32-byte sectors.
// * Two stages: more measured slower. Two CTAs an SM at D <= 80 (89 KB
//   of shared memory for select, 67 KB for correct), one at D <= 128 (164
//   KB for select).
//
// The masked mode and the fp64 correct and select modes up to D = 128
// (gbatc_tile_kernel; the masked mode replaces the Pallas gbatc_correct,
// src/repro/kernels/gbatc_project.py:140, and reaches over half its byte
// bound): at D = 80 each output element costs 80 FMAs against 8 (fp32) or
// 16 (fp64) bytes moved, which sits near the ridge of the fp32 CUDA-core
// roofline, so the kernel must neither re-read inputs nor stall on them.
// Design:
//
// * One CTA owns one species and a run of row tiles of 64 blocks; the
//   species' basis stays in shared memory for the CTA's life (transposed on
//   load for the U^T product, so the inner loop reads it conflict-free).
//   Runs are short (the wrapper asks for 8 tiles), so the grid is many
//   waves deep and no SM idles through a long tail. The species are the
//   grid's y, which stops at 65,535: past that a CTA takes species y, y +
//   65,535, ... in turn, each as it would alone.
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
//   (x +) reads and writes device memory coalesced.
// * Registers are capped at 128 a thread (two CTAs per SM), so one CTA's
//   staging overlaps the other's FMAs.
// * The select mode reads its per-row cut m once per row and forms
//   rank < m in registers while staging; the masked mode multiplies its
//   mask in there. Neither the mask nor the masked coefficients are ever
//   written to device memory.
//
// Wide blocks, D > 128 (project_f64_wide, gbatc_wide): every mode takes
// any D, as the Pallas wrappers do by padding. The weight checkpoint's
// blocks are 256 long (train/checkpoint.py) and a codec's 8 x 8 x 8 block
// is 512. A species' basis is 512 KB in fp64 and 256 KB in fp32 at D =
// 256, more than the 227 KB of shared memory a CTA may hold, so both
// kernels stage it in k panels beside the matching panel of the row tile,
// one ring of panels a CTA that runs on across its tiles. At (1, 65536,
// 256) the projection moves 268 MB (0.080 ms at 3.35 TB/s) for 8.6 GFLOP
// (0.128 ms on the fp64 tensor cores), and correct 201 MB for 4.3 G FFMA
// (0.128 ms at 67 TFLOP/s): the operations bound both. Select moves 268 MB
// (0.080 ms) and needs FFMAs only for the kept terms, about half of them at
// uniform cuts: its bytes bound it. At a codec's (58, 1600, 512) every mode
// does 2 x 58 x 1600 x 512^2 = 48.7 GFLOP (0.73 ms at 67 TFLOP/s) against
// 0.13-0.26 ms of bytes: the operations bound all of them. Design:
//
// * project_f64_wide (the fp64 projection): DMMA m16n8k8 in fp64 as
//   project_f64_dmma. A 64-row tile takes a slab of 256 columns (all of
//   them at D <= 256): 8 warps of 32 rows by 64 columns, 64 fp64
//   accumulators a lane. A panel is 32 k: the tile's A[:, k0 : k0 + 32]
//   (18 KB, rows padded to 36 doubles) and U[k0 : k0 + 32, j0 : j0 + 256]
//   as it lies in device memory (66 KB, rows padded to 264 doubles), both
//   copied 16 bytes at a time; 2 stages, 168 KB, one CTA an SM. Each basis
//   byte fetched from L2 serves 64 rows. A B fragment is two 8-byte loads
//   a lane (rows q and q + 4), which take the 4 wavefronts of one 16-byte
//   load: a panel in fragment order would take 8-byte copies, and filling
//   it that way measured slower than the loads it saves. Past D = 256 a
//   row tile's slabs follow each other, each looping k over all of D.
// * gbatc_wide<T, MODE> (fp32 correct and select, fp64 correct and select,
//   the masked mode in both dtypes, and the fp32 projection): 128 x 128
//   tiles (a row tile's column tiles follow each other, so its A panels
//   come from L2 the second time), 8 warps of 32 rows by 64 columns, an
//   8 x 8 register tile a thread. A panel is 16 k: A[rows, k0 : k0 + 16]
//   (c or the residual; select: and rank; masked: and the mask) and the
//   basis' piece land as they lie in device memory through a 3-stage
//   cp.async ring, and the thread that copied a chunk writes it (select: c
//   = +0 where rank >= m; masked: c times the mask) into a double buffer
//   laid out [k][row] and [k][j]; each k is then 2 + 2 16-byte loads (fp64:
//   4 + 4) for 64 FMAs. The correct modes read U[j0 : j0 + 128, k0 : k0 +
//   16] and transpose it; the projection reads U[k0 : k0 + 16, j0 : j0 +
//   128], already [k][j], and adds no x. fp32: 82 KB (correct, project) or
//   106 KB (select, masked) a CTA, two CTAs an SM under 128 registers;
//   what spills under that cap is stored and loaded around the copies, the
//   transposes and the epilogue, never in the FFMA loop. fp64: 162, 187 or
//   210 KB and one CTA an SM under 255 registers (64 fp64 accumulators a
//   thread). x is read once an element, in the epilogue.
// * The order of arithmetic is fixed, so no bit depends on the tiling.
//   gbatc_wide: acc = +0, acc = fma(c'_k, B[k][j], acc) for k ascending up
//   to ceil(D / E) * E (E = 4 fp32, 2 fp64 values a 16-byte chunk) with +0
//   terms past D, out = x + acc (the projection: acc), c' = +0 where rank
//   >= m, c' = c * mask in the masked mode; select on (c, rank, m) stays
//   bitwise correct on where(rank < m, c, 0). project_f64_wide: each
//   fragment's m16n8k8 steps ascending from +0, no step past ceil(D / 8),
//   +0 in A and B past D. A panel or a slab only changes which thread
//   computes an element and when its operands arrive; no split-k, no TF32,
//   no fast-math. The kernels phase of chip_smoke.py holds their outputs'
//   sha256 at every WIDE shape to pinned values (WIDE_SHA256, the fp32
//   correct and select and the fp64 projection since their first build),
//   and every route's at every ANY_D shape (ANY_D_SHA256).
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
constexpr int MAX_D = 128;  // the tile, ring and 3xTF32 kernels; wide past it

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

// Species s: this CTA's row tiles of it.
template <typename T, int MODE, int CMAX>
__device__ __forceinline__ void gbatc_tile_species(
    const T* __restrict__ a,       // coefficients
    const T* __restrict__ basis,   // (S, D, D)
    const T* __restrict__ x,       // x_rec
    const int* __restrict__ rank,  // select only, (S, NB, D)
    const int* __restrict__ m,     // select only, (S, NB)
    const T* __restrict__ mk,      // masked only, (S, NB, D)
    T* __restrict__ out, long long nb, int d, int tiles_per_cta, int vec_ok,
    int s) {
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

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  if (ld != d) {  // zero the padding once: padded k must add exactly 0
    for (int i = tid; i < ld * ld + TILE_ROWS * ld; i += THREADS) u_s[i] = T(0);
    __syncthreads();
  }
  // B[k][j] = U[j][k] of acc = A @ B = C @ U^T
  const T* u_g = basis + (size_t)s * d * d;
  for (int i = tid; i < d * d; i += THREADS) {
    const int row = i / d, col = i - row * d;
    u_s[col * ld + row] = u_g[i];
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

    // ---- epilogue: out = x + tile, coalesced -----------------------------
    if (vec_ok) {
      const int nvec = n_el / N;
      const P* x_v = reinterpret_cast<const P*>(x + base);
      P* o_v = reinterpret_cast<P*>(out + base);
      for (int v0 = 0; v0 * THREADS < nvec; v0 += BATCH) {
        P xv[BATCH];
#pragma unroll
        for (int v = 0; v < BATCH; ++v) {
          const int idx = tid + (v0 + v) * THREADS;
          if (idx < nvec) xv[v] = x_v[idx];
        }
#pragma unroll
        for (int v = 0; v < BATCH; ++v) {
          const int idx = tid + (v0 + v) * THREADS;
          if (idx < nvec) {
            P w = reinterpret_cast<const P*>(a_s)[idx];
#pragma unroll
            for (int c = 0; c < N; ++c) w.v[c] = xv[v].v[c] + w.v[c];
            o_v[idx] = w;
          }
        }
      }
    } else {
      for (int i = tid; i < n_el; i += THREADS) {
        const int row = i / d, col = i - row * d;
        out[base + i] = x[base + i] + a_s[row * ld + col];
      }
    }
  }
}

// A grid's y stops at 65,535: a CTA takes species blockIdx.y, blockIdx.y +
// gridDim.y, ... of s_count (one, up to 65,535 species), each with the
// arithmetic of one species a CTA.
template <typename T, int MODE, int CMAX>
__global__ void __launch_bounds__(THREADS, 2)
gbatc_tile_kernel(const T* __restrict__ a, const T* __restrict__ basis,
                  const T* __restrict__ x, const int* __restrict__ rank,
                  const int* __restrict__ m, const T* __restrict__ mk,
                  T* __restrict__ out, int s_count, long long nb, int d,
                  int tiles_per_cta, int vec_ok) {
  for (int s = blockIdx.y; s < s_count; s += gridDim.y) {
    if (s != (int)blockIdx.y) __syncthreads();  // shared memory is free
    gbatc_tile_species<T, MODE, CMAX>(a, basis, x, rank, m, mk, out, nb, d,
                                      tiles_per_cta, vec_ok, s);
  }
}

// ---- fp64 projection on the tensor cores ---------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
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

// one bulk copy (the TMA engine) of `bytes` contiguous bytes to shared
// memory, reported to the mbarrier `bar` as transaction bytes
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}
// wait for the phase of `bar` with this parity to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// c += a . b over one m16n8k8 step in fp64. Per lane (g = lane / 4,
// t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b =
// B[t][g], B[t+4][g]; c = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4],
                                     double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// padded shared row length of an A tile: at least D rounded up to the k
// step of 8, and 4 or 12 mod 16, so the 8 rows of a fragment load sit on
// distinct banks
inline int dmma_ld(int d) {
  int ld = (d + 7) / 8 * 8;
  while (ld % 16 != 4 && ld % 16 != 12) ld += 4;
  return ld;
}

template <int NFW, int TM, int STAGES>
__global__ void __launch_bounds__(TM / 16 * 64, 1)
project_f64_dmma(const double* __restrict__ r, const double* __restrict__ basis,
                 double* __restrict__ out, int s_count, long long nb, int d,
                 int ld, int vec) {
  constexpr int WM = TM / 16;         // 16-row warp groups in a tile
  constexpr int THREADS_D = WM * 64;  // two warps (column halves) a group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks_n = (d + 7) / 8;     // k steps of 8
  const int nf_n = (d + 7) / 8;     // n fragments of 8
  double* b_s = reinterpret_cast<double*>(smem_raw);  // (ks_n, nf_n, 32, 2)
  double* a_s = b_s + ks_n * nf_n * 64;                // (STAGES, TM, ld)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, q = lane & 3;
  const int nf_w = min(NFW, nf_n - wn * NFW);  // this warp's n fragments
  const long long tps = (nb + TM - 1) / TM;    // tiles a species
  const long long total = tps * s_count;
  const long long t_begin = total * blockIdx.x / gridDim.x;
  const long long t_end = total * (blockIdx.x + 1) / gridDim.x;

  // pad columns d .. ld-1 add exactly 0 (B's pad rows are zero too)
  const int pad = ld - d;
  for (int i = tid; i < STAGES * TM * pad; i += THREADS_D)
    a_s[(i / pad) * ld + d + i % pad] = 0.0;

  auto issue = [&](long long t, int buf) {
    const long long s = t / tps, row0 = (t - s * tps) * TM;
    const int rows = (int)min((long long)TM, nb - row0);
    const double* src = r + ((size_t)s * nb + row0) * d;
    double* dst = a_s + buf * TM * ld;
    if (vec) {
      const int half = d >> 1, n = rows * half;
      for (int i = tid; i < n; i += THREADS_D) {
        const int row = i / half, c = (i - row * half) * 2;
        cp_async16(dst + row * ld + c, src + (size_t)row * d + c);
      }
    } else {
      const int n = rows * d;
      for (int i = tid; i < n; i += THREADS_D) {
        const int row = i / d, c = i - row * d;
        cp_async8(dst + row * ld + c, src + i);
      }
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (t_begin + st < t_end) issue(t_begin + st, st);
    cp_async_commit();
  }

  long long cur_s = -1;
  for (long long t = t_begin; t < t_end; ++t) {
    const int i = (int)(t - t_begin);
    cp_async_wait<STAGES - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();              // ... everyone's; tile t-1 is done with
    if (t + STAGES - 1 < t_end)
      issue(t + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    const long long s = t / tps;
    if (s != cur_s) {  // the range crossed into a new species
      const double* u = basis + (size_t)s * d * d;
      for (int idx = tid; idx < ks_n * nf_n * 64; idx += THREADS_D) {
        const int e = idx & 1, ln = (idx >> 1) & 31, f = idx >> 6;
        const int k = (f / nf_n) * 8 + (ln & 3) + 4 * e;
        const int n = (f % nf_n) * 8 + (ln >> 2);
        b_s[idx] = (k < d && n < d) ? u[k * d + n] : 0.0;
      }
      __syncthreads();
      cur_s = s;
    }
    if (nf_w <= 0) continue;  // warp-uniform: D too small for this half

    const long long row0 = (t - s * tps) * TM;
    const int rows = (int)min((long long)TM, nb - row0);
    const double* a0 = a_s + (i % STAGES) * TM * ld + (wm * 16 + g) * ld + q;
    const double2* bp =
        reinterpret_cast<const double2*>(b_s) + wn * NFW * 32 + lane;
    double acc[NFW][4];
#pragma unroll
    for (int j = 0; j < NFW; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0;
#pragma unroll 2
    for (int ks = 0; ks < ks_n; ++ks) {
      const double* ak = a0 + ks * 8;
      const double a[4] = {ak[0], ak[8 * ld], ak[4], ak[8 * ld + 4]};
      const double2* bk = bp + ks * nf_n * 32;
#pragma unroll
      for (int j = 0; j < NFW; ++j) {
        if (j < nf_w) {
          const double2 b = bk[j * 32];
          dmma(acc[j], a, b.x, b.y);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 16 + h * 8 + g;
      if (row >= rows) continue;
      double* o = out + ((size_t)s * nb + row0 + row) * d;
#pragma unroll
      for (int j = 0; j < NFW; ++j) {
        const int col = (wn * NFW + j) * 8 + 2 * q;
        if (j >= nf_w || col >= d) continue;
        if (vec) {
          *reinterpret_cast<double2*>(o + col) =
              make_double2(acc[j][2 * h], acc[j][2 * h + 1]);
        } else {
          o[col] = acc[j][2 * h];
          if (col + 1 < d) o[col + 1] = acc[j][2 * h + 1];
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- fp64 projection past D = 128 ------------------------------------------

constexpr int WIDE_THREADS = 256;  // 8 warps, both wide kernels

// species, first column, first row (of all S * NB) and rows of a tile
struct WideTile {
  int s, j0, rows;
  long long r0;
};

// A 64-row tile against a slab of up to WIDE_SLAB64 of a species' columns
// (one slab at D <= 256; past it a row tile's slabs follow each other, so
// its A panels come from L2 the second time). Warp (wm, wn) owns rows
// 32 wm .. +31 (two A fragments) and n fragments 8 wn .. +7 of the slab.
// A CTA walks its tiles as one stream of k panels (WIDE_KP64 k each): a
// panel is the tile's A[:, k0 : k0 + KP] (rows padded to KP + 4 doubles)
// and U[k0 : k0 + KP, j0 : j0 + 256] as it lies in device memory (rows
// padded to 264 doubles), both copied by all threads with cp.async; lane
// (g, q) reads its B fragment as U[k0 + 8 ks + q][n] and U[k0 + 8 ks + q +
// 4][n], n = j0 + 8 f + g.
constexpr int WIDE_KP64 = 32;     // k a panel of the fp64 projection
constexpr int WIDE_STAGES64 = 2;  // panels in its ring
constexpr int WIDE_SLAB64 = 256;  // columns a tile

__global__ void __launch_bounds__(WIDE_THREADS, 1)
project_f64_wide(const double* __restrict__ r, const double* __restrict__ basis,
                 double* __restrict__ out, int s_count, long long nb, int d,
                 int vec) {
  constexpr int TM = 64, KP = WIDE_KP64, KS = KP / 8, STAGES = WIDE_STAGES64;
  constexpr int SLAB = WIDE_SLAB64;
  // row pads: 4 mod 16 doubles puts an A fragment's 8 rows on distinct
  // banks, 8 mod 32 a B fragment's rows q and q + 1 on distinct bank halves
  constexpr int LDA = KP + 4, LDB = SLAB + 8;
  constexpr int A_WORDS = TM * LDA, B_WORDS = KP * LDB;
  constexpr int STAGE = A_WORDS + B_WORDS;  // doubles a ring buffer
  static_assert(LDA % 16 == 4 && LDB % 32 == 8, "panel shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);  // STAGES x [A | B]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, q = lane & 3;
  const int ks_n = (d + 7) / 8;  // k steps of D
  const int dp = ks_n * 8;       // D padded with zero terms
  const int panels = (ks_n + KS - 1) / KS;
  const int nsl = (d + SLAB - 1) / SLAB;  // column slabs
  // tile and step indices fit an int (the launcher checks tiles x panels)
  const int tps = (int)((nb + TM - 1) / TM) * nsl;  // tiles a species
  const int total = tps * s_count;
  const int t_begin = (int)((long long)total * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);
  const int steps = (t_end - t_begin) * panels;

  // species-major, then row tile, then column slab
  auto tile = [&](int t) {
    WideTile w;
    w.s = t / tps;
    const int rt = (t - w.s * tps) / nsl;
    w.j0 = (t - w.s * tps - rt * nsl) * SLAB;
    const long long row0 = (long long)rt * TM;
    w.r0 = w.s * nb + row0;
    w.rows = (int)min((long long)TM, nb - row0);
    return w;
  };

  // The copies run STAGES - 1 steps ahead of the MMAs: step iv, panel ip
  // of tile it, goes into ring buffer iv % STAGES. k in [D, dp) and
  // columns in [jw, jwp) of a slab jw wide are zero terms, in A and in B,
  // as in project_f64_dmma.
  int it = t_begin, ip = 0, iv = 0;
  WideTile iw{};
  auto issue = [&]() {
    if (ip == 0) iw = tile(it);
    const int k0 = ip * KP;
    const int kv = min(KP, d - k0);   // k of D in this panel
    const int kn = min(KP, dp - k0);  // k its MMAs run
    const int jw = min(SLAB, d - iw.j0);  // columns of D in this slab
    const int jwp = (jw + 7) / 8 * 8;     // and its MMAs
    double* a_s = ring + (iv % STAGES) * STAGE;
    double* b_s = a_s + A_WORDS;
    const double* src = r + (size_t)iw.r0 * d + k0;
    const double* u = basis + ((size_t)iw.s * d + k0) * d + iw.j0;
    // a thread's chunks of the B panel are (k, n) = (i / bw, i % bw), i =
    // tid + 256 n, bw the chunks of a row: the walk's start and step
    const int bw = vec ? jw / 2 : jw;
    const int bdk = WIDE_THREADS / bw, bdn = WIDE_THREADS % bw;
    if (vec) {  // D even: 16-byte pairs
      for (int i = tid; i < TM * KP / 2; i += WIDE_THREADS) {
        const int row = i / (KP / 2), k = i % (KP / 2) * 2;
        if (row < iw.rows && k < kv)
          cp_async16(a_s + row * LDA + k, src + (size_t)row * d + k);
      }
      for (int k = tid / bw, n = tid % bw; k < kv;) {
        cp_async16(b_s + k * LDB + 2 * n, u + (size_t)k * d + 2 * n);
        k += bdk, n += bdn;
        if (n >= bw) n -= bw, ++k;
      }
    } else {
      for (int i = tid; i < TM * KP; i += WIDE_THREADS) {
        const int row = i / KP, k = i % KP;
        if (row < iw.rows && k < kv)
          cp_async8(a_s + row * LDA + k, src + (size_t)row * d + k);
      }
      for (int k = tid / bw, n = tid % bw; k < kv;) {
        cp_async8(b_s + k * LDB + n, u + (size_t)k * d + n);
        k += bdk, n += bdn;
        if (n >= bw) n -= bw, ++k;
      }
    }
    // the zero terms: A columns [kv, kn); B rows [kv, kn) and columns [jw, jwp)
    if (kn > kv) {
      for (int i = tid; i < iw.rows * (kn - kv); i += WIDE_THREADS)
        a_s[i / (kn - kv) * LDA + kv + i % (kn - kv)] = 0.0;
    }
    if (jwp > jw || kn > kv) {
      for (int i = tid; i < kn * jwp; i += WIDE_THREADS) {
        const int k = i / jwp, n = i % jwp;
        if (k >= kv || n >= jw) b_s[k * LDB + n] = 0.0;
      }
    }
    ++iv;
    if (++ip == panels) ip = 0, ++it;
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) issue();
    cp_async_commit();
  }

  double acc[2][8][4];
  WideTile w{};
  int jw = 0, nf_w = 0;  // the tile's columns, and this warp's n fragments
  for (int v = 0, t = t_begin, p = 0; v < steps; ++v) {
    cp_async_wait<STAGES - 2>();  // step v has landed (this thread's copies)
    __syncthreads();              // ... everyone's; step v-1 is done with
    if (v + STAGES - 1 < steps) issue();
    cp_async_commit();

    if (p == 0) {  // a new tile: acc = +0
      w = tile(t);
      jw = min(SLAB, d - w.j0);
      nf_w = min(8, (jw + 7) / 8 - wn * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.0;
    }
    if (nf_w > 0) {  // warp-uniform: the slab may leave this warp's columns empty
      const double* a_s = ring + (v % STAGES) * STAGE;
      const double* a0 = a_s + (wm * 32 + g) * LDA + q;
      const double* b0 = a_s + A_WORDS + q * LDB + wn * 64 + g;
      auto kstep = [&](int ks) {  // k0 + 8 ks .. +7, one MMA a fragment pair
        double a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const double* ak = a0 + mi * 16 * LDA + ks * 8;
          a[mi][0] = ak[0], a[mi][1] = ak[8 * LDA];
          a[mi][2] = ak[4], a[mi][3] = ak[8 * LDA + 4];
        }
        const double* bk = b0 + ks * 8 * LDB;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nf_w) {
            const double bx = bk[j * 8], by = bk[4 * LDB + j * 8];
            dmma(acc[0][j], a[0], bx, by);
            dmma(acc[1][j], a[1], bx, by);
          }
        }
      };
      const int ksn = min(KS, ks_n - p * KS);
      if (ksn == KS) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) kstep(ks);
      } else {
#pragma unroll 1
        for (int ks = 0; ks < ksn; ++ks) kstep(ks);
      }
    }
    if (++p < panels) continue;
    p = 0, ++t;
    if (nf_w <= 0) continue;

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + mi * 16 + h * 8 + g;
        if (row >= w.rows) continue;
        double* o = out + (size_t)(w.r0 + row) * d + w.j0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = (wn * 8 + j) * 8 + 2 * q;
          if (j >= nf_w || col >= jw) continue;
          if (vec) {
            *reinterpret_cast<double2*>(o + col) =
                make_double2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
          } else {
            o[col] = acc[mi][j][2 * h];
            if (col + 1 < jw) o[col + 1] = acc[mi][j][2 * h + 1];
          }
        }
      }
  }
  cp_async_wait<0>();
}

// ---- fp32 projection on the tensor cores: 3xTF32 -------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}
// x = hi + lo to about 2^-22 of x, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a . b over one m16n8k8 step, tf32 operands, fp32 accumulate; the
// fragments are laid out as dmma's
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// padded shared row length of an A tile: D rounded up to the k pair of 16,
// and 16 mod 32 floats, so the two rows a quarter warp loads at once (16
// bytes a lane) fall on distinct banks
inline int tf32_ld(int d) {
  const int ld = (d + 15) / 16 * 16;
  return ld % 32 == 16 ? ld : ld + 16;
}

// A k pair covers 16 k as two m16n8k8 steps. Lane (g, q) loads A[row][16 p
// + 4 q .. + 3] of rows g and g + 8 as one 16-byte load each: the first
// step takes k = 16 p + 4 q (its fragment's k = q) and 16 p + 4 q + 1 (k =
// q + 4), the second 16 p + 4 q + 2 and + 3. B is stored in the same order.
template <int NFW, int TM, int STAGES>
__global__ void __launch_bounds__(TM / 16 * 64, TM == 64 ? 2 : 1)
project_f32_3xtf32(const float* __restrict__ r, const float* __restrict__ basis,
                   float* __restrict__ out, int s_count, long long nb, int d,
                   int ld, int vec) {
  constexpr int WM = TM / 16;         // 16-row warp groups in a tile
  constexpr int THREADS_T = WM * 64;  // two warps (column halves) a group
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kp_n = (d + 15) / 16;  // k pairs
  const int nf_n = (d + 7) / 8;    // n fragments of 8
  // the basis split into tf32 hi and lo parts, in fragment order: slot
  // ((p * nf_n + f) * 2 + part) * 32 + lane holds B[16 p + 4 q + 0..3][8 f
  // + g], so each B load is one conflict-free 16-byte load a lane
  uint4* b_s = reinterpret_cast<uint4*>(smem_raw);
  float* a_s = reinterpret_cast<float*>(b_s + kp_n * nf_n * 64);  // (STAGES, TM, ld)
  uint64_t* bars = reinterpret_cast<uint64_t*>(a_s + STAGES * TM * ld);  // bulk

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, q = lane & 3;
  const int nf_w = min(NFW, nf_n - wn * NFW);  // this warp's n fragments
  const long long tps = (nb + TM - 1) / TM;    // tiles a species
  const long long total = tps * s_count;
  const long long t_begin = total * blockIdx.x / gridDim.x;
  const long long t_end = total * (blockIdx.x + 1) / gridDim.x;

  // pad columns d .. ld-1 add exactly 0 (B's pad rows are zero too)
  const int pad = ld - d;
  for (int i = tid; i < STAGES * TM * pad; i += THREADS_T)
    a_s[(i / pad) * ld + d + i % pad] = 0.f;

  // vec == 2 (ld == d): a tile is one contiguous block in both memories
  // and thread 0 moves it with one bulk copy; otherwise a thread copies
  // the chunks (row, k) of a tile from (row_first, k_first) on, a fixed
  // step apart: the same chunks every tile
  if (vec == 2 && tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(bars + st);
    fence_proxy_async();
  }
  __syncthreads();
  const int w = vec ? 4 : 1;  // floats a chunk
  const int qc = d / w;       // chunks a row
  const int row_first = tid / qc, k_first = tid - row_first * qc;
  const int row_step = THREADS_T / qc, k_step = THREADS_T - row_step * qc;
  auto issue = [&](long long t, int buf) {
    const long long s = t / tps, row0 = (t - s * tps) * TM;
    const int rows = (int)min((long long)TM, nb - row0);
    const float* src = r + ((size_t)s * nb + row0) * d;
    float* dst = a_s + buf * TM * ld;
    if (vec == 2) {
      if (tid == 0) {
        fence_proxy_async();  // the buffer's last reads come before the copy
        bulk_copy(dst, src, rows * d * (int)sizeof(float), bars + buf);
      }
      return;
    }
    for (int row = row_first, k = k_first; row < rows;) {
      if (vec) cp_async16(dst + row * ld + k * 4, src + (size_t)row * d + k * 4);
      else cp_async4(dst + row * ld + k, src + (size_t)row * d + k);
      row += row_step;
      k += k_step;
      if (k >= qc) k -= qc, ++row;
    }
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (t_begin + st < t_end) issue(t_begin + st, st);
    cp_async_commit();
  }

  long long cur_s = -1;
  for (long long t = t_begin; t < t_end; ++t) {
    const int i = (int)(t - t_begin);
    if (vec == 2) mbar_wait(bars + i % STAGES, (i / STAGES) & 1);  // tile t landed
    else cp_async_wait<STAGES - 2>();  // tile t landed (this thread's copies)
    __syncthreads();                   // ... everyone's; tile t-1 is done with
    if (t + STAGES - 1 < t_end)
      issue(t + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();

    const long long s = t / tps;
    if (s != cur_s) {  // the range crossed into a new species: split its basis
      const float* u = basis + (size_t)s * d * d;
      for (int idx = tid; idx < kp_n * nf_n * 32; idx += THREADS_T) {
        const int ln = idx & 31, pf = idx >> 5;
        const int k0 = (pf / nf_n) * 16 + (ln & 3) * 4;
        const int n = (pf % nf_n) * 8 + (ln >> 2);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int k = k0 + m;
          split_tf32((k < d && n < d) ? u[k * d + n] : 0.f, hi[m], lo[m]);
        }
        b_s[pf * 64 + ln] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        b_s[pf * 64 + 32 + ln] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      __syncthreads();
      cur_s = s;
    }
    if (nf_w <= 0) continue;  // warp-uniform: D too small for this half

    const long long row0 = (t - s * tps) * TM;
    const int rows = (int)min((long long)TM, nb - row0);
    const float* a0 = a_s + (i % STAGES) * TM * ld + (wm * 16 + g) * ld + 4 * q;
    const uint4* bp = b_s + wn * NFW * 64 + lane;
    // a_hi . b_hi into acc; a_lo . b_hi and a_hi . b_lo into cor, added once
    // after the k loop (a_lo . b_lo, about 2^-22 of a product, is dropped)
    float acc[NFW][4], cor[NFW][4];
#pragma unroll
    for (int j = 0; j < NFW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = cor[j][e] = 0.f;
    for (int p = 0; p < kp_n; ++p) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + p * 16);
      const float4 x1 = *reinterpret_cast<const float4*>(a0 + 8 * ld + p * 16);
      uint32_t ah[2][4], al[2][4];
      split_tf32(x0.x, ah[0][0], al[0][0]);
      split_tf32(x1.x, ah[0][1], al[0][1]);
      split_tf32(x0.y, ah[0][2], al[0][2]);
      split_tf32(x1.y, ah[0][3], al[0][3]);
      split_tf32(x0.z, ah[1][0], al[1][0]);
      split_tf32(x1.z, ah[1][1], al[1][1]);
      split_tf32(x0.w, ah[1][2], al[1][2]);
      split_tf32(x1.w, ah[1][3], al[1][3]);
      const uint4* bk = bp + p * nf_n * 64;
      // a product's MMAs for all n fragments back to back: no MMA waits on
      // the one before it
      uint4 bh[NFW], bl[NFW];
#pragma unroll
      for (int j = 0; j < NFW; ++j)
        if (j < nf_w) bh[j] = bk[j * 64], bl[j] = bk[j * 64 + 32];
#pragma unroll
      for (int j = 0; j < NFW; ++j) if (j < nf_w) mma_tf32(cor[j], al[0], bh[j].x, bh[j].y);
#pragma unroll
      for (int j = 0; j < NFW; ++j) if (j < nf_w) mma_tf32(acc[j], ah[0], bh[j].x, bh[j].y);
#pragma unroll
      for (int j = 0; j < NFW; ++j) if (j < nf_w) mma_tf32(cor[j], ah[0], bl[j].x, bl[j].y);
#pragma unroll
      for (int j = 0; j < NFW; ++j) if (j < nf_w) mma_tf32(acc[j], ah[1], bh[j].z, bh[j].w);
#pragma unroll
      for (int j = 0; j < NFW; ++j) if (j < nf_w) mma_tf32(cor[j], al[1], bh[j].z, bh[j].w);
#pragma unroll
      for (int j = 0; j < NFW; ++j) if (j < nf_w) mma_tf32(cor[j], ah[1], bl[j].z, bl[j].w);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 16 + h * 8 + g;
      if (row >= rows) continue;
      float* o = out + ((size_t)s * nb + row0 + row) * d;
#pragma unroll
      for (int j = 0; j < NFW; ++j) {
        const int col = (wn * NFW + j) * 8 + 2 * q;
        if (j >= nf_w || col >= d) continue;
        const float y0 = acc[j][2 * h] + cor[j][2 * h];
        const float y1 = acc[j][2 * h + 1] + cor[j][2 * h + 1];
        if (vec) {
          *reinterpret_cast<float2*>(o + col) = make_float2(y0, y1);
        } else {
          o[col] = y0;
          if (col + 1 < d) o[col + 1] = y1;
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ---- fp32 correct and select: persistent cp.async ring, FFMA register tile

constexpr int RING_RM = 4;                  // rows a thread
constexpr int RING_NRY = 16;                // row lanes: rows ry + 16 i
constexpr int RING_TM = RING_RM * RING_NRY;  // 64-row tiles
constexpr int RING_STAGES = 2;              // tiles of c in the ring


__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

// padded shared row length of an A tile: D rounded up to 4 floats, and an
// odd number of 16-byte chunks, so the 8 rows a warp loads at one k fall
// on distinct banks
inline int ring_lda(int d) {
  int ld = (d + KU - 1) / KU * KU;
  if ((ld / 4) % 2 == 0) ld += 4;
  return ld;
}

// Thread tid owns rows ry + 16 i (i < 4) of a tile, ry = (tid / 4) % 16,
// and columns col .. col+3, col = 16 (tid / 64) + 4 (tid % 4): blockDim.x
// is 64 ceil(D / 16); NCH, the most 16-column groups, sets the launch
// bounds and B's row length in shared memory.
template <int MODE, int NCH, int MINB>
__global__ void __launch_bounds__(NCH * 64, MINB)
correct_f32_ring(const float* __restrict__ x, const float* __restrict__ c,
                 const int* __restrict__ rank,  // select only, (S, NB, D)
                 const int* __restrict__ m,     // select only, (S, NB)
                 const float* __restrict__ basis, float* __restrict__ out,
                 int s_count, long long nb, int d, int lda, int vec) {
  constexpr int RM = RING_RM, TM = RING_TM, LDB = 16 * NCH;
  constexpr int STAGES = RING_STAGES;
  constexpr bool SELECT = MODE == MODE_SELECT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int threads = blockDim.x;
  const int ldk = (d + KU - 1) / KU * KU;  // k padded with zero terms
  float* b_s = reinterpret_cast<float*>(smem_raw);  // (ldk, LDB): U^T
  float* c_s = b_s + ldk * LDB;                      // (STAGES, TM, lda)
  // select: one rank tile (TM, lda), then the cuts (STAGES, TM)
  int* r_s = reinterpret_cast<int*>(c_s + STAGES * TM * lda);
  int* m_s = r_s + (SELECT ? TM * lda : 0);

  const int tid = threadIdx.x;
  const int ry = (tid >> 2) % RING_NRY;
  const int col = (tid >> 6) * 16 + (tid & 3) * 4;
  // tile indices fit an int (the launcher checks S * tiles a species)
  const int tps = (int)((nb + TM - 1) / TM);  // tiles a species
  const int total = tps * s_count;
  const int t_begin = (int)((long long)total * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);
  // a thread copies the chunks (row, k) of a tile from (row_first,
  // k_first) on, a fixed step apart: the same chunks every tile
  const int w = vec ? 4 : 1;  // floats a chunk
  const int q = d / w;        // chunks a row
  const int row_first = tid / q, k_first = tid - row_first * q;
  const int row_step = threads / q, k_step = threads - row_step * q;

  // species, first row (of all S * NB) and rows of tile t
  auto tile = [&](int t, int& s, long long& r0, int& rows) {
    s = t / tps;
    const long long row0 = (long long)(t - s * tps) * TM;
    r0 = s * nb + row0;
    rows = (int)min((long long)TM, nb - row0);
  };
  auto copy = [&](void* dst, const void* src) {
    if (vec) cp_async16(dst, src);
    else cp_async4(dst, src);
  };
  // calls f(row, shared offset, offset in device memory) on each chunk of
  // a tile of `rows` rows that this thread copies
  auto own_chunks = [&](int rows, auto f) {
    for (int row = row_first, k = k_first; row < rows;) {
      f(row, row * lda + k * w, (size_t)row * d + k * w);
      row += row_step;
      k += k_step;
      if (k >= q) k -= q, ++row;
    }
  };
  auto issue_c = [&](int t, int buf) {
    int s;
    long long r0;
    int rows;
    tile(t, s, r0, rows);
    const float* src = c + (size_t)r0 * d;
    float* dst = c_s + buf * TM * lda;
    own_chunks(rows, [&](int, int off, size_t g) { copy(dst + off, src + g); });
  };
  // select: rank of tile t into the one rank tile. A thread reads there
  // only the chunks it copied itself, so it may refill them for the next
  // tile as soon as it has masked them, with no barrier between
  auto issue_rank = [&](int t) {
    int s;
    long long r0;
    int rows;
    tile(t, s, r0, rows);
    const int* src = rank + (size_t)r0 * d;
    own_chunks(rows, [&](int, int off, size_t g) { copy(r_s + off, src + g); });
  };
  // select: the cuts of tile t into slot buf, one group ahead of its tile
  auto issue_m = [&](int t, int buf) {
    int s;
    long long r0;
    int rows;
    tile(t, s, r0, rows);
    if (tid < rows) cp_async4(m_s + buf * TM + tid, m + r0 + tid);
  };
  // select: c = +0 where rank >= m, over the chunks this thread copied
  auto mask_own = [&](int t, int buf) {
    int s;
    long long r0;
    int rows;
    tile(t, s, r0, rows);
    float* cd = c_s + buf * TM * lda;
    const int* ms = m_s + buf * TM;
    own_chunks(rows, [&](int row, int off, size_t) {
      const int cut = ms[row];
      if (vec) {
        const int4 r = *reinterpret_cast<const int4*>(r_s + off);
        float4 v = *reinterpret_cast<float4*>(cd + off);
        if (!(r.x < cut)) v.x = 0.f;
        if (!(r.y < cut)) v.y = 0.f;
        if (!(r.z < cut)) v.z = 0.f;
        if (!(r.w < cut)) v.w = 0.f;
        *reinterpret_cast<float4*>(cd + off) = v;
      } else if (!(r_s[off] < cut)) {
        cd[off] = 0.f;
      }
    });
  };

  // zero padding, once: k in [d, ldk) of every A row adds fmaf(0, 0, acc),
  // which is acc; B's rows k >= d and columns j >= d are zero
  for (int i = tid; i < ldk * LDB; i += threads) b_s[i] = 0.f;
  if (ldk > d) {
    const int pad = ldk - d;
    for (int i = tid; i < STAGES * TM * pad; i += threads)
      c_s[(i / pad) * lda + d + i % pad] = 0.f;
  }
  if (SELECT) {  // the first tile's cuts, synchronously
    int s;
    long long r0;
    int rows;
    tile(t_begin, s, r0, rows);
    if (tid < rows) m_s[tid] = m[r0 + tid];
  }
  __syncthreads();
  // cp.async groups, oldest first: [rank t_begin], then per stage
  // [c t, cuts t+1]; each iteration adds [rank t+1] and [c t+STAGES-1,
  // cuts t+STAGES], so waiting for all but the newest STAGES-2 groups
  // covers c, rank and cuts of the tile at hand
  if (SELECT) {
    issue_rank(t_begin);
    cp_async_commit();
  }
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (t_begin + st < t_end) issue_c(t_begin + st, st);
    if (SELECT && t_begin + st + 1 < t_end)
      issue_m(t_begin + st + 1, (st + 1) % STAGES);
    cp_async_commit();
  }

  int cur_s = -1;
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t landed
    if (SELECT) {
      mask_own(t, buf);
      // the rank chunks just read are refilled next: keep the compiler
      // from moving those reads past the copies
      asm volatile("" ::: "memory");
      if (t + 1 < t_end) issue_rank(t + 1);
      cp_async_commit();
    }
    __syncthreads();  // tile t whole and masked; tile t-1 done with
    if (t + STAGES - 1 < t_end) issue_c(t + STAGES - 1, (buf + STAGES - 1) % STAGES);
    if (SELECT && t + STAGES < t_end) issue_m(t + STAGES, buf);
    cp_async_commit();

    int s;
    long long r0;
    int rows;
    tile(t, s, r0, rows);
    const size_t g0 = (size_t)r0 * d;
    if (s != cur_s) {  // the range crossed into a new species
      const float* u = basis + (size_t)s * d * d;
#pragma unroll 4
      for (int e = tid; e < d * d; e += threads) {
        const int j = e / d;
        b_s[(e - j * d) * LDB + j] = u[e];  // B[k][j] = U[j][k]
      }
      __syncthreads();
      cur_s = s;
    }

    // x of this thread's elements, in flight while the FFMAs run
    float xv[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = ry + r * RING_NRY;
      const float* xp = x + g0 + (size_t)row * d + col;
      if (vec) {
        if (row < rows && col < d) ld4(xp, xv[r]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xv[r][e] = (row < rows && col + e < d) ? xp[e] : 0.f;
      }
    }

    float acc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    const float* ap = c_s + buf * TM * lda + ry * lda;
    const float* bp = b_s + col;
    // unrolled 5 times (20 k at D = 80) for correct, twice for select,
    // whose mask and rank pointers leave fewer registers: what measured
    // fastest without spilling
#pragma unroll(MODE == MODE_SELECT ? 2 : 5)
    for (int k0 = 0; k0 < ldk; k0 += 4) {
      float a[RM][4];
#pragma unroll
      for (int r = 0; r < RM; ++r) ld4(ap + r * RING_NRY * lda + k0, a[r]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[4];
        ld4(bp + (k0 + kk) * LDB, b);
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(a[r][kk], b[e], acc[r][e]);
      }
    }

#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = ry + r * RING_NRY;
      if (row >= rows) continue;
      float* op = out + g0 + (size_t)row * d + col;
      if (vec) {
        if (col < d)
          *reinterpret_cast<float4*>(op) =
              make_float4(xv[r][0] + acc[r][0], xv[r][1] + acc[r][1],
                          xv[r][2] + acc[r][2], xv[r][3] + acc[r][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) op[e] = xv[r][e] + acc[r][e];
      }
    }
  }
  cp_async_wait<0>();
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---- every mode past D = 128: k panels through a cp.async ring ---------------

constexpr int WIDE_TILE = 128;   // rows and columns of a tile
constexpr int WIDE_KP = 16;      // k a panel
constexpr int WIDE_STAGES = 3;   // panels in the ring

template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src) {
  if constexpr (BYTES == 16) cp_async16(dst, src);
  else if constexpr (BYTES == 8) cp_async8(dst, src);
  else cp_async4(dst, src);
}

// KU consecutive values to a 16-byte aligned address
template <typename T>
__device__ __forceinline__ void store_ku(T* p, const T (&v)[KU]) {
  constexpr int N = Pack<T>::N;
#pragma unroll
  for (int q = 0; q < KU / N; ++q) {
    Pack<T> t;
#pragma unroll
    for (int c = 0; c < N; ++c) t.v[c] = v[q * N + c];
    reinterpret_cast<Pack<T>*>(p)[q] = t;
  }
}

// A 128 x 128 tile of out. Warp w owns rows 32 (w % 4) .. +31 and columns
// 64 (w / 4) .. +63; lane (ry, cx) = (lane / 8, lane % 8) owns rows 4 ry +
// r + 16 h and columns 4 cx + e + 32 h (r, e < 4; h < 2) of them. A CTA
// walks its tiles as one stream of k panels (KP k each). The cp.async ring
// lands a step's A[rows, k0 : k0 + KP] (c, or the residual R of the
// projection; select: and rank; masked: and the mask) and the matching
// piece of the basis as they lie in device memory: U[j0 : j0 + 128, k0 :
// k0 + KP] for the U^T product, U[k0 : k0 + KP, j0 : j0 + 128] for the
// projection's R U. The A rows' 16-byte chunks are XOR-swizzled so the
// chunks a warp reads at once fall on distinct banks; the thread that
// copied a chunk then writes it (select: masked; masked: times the mask)
// into a double buffer laid out [k][row] and [k][j], so each k is two
// 16-byte loads of A and two of B (fp64: four and four) for 64 FMAs.
template <typename T, int MODE, int MINB>
__global__ void __launch_bounds__(WIDE_THREADS, MINB)
gbatc_wide(const T* __restrict__ x,         // x_rec; none in the projection
           const T* __restrict__ c,         // coefficients, or the residual
           const int* __restrict__ rank,    // select only, (S, NB, D)
           const int* __restrict__ m,       // select only, (S, NB)
           const T* __restrict__ mk,        // masked only, (S, NB, D)
           const T* __restrict__ basis, T* __restrict__ out, int s_count,
           long long nb, int d, int vec) {
  constexpr int TT = WIDE_TILE, KP = WIDE_KP, STAGES = WIDE_STAGES;
  constexpr int E = Pack<T>::N;  // values a 16-byte chunk
  constexpr int CH = KP / E;     // chunks a panel row
  constexpr int RPL = CH < 8 ? 8 / CH : 1;  // panel rows a 128-byte line of banks
  constexpr bool SELECT = MODE == MODE_SELECT, MASKED = MODE == MODE_MASKED;
  constexpr bool PROJECT = MODE == MODE_PROJECT;
  constexpr int LAND = TT * KP;  // values of one operand a step
  // bytes a ring buffer: [A | B | rank or mask]
  constexpr int STAGE_BYTES =
      LAND * (2 * (int)sizeof(T) + (SELECT ? 4 : MASKED ? (int)sizeof(T) : 0));
  // transposed rows padded to 132 values: the two chunks a warp stores at
  // once, k rows apart, fall on distinct banks
  constexpr int LDT = TT + 4;
  constexpr int TBUF = 2 * KP * LDT;  // [A^T | B^T]
  // the cuts of tile t + 1 ride with the last panel of tile t into one of
  // two slots: safe while a tile has at least STAGES panels (9 at D > 128)
  static_assert(KP == 16 && STAGES >= 2 && STAGES <= 9, "panel shape");
  static_assert(TT * CH % WIDE_THREADS == 0 && STAGE_BYTES % 16 == 0, "chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tr = reinterpret_cast<T*>(smem_raw + STAGES * STAGE_BYTES);  // 2 steps
  int* m_s = reinterpret_cast<int*>(tr + 2 * TBUF);  // select: (2, TT) cuts

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's rows row_t + r + 16 h and columns col_t + e + 32 h
  const int row_t = (warp & 3) * 32 + (lane >> 3) * 4;
  const int col_t = (warp >> 2) * 64 + (lane & 7) * 4;
  const int ldk = (d + E - 1) / E * E;  // k padded with zero terms
  const int panels = (ldk + KP - 1) / KP;
  const int nt = (d + TT - 1) / TT;  // column tiles
  // tile and step indices fit an int (the launcher checks tiles x panels)
  const int tps = (int)((nb + TT - 1) / TT) * nt;  // tiles a species
  const int total = tps * s_count;
  const int t_begin = (int)((long long)total * blockIdx.x / gridDim.x);
  const int t_end = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);
  const int steps = (t_end - t_begin) * panels;

  // species-major, then row tile, then column tile: a row tile's column
  // tiles follow each other, so its A panels are read again from L2
  auto tile = [&](int t) {
    WideTile w;
    w.s = t / tps;
    const int rt = (t - w.s * tps) / nt;
    w.j0 = (t - w.s * tps - rt * nt) * TT;
    const long long row0 = (long long)rt * TT;
    w.r0 = w.s * nb + row0;
    w.rows = (int)min((long long)TT, nb - row0);
    return w;
  };
  auto stage = [&](int v, T*& a_l, T*& b_l, int*& r_l, T*& m_l) {
    unsigned char* base = smem_raw + (v % STAGES) * STAGE_BYTES;
    a_l = reinterpret_cast<T*>(base);
    b_l = a_l + LAND;
    r_l = reinterpret_cast<int*>(b_l + LAND);
    m_l = reinterpret_cast<T*>(b_l + LAND);
  };
  // landed offset of chunk ch of A panel row `row` (and of U^T's row j)
  auto land = [](int row, int ch) {
    return row * KP + (ch ^ (row / RPL % CH)) * E;
  };
  // A thread copies, and later transposes, the chunks (row, ch) of the A
  // operands and U given by chunk(tid + 256 n): a warp's are 16 rows by two
  // neighbouring chunks, whole 32-byte sectors. The projection's U panel
  // (KP rows of 128 columns) is walked as (k, jc) = (i / (TT / E), i % (TT
  // / E)) and lands unswizzled. Where D % E != 0 or an operand is not
  // 16-byte aligned, the walk is over values (row, k) = (i % TT, i / TT).
  auto chunk = [](int i, int& row, int& ch) {
    row = (i >> 5 & 7) * 16 + (i & 15);
    ch = (i >> 8) * 2 + (i >> 4 & 1);
  };

  // The copies run STAGES - 1 steps ahead: step iv, panel ip of tile it
  // (iw), lands in ring buffer iv % STAGES.
  int it = t_begin, ip = 0, iv = 0;
  WideTile iw = tile(t_begin);
  auto issue = [&]() {
    const int k0 = ip * KP;
    const int kv = min(KP, d - k0);     // k of D in this panel
    const int jn = min(TT, d - iw.j0);  // columns of D in this tile
    T *a_l, *b_l, *m_l;
    int* r_l;
    stage(iv, a_l, b_l, r_l, m_l);
    const size_t ga = (size_t)iw.r0 * d + k0;
    const T* ub = PROJECT ? basis + ((size_t)iw.s * d + k0) * d + iw.j0
                          : basis + ((size_t)iw.s * d + iw.j0) * d + k0;
    if (vec) {
      for (int i = tid; i < TT * CH; i += WIDE_THREADS) {
        int row, ch;
        chunk(i, row, ch);
        if (ch * E < kv) {
          const int o = land(row, ch);
          const size_t g = ga + (size_t)row * d + ch * E;
          if (row < iw.rows) {
            cp_async16(a_l + o, c + g);
            if (SELECT) cp_async_n<4 * E>(r_l + o, rank + g);
            if (MASKED) cp_async16(m_l + o, mk + g);
          }
          if (!PROJECT && row < jn) cp_async16(b_l + o, ub + (size_t)row * d + ch * E);
        }
        if (PROJECT) {
          const int k = i / (TT / E), jc = i % (TT / E) * E;
          if (k < kv && jc < jn) cp_async16(b_l + k * TT + jc, ub + (size_t)k * d + jc);
        }
      }
    } else {
      for (int i = tid; i < TT * KP; i += WIDE_THREADS) {
        const int row = i % TT, k = i / TT;
        if (k >= kv) continue;
        const int o = land(row, k / E) + k % E;
        const size_t g = ga + (size_t)row * d + k;
        if (row < iw.rows) {
          cp_async_n<(int)sizeof(T)>(a_l + o, c + g);
          if (SELECT) cp_async4(r_l + o, rank + g);
          if (MASKED) cp_async_n<(int)sizeof(T)>(m_l + o, mk + g);
        }
        if (row < jn) {
          if (PROJECT) cp_async_n<(int)sizeof(T)>(b_l + k * TT + row, ub + (size_t)k * d + row);
          else cp_async_n<(int)sizeof(T)>(b_l + o, ub + (size_t)row * d + k);
        }
      }
    }
    ++iv;
    if (++ip < panels) return;
    ip = 0;
    if (++it < t_end) {
      iw = tile(it);
      if (SELECT && tid < iw.rows)  // its cuts ride with this tile's last panel
        cp_async4(m_s + (it - t_begin) % 2 * TT + tid, m + iw.r0 + tid);
    }
  };

  // The FMAs' step v: panel p of tile t (w). Step v's own chunks, landed,
  // go into transposed buffer v % 2 (select: c = +0 where rank >= m;
  // masked: c times the mask); k in [D, ldk) are +0 terms in A and in B.
  WideTile w = iw;
  auto transpose = [&](int v, int p, int t) {
    const int k0 = p * KP;
    const int kv = min(KP, d - k0), kn = min(KP, ldk - k0);
    const int jn = min(TT, d - w.j0);
    T *a_l, *b_l, *m_l;
    int* r_l;
    stage(v, a_l, b_l, r_l, m_l);
    T* at = tr + (v % 2) * TBUF;
    T* bt = at + KP * LDT;
    const int* ms = m_s + (t - t_begin) % 2 * TT;
    if (vec) {  // kv == kn
      for (int i = tid; i < TT * CH; i += WIDE_THREADS) {
        int row, ch;
        chunk(i, row, ch);
        if (ch * E < kv) {
          const int o = land(row, ch);
          if (row < w.rows) {
            Pack<T> val = *reinterpret_cast<const Pack<T>*>(a_l + o);
            if (SELECT) {
              const IntPack<E> rk = *reinterpret_cast<const IntPack<E>*>(r_l + o);
              const int cut = ms[row];
#pragma unroll
              for (int e = 0; e < E; ++e)
                if (!(rk.v[e] < cut)) val.v[e] = T(0);
            }
            if (MASKED) {
              const Pack<T> mv = *reinterpret_cast<const Pack<T>*>(m_l + o);
#pragma unroll
              for (int e = 0; e < E; ++e) val.v[e] = val.v[e] * mv.v[e];
            }
#pragma unroll
            for (int e = 0; e < E; ++e) at[(ch * E + e) * LDT + row] = val.v[e];
          }
          if (!PROJECT && row < jn) {
            const Pack<T> val = *reinterpret_cast<const Pack<T>*>(b_l + o);
#pragma unroll
            for (int e = 0; e < E; ++e) bt[(ch * E + e) * LDT + row] = val.v[e];
          }
        }
        if (PROJECT) {  // U[k][j] as it lies: a copy, not a transpose
          const int k = i / (TT / E), jc = i % (TT / E) * E;
          if (k < kv && jc < jn)
            *reinterpret_cast<Pack<T>*>(bt + k * LDT + jc) =
                *reinterpret_cast<const Pack<T>*>(b_l + k * TT + jc);
        }
      }
    } else {
      for (int i = tid; i < TT * KP; i += WIDE_THREADS) {
        const int row = i % TT, k = i / TT;
        if (k >= kn) continue;
        const int o = land(row, k / E) + k % E;
        if (row < w.rows) {
          T val = T(0);
          if (k < kv && (!SELECT || r_l[o] < ms[row])) val = a_l[o];
          if (MASKED && k < kv) val = val * m_l[o];
          at[k * LDT + row] = val;
        }
        if (row < jn)
          bt[k * LDT + row] = k >= kv ? T(0) : PROJECT ? b_l[k * TT + row] : b_l[o];
      }
    }
  };

  if (SELECT && t_begin < t_end && tid < iw.rows)  // the first cuts, now
    m_s[tid] = m[iw.r0 + tid];
  __syncthreads();
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) issue();
    cp_async_commit();
  }

  T acc[8][8];  // [row r + 4 h][column e + 4 h]
  for (int v = 0, t = t_begin, p = 0; v < steps; ++v) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step v landed
    transpose(v, p, t);
    __syncthreads();  // step v transposed; step v-1 done with
    if (v + STAGES - 1 < steps) issue();
    cp_async_commit();

    if (p == 0) {  // a new tile: acc = +0
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = T(0);
    }

    const T* at = tr + (v % 2) * TBUF + row_t;
    const T* bt = tr + (v % 2) * TBUF + KP * LDT + col_t;
    auto kstep = [&](int k) {  // acc += A[:, k] B[k, :], k ascending
      T a[2][KU], b[2][KU];
      load_ku(at + k * LDT, a[0]);
      load_ku(at + k * LDT + 16, a[1]);
      load_ku(bt + k * LDT, b[0]);
      load_ku(bt + k * LDT + 32, b[1]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[i][e] = fma_t(a[i >> 2][i & 3], b[e >> 2][e & 3], acc[i][e]);
    };
    const int kn = min(KP, ldk - p * KP);
    if (kn == KP) {
#pragma unroll 1
      for (int k = 0; k < KP; ++k) kstep(k);
    } else {
#pragma unroll 4
      for (int k = 0; k < kn; ++k) kstep(k);
    }
    if (++p < panels) continue;
    p = 0;

#pragma unroll
    for (int i = 0; i < 8; ++i) {  // out = x + acc (the projection: acc)
      const int row = row_t + (i & 3) + 16 * (i >> 2);
      if (row >= w.rows) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = w.j0 + col_t + 32 * h;
        const size_t o = (size_t)(w.r0 + row) * d + col;
        const T* aa = acc[i] + 4 * h;
        if (vec && col + KU <= d) {
          T y[KU];
          if (PROJECT) {
#pragma unroll
            for (int e = 0; e < KU; ++e) y[e] = aa[e];
          } else {
            load_ku(x + o, y);
#pragma unroll
            for (int e = 0; e < KU; ++e) y[e] = y[e] + aa[e];
          }
          store_ku(out + o, y);
        } else {
#pragma unroll
          for (int e = 0; e < KU; ++e)
            if (col + e < d) out[o + e] = PROJECT ? aa[e] : x[o + e] + aa[e];
        }
      }
    }
    if (++t < t_end) w = tile(t);
  }
  cp_async_wait<0>();
}


template <int MODE, int NCH, int MINB>
int launch_ring(const float* x, const float* c, const int* rank, const int* m,
                const float* u, float* out, int s, long long nb, int d,
                void* stream) {
  const int threads = 64 * ((d + 15) / 16);
  const int ldk = (d + KU - 1) / KU * KU, lda = ring_lda(d);
  size_t words = (size_t)ldk * 16 * NCH + (size_t)RING_STAGES * RING_TM * lda;
  if (MODE == MODE_SELECT) words += (size_t)RING_TM * lda + RING_STAGES * RING_TM;
  const size_t smem = words * sizeof(float);
  const long long tiles = (long long)s * ((nb + RING_TM - 1) / RING_TM);
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = correct_f32_ring<MODE, NCH, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long slots = (long long)sms * per_sm;
  const long long grid = tiles < slots ? tiles : slots;
  const int vec = d % 4 == 0 && aligned16(x) && aligned16(c) &&
                  aligned16(rank) && aligned16(out);
  kernel<<<(unsigned)grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, c, rank, m, u, out, s, nb, d, lda, vec);
  return (int)cudaGetLastError();
}

// every mode past D = 128, either dtype; x is null in the projection
template <typename T, int MODE>
int launch_wide(const T* x, const T* c, const int* rank, const int* m,
                const T* mk, const T* u, T* out, int s, long long nb, int d,
                void* stream) {
  constexpr int TT = WIDE_TILE, KP = WIDE_KP, E = 16 / (int)sizeof(T);
  constexpr int MINB = sizeof(T) == 4 ? 2 : 1;  // CTAs an SM
  const size_t third = MODE == MODE_SELECT ? 4 : MODE == MODE_MASKED ? sizeof(T) : 0;
  const size_t smem = (size_t)WIDE_STAGES * TT * KP * (2 * sizeof(T) + third) +
                      (size_t)4 * KP * (TT + 4) * sizeof(T) +
                      (MODE == MODE_SELECT ? 2 * TT * sizeof(int) : 0);
  const long long tiles =
      (long long)s * ((nb + TT - 1) / TT) * ((d + TT - 1) / TT);
  const int panels = ((d + E - 1) / E * E + KP - 1) / KP;
  if (tiles * panels > INT32_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = gbatc_wide<T, MODE, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      WIDE_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long slots = (long long)sms * per_sm;
  const long long grid = tiles < slots ? tiles : slots;
  const int vec = d % E == 0 && aligned16(x) && aligned16(c) && aligned16(rank) &&
                  aligned16(mk) && aligned16(u) && aligned16(out);
  kernel<<<(unsigned)grid, WIDE_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(x, c, rank, m, mk, u, out, s,
                                                nb, d, vec);
  return (int)cudaGetLastError();
}

// two CTAs an SM at D <= 80, one at D <= 128, the wide kernel past it
template <int MODE>
int launch_correct_f32(const float* x, const float* c, const int* rank,
                       const int* m, const float* u, float* out, int s,
                       long long nb, int d, int tiles_per_cta, void* stream) {
  if (d < 1 || s < 0 || nb < 0 || tiles_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  if (s == 0 || nb == 0) return (int)cudaSuccess;
  if (d <= 80)
    return launch_ring<MODE, 5, 2>(x, c, rank, m, u, out, s, nb, d, stream);
  if (d <= MAX_D)
    return launch_ring<MODE, 8, 1>(x, c, rank, m, u, out, s, nb, d, stream);
  return launch_wide<float, MODE>(x, c, rank, m, nullptr, u, out, s, nb, d,
                                  stream);
}

template <int NFW, int TM, int STAGES>
int launch_dmma(const double* r, const double* u, double* c, int s,
                long long nb, int d, void* stream) {
  constexpr int threads = TM / 16 * 64;
  const int ld = dmma_ld(d);
  const size_t smem =
      ((size_t)((d + 7) / 8) * ((d + 7) / 8) * 64 + (size_t)STAGES * TM * ld) *
      sizeof(double);
  auto kernel = project_f64_dmma<NFW, TM, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)s * ((nb + TM - 1) / TM);
  const long long slots = (long long)sms * per_sm;
  const long long grid = tiles < slots ? tiles : slots;
  const int vec = d % 2 == 0 && aligned16(r) && aligned16(c);
  kernel<<<(unsigned)grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, u, c, s, nb, d, ld, vec);
  return (int)cudaGetLastError();
}

int launch_dmma_wide(const double* r, const double* u, double* c, int s,
                     long long nb, int d, void* stream) {
  constexpr int KP = WIDE_KP64;
  const size_t smem = (size_t)WIDE_STAGES64 *
                      (64 * (KP + 4) + KP * (WIDE_SLAB64 + 8)) * sizeof(double);
  const long long tiles = (long long)s * ((nb + 63) / 64) *
                          ((d + WIDE_SLAB64 - 1) / WIDE_SLAB64);
  const int panels = ((d + 7) / 8 + KP / 8 - 1) / (KP / 8);
  if (tiles * panels > INT32_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = project_f64_wide;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      WIDE_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long slots = (long long)sms * per_sm;
  const long long grid = tiles < slots ? tiles : slots;
  const int vec = d % 2 == 0 && aligned16(r) && aligned16(u) && aligned16(c);
  kernel<<<(unsigned)grid, WIDE_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(r, u, c, s, nb, d, vec);
  return (int)cudaGetLastError();
}

int launch_project_f64(const double* r, const double* u, double* c, int s,
                       long long nb, int d, int tiles_per_cta, void* stream) {
  if (d < 1 || s < 0 || nb < 0 || tiles_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  if (s == 0 || nb == 0) return (int)cudaSuccess;
  if (d <= 80) return launch_dmma<5, 64, 3>(r, u, c, s, nb, d, stream);
  if (d <= MAX_D) return launch_dmma<8, 32, 3>(r, u, c, s, nb, d, stream);
  return launch_dmma_wide(r, u, c, s, nb, d, stream);
}

template <int NFW, int TM, int STAGES>
int launch_3xtf32(const float* r, const float* u, float* c, int s, long long nb,
                  int d, void* stream) {
  constexpr int threads = TM / 16 * 64;
  const int ld = tf32_ld(d);
  const size_t smem = (size_t)((d + 15) / 16) * ((d + 7) / 8) * 64 * 16 +
                      (size_t)STAGES * TM * ld * sizeof(float) +
                      STAGES * sizeof(uint64_t);
  auto kernel = project_f32_3xtf32<NFW, TM, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)s * ((nb + TM - 1) / TM);
  const long long slots = (long long)sms * per_sm;
  const long long grid = tiles < slots ? tiles : slots;
  int vec = d % 4 == 0 && aligned16(r) && aligned16(c);
  if (vec && ld == d) vec = 2;  // tiles are contiguous in shared memory too
  kernel<<<(unsigned)grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      r, u, c, s, nb, d, ld, vec);
  return (int)cudaGetLastError();
}

int launch_project_f32(const float* r, const float* u, float* c, int s,
                       long long nb, int d, int tiles_per_cta, void* stream) {
  if (d < 1 || s < 0 || nb < 0 || tiles_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  if (s == 0 || nb == 0) return (int)cudaSuccess;
  if (d <= 80) return launch_3xtf32<5, 64, 2>(r, u, c, s, nb, d, stream);
  if (d <= MAX_D) return launch_3xtf32<8, 32, 3>(r, u, c, s, nb, d, stream);
  return launch_wide<float, MODE_PROJECT>(nullptr, r, nullptr, nullptr, nullptr,
                                          u, c, s, nb, d, stream);
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
  dim3 grid((unsigned)grid_x, (unsigned)(s < 65535 ? s : 65535));
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      a, basis, x, rank, m, mk, out, s, nb, d, tiles_per_cta, vec_ok);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch(const T* a, const T* basis, const T* x, const int* rank,
           const int* m, const T* mk, T* out, int s, long long nb, int d,
           int tiles_per_cta, void* stream) {
  if (d < 1 || s < 0 || nb < 0 || tiles_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  if (s == 0 || nb == 0) return (int)cudaSuccess;
  if (d > MAX_D)
    return launch_wide<T, MODE>(x, a, rank, m, mk, basis, out, s, nb, d, stream);
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
  // persistent 3xTF32 kernel, as the fp64 projection: tiles_per_cta is only
  // checked
  return launch_project_f32(r, u, c, s, nb, d, tiles_per_cta, stream);
}
int gbatc_project_batched_f64(const double* r, const double* u, double* c,
                              int s, long long nb, int d, int tiles_per_cta,
                              void* stream) {
  // persistent DMMA kernel: it sizes its own grid; tiles_per_cta is only
  // checked, as for the other modes
  return launch_project_f64(r, u, c, s, nb, d, tiles_per_cta, stream);
}
int gbatc_correct_batched_f32(const float* x, const float* c, const float* u,
                              float* out, int s, long long nb, int d,
                              int tiles_per_cta, void* stream) {
  // persistent ring kernel, as select: tiles_per_cta is only checked
  return launch_correct_f32<MODE_CORRECT>(x, c, nullptr, nullptr, u, out, s,
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
  return launch_correct_f32<MODE_SELECT>(x, c, rank, m, u, out, s, nb, d,
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
