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
// into the coefficients once they are staged, where the select mode forms
// rank < m). What is kept from them is the
// function; their 128-lane padding, padded rows in device memory and the
// INT32_MAX rank sentinel are not: D is a runtime argument and ragged row
// tiles are masked here.
//
// Eight kernels serve these modes: four up to D = 128 (project_f64_dmma,
// project_f32_3xtf32, correct_f32_ring for every fp32 correct, select and
// masked route, gbatc_tile_kernel for the fp64 ones), and past it four that
// stage the basis in k panels ("Wide blocks" below), the fp64 projection's
// two (project_f64_wide_tma, project_f64_wide) and every other route's two
// (gbatc_wide_3xtf32, gbatc_wide_dmma), all of them on the tensor cores.
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
// fp32 correct, select and the masked mode (correct_f32_ring; they replace
// the Pallas gbatc_correct_batched, src/repro/kernels/gbatc_project.py:240,
// gbatc_select_accumulate, :288, and the 2D gbatc_correct, :140): at the
// main path's (58, 20480, 80) select reads x, c and rank and writes out
// (1.52 GB, 0.455 ms at 3.35 TB/s), correct reads x and c (1.14 GB, 0.341
// ms); either does 7.6 G FFMA, 0.227 ms on the CUDA cores at 67 TFLOP/s.
// The masked 2D correct at (1187840, 80) moves select's bytes (x, c, the
// mask, out: 0.454 ms). What bounds them on this card is the
// FFMAs as much as the bytes: the compiler's outer-product FFMAs issue well
// below the FFMA peak (each reads two fresh registers), so the FMA loop
// alone takes about as long as correct's byte stream, and the design's aim
// is to keep both going at once. Design:
//
// * The three modes keep one order of arithmetic, the tile kernel's before
//   them: acc = +0, acc = fmaf(c'_k, U[j][k], acc) for k ascending (k
//   padded with zeros to a multiple of 4), out = x + acc, where c'_k is
//   +0 in select when rank >= m and c_k * mask_k (one fp32 multiply) in the
//   masked mode. Select on (c, rank, m) is therefore bitwise correct on
//   where(rank < m, c, 0): the encode side's reconstruction and the decode
//   side's replay agree bit for bit; the masked mode gives the tile
//   kernel's bits (OLD_DOMAIN_SHA256 in chip_smoke.py pins them). No
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
//   landed a tile earlier; the masked mode copies its mask alike and
//   multiplies them by it. A thread reads only its own rank or mask
//   chunks, so it refills them for the next tile right after masking, and
//   one barrier a tile serves every mode. Neither mask nor masked
//   coefficients reach device memory. The masked mode on the tile kernel
//   (a run of 64-row tiles a CTA, each staged once, no ring) took 0.90-0.95
//   ms at (1187840, 80); on this ring 0.66 (tools/gbatc_wide_timing.py).
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
//   of shared memory for select and the masked mode, 67 KB for correct),
//   one at D <= 128 (164 KB for select and the masked mode).
//
// The fp64 correct, select and masked modes up to D = 128
// (gbatc_tile_kernel; no fp32 route runs it): at the main path's (58,
// 20480, 80) correct reads x and c and writes out in fp64 (2.28 GB, 0.68
// ms at 3.35 TB/s) and does 7.6 G DFMA (0.45 ms at the CUDA cores' 33.5
// TFLOP/s), so bytes bound it; it takes 2.3 ms, select 1.4
// (tools/gbatc_wide_timing.py; no path launches them: the engine selects
// and replays in fp32). Design:
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
// Wide blocks, D > 128 (project_f64_wide_tma, project_f64_wide,
// gbatc_wide_3xtf32, gbatc_wide_dmma): every mode takes any D, as the Pallas
// wrappers do by padding. The weight checkpoint's blocks are 256 long
// (train/checkpoint.py) and a codec's 8 x 8 x 8 block is 512. A species'
// basis is 512 KB in fp64 and 256 KB in fp32 at D = 256, more than the 227
// KB of shared memory a CTA may hold, so the kernels stage it in k panels
// beside the matching panel of the row tile, one ring of panels a CTA that
// runs on across its tiles.
// At a codec's (58, 1600, 512) every mode does 2 x 58 x 1600 x 512^2 = 48.7
// GFLOP against 0.13-0.26 ms of bytes: the operations bound all of them,
// at 0.73 ms on the fp64 tensor cores (67 TFLOP/s), 0.29 ms for fp32 as
// 3xTF32 (495 / 3 TFLOP/s) and 0.73 ms on the CUDA cores' FFMAs (67). Select
// needs products only for the kept terms, about half of them at uniform
// cuts. Design:
//
// * project_f64_wide_tma (the fp64 projection with D even and R, U and C
//   16-byte aligned): 128-row tiles against slabs of up to 128 columns,
//   panels landed by TMA copies that one thread issues; notes above it.
// * project_f64_wide (the fp64 projection at odd D or an unaligned
//   operand, which TMA cannot copy): DMMA m16n8k8 in fp64 as
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
//   row tile's slabs follow each other, each looping k over all of D. It
//   took 1.44-1.49 ms at (58, 1600, 512), its copies alone 1.03-1.05 and its
//   DMMAs alone 0.98-1.00: all 8 warps issue the copies, and a 2-panel ring
//   leaves one panel in flight behind the MMAs.
// * gbatc_wide_3xtf32<MODE> (every fp32 route: project, correct, select and
//   the masked mode) and gbatc_wide_dmma<MODE> (fp64 correct, select and the
//   masked mode): 128-row tiles against slabs of up to 128 columns, a
//   persistent grid whose CTAs take the tiles in turn, and in each CTA a
//   producer warpgroup that copies k panels through a cp.async ring, masks
//   them (select, masked) and puts them where the MMAs read them (fp32:
//   split into tf32 hi and lo planes in fragment order; fp64: rows
//   interleaved in pairs), ahead of 8 MMA warps, the two sides handing each
//   panel over through mbarriers. Every fragment is a 16-byte load a lane
//   that needs no register move. Notes above each kernel give its layout,
//   its order of arithmetic and what bounds it.
// * The order of arithmetic is fixed, so no bit depends on the tiling:
//   both fp64 projections and gbatc_wide_dmma run each fragment's m16n8k8
//   steps ascending from +0, no step past ceil(D / 8), +0 in A and B past D;
//   gbatc_wide_3xtf32 adds each k pair's three TF32 products into a partial
//   from +0 and the partial into the accumulator; out = x + acc (the
//   projection: acc). c' = +0 where rank >= m, c' = c * mask in the masked
//   mode; select on (c, rank, m) stays bitwise correct on where(rank < m,
//   c, 0) in both dtypes. A panel or a slab only changes which thread
//   computes an element and when its operands arrive; no split-k, no
//   fast-math, no single-pass TF32. The kernels phase of chip_smoke.py holds
//   their outputs' sha256 at every WIDE shape to pinned values (WIDE_SHA256)
//   and every route's at every ANY_D shape (ANY_D_SHA256).
//
// fp64 at D = 80 needs 51.2 KB for the basis alone, above the 48 KB static
// limit: all shared memory is dynamic and every launcher raises the
// function's limit first. Launchers return the cudaError_t of the launch.

#include <cuda.h>  // CUtensorMap (no -lcuda: the encoder comes from the runtime)
#include <cudaTypedefs.h>
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
// an mbarrier whose phase completes after `count` arrivals
__device__ __forceinline__ void mbar_init_count(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}
// this thread's arrival (release: its shared-memory writes before it are
// seen by a thread that waits for the phase)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// mbar_wait for a phase that other warps of the CTA complete: a wait past
// 2^32 cycles (over 2 s) means an arrival was lost, and the kernel traps
// with an error rather than hang the card
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
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

// c = a . b over one m16n8k8 step from +0 (no accumulator read)
__device__ __forceinline__ void mma_tf32_zero(float (&c)[4], const uint4& a,
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "f"(0.f));
}

// c += a . b on an A fragment held as one 16-byte load
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
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
                 const float* __restrict__ mk,  // masked only, (S, NB, D)
                 const float* __restrict__ basis, float* __restrict__ out,
                 int s_count, long long nb, int d, int lda, int vec) {
  constexpr int RM = RING_RM, TM = RING_TM, LDB = 16 * NCH;
  constexpr int STAGES = RING_STAGES;
  constexpr bool SELECT = MODE == MODE_SELECT, MASKED = MODE == MODE_MASKED;
  constexpr bool AUX = SELECT || MASKED;  // a second tile: rank or the mask
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int threads = blockDim.x;
  const int ldk = (d + KU - 1) / KU * KU;  // k padded with zero terms
  float* b_s = reinterpret_cast<float*>(smem_raw);  // (ldk, LDB): U^T
  float* c_s = b_s + ldk * LDB;                      // (STAGES, TM, lda)
  // select: one rank tile (TM, lda), then the cuts (STAGES, TM); masked:
  // one mask tile (TM, lda)
  int* r_s = reinterpret_cast<int*>(c_s + STAGES * TM * lda);
  float* mk_s = reinterpret_cast<float*>(r_s);
  int* m_s = r_s + (AUX ? TM * lda : 0);

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
  // select, masked: rank or the mask of tile t into the one such tile. A
  // thread reads there only the chunks it copied itself, so it may refill
  // them for the next tile as soon as it has masked them, with no barrier
  // between
  auto issue_aux = [&](int t) {
    int s;
    long long r0;
    int rows;
    tile(t, s, r0, rows);
    if (SELECT) {
      const int* src = rank + (size_t)r0 * d;
      own_chunks(rows, [&](int, int off, size_t g) { copy(r_s + off, src + g); });
    } else {
      const float* src = mk + (size_t)r0 * d;
      own_chunks(rows, [&](int, int off, size_t g) { copy(mk_s + off, src + g); });
    }
  };
  // select: the cuts of tile t into slot buf, one group ahead of its tile
  auto issue_m = [&](int t, int buf) {
    int s;
    long long r0;
    int rows;
    tile(t, s, r0, rows);
    if (tid < rows) cp_async4(m_s + buf * TM + tid, m + r0 + tid);
  };
  // select: c = +0 where rank >= m; masked: c = c * mask (one fp32
  // multiply, as the tile kernel had it); over the chunks this thread copied
  auto mask_own = [&](int t, int buf) {
    int s;
    long long r0;
    int rows;
    tile(t, s, r0, rows);
    float* cd = c_s + buf * TM * lda;
    const int* ms = m_s + buf * TM;
    own_chunks(rows, [&](int row, int off, size_t) {
      if (MASKED) {
        if (vec) {
          const float4 w = *reinterpret_cast<const float4*>(mk_s + off);
          float4 v = *reinterpret_cast<float4*>(cd + off);
          v.x = v.x * w.x, v.y = v.y * w.y, v.z = v.z * w.z, v.w = v.w * w.w;
          *reinterpret_cast<float4*>(cd + off) = v;
        } else {
          cd[off] = cd[off] * mk_s[off];
        }
        return;
      }
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
  // cp.async groups, oldest first: [rank or mask t_begin], then per stage
  // [c t, cuts t+1]; each iteration adds [rank or mask t+1] and [c
  // t+STAGES-1, cuts t+STAGES], so waiting for all but the newest STAGES-2
  // groups covers c, rank or mask and cuts of the tile at hand
  if (AUX) {
    issue_aux(t_begin);
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
    if (AUX) {
      mask_own(t, buf);
      // the rank or mask chunks just read are refilled next: keep the
      // compiler from moving those reads past the copies
      asm volatile("" ::: "memory");
      if (t + 1 < t_end) issue_aux(t + 1);
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
    // unrolled 5 times (20 k at D = 80) for correct and the masked mode,
    // twice for select, whose mask and rank pointers leave fewer
    // registers: what measured fastest without spilling (the masked mode
    // unrolled twice spilled 56 bytes at D <= 80 and took 0.73 ms at
    // (1187840, 80) against 0.66)
#pragma unroll(SELECT ? 2 : 5)
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

// ---- every route past D = 128 but the fp64 projection: k panels through a
// cp.async ring into the tensor cores -----------------------------------------

// Both kernels tile alike: a 128-row tile against a slab of up to 128 of a
// species' columns, one CTA an SM walking its tiles as one stream of k
// panels. A CTA is warp-specialised: a producer warpgroup (4 warps) copies
// each panel into a cp.async ring and gets it ready for the tensor cores,
// and 8 MMA warps of 32 rows by up to 64 columns (warp (wm, wn) owns rows
// 32 wm .. +31, two m16 fragments, and n8 fragments f0 .. f0 + nf_w - 1 of
// the slab) run the MMAs and the epilogue, the two sides handing panels
// over through mbarriers (full: ready; empty: MMAs done), so the copies
// and the producers' passes overlap the MMAs (one group of 8 warps doing
// both, at one CTA an SM, overlapped them little and measured 17-26 %
// slower; PERF.md, PR 31). 384 threads hold 168 registers each. The slabs of a row tile follow each other and share D
// evenly: ceil(D / 128) of them, each ceil(D / slabs) columns rounded up
// to 8, so no slab leaves warps idle (320 = 3 x 112, not 128 + 128 + 64).
// A 64 x 256 tile (the fp64 projection's) measured 3-10 % slower: it reads
// the same bytes in more, shorter rows.
constexpr int WT_TM = 128;    // rows a tile
constexpr int WT_SLAB = 128;  // most columns a tile
constexpr int WT_WM = WT_TM / 32;  // warps down a tile (32 rows each)
constexpr int WT_WN = WIDE_THREADS / 32 / WT_WM;  // and across it
static_assert(WT_WM * WT_WN * 32 == WIDE_THREADS && WT_SLAB <= WT_WN * 64, "warp grid");

// the slab width of D (a multiple of 8, at most WT_SLAB)
__host__ __device__ __forceinline__ int slab_width(int d) {
  const int nsl = (d + WT_SLAB - 1) / WT_SLAB;
  return ((d + nsl - 1) / nsl + 7) / 8 * 8;
}

// this warp's share of a slab jw columns wide: its first n fragment and how
// many it runs (at most 8; warp-uniform)
__device__ __forceinline__ void warp_frags(int jw, int wn, int& f0, int& nf_w) {
  const int nfs = (jw + 7) / 8, per = (nfs + WT_WN - 1) / WT_WN;
  f0 = wn * per;
  nf_w = max(0, min(per, nfs - f0));
}

// this CTA's i-th tile: tile blockIdx.x + i gridDim.x of the species-major,
// row-tile, slab order (tps tiles a species, nsl slabs sw columns wide a
// row tile). The CTAs take the tiles in turn, so at any time they work on
// neighbouring tiles of two or three species and read the same basis
// panels, which stay in L2 (a contiguous range a CTA would spread the CTAs
// over every species, and the bases then stream from device memory).
__device__ __forceinline__ WideTile wide_tile(int i, int tps, int nsl, int sw,
                                              long long nb) {
  const int t = (int)blockIdx.x + i * (int)gridDim.x;
  WideTile w;
  w.s = t / tps;
  const int rt = (t - w.s * tps) / nsl;
  w.j0 = (t - w.s * tps - rt * nsl) * sw;
  const long long row0 = (long long)rt * WT_TM;
  w.r0 = w.s * nb + row0;
  w.rows = (int)min((long long)WT_TM, nb - row0);
  return w;
}
// the tiles of this CTA among total
__device__ __forceinline__ int wide_tiles(int total) {
  return (total - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
}

// -- fp32: gbatc_wide_3xtf32 -----------------------------------------------
//
// A panel is one k pair (WT_KP = 16 k, two m16n8k8 steps). The producers
// land a step's A[rows, k0 : k0 + 16] (c, or the residual of the
// projection; select: and rank; masked: and the mask) and its piece of the
// basis as they lie in device memory; then the thread that copied a piece
// masks it (select: c = +0 where rank >= m; masked: c times the mask; +0
// past D and past the tile's rows and columns), splits each value into
// tf32 hi and lo (split_plane) and writes both into the step's hi / lo
// planes, double buffered, in fragment order, so every A and B fragment is
// one conflict-free 16-byte load a lane that lands in the registers the
// MMA reads (no register moves between load and MMA; assembling the A
// fragment from row loads cost about 8 moves an MMA):
//
// * A: thread (m fragment mf, lane (g, q)) copies rows g and g + 8 of the
//   fragment, k 4q .. 4q + 3, and writes {A[g][4q + 2s], A[g + 8][4q + 2s],
//   A[g][4q + 2s + 1], A[g + 8][4q + 2s + 1]} for steps s = 0, 1: step s
//   takes k = 4q + 2s for a fragment's column q and 4q + 2s + 1 for column
//   q + 4, a permutation of the k inside a pair, alike in A and B, as in
//   project_f32_3xtf32;
// * B (the correct modes): U[j0 : j0 + sw, k0 : k0 + 16], k-contiguous for
//   each column j as the .col fragment wants; the chunk U[j][4q .. + 3] is
//   lane (j % 8, q)'s {b0, b1} of step 0 and of step 1 at once;
// * B (the projection): U[k0 : k0 + 16, j0 : j0 + sw], transposed by the
//   split (raw rows padded to WT_LDU floats, chunks walked k-fastest, stores
//   ordered so that a warp's loads and stores fall on distinct banks).
//
// What bounds it: 3 x 2 x 58 x 1600 x 512^2 = 146 GFLOP of TF32 MMAs at
// (58, 1600, 512), 0.48 ms at the 302 TFLOP/s that mma.sync reaches on an
// H100 with 8 warps an SM (tools/mma_peak.py; 495 TFLOP/s is wgmma's); the
// MMA warps' fragment loads, 96 KB of shared memory a panel (768 cycles of
// the SM's 128 bytes a cycle, against the MMAs' 1,206 at that rate); and
// the producers' copies and split. With the
// other side taken out, the MMA warps take 0.97 ms (epilogue included) and
// the producers 0.88 of correct's 1.22 there (tools/gbatc_wide_timing.py
// --probes): each side alone is near the whole.
constexpr int WT_KP = 16;            // k a panel: one k pair
constexpr int WT_STAGES = 4;         // raw panels in the ring
constexpr int WT_PRODUCERS = 128;    // one warpgroup copies, masks and splits
constexpr int WT_THREADS = WIDE_THREADS + WT_PRODUCERS;  // 168 registers each
constexpr int WT_JG = 2;  // n fragments whose products a warp interleaves
constexpr int WT_LDU = WT_SLAB + 4;  // the projection's raw basis rows, floats
constexpr int WT_PLANE_A = WT_TM / 16 * 128;   // uint4: hi, lo of 4 m16 fragments
constexpr int WT_PLANE_B = WT_SLAB / 8 * 64;   // uint4: hi, lo of 32 n8 fragments
constexpr int WT_PLANES = WT_PLANE_A + WT_PLANE_B;

// floats of a ring stage: [A | rank or mask | U]
template <int MODE>
__host__ __device__ constexpr int wt_stage_words() {
  return WT_TM * WT_KP * (MODE == MODE_SELECT || MODE == MODE_MASKED ? 2 : 1) +
         (MODE == MODE_PROJECT ? WT_KP * WT_LDU : WT_SLAB * WT_KP);
}
template <int MODE>
constexpr size_t wt_smem_bytes() {
  return (size_t)WT_STAGES * wt_stage_words<MODE>() * sizeof(float) +
         2 * (size_t)WT_PLANES * sizeof(uint4) + 4 * sizeof(uint64_t);
}

// x = hi + lo: hi = cvt.rna.tf32(x), as an integer add of half a tf32 ulp and
// a mask; lo = x - hi, exact in fp32, goes to the tensor cores as it is,
// which read its top 19 bits (rounded toward zero) as flash_attention.cu's
// split_tf32 leaves them
__device__ __forceinline__ void split_plane(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & ~0x1fffu;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(const float (&v)[4], uint4& hi, uint4& lo) {
  split_plane(v[0], hi.x, lo.x);
  split_plane(v[1], hi.y, lo.y);
  split_plane(v[2], hi.z, lo.z);
  split_plane(v[3], hi.w, lo.w);
}

// Order of arithmetic, the same for every tile, slab and CTA: for each k
// pair, ascending from +0 (k padded with +0 to a multiple of 16), a partial
// sum starts at +0 and takes, step by step, a_lo b_hi, a_hi b_lo and a_hi
// b_hi; the partial is then added to the row's accumulator (an fp32 add,
// rounded to nearest); out = x + acc, the projection acc. The tensor cores
// truncate as they accumulate: one accumulator over all of k (two, main
// and correction, as in project_f32_3xtf32) drifted 1.2-1.5e-5 from the
// plain version at D = 512 and 1000, past FP32_LIMIT; a chain of one pair
// keeps the kernel within 2.1e-6 of the product in fp64 (cuBLAS's fp32
// product is within 8.3e-6 of it). Select on (c, rank, m) feeds the MMAs
// the bits correct feeds them on where(rank < m, c, 0), so both give the
// same bits. x is null in the projection, rank and m outside select, mk
// outside the masked mode.
template <int MODE>
__global__ void __launch_bounds__(WT_THREADS, 1)
gbatc_wide_3xtf32(const float* __restrict__ x, const float* __restrict__ c,
                  const int* __restrict__ rank, const int* __restrict__ m,
                  const float* __restrict__ mk, const float* __restrict__ basis,
                  float* __restrict__ out, int s_count, long long nb, int d,
                  int vec) {
  constexpr bool SELECT = MODE == MODE_SELECT, MASKED = MODE == MODE_MASKED;
  constexpr bool PROJECT = MODE == MODE_PROJECT;
  constexpr int TM = WT_TM, KP = WT_KP, STAGES = WT_STAGES;
  constexpr int STAGE = wt_stage_words<MODE>();
  constexpr int U_OFF = TM * KP * (SELECT || MASKED ? 2 : 1);  // U in a stage
  constexpr int P = WT_PRODUCERS;
  static_assert(STAGES >= 2 && KP == 16 && TM * 2 % P == 0 && STAGE % 4 == 0, "ring shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  uint4* planes = reinterpret_cast<uint4*>(ring + STAGES * STAGE);  // 2 x [A | B]
  // full[b]: plane b split (the producers arrive); empty[b]: its MMAs done
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + 2 * WT_PLANES);
  uint64_t* empty = full + 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int panels = (d + KP - 1) / KP;
  const int nsl = (d + WT_SLAB - 1) / WT_SLAB;
  const int sw = slab_width(d);
  // tile and step indices fit an int (the launcher checks tiles x panels)
  const int tps = (int)((nb + TM - 1) / TM) * nsl;  // tiles a species
  const int total = tps * s_count;
  const int n_tiles = wide_tiles(total);
  const int steps = n_tiles * panels;

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init_count(full + b, P);
      mbar_init_count(empty + b, WIDE_THREADS);
    }
  }
  __syncthreads();

  if (warp >= WIDE_THREADS / 32) {
    // ---- the producer warpgroup: copies, masks and splits -------------------
    const int pt = tid - WIDE_THREADS;
    // A: rows 16 mf + g and + 8 of m fragments mf = pt / 32 + 4 i, k 4q .. + 3
    // The copies run STAGES - 1 steps ahead of the split: step iv, panel ip
    // of tile it (iw), lands in ring buffer iv % STAGES. A thread reads back
    // only what it copied, so the producers need no barrier of their own.
    int it = 0, ip = 0, iv = 0;
    WideTile iw = wide_tile(0, tps, nsl, sw, nb);
    auto issue = [&]() {
      const int k0 = ip * KP;
      const int kv = min(KP, d - k0);      // k of D in this panel
      const int jw = min(sw, d - iw.j0);   // columns of D in this slab
      float* a_r = ring + (iv % STAGES) * STAGE;
      float* u_r = a_r + U_OFF;
#pragma unroll
      for (int r = 0; r < TM * 2 / P * 2; ++r) {  // rows as they lie: [row][KP]
        const int row = ((pt >> 5) + (r >> 1) * (P / 32)) * 16 + g + 8 * (r & 1);
        if (row >= iw.rows || q * 4 >= kv) continue;
        const size_t ga = (size_t)(iw.r0 + row) * d + k0 + q * 4;
        float* dst = a_r + row * KP + q * 4;
        if (vec) {
          cp_async16(dst, c + ga);
          if (SELECT) cp_async16(dst + TM * KP, rank + ga);
          if (MASKED) cp_async16(dst + TM * KP, mk + ga);
        } else {
          for (int e = 0; e < 4 && q * 4 + e < kv; ++e) {
            cp_async4(dst + e, c + ga + e);
            if (SELECT) cp_async4(dst + TM * KP + e, rank + ga + e);
            if (MASKED) cp_async4(dst + TM * KP + e, mk + ga + e);
          }
        }
      }
      const float* ub = basis + (size_t)iw.s * d * d;
#pragma unroll
      for (int r = 0; r < WT_SLAB * KP / 4 / P; ++r) {
        const int i = pt + r * P;
        if (PROJECT) {  // chunk (k, nc): U[k0 + k][j0 + 4 nc .. + 3]
          const int k = i & 15, nc = i >> 4;
          if (k >= kv || nc * 4 >= jw) continue;
          const float* src = ub + (size_t)(k0 + k) * d + iw.j0 + nc * 4;
          float* dst = u_r + k * WT_LDU + nc * 4;
          if (vec) {
            cp_async16(dst, src);
          } else {
            for (int e = 0; e < 4 && nc * 4 + e < jw; ++e) cp_async4(dst + e, src + e);
          }
        } else {  // chunk (n, kc): U[j0 + n][k0 + 4 kc .. + 3] = B[4 kc ..][n]
          const int n = i >> 2, kc = i & 3;
          if (n >= jw || kc * 4 >= kv) continue;
          const float* src = ub + (size_t)(iw.j0 + n) * d + k0 + kc * 4;
          float* dst = u_r + i * 4;
          if (vec) {
            cp_async16(dst, src);
          } else {
            for (int e = 0; e < 4 && kc * 4 + e < kv; ++e) cp_async4(dst + e, src + e);
          }
        }
      }
      ++iv;
      if (++ip < panels) return;
      ip = 0;
      if (++it < n_tiles) iw = wide_tile(it, tps, nsl, sw, nb);
    };

#pragma unroll
    for (int s0 = 0; s0 < STAGES - 1; ++s0) {
      if (s0 < steps) issue();
      cp_async_commit();
    }
    WideTile ws{};
    int cut[TM * 2 / P * 2];  // select: this thread's rows' cuts
    for (int v = 0, t = 0, p = 0; v < steps; ++v) {
      if (p == 0) {
        ws = wide_tile(t, tps, nsl, sw, nb);
#pragma unroll
        for (int r = 0; r < TM * 2 / P * 2; ++r) {
          const int row = ((pt >> 5) + (r >> 1) * (P / 32)) * 16 + g + 8 * (r & 1);
          cut[r] = SELECT && row < ws.rows ? m[ws.r0 + row] : 0;
        }
      }
      const int k0 = p * KP, kv = min(KP, d - k0);
      const int jw = min(sw, d - ws.j0);
      cp_async_wait<STAGES - 2>();  // step v landed (this thread's copies)
      // plane v % 2 is free once the MMAs of step v - 2 are done with it
      if (v >= 2) mbar_wait_or_trap(empty + (v & 1), ((v >> 1) - 1) & 1);
      const float* a_r = ring + (v % STAGES) * STAGE;
      const float* u_r = a_r + U_OFF;
      uint4* pa = planes + (v & 1) * WT_PLANES;
      uint4* pb = pa + WT_PLANE_A;
#pragma unroll
      for (int r2 = 0; r2 < TM * 2 / P; ++r2) {
        // A: rows g and g + 8 (h) of m fragment mf, k 4q .. + 3, masked;
        // step s of the pair gets {A[g][4q + 2s], A[g + 8][..], A[g][4q +
        // 2s + 1], A[g + 8][..]}: lane (g, q)'s fragment as the MMA reads it
        const int mf = (pt >> 5) + r2 * (P / 32);
        float val[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mf * 16 + g + 8 * h;
#pragma unroll
          for (int e = 0; e < 4; ++e) val[h][e] = 0.f;
          if (row >= ws.rows) continue;
          const float4 raw = *reinterpret_cast<const float4*>(a_r + row * KP + q * 4);
          const float rv[4] = {raw.x, raw.y, raw.z, raw.w};
          float mv[4] = {1.f, 1.f, 1.f, 1.f};
          int rk[4] = {0, 0, 0, 0};
          if (MASKED) {
            const float4 t4 = *reinterpret_cast<const float4*>(a_r + TM * KP + row * KP + q * 4);
            mv[0] = t4.x, mv[1] = t4.y, mv[2] = t4.z, mv[3] = t4.w;
          }
          if (SELECT) {
            const int4 t4 = *reinterpret_cast<const int4*>(a_r + TM * KP + row * KP + q * 4);
            rk[0] = t4.x, rk[1] = t4.y, rk[2] = t4.z, rk[3] = t4.w;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool live = q * 4 + e < kv && (!SELECT || rk[e] < cut[r2 * 2 + h]);
            val[h][e] = live ? (MASKED ? rv[e] * mv[e] : rv[e]) : 0.f;
          }
        }
        uint4* slot = pa + mf * 128 + lane;  // [m fragment][step][hi, lo][lane]
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          const float f[4] = {val[0][2 * s2], val[1][2 * s2], val[0][2 * s2 + 1],
                              val[1][2 * s2 + 1]};
          uint4 hi, lo;
          split4(f, hi, lo);
          slot[s2 * 64] = hi;
          slot[s2 * 64 + 32] = lo;
        }
      }
#pragma unroll
      for (int r = 0; r < WT_SLAB * KP / 4 / P; ++r) {
        const int i = pt + r * P;
        if (PROJECT) {
          // B[k][4 nc + e] goes to n fragment nc / 2, lane ((nc % 2) * 4 + e)
          // * 4 + k / 4, component k % 4; a half warp with nc odd stores its
          // e in the order 1, 0, 3, 2, so the warp's 32 stores hit 32 banks
          const int k = i & 15, nc = i >> 4;
          float val[4] = {0.f, 0.f, 0.f, 0.f};
          if (k < kv && nc * 4 < jw) {
            const float4 raw = *reinterpret_cast<const float4*>(u_r + k * WT_LDU + nc * 4);
            const float rv[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) val[e] = nc * 4 + e < jw ? rv[e] : 0.f;
          }
          uint32_t* pw = reinterpret_cast<uint32_t*>(pb + (nc >> 1) * 64);
#pragma unroll
          for (int ee = 0; ee < 4; ++ee) {
            const int e = ee ^ (nc & 1);
            uint32_t hi, lo;
            split_plane(val[e], hi, lo);
            const int word = (((nc & 1) * 4 + e) * 4 + (k >> 2)) * 4 + (k & 3);
            pw[word] = hi;
            pw[128 + word] = lo;
          }
        } else {  // chunk (n, kc): n fragment n / 8, lane (n % 8) * 4 + kc = i % 32
          const int n = i >> 2, kc = i & 3;
          float val[4] = {0.f, 0.f, 0.f, 0.f};
          if (n < jw) {
            const float4 raw = *reinterpret_cast<const float4*>(u_r + i * 4);
            const float rv[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) val[e] = kc * 4 + e < kv ? rv[e] : 0.f;
          }
          uint4 hi, lo;
          split4(val, hi, lo);
          const int slot = (i >> 5) * 64 + (i & 31);
          pb[slot] = hi;
          pb[slot + 32] = lo;
        }
      }
      mbar_arrive(full + (v & 1));
      // ring buffer v % STAGES is read: refill it STAGES - 1 steps ahead
      if (v + STAGES - 1 < steps) issue();
      cp_async_commit();
      if (++p == panels) p = 0, ++t;
    }
    cp_async_wait<0>();
    return;
  }

  // ---- the MMA warps: 2 warpgroups of 32-row by 64-column warp tiles --------
  const int wm = warp % WT_WM, wn = warp / WT_WM;
  // The MMAs of step v (plane v % 2) for this warp's first nf n fragments:
  // a panel's six products of a fragment pair go into part from +0, which
  // is then added to acc (an fp32 add, rounded to nearest)
  float acc[2][8][4];
  int jw = 0, f0 = 0, nf_w = 0;  // the tile's columns, this warp's n fragments
  auto mmas = [&](int v, int nf) {
    const uint4* pa = planes + (v & 1) * WT_PLANES + wm * 256 + lane;
    const uint4* pb = planes + (v & 1) * WT_PLANES + WT_PLANE_A + f0 * 64 + lane;
    uint4 ah[2][2], al[2][2];  // [m fragment][step]: fragments as loaded
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        ah[mi][s2] = pa[mi * 128 + s2 * 64];
        al[mi][s2] = pa[mi * 128 + s2 * 64 + 32];
      }
    // two n fragments at a time, each product for all four (fragment, m
    // fragment) pairs back to back: no MMA waits on the one before it
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += WT_JG) {
      if (j0 >= nf) break;
      uint4 bh[WT_JG], bl[WT_JG];
      float part[WT_JG][2][4];
#pragma unroll
      for (int jj = 0; jj < WT_JG; ++jj)
        if (j0 + jj < nf) bh[jj] = pb[(j0 + jj) * 64], bl[jj] = pb[(j0 + jj) * 64 + 32];
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
#pragma unroll
        for (int jj = 0; jj < WT_JG; ++jj) {
          const uint32_t h0 = s2 ? bh[jj].z : bh[jj].x, h1 = s2 ? bh[jj].w : bh[jj].y;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (j0 + jj >= nf) continue;
            if (s2 == 0) mma_tf32_zero(part[jj][mi], al[mi][s2], h0, h1);
            else mma_tf32(part[jj][mi], al[mi][s2], h0, h1);
          }
        }
#pragma unroll
        for (int jj = 0; jj < WT_JG; ++jj) {
          const uint32_t l0 = s2 ? bl[jj].z : bl[jj].x, l1 = s2 ? bl[jj].w : bl[jj].y;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            if (j0 + jj < nf) mma_tf32(part[jj][mi], ah[mi][s2], l0, l1);
        }
#pragma unroll
        for (int jj = 0; jj < WT_JG; ++jj) {
          const uint32_t h0 = s2 ? bh[jj].z : bh[jj].x, h1 = s2 ? bh[jj].w : bh[jj].y;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            if (j0 + jj < nf) mma_tf32(part[jj][mi], ah[mi][s2], h0, h1);
        }
      }
#pragma unroll
      for (int jj = 0; jj < WT_JG; ++jj)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + jj < nf) acc[mi][j0 + jj][e] += part[jj][mi][e];
    }
  };

  WideTile w{};
  for (int v = 0, t = 0, p = 0; v < steps; ++v) {
    if (p == 0) {  // a new tile: acc = +0
      w = wide_tile(t, tps, nsl, sw, nb);
      jw = min(sw, d - w.j0);
      warp_frags(jw, wn, f0, nf_w);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    }
    mbar_wait_or_trap(full + (v & 1), (v >> 1) & 1);  // plane v % 2 split
    if (nf_w == 8) mmas(v, 8);  // the whole warp tile, unguarded
    else if (nf_w > 0) mmas(v, nf_w);  // warp-uniform: a narrow slab
    mbar_arrive(empty + (v & 1));  // done with plane v % 2

    if (++p == panels) {
      p = 0, ++t;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mi * 16 + h * 8 + g;
          if (row >= w.rows) continue;
          const size_t o = (size_t)(w.r0 + row) * d + w.j0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = (f0 + j) * 8 + 2 * q;
            if (j >= nf_w || col >= jw) continue;
            const float y0 = acc[mi][j][2 * h], y1 = acc[mi][j][2 * h + 1];
            if (vec) {  // D % 4 == 0: col + 1 < jw
              float2 r = make_float2(y0, y1);
              if (!PROJECT) {
                const float2 xv = *reinterpret_cast<const float2*>(x + o + col);
                r = make_float2(xv.x + y0, xv.y + y1);
              }
              *reinterpret_cast<float2*>(out + o + col) = r;
            } else {
              out[o + col] = PROJECT ? y0 : x[o + col] + y0;
              if (col + 1 < jw) out[o + col + 1] = PROJECT ? y1 : x[o + col + 1] + y1;
            }
          }
        }
    }
  }
}

// -- fp64: gbatc_wide_dmma (correct, select and the masked mode) ------------
//
// DMMA m16n8k8 in fp64, as project_f64_wide, on panels of WD_KP = 16 k (two
// k steps) in a WD_STAGES-deep cp.async ring that the MMA warps read
// directly: A[rows, k0 : k0 + 16] (c; select: and rank; masked: and the
// mask) and U[j0 : j0 + sw, k0 : k0 + 16], whose rows are B's columns,
// k-contiguous as the .col fragment wants. Within a k step a fragment's
// column q takes k = 2q and column q + 4 takes k = 2q + 1 (in A and in B
// alike). B lies as it is read, 8 chunks of 16 bytes a row, the chunk
// index XOR-ed with 4 on odd rows (wd_chunk) so the two rows a quarter
// warp loads fall on distinct banks: lane (g, q)'s {b0, b1} is one 16-byte
// load. The producers copy A 8 bytes at a time into rows g and g + 8 of a
// fragment interleaved (wd_a), so {a0, a1} and {a2, a3} are two 16-byte
// loads that land in the registers the DMMA reads (project_f64_wide's B
// fragment is two 8-byte loads, and an A fragment read from rows as they
// lie needs four register moves a DMMA); the thread that copied a value of
// c masks it in place once it lands (select: +0 where rank >= m; masked: c
// times the mask) and then marks the buffer full. Order: each fragment's
// steps ascend from +0 over k of D padded with +0 to a multiple of 8, out
// = x + acc; select on (c, rank, m) feeds the MMAs the bits correct feeds
// them on where(rank < m, c, 0). What bounds it: 48.7 GFLOP at (58, 1600,
// 512), 0.75 ms at the 64.5 TFLOP/s DMMA reaches on an H100
// (tools/mma_peak.py), and the producers' copies, 128 threads issuing
// 8-byte copies for A; the MMA warps spill. With the other side taken out,
// the MMA warps take 1.32 ms and the producers 1.19 of correct's 1.46
// there (tools/gbatc_wide_timing.py --probes).
constexpr int WD_KP = 16;     // k a panel: two k steps
constexpr int WD_STAGES = 4;  // panels in the ring

constexpr int WD_LDA = 2 * WD_KP + 2;  // doubles a row pair of A, padded

// U's panel: the double offset of 16-byte chunk ch of row n
__device__ __forceinline__ int wd_chunk(int row, int ch) {
  return row * WD_KP + ((ch ^ ((row & 1) << 2)) << 1);  // doubles
}
// A's panel: rows g and g + 8 of an m fragment interleaved, {A[g][k],
// A[g + 8][k]} at offset k of the pair, so a lane's two fragment k are
// two 16-byte loads that land in fragment order
__device__ __forceinline__ int wd_a(int row, int k) {
  return ((row >> 4) * 8 + (row & 7)) * WD_LDA + 2 * k + ((row >> 3) & 1);
}
// doubles of a ring stage: [A | rank (select) or mask (masked) | U]
template <int MODE>
__host__ __device__ constexpr int wd_stage_words() {
  return WT_TM / 2 * WD_LDA +
         (MODE == MODE_SELECT ? WT_TM * WD_KP / 2 : MODE == MODE_MASKED ? WT_TM * WD_KP : 0) +
         WT_SLAB * WD_KP;
}

template <int MODE>
__global__ void __launch_bounds__(WT_THREADS, 1)
gbatc_wide_dmma(const double* __restrict__ x, const double* __restrict__ c,
                const int* __restrict__ rank, const int* __restrict__ m,
                const double* __restrict__ mk, const double* __restrict__ basis,
                double* __restrict__ out, int s_count, long long nb, int d,
                int vec) {
  constexpr bool SELECT = MODE == MODE_SELECT, MASKED = MODE == MODE_MASKED;
  constexpr int TM = WT_TM, KP = WD_KP, KS = KP / 8, STAGES = WD_STAGES;
  constexpr int STAGE = wd_stage_words<MODE>();
  constexpr int A_WORDS = TM / 2 * WD_LDA;      // A in a stage
  constexpr int U_OFF = STAGE - WT_SLAB * KP;  // U in a stage
  constexpr int P = WT_PRODUCERS;
  constexpr int A_CH = TM * KP / 2 / P;       // A chunks a producer thread
  constexpr int U_CH = WT_SLAB * KP / 2 / P;  // U chunks a producer thread
  static_assert(STAGES >= 2 && KP == 16 && A_CH * P * 2 == TM * KP, "ring shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ring = reinterpret_cast<double*>(smem_raw);
  // full[s]: ring buffer s landed (and masked); empty[s]: its MMAs done
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int ks_n = (d + 7) / 8;  // k steps of D
  const int dp = ks_n * 8;       // D padded with zero terms
  const int panels = (ks_n + KS - 1) / KS;
  const int nsl = (d + WT_SLAB - 1) / WT_SLAB;
  const int sw = slab_width(d);
  const int tps = (int)((nb + TM - 1) / TM) * nsl;
  const int total = tps * s_count;
  const int n_tiles = wide_tiles(total);
  const int steps = n_tiles * panels;

  if (tid == 0) {
    for (int b = 0; b < STAGES; ++b) {
      mbar_init_count(full + b, P);
      mbar_init_count(empty + b, WIDE_THREADS);
    }
  }
  __syncthreads();

  if (warp >= WIDE_THREADS / 32) {
    // ---- the producer warpgroup: copies and masks ----------------------------
    // chunk i = pt + r P of a panel: A (row, ch) = (i / 8, i % 8), two k of a
    // row; U (n, ch) likewise. k in [D, dp) of a panel is +0 in A and in B
    // (written with the copies); rows past the tile and columns past the
    // slab only feed outputs that are never stored. A thread reads back
    // only what it copied.
    const int pt = tid - WIDE_THREADS;
    int it = 0, ip = 0, iv = 0;
    WideTile iw = wide_tile(0, tps, nsl, sw, nb);
    auto issue = [&]() {
      const int k0 = ip * KP;
      const int kv = min(KP, d - k0);   // k of D in this panel
      const int kn = min(KP, dp - k0);  // k its MMAs run
      const int jw = min(sw, d - iw.j0);
      double* a_s = ring + (iv % STAGES) * STAGE;
      double* u_s = a_s + U_OFF;
#pragma unroll
      for (int r = 0; r < A_CH; ++r) {
        const int i = pt + r * P, row = i >> 3, ch = i & 7;
        if (row >= iw.rows) continue;
        const size_t ga = (size_t)(iw.r0 + row) * d + k0 + 2 * ch;
        for (int e = 0; e < 2; ++e) {
          const int k = 2 * ch + e;
          if (k >= kn) break;
          double* dst = a_s + wd_a(row, k);
          if (k >= kv) {
            *dst = 0.0;
            continue;
          }
          cp_async8(dst, c + ga + e);
          if (vec && e == 0) {  // kv is even: the chunk is whole
            if (SELECT) cp_async8(reinterpret_cast<int*>(a_s + A_WORDS) + i * 2, rank + ga);
            if (MASKED) cp_async16(a_s + A_WORDS + i * 2, mk + ga);
          } else if (!vec) {
            if (SELECT) cp_async4(reinterpret_cast<int*>(a_s + A_WORDS) + i * 2 + e, rank + ga + e);
            if (MASKED) cp_async8(a_s + A_WORDS + i * 2 + e, mk + ga + e);
          }
        }
      }
      const double* ub = basis + ((size_t)iw.s * d + iw.j0) * d + k0;
#pragma unroll 4
      for (int r = 0; r < U_CH; ++r) {  // chunk (n, ch): U[j0 + n][k0 + 2 ch ..]
        const int i = pt + r * P, n = i >> 3, ch = i & 7;
        if (n >= jw || 2 * ch >= kn) continue;
        const double* src = ub + (size_t)n * d + 2 * ch;
        double* dst = u_s + wd_chunk(n, ch);
        if (vec && 2 * ch < kv) {
          cp_async16(dst, src);
        } else {
          for (int e = 0; e < 2 && 2 * ch + e < kn; ++e) {
            if (2 * ch + e < kv) cp_async8(dst + e, src + e);
            else dst[e] = 0.0;
          }
        }
      }
      ++iv;
      if (++ip < panels) return;
      ip = 0;
      if (++it < n_tiles) iw = wide_tile(it, tps, nsl, sw, nb);
    };

#pragma unroll
    for (int s0 = 0; s0 < STAGES - 1; ++s0) {
      if (s0 < steps) issue();
      cp_async_commit();
    }
    WideTile wk{};
    int cut[A_CH];  // select: the cuts of this thread's rows
    for (int v = 0, t = 0, p = 0; v < steps; ++v) {
      if (SELECT && p == 0) {
        wk = wide_tile(t, tps, nsl, sw, nb);
#pragma unroll
        for (int r = 0; r < A_CH; ++r) {
          const int row = (pt + r * P) >> 3;
          cut[r] = row < wk.rows ? m[wk.r0 + row] : 0;
        }
      } else if (MASKED && p == 0) {
        wk = wide_tile(t, tps, nsl, sw, nb);
      }
      cp_async_wait<STAGES - 2>();  // step v landed (this thread's copies)
      if (SELECT || MASKED) {  // c masked in place: +0 where rank >= m, or c * mask
        const int kv = min(KP, d - p * KP);
        double* a_s = ring + (v % STAGES) * STAGE;
#pragma unroll
        for (int r = 0; r < A_CH; ++r) {
          const int i = pt + r * P, row = i >> 3, ch = i & 7;
          if (row >= wk.rows) continue;
          for (int e = 0; e < 2 && 2 * ch + e < kv; ++e) {
            double* cv = a_s + wd_a(row, 2 * ch + e);
            if (SELECT) {
              const int rk = reinterpret_cast<const int*>(a_s + A_WORDS)[i * 2 + e];
              if (!(rk < cut[r])) *cv = 0.0;
            } else {
              *cv = *cv * a_s[A_WORDS + i * 2 + e];
            }
          }
        }
      }
      mbar_arrive(full + v % STAGES);
      // ring buffer (v - 1) % STAGES is refilled once its MMAs are done
      if (v + STAGES - 1 < steps) {
        if (v >= 1) mbar_wait_or_trap(empty + (v - 1) % STAGES, ((v - 1) / STAGES) & 1);
        issue();
      }
      cp_async_commit();
      if (++p == panels) p = 0, ++t;
    }
    cp_async_wait<0>();
    return;
  }

  // ---- the MMA warps -----------------------------------------------------------
  const int wm = warp % WT_WM, wn = warp / WT_WM;
  double acc[2][8][4];
  int jw = 0, f0 = 0, nf_w = 0;
  // the MMAs of step v for this warp's first nf n fragments
  auto mmas = [&](int v, int ksn, int nf) {
    const double* a_s = ring + (v % STAGES) * STAGE;
    const double* u_s = a_s + U_OFF;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {  // k0 + 8 ks .. + 7
      if (ks >= ksn) break;
      double a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {  // rows g and g + 8 at k = 8 ks + 2q, + 1
        const double* ap = a_s + wd_a(wm * 32 + mi * 16 + g, 8 * ks + 2 * q);
        const double2 k0v = *reinterpret_cast<const double2*>(ap);
        const double2 k1v = *reinterpret_cast<const double2*>(ap + 2);
        a[mi][0] = k0v.x, a[mi][1] = k0v.y, a[mi][2] = k1v.x, a[mi][3] = k1v.y;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nf) continue;
        const double2 b = *reinterpret_cast<const double2*>(
            u_s + wd_chunk((f0 + j) * 8 + g, 4 * ks + q));
        dmma(acc[0][j], a[0], b.x, b.y);
        dmma(acc[1][j], a[1], b.x, b.y);
      }
    }
  };

  WideTile w{};
  for (int v = 0, t = 0, p = 0; v < steps; ++v) {
    if (p == 0) {  // a new tile: acc = +0
      w = wide_tile(t, tps, nsl, sw, nb);
      jw = min(sw, d - w.j0);
      warp_frags(jw, wn, f0, nf_w);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.0;
    }
    mbar_wait_or_trap(full + v % STAGES, (v / STAGES) & 1);  // step v landed
    const int ksn = min(KS, ks_n - p * KS);  // the last panel may hold one step
    if (nf_w == 8 && ksn == KS) mmas(v, KS, 8);  // unguarded
    else if (nf_w > 0) mmas(v, ksn, nf_w);  // warp-uniform
    mbar_arrive(empty + v % STAGES);  // done with ring buffer v % STAGES

    if (++p == panels) {
      p = 0, ++t;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mi * 16 + h * 8 + g;
          if (row >= w.rows) continue;
          const size_t o = (size_t)(w.r0 + row) * d + w.j0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = (f0 + j) * 8 + 2 * q;
            if (j >= nf_w || col >= jw) continue;
            if (vec) {  // D even: col + 1 < jw
              const double2 xv = *reinterpret_cast<const double2*>(x + o + col);
              *reinterpret_cast<double2*>(out + o + col) =
                  make_double2(xv.x + acc[mi][j][2 * h], xv.y + acc[mi][j][2 * h + 1]);
            } else {
              out[o + col] = x[o + col] + acc[mi][j][2 * h];
              if (col + 1 < jw) out[o + col + 1] = x[o + col + 1] + acc[mi][j][2 * h + 1];
            }
          }
        }
    }
  }
}

// -- fp64 projection past D = 128: project_f64_wide_tma ------------------------
//
// C = R U on DMMA m16n8k8 in fp64, as project_f64_wide, in 128-row tiles
// against slabs of up to 128 columns (slab_width, the tiles and the
// persistent order of gbatc_wide_dmma), its panels landed by the Tensor
// Memory Accelerator. A CTA is 8 MMA warps of 32 rows by 64 columns (warp
// (wm, wn) = (warp % 4, warp / 4)) and a producer warpgroup, one thread of
// which issues every copy: per panel of TMA_KP k, the tile's A[rows, k0 :
// k0 + 32] as two boxes of 16 k by 128 rows and U[k0 : k0 + 32, j0 : j0 +
// sw] as boxes of 32 k by 16 columns, each one cp.async.bulk.tensor.3d over
// (D, NB, S) or (D, D, S), both with the 128-byte swizzle (box rows of 128
// bytes, the 16-byte chunk c of row r at c ^ (r % 8)), into a ring of
// TMA_STAGES panels (192 KB) with full / empty mbarriers (the waits trap
// rather than hang). The producers give their registers to the MMA warps
// (setmaxnreg), whose 64 fp64 accumulators a lane need them: a single
// producer warp beside them left 168 registers a thread and the MMA warps
// spilled. The tensor maps fill what lies past NB rows or D columns with
// +0, so ragged rows, the last slab and the k past D cost no code: +0 in A
// and in B past D, as the other projections have it. TMA needs rows of a
// multiple of 16 bytes and aligned bases, so the launcher takes this kernel
// only for even D with R, U and C 16-byte aligned (project_f64_wide
// otherwise).
//
// The swizzle makes every fragment load conflict-free, given two
// relabelings that move no bit. Rows: a fragment's row g is the tile's row
// 8 i + pg, pg = 2 (g % 4) + g / 4, so the 4 rows a half warp loads fall on
// swizzle keys 0, 2, 4, 6 (or 1, 3, 5, 7) and its 16 eight-byte loads on 16
// distinct bank pairs. Columns: n fragments come in pairs (2 b, 2 b + 1) over
// box b's 16 columns, fragment column g of the pair taking columns 16 b + 2
// pc and + 1, pc = g / 2 + 4 (g % 2), so lane (g, q)'s B values of both
// fragments, {B[k][16 b + 2 pc], B[k][16 b + 2 pc + 1]}, are one 16-byte
// load, whose quarter warps fall on 8 distinct chunks; lane (g, q) then
// holds output columns 16 b + 2 q, + 1 and 16 b + 2 q + 8, + 9 of its rows,
// two 16-byte stores. A k step is 8 eight-byte loads of A and 8 sixteen-byte
// loads of B for 16 DMMAs a warp (project_f64_wide: 24 eight-byte loads).
//
// Order of arithmetic: project_f64_wide's. Each output's m16n8k8 steps run
// ascending from +0, ceil(D / 8) of them, fragment column q of a step
// taking k0 + q and column q + 4 taking k0 + q + 4; which row or column of a
// fragment an output sits in moves no bit (WIDE_SHA256 and ANY_D_SHA256
// hold). What bounds it at (58, 1600, 512): 48.7 GFLOP, 0.73 ms at 67
// TFLOP/s (0.75 at the 64.5 that mma.sync reaches, tools/mma_peak.py),
// against 0.26 ms of bytes; at (1, 65536, 256) 8.6 GFLOP, 0.13 ms. From L2
// a tile reads 128 x 512 x 8 bytes of A and as many of U, 16 KB a k step
// for 128 DMMAs (project_f64_wide's 64 x 256 tiles: 20 KB), 3.1 GB in all
// (3.7). Measured at (58, 1600, 512) (tools/gbatc_wide_timing.py --probes,
// an H100 at 700 W): the copies alone take 0.40 ms, so L2 does not bind
// and the CTAs share no panel (no cluster); the DMMAs alone took 0.97-1.01
// with one thread of the MMA warps issuing the copies and the two together
// 1.17-1.19, since that warp waited on the others before each refill; with
// the producer warpgroup 0.92 (torch.bmm 0.89; project_f64_wide 1.43), and
// 0.19 at (1, 65536, 256) (bmm 0.19; project_f64_wide 0.29).
constexpr int TMA_FROM_D = 128;                    // the fp64 projection's TMA route past it
constexpr int TMA_KP = 32;                         // k a panel
constexpr int TMA_STAGES = 3;                      // panels in the ring
constexpr int TMA_BOX = 16;                        // doubles a box row: 128 bytes
constexpr int TMA_A_BOX = WT_TM * TMA_BOX * 8;     // bytes of an A box (16 k)
constexpr int TMA_B_BOX = TMA_KP * TMA_BOX * 8;    // bytes of a U box (16 columns)
constexpr int TMA_A_BYTES = TMA_KP / TMA_BOX * TMA_A_BOX;
constexpr int TMA_STAGE = TMA_A_BYTES + WT_SLAB / TMA_BOX * TMA_B_BOX;
constexpr int TMA_THREADS = WIDE_THREADS + 128;    // 8 MMA warps, a producer warpgroup
// registers a thread after setmaxnreg: the producers give theirs to the MMA
// warps (168 a thread at launch: 128 x 40 + 256 x 232 = 384 x 168)
constexpr int TMA_PRODUCER_REGS = 40, TMA_MMA_REGS = 232;
constexpr size_t TMA_SMEM = (size_t)TMA_STAGES * TMA_STAGE +
                            2 * TMA_STAGES * sizeof(uint64_t) + 1024;  // + alignment
static_assert(TMA_A_BOX % 1024 == 0 && TMA_B_BOX % 1024 == 0 && TMA_KP % TMA_BOX == 0 &&
              TMA_SMEM <= 232448, "TMA ring shape");
static_assert(128 * TMA_PRODUCER_REGS + WIDE_THREADS * TMA_MMA_REGS <= 64 * 1024 &&
              TMA_PRODUCER_REGS % 8 == 0 && TMA_MMA_REGS % 8 == 0, "register split");

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the mbarrier's phase completes on this arrival and `bytes` of copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
// one TMA copy of the box at (c0, c1, c2) of `map` to shared memory,
// reported to `bar` as transaction bytes
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar)) : "memory");
}

__global__ void __launch_bounds__(TMA_THREADS, 1)
project_f64_wide_tma(const __grid_constant__ CUtensorMap a_map,  // R: (D, NB, S)
                     const __grid_constant__ CUtensorMap u_map,  // U: (D, D, S)
                     double* __restrict__ out, int s_count, long long nb, int d) {
  constexpr int TM = WT_TM, KP = TMA_KP, KS = KP / 8, STAGES = TMA_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes from a 1024-byte aligned base
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  // full[s]: ring buffer s landed; empty[s]: its MMAs done
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * TMA_STAGE);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ks_n = (d + 7) / 8;  // k steps of D
  const int panels = (ks_n + KS - 1) / KS;
  const int nsl = (d + WT_SLAB - 1) / WT_SLAB;
  const int sw = slab_width(d);
  // tile and step indices fit an int (the launcher checks tiles x panels)
  const int tps = (int)((nb + TM - 1) / TM) * nsl;
  const int total = tps * s_count;
  const int n_tiles = wide_tiles(total);
  const int steps = n_tiles * panels;

  if (tid == 0) {
    for (int b = 0; b < STAGES; ++b) {
      mbar_init_count(full + b, 1);
      mbar_init_count(empty + b, WIDE_THREADS);
    }
    fence_mbarrier_init();
    fence_proxy_async();
  }
  __syncthreads();

  // One thread of the producer warpgroup issues the copies: panel v of the
  // CTA's stream (tile t, panel p of it) into ring buffer v % STAGES, once
  // every MMA warp is done with step v - STAGES there.
  WideTile iw{};
  int iv = 0, it = 0, ip = 0;
  auto issue = [&]() {
    const int st = iv % STAGES;
    if (ip == 0) iw = wide_tile(it, tps, nsl, sw, nb);
    const int k0 = ip * KP;
    const int na = min(KP / TMA_BOX, (d - k0 + TMA_BOX - 1) / TMA_BOX);  // A boxes in D
    const int nbx = (min(sw, d - iw.j0) + TMA_BOX - 1) / TMA_BOX;      // U boxes
    unsigned char* a_s = ring + st * TMA_STAGE;
    const int row0 = (int)(iw.r0 - (long long)iw.s * nb);
    mbar_expect_tx(full + st, na * TMA_A_BOX + nbx * TMA_B_BOX);
    for (int i = 0; i < na; ++i)
      tma_load_3d(a_s + i * TMA_A_BOX, &a_map, k0 + i * TMA_BOX, row0, iw.s, full + st);
    for (int b = 0; b < nbx; ++b)
      tma_load_3d(a_s + TMA_A_BYTES + b * TMA_B_BOX, &u_map, iw.j0 + b * TMA_BOX, k0,
                  iw.s, full + st);
    ++iv;
    if (++ip == panels) ip = 0, ++it;
  };
  if (warp >= WIDE_THREADS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(TMA_PRODUCER_REGS) : "memory");
    if (tid == WIDE_THREADS) {
      for (int v = 0; v < steps; ++v) {
        if (v >= STAGES) mbar_wait_or_trap(empty + v % STAGES, (v / STAGES - 1) & 1);
        issue();
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(TMA_MMA_REGS) : "memory");

  // ---- the MMA warps ---------------------------------------------------------

  const int wm = warp % WT_WM, wn = warp / WT_WM;
  const int g = lane >> 2, q = lane & 3;
  const int pg = 2 * (g & 3) + (g >> 2);   // fragment row g's row (mod 8) in a tile
  const int pc = (g >> 1) + 4 * (g & 1);   // fragment column g's column pair in a box
  // byte offsets in a stage: rows 8 (4 wm + 2 mi + h) + pg of an A box, and
  // this lane's k = 8 ks + q (a[0], a[1]) and + 4 (a[2], a[3]) in it
  const int a_row = (wm * 32 + pg) * 128 + (q & 1) * 8;
  const int a_k0 = ((q >> 1) ^ pg) << 4, a_k4 = ((2 + (q >> 1)) ^ pg) << 4;
  // U rows k = 8 ks + q and + 4 of a box, chunk pc, swizzled by k % 8
  const int b_k0 = TMA_A_BYTES + q * 128 + ((pc ^ q) << 4);
  const int b_k4 = TMA_A_BYTES + (q + 4) * 128 + ((pc ^ q ^ 4) << 4);
  double acc[2][8][4];
  // the MMAs of ring buffer `st` for this warp's first nb_ boxes, ksn k steps
  auto mmas = [&](const unsigned char* st, int ksn, int nb_) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks >= ksn) break;
      const unsigned char* ab = st + (ks >> 1) * TMA_A_BOX + a_row;
      const int sx = (ks & 1) << 6;  // k 8 .. 15 of a box: chunk + 4, swizzled
      double a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned char* ar = ab + (16 * mi + 8 * h) * 128;
          a[mi][h] = *reinterpret_cast<const double*>(ar + (a_k0 ^ sx));
          a[mi][2 + h] = *reinterpret_cast<const double*>(ar + (a_k4 ^ sx));
        }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (b >= nb_) break;
        const unsigned char* bb = st + (wn * 4 + b) * TMA_B_BOX + ks * 1024;
        const double2 b0 = *reinterpret_cast<const double2*>(bb + b_k0);
        const double2 b1 = *reinterpret_cast<const double2*>(bb + b_k4);
        dmma(acc[0][2 * b], a[0], b0.x, b1.x);
        dmma(acc[1][2 * b], a[1], b0.x, b1.x);
        dmma(acc[0][2 * b + 1], a[0], b0.y, b1.y);
        dmma(acc[1][2 * b + 1], a[1], b0.y, b1.y);
      }
    }
  };

  WideTile w{};
  int jw = 0, nbw = 0;
  bool live = false;  // warp-uniform: this warp has rows and columns in the tile
  for (int v = 0, t = 0, p = 0; v < steps; ++v) {
    if (p == 0) {  // a new tile: acc = +0
      w = wide_tile(t, tps, nsl, sw, nb);
      jw = min(sw, d - w.j0);
      nbw = max(0, min(4, (jw + TMA_BOX - 1) / TMA_BOX - wn * 4));
      live = nbw > 0 && wm * 32 < w.rows;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.0;
    }
    const int st = v % STAGES;
    mbar_wait_or_trap(full + st, (v / STAGES) & 1);  // step v landed
    const int ksn = min(KS, ks_n - p * KS);  // the last panel may hold fewer steps
    if (live) {
      if (nbw == 4 && ksn == KS) mmas(ring + st * TMA_STAGE, KS, 4);  // unguarded
      else mmas(ring + st * TMA_STAGE, ksn, nbw);
    }
    mbar_arrive(empty + st);  // done with ring buffer st

    if (++p < panels) continue;
    p = 0, ++t;
    if (!live) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + 16 * mi + 8 * h + pg;
        if (row >= w.rows) continue;
        double* o = out + (size_t)(w.r0 + row) * d + w.j0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = (wn * 4 + b) * TMA_BOX + 2 * q;  // and col + 8
          if (b >= nbw || col >= jw) continue;
          *reinterpret_cast<double2*>(o + col) =
              make_double2(acc[mi][2 * b][2 * h], acc[mi][2 * b + 1][2 * h]);
          if (col + 8 < jw)  // D even: col + 9 < jw too
            *reinterpret_cast<double2*>(o + col + 8) =
                make_double2(acc[mi][2 * b][2 * h + 1], acc[mi][2 * b + 1][2 * h + 1]);
        }
      }
  }
}

template <int MODE, int NCH, int MINB>
int launch_ring(const float* x, const float* c, const int* rank, const int* m,
                const float* mk, const float* u, float* out, int s, long long nb,
                int d, void* stream) {
  const int threads = 64 * ((d + 15) / 16);
  const int ldk = (d + KU - 1) / KU * KU, lda = ring_lda(d);
  size_t words = (size_t)ldk * 16 * NCH + (size_t)RING_STAGES * RING_TM * lda;
  if (MODE == MODE_SELECT) words += (size_t)RING_TM * lda + RING_STAGES * RING_TM;
  if (MODE == MODE_MASKED) words += (size_t)RING_TM * lda;
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
                  aligned16(rank) && aligned16(mk) && aligned16(out);
  kernel<<<(unsigned)grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, c, rank, m, mk, u, out, s, nb, d, lda, vec);
  return (int)cudaGetLastError();
}

// every route past D = 128 but the fp64 projection: gbatc_wide_3xtf32
// (fp32) or gbatc_wide_dmma (fp64), one CTA an SM; x is null in the
// projection
template <typename T, int MODE>
int launch_wide(const T* x, const T* c, const int* rank, const int* m,
                const T* mk, const T* u, T* out, int s, long long nb, int d,
                void* stream) {
  constexpr bool F32 = sizeof(T) == 4;
  const size_t smem =
      F32 ? wt_smem_bytes<MODE>()
          : (size_t)WD_STAGES * wd_stage_words<MODE>() * sizeof(double) +
                2 * WD_STAGES * sizeof(uint64_t);
  const long long tiles = (long long)s * ((nb + WT_TM - 1) / WT_TM) *
                          ((d + WT_SLAB - 1) / WT_SLAB);
  const int panels = F32 ? (d + WT_KP - 1) / WT_KP : ((d + 7) / 8 + 1) / 2;
  if (tiles * panels > INT32_MAX) return (int)cudaErrorInvalidValue;
  void (*kernel)(const T*, const T*, const int*, const int*, const T*, const T*,
                 T*, int, long long, int, int);
  if constexpr (F32) kernel = gbatc_wide_3xtf32<MODE>;
  else kernel = gbatc_wide_dmma<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int threads = WT_THREADS;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long slots = (long long)sms * per_sm;
  const long long grid = tiles < slots ? tiles : slots;
  const int vec = d % (16 / (int)sizeof(T)) == 0 && aligned16(x) && aligned16(c) &&
                  aligned16(rank) && aligned16(mk) && aligned16(u) && aligned16(out);
  kernel<<<(unsigned)grid, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(x, c, rank, m, mk, u, out, s,
                                                nb, d, vec);
  return (int)cudaGetLastError();
}

// every fp32 correct, select and masked route: correct_f32_ring, two CTAs
// an SM at D <= 80, one at D <= 128, gbatc_wide_3xtf32 past it
template <int MODE>
int launch_correct_f32(const float* x, const float* c, const int* rank,
                       const int* m, const float* mk, const float* u, float* out,
                       int s, long long nb, int d, int tiles_per_cta, void* stream) {
  if (d < 1 || s < 0 || nb < 0 || tiles_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  if (s == 0 || nb == 0) return (int)cudaSuccess;
  if (d <= 80)
    return launch_ring<MODE, 5, 2>(x, c, rank, m, mk, u, out, s, nb, d, stream);
  if (d <= MAX_D)
    return launch_ring<MODE, 8, 1>(x, c, rank, m, mk, u, out, s, nb, d, stream);
  return launch_wide<float, MODE>(x, c, rank, m, mk, u, out, s, nb, d, stream);
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

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda);
// null where the driver lacks it
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// a 3D fp64 tensor map over (n0, n1, n2) contiguous doubles, boxes of
// (TMA_BOX, box1, 1), 128-byte swizzle, +0 past the tensor
bool encode_f64_3d(CUtensorMap* map, const double* base, long long n0, long long n1,
                   long long n2, int box1) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)n0 * 8, (cuuint64_t)(n0 * n1) * 8};
  const cuuint32_t box[3] = {TMA_BOX, (cuuint32_t)box1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3, const_cast<double*>(base), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA route's operands: rows a multiple of 16 bytes (D even), R, U and
// C 16-byte aligned, NB and D within the maps' int coordinates.
inline bool tma_ok(const double* r, const double* u, const double* c, long long nb,
                   int d) {
  return d % 2 == 0 && aligned16(r) && aligned16(u) && aligned16(c) && nb <= INT32_MAX;
}

int launch_dmma_tma(const double* r, const double* u, double* c, int s, long long nb,
                    int d, void* stream) {
  const long long tiles = (long long)s * ((nb + WT_TM - 1) / WT_TM) *
                          ((d + WT_SLAB - 1) / WT_SLAB);
  const int panels = ((d + 7) / 8 + TMA_KP / 8 - 1) / (TMA_KP / 8);
  if (tiles * panels > INT32_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap a_map, u_map;
  if (!encode_f64_3d(&a_map, r, d, nb, s, WT_TM) ||
      !encode_f64_3d(&u_map, u, d, d, s, TMA_KP))
    return (int)cudaErrorNotSupported;
  auto kernel = project_f64_wide_tma;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TMA_THREADS,
                                                      TMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long slots = (long long)sms * per_sm;
  const long long grid = tiles < slots ? tiles : slots;
  kernel<<<(unsigned)grid, TMA_THREADS, TMA_SMEM, static_cast<cudaStream_t>(stream)>>>(
      a_map, u_map, c, s, nb, d);
  return (int)cudaGetLastError();
}

int launch_project_f64(const double* r, const double* u, double* c, int s,
                       long long nb, int d, int tiles_per_cta, void* stream) {
  if (d < 1 || s < 0 || nb < 0 || tiles_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  if (s == 0 || nb == 0) return (int)cudaSuccess;
  if (d <= 80) return launch_dmma<5, 64, 3>(r, u, c, s, nb, d, stream);
  if (d <= MAX_D) return launch_dmma<8, 32, 3>(r, u, c, s, nb, d, stream);
  // past TMA_FROM_D with TMA's operands: project_f64_wide_tma; else
  // (odd D, an unaligned operand) project_f64_wide's cp.async copies
  if (d > TMA_FROM_D && tma_ok(r, u, c, nb, d))
    return launch_dmma_tma(r, u, c, s, nb, d, stream);
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

// every fp64 correct, select and masked route: the tile kernel up to D =
// 128, gbatc_wide_dmma past it (every fp32 route is launch_correct_f32's)
template <int MODE>
int launch_f64(const double* a, const double* basis, const double* x, const int* rank,
               const int* m, const double* mk, double* out, int s, long long nb, int d,
               int tiles_per_cta, void* stream) {
  if (d < 1 || s < 0 || nb < 0 || tiles_per_cta < 1)
    return (int)cudaErrorInvalidValue;
  if (s == 0 || nb == 0) return (int)cudaSuccess;
  if (d > MAX_D)
    return launch_wide<double, MODE>(x, a, rank, m, mk, basis, out, s, nb, d, stream);
  if (d <= 5 * TX)
    return launch_as<double, MODE, 5>(a, basis, x, rank, m, mk, out, s, nb, d,
                                      tiles_per_cta, stream);
  return launch_as<double, MODE, MAX_D / TX>(a, basis, x, rank, m, mk, out, s, nb,
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
  return launch_correct_f32<MODE_CORRECT>(x, c, nullptr, nullptr, nullptr, u, out,
                                          s, nb, d, tiles_per_cta, stream);
}
int gbatc_correct_batched_f64(const double* x, const double* c,
                              const double* u, double* out, int s,
                              long long nb, int d, int tiles_per_cta,
                              void* stream) {
  return launch_f64<MODE_CORRECT>(c, u, x, nullptr, nullptr, nullptr, out, s, nb, d,
                                  tiles_per_cta, stream);
}
int gbatc_select_accumulate_f32(const float* x, const float* c,
                                const int* rank, const int* m, const float* u,
                                float* out, int s, long long nb, int d,
                                int tiles_per_cta, void* stream) {
  return launch_correct_f32<MODE_SELECT>(x, c, rank, m, nullptr, u, out, s, nb, d,
                                         tiles_per_cta, stream);
}
int gbatc_select_accumulate_f64(const double* x, const double* c,
                                const int* rank, const int* m, const double* u,
                                double* out, int s, long long nb, int d,
                                int tiles_per_cta, void* stream) {
  return launch_f64<MODE_SELECT>(c, u, x, rank, m, nullptr, out, s, nb, d,
                                 tiles_per_cta, stream);
}
int gbatc_correct_masked_f32(const float* x, const float* c, const float* mask,
                             const float* u, float* out, int s, long long nb,
                             int d, int tiles_per_cta, void* stream) {
  return launch_correct_f32<MODE_MASKED>(x, c, nullptr, nullptr, mask, u, out, s, nb,
                                         d, tiles_per_cta, stream);
}
int gbatc_correct_masked_f64(const double* x, const double* c,
                             const double* mask, const double* u, double* out,
                             int s, long long nb, int d, int tiles_per_cta,
                             void* stream) {
  return launch_f64<MODE_MASKED>(c, u, x, nullptr, nullptr, mask, out, s, nb, d,
                                 tiles_per_cta, stream);
}

}  // extern "C"
