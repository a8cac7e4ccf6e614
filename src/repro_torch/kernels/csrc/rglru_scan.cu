// RG-LRU scan (diagonal linear recurrence) for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel rglru_scan (_rglru_kernel) of
// src/repro/kernels/rglru_scan.py:
//
//   h_t = a_t * h_{t-1} + b_t        per channel, a clamped to [1e-37, 1]
//
// over a, b (B, T, W) in fp32 or bf16 and h0 (B, W) fp32 (or none: zero);
// h (B, T, W) in a's type, h_T (B, W) fp32. The clamp is the TPU kernel's
// (it clamps before taking logs); within the contract a in (0, 1] it
// changes nothing.
//
// What is ported is the function. The TPU kernel's chunked form (a (C, C)
// tile of exp(cum_t - cum_s) per channel block, which gives the MXU a
// matrix product) is a TPU adaptation and is not carried over, nor is T
// split across CTAs with a carry pass: both would round differently.
//
// Bound on this card: bytes. a and b are read once and h written once,
// 3 B T W sizeof(T) bytes, against two flops an element; at
// RecurrentGemma-2B's serving shape (4, 2304, 2560) in fp32 that is 283 MB,
// 0.085 ms at 3.35 TB/s. The serial chain is not the limit: one
// __fmul_rn and one __fadd_rn a step, about 8 cycles, 2304 steps in about
// 10 us.
//
// Why the first design sat at 39 % of that bound: one thread walked one
// channel with the next 16 steps of a and b in registers, 128 bytes in
// flight a thread, in one-warp CTAs. At (4, 2304, 2560) the 10,240 channels
// hold about 1.3 MB in flight over the card, while 3.35 TB/s at about 1 us
// of loaded DRAM latency needs about 3 MB (Little's law): the kernel waited
// on latency with too few bytes in flight.
//
// The ring: a CTA owns one group of GROUP = 32 channels of one batch row
// (a 128-byte row a step in fp32, 64 in bf16) and walks T in tiles of
// T_TILE = 32 steps through a ring of STAGES = 3 slots of a and b in
// dynamic shared memory. Its second warp, the producer, keeps the next two
// tiles in flight ahead of the tile the chain walks with asynchronous
// copies (cp.async): 16 KB a CTA in fp32, 5.2 MB over the 320 CTAs of
// (4, 2304, 2560). The first warp, the chain (lane = channel), reads a
// tile's a and b from shared memory into registers ahead of the dependent
// ops, keeps the tile's h in shared memory and stores it as 16-byte rows.
// tools/rglru_variants.py times the choices not taken (2 or 4 slots,
// 16-step tiles, no producer warp, h stored a step at a time, 16-channel
// groups, L2 and store hints) and probes where the time goes.
//
// Why no bit moves: each channel is still one thread's serial fp32 walk in
// ascending t, the product and the sum rounded separately (__fmul_rn /
// __fadd_rn, so nvcc cannot contract them into an FMA), a clamped by
// fminf(fmaxf(...)), bf16 h rounded once by __float2bfloat16_rn from the
// fp32 carry; only where the operands wait before the chain reads them
// changed. The kernel's bits equal the plain version's.
//
// Ragged T and W are loop bounds; nothing is padded in device memory. The
// launcher picks the copy width from W and the pointers (copy_width):
// 16-byte cp.async where a row of W elements and the bases of a, b and h
// are 16-byte aligned, else element loads through the producer's
// registers (a base one element in, bf16 at odd W); h is staged only on
// the 16-byte path. Both walk the same ring and chain. Launchers return
// the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GROUP = 32;    // channels a CTA, one chain lane each
constexpr int T_TILE = 32;   // steps a ring slot holds
constexpr int STAGES = 3;    // ring slots
constexpr int THREADS = 64;  // the chain warp, then the producer warp
constexpr int SLOT = 2 * T_TILE * GROUP;  // elements a slot: a, then b

// copy widths, chosen by copy_width
constexpr int VEC16 = 0;  // cp.async of 16 bytes
constexpr int ELEM = 1;   // an element through a register

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int COPY>
__device__ __forceinline__ void copy_in(T* dst, const T* src) {
  if constexpr (COPY == VEC16) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Steps t0 .. t0 + T_TILE - 1 (those below t_len) of the group's cols
// channels of a and of b into a ring slot: a as [T_TILE][GROUP], then b.
// A row is CPR copies of E elements, so the producer's 32 lanes cover RPP
// rows a pass; lane copies column (lane % CPR) E of rows lane / CPR,
// + RPP, ... of both arrays.
template <typename T, int COPY>
__device__ __forceinline__ void fill(T* slot, const T* __restrict__ a,
                                     const T* __restrict__ b, size_t base,
                                     int t0, int t_len, int w_len, int cols,
                                     int lane) {
  constexpr int E = COPY == VEC16 ? 16 / (int)sizeof(T) : 1;
  constexpr int CPR = GROUP / E;  // copies a row
  constexpr int RPP = 32 / CPR;   // rows a pass
  static_assert(RPP * CPR == 32 && T_TILE % RPP == 0,
                "the lanes cover whole rows and the tile whole passes");
  const int r0 = lane / CPR, c = (lane % CPR) * E;
  if (c >= cols) return;
  const int left = min(T_TILE, t_len - t0) - r0;  // rows from r0 on
  const size_t g = base + (size_t)(t0 + r0) * w_len + c;
  const size_t pass = (size_t)RPP * w_len;
  T* s = slot + r0 * GROUP + c;
#pragma unroll
  for (int p = 0; p < T_TILE / RPP; ++p) {
    if (p * RPP < left) {
      copy_in<T, COPY>(s + p * RPP * GROUP, a + g + p * pass);
      copy_in<T, COPY>(s + (T_TILE + p * RPP) * GROUP, b + g + p * pass);
    }
  }
}

// Batch row y of the channel group blockIdx.x.
template <typename T, int COPY>
__device__ __forceinline__ void rglru_row(const T* __restrict__ a,
                                          const T* __restrict__ b,
                                          const float* __restrict__ h0,
                                          T* __restrict__ h,
                                          float* __restrict__ h_last,
                                          int t_len, int w_len, int y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr bool STAGED = COPY == VEC16;  // h staged a tile in shared memory
  T* hbuf = ring + STAGES * SLOT;         // [T_TILE][GROUP] of h where STAGED
  const int lane = threadIdx.x & 31;
  const bool chain = threadIdx.x < 32, copier = !chain;
  const int w0 = blockIdx.x * GROUP;
  const int cols = min(GROUP, w_len - w0);
  const bool live = chain && lane < cols;
  const size_t base = (size_t)y * t_len * w_len + w0;
  const size_t chan = (size_t)y * w_len + w0 + lane;
  const int tiles = (t_len + T_TILE - 1) / T_TILE;

  if (copier) {
#pragma unroll
    for (int k = 0; k < STAGES - 1; ++k) {
      if (k < tiles)
        fill<T, COPY>(ring + k * SLOT, a, b, base, k * T_TILE, t_len, w_len,
                      cols, lane);
      cp_async_commit();
    }
  }
  float hc = (live && h0) ? h0[chan] : 0.0f;
  T* hp = h + base + (STAGED ? 0 : lane);
  for (int k = 0; k < tiles; ++k) {
    // tile k has landed (each copier waits for its own copies, the barrier
    // publishes them) and every lane is done with tile k - 1's slot
    if (copier) cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (copier) {
      const int n = k + STAGES - 1;
      if (n < tiles)
        fill<T, COPY>(ring + (n % STAGES) * SLOT, a, b, base, n * T_TILE,
                      t_len, w_len, cols, lane);
      cp_async_commit();
    }
    if (chain) {
      const T* sa = ring + (k % STAGES) * SLOT + lane;
      const T* sb = sa + T_TILE * GROUP;
      const int steps = min(T_TILE, t_len - k * T_TILE);
      float av[T_TILE], bv[T_TILE];
#pragma unroll
      for (int j = 0; j < T_TILE; ++j) {
        av[j] = to_f(sa[j * GROUP]);
        bv[j] = to_f(sb[j * GROUP]);
      }
#pragma unroll
      for (int j = 0; j < T_TILE; ++j) {
        if (j < steps) {
          const float at = fminf(fmaxf(av[j], 1e-37f), 1.0f);
          hc = __fadd_rn(__fmul_rn(at, hc), bv[j]);
          // every lane stages its h (columns past cols are never stored):
          // a store predicated on live slowed the walk by half at
          // (2, 2112, 2560)
          if (STAGED)
            store(hbuf + j * GROUP + lane, hc);
          else if (live)
            store(hp + (size_t)j * w_len, hc);
        }
      }
      if constexpr (STAGED) {
        // the tile's h rows out of shared memory, 16 bytes a lane: lane
        // stores column (lane % CPR) E of rows lane / CPR, + RPP, ...
        // (cols is a multiple of E here, so every staged column is live)
        constexpr int E = 16 / (int)sizeof(T);
        constexpr int CPR = GROUP / E;
        constexpr int RPP = 32 / CPR;
        const int r0 = lane / CPR, c = (lane % CPR) * E;
        __syncwarp();
        if (c < cols) {
#pragma unroll
          for (int p = 0; p < T_TILE / RPP; ++p) {
            const int r = r0 + p * RPP;
            if (r < steps)
              *reinterpret_cast<int4*>(hp + (size_t)r * w_len + c) =
                  *reinterpret_cast<const int4*>(hbuf + r * GROUP + c);
          }
        }
      }
      hp += (size_t)T_TILE * w_len;
    }
  }
  if (live) h_last[chan] = hc;
}

// A grid's y stops at 65,535: a CTA takes batch rows blockIdx.y, blockIdx.y
// + gridDim.y, ... (one, up to 65,535 rows), each walked as one row a CTA
// walks it; the producer warp primes the ring again for each row, once
// every lane is done with the last row's slots.
template <typename T, int COPY>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ h0, T* __restrict__ h,
             float* __restrict__ h_last, int t_len, int w_len, int batch) {
  for (int y = blockIdx.y; y < batch; y += gridDim.y) {
    if (y != (int)blockIdx.y) __syncthreads();
    rglru_row<T, COPY>(a, b, h0, h, h_last, t_len, w_len, y);
  }
}

// The widest copy the rows and base pointers allow; a host-side copy of
// this choice is in tests/test_torch_rglru_tiles.py.
template <typename T>
int copy_width(const T* a, const T* b, const T* h, int w_len) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(a) |
                      reinterpret_cast<uintptr_t>(b) |
                      reinterpret_cast<uintptr_t>(h);
  const size_t row = (size_t)w_len * sizeof(T);
  if (row % 16 == 0 && p % 16 == 0) return VEC16;
  return ELEM;
}

template <typename T, int COPY>
int launch_copy(const T* a, const T* b, const float* h0, T* h, float* h_last,
                int batch, int t_len, int w_len, cudaStream_t stream) {
  // the ring and, where staged, one tile of h
  constexpr size_t smem =
      (size_t)(2 * STAGES + (COPY == VEC16)) * T_TILE * GROUP * sizeof(T);
  static_assert(smem <= 48 * 1024, "the ring fits the default shared memory");
  const dim3 grid((unsigned)((w_len + GROUP - 1) / GROUP),
                  (unsigned)(batch < 65535 ? batch : 65535));
  rglru_kernel<T, COPY><<<grid, THREADS, smem, stream>>>(a, b, h0, h, h_last,
                                                         t_len, w_len, batch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* a, const T* b, const float* h0, T* h, float* h_last,
           int batch, int t_len, int w_len, void* stream) {
  if (batch < 0 || t_len < 0 || w_len < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || w_len == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (copy_width<T>(a, b, h, w_len) == VEC16)
    return launch_copy<T, VEC16>(a, b, h0, h, h_last, batch, t_len, w_len, s);
  return launch_copy<T, ELEM>(a, b, h0, h, h_last, batch, t_len, w_len, s);
}

}  // namespace

extern "C" {

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rglru_scan_f32(const float* a, const float* b, const float* h0, float* h,
                   float* h_last, int batch, int t_len, int w_len,
                   void* stream) {
  return launch<float>(a, b, h0, h, h_last, batch, t_len, w_len, stream);
}
int rglru_scan_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                    const float* h0, __nv_bfloat16* h, float* h_last,
                    int batch, int t_len, int w_len, void* stream) {
  return launch<__nv_bfloat16>(a, b, h0, h, h_last, batch, t_len, w_len,
                               stream);
}

}  // extern "C"
