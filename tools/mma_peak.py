#!/usr/bin/env python3
"""The rate the card's tensor cores reach through ``mma.sync`` m16n8k8, in
TF32 (fp32 accumulate) and in fp64 (DMMA), the instruction the GBATC kernels
past D = 128 run (``kernels/csrc/gbatc_kernels.cu``).

Builds a small kernel of back-to-back MMAs into independent accumulators
(CHAINS a warp, registers only: no loads, no stores in the loop) with the
package's ``nvcc`` flags into ``build/mma_peak/`` and times it with CUDA
events at one and two CTAs of 256 threads an SM. One JSON line a case with
its TFLOP/s (2 x 16 x 8 x 8 operations an MMA), and the card's name and
power limit. These are the ceilings the kernels' notes and ``PERF.md``
compare them with (the data sheet's 495 TFLOP/s TF32 is wgmma's). Needs one
H100-class card::

    python3 tools/mma_peak.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

OUT = os.path.join(ROOT, "build", "mma_peak")
CHAINS = 16
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CH>
__global__ void tf32_peak(float* out, int iters) {
  float c[CH][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = 1u, a2 = 2u, a3 = 3u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CH; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
                   "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(5u + i), "r"(7u));
  float s = 0.f;
  for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int CH>
__global__ void f64_peak(double* out, int iters) {
  double c[CH][4] = {};
  const double a0 = threadIdx.x, a1 = 1.0, a2 = 2.0, a3 = 3.0;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CH; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
                   "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+d"(c[j][0]), "+d"(c[j][1]), "+d"(c[j][2]), "+d"(c[j][3])
                   : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(5.0 + i), "d"(7.0));
  double s = 0.0;
  for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(int f64, void* out, int iters, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64) f64_peak<CHAINS><<<blocks, 256, 0, st>>>((double*)out, iters);
  else tf32_peak<CHAINS><<<blocks, 256, 0, st>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
""".replace("CHAINS", str(CHAINS))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tools/mma_peak.py: needs a CUDA device")
    os.makedirs(OUT, exist_ok=True)
    src, lib = os.path.join(OUT, "mma_peak.cu"), os.path.join(OUT, "libmma_peak.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True, timeout=300)
    fn = ctypes.CDLL(lib).mma_peak
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * 256, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(cs.gpu_line(), flush=True)
    for f64, iters in ((0, 4000), (1, 1000)):
        for per_sm in (1, 2):
            blocks = per_sm * sms
            if fn(f64, out.data_ptr(), 10, blocks, stream):
                sys.exit("mma_peak failed to launch")
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(f64, out.data_ptr(), iters, blocks, stream)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
            mmas = blocks * 8 * iters * CHAINS
            print(json.dumps({"mma": "f64 m16n8k8" if f64 else "tf32 m16n8k8",
                              "ctas_an_sm": per_sm, "warps_an_sm": 8 * per_sm,
                              "chains_a_warp": CHAINS, "ms": ms,
                              "tflops": mmas * 2 * 16 * 8 * 8 / ms / 1e9}), flush=True)


if __name__ == "__main__":
    main()
