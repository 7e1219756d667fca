#!/usr/bin/env python3
"""Measure what a warp's 16-byte shared-memory load costs on the card,
by the pattern of addresses its lanes read.

    python3 scripts/smem_bench.py

Builds a small CUDA kernel with nvcc into ``build/smem_bench/`` and
runs one CTA of 16 warps on each SM.  Each warp issues 16-byte
``ld.volatile.shared`` loads in a loop; the kernel's own clock gives
loads per SM clock, printed as shared clocks a load (the SM serves 128
bytes a clock).  Patterns (lane l, addresses in floats):

* ``distinct``: 32 distinct 16-byte chunks (512 bytes);
* ``quarter_broadcast``: one address per quarter-warp, four in all
  (the Q and P reads of ``csrc/flash_attention.cu``);
* ``warp_broadcast``: one address for the whole warp;
* ``quarter_repeat``: 8 consecutive chunks (128 bytes), the same in all
  four quarter-warps (a V read with 8 lanes to a row);
* ``rows_stride68``: 8 rows 68 floats apart, the same in all four
  quarter-warps (a K read of the flash kernel's score layout).

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

SRC = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(512, 1) lds_kernel(float* out, long long* cyc, int iters, int mode) {
  __shared__ __align__(16) float sm[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sm[i] = i * 1e-6f;
  __syncthreads();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  int off = mode == 0 ? lane * 4 : mode == 1 ? (lane / 8) * 68
          : mode == 2 ? 0 : mode == 3 ? (lane % 8) * 4 : (lane % 8) * 68;
  off += (w % 4) * 1024;
  const unsigned base = (unsigned)__cvta_generic_to_shared(sm + off);
  float a = 0.f;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float x, y, z, v;
      asm volatile("ld.volatile.shared.v4.f32 {%0,%1,%2,%3}, [%4];"
                   : "=f"(x), "=f"(y), "=f"(z), "=f"(v)
                   : "r"(base + u * 16));
      if (u == 7 && it == iters - 1) a = x + y + z + v;
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = a;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
extern "C" int run(int mode, int iters, int sms, long long* cycles) {
  float* out; long long* cyc;
  cudaMalloc(&out, sizeof(float) * sms * 512);
  cudaMalloc(&cyc, sizeof(long long) * sms);
  lds_kernel<<<sms, 512>>>(out, cyc, 16, mode);
  lds_kernel<<<sms, 512>>>(out, cyc, iters, mode);
  long long* h = new long long[sms];
  cudaMemcpy(h, cyc, sizeof(long long) * sms, cudaMemcpyDeviceToHost);
  long long sum = 0;
  for (int i = 0; i < sms; ++i) sum += h[i];
  *cycles = sum / sms;
  delete[] h;
  cudaFree(out); cudaFree(cyc);
  return (int)cudaGetLastError();
}
"""

PATTERNS = ("distinct", "quarter_broadcast", "warp_broadcast",
            "quarter_repeat", "rows_stride68")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
    work = root / "build" / "smem_bench"
    work.mkdir(parents=True, exist_ok=True)
    (work / "lds.cu").write_text(SRC)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    nvcc = nvcc if os.path.isfile(nvcc) else shutil.which("nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(work / "lds.so"), str(work / "lds.cu")], check=True)
    lib = ctypes.CDLL(str(work / "lds.so"))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4000
    res = {"device": torch.cuda.get_device_name(0), "sms": sms}
    for mode, name in enumerate(PATTERNS):
        cyc = ctypes.c_longlong()
        err = lib.run(mode, iters, sms, ctypes.byref(cyc))
        if err:
            raise SystemExit(f"launch failed: cudaError {err}")
        loads = 16 * iters * 8             # 16 warps, 8 loads an iteration
        res[name] = {"loads_per_clock": loads / cyc.value,
                     "clocks_per_load": cyc.value / loads}
        print(f"{name:18s} {loads / cyc.value:.3f} warp loads a clock, "
              f"{cyc.value / loads:.2f} clocks a load")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
