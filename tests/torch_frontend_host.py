"""csrc/frontend.cu built for the host with g++, so the CPU tests run the
kernels' own arithmetic without a card.

The CUDA it uses is stood in for: each __*_rn intrinsic is the IEEE
operation it names (compiled with -ffp-contract=off, so nothing is
contracted into an FMA, as on the card), rsqrtf is 1 / sqrtf, a launch
runs its blocks one after another with one std::thread per CUDA thread,
and __syncthreads / __shfl_down_sync meet at a barrier of the block.
expf, logf and the reciprocal square root are the host's, so the columns
agree with the card's to an ulp or two, not bit for bit.

`host_library(out_dir)` builds the library and returns its path;
`on_host(monkeypatch, lib)` makes ops/frontend.py's wrappers launch it on
CPU tensors.
"""

import contextlib
import ctypes
import re
import subprocess
from pathlib import Path

import torch

from instantsplat_tpu_torch.ops import cuda_build
from instantsplat_tpu_torch.ops import frontend as FE

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
#define __shared__ static
typedef void* cudaStream_t;
struct host_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local host_dim3 threadIdx, blockIdx;
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int cudaGetLastError() { return 0; }
inline std::barrier<>* host_barrier = nullptr;
inline float host_lanes[1024];
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
inline float __shfl_down_sync(unsigned, float x, int offset) {
  const int t = threadIdx.x;
  host_barrier->arrive_and_wait();
  host_lanes[t] = x;
  host_barrier->arrive_and_wait();
  return (t & 31) + offset < 32 ? host_lanes[t + offset] : x;
}
template <class F> void host_launch(int grid, int block, F fn) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> barrier(block);
    host_barrier = &barrier;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, b, t] { threadIdx.x = t; blockIdx.x = b; fn(); });
    for (auto& th : threads) th.join();
  }
}
"""

_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<(.*?),\s*(.*?),\s*0,\s*(.*?)>>>\(",
                     re.S)


def host_source() -> str:
    """frontend.cu with the shim included and each kernel<<<grid, block,
    0, stream>>>(args) launch made host_launch(grid, block, ...)."""
    src = (cuda_build.CSRC / "frontend.cu").read_text().replace(
        "#include <cuda_runtime.h>", '#include "host_shim.h"')
    out, pos = [], 0
    for m in _LAUNCH.finditer(src):
        if m.start() < pos:
            continue
        depth, end = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[end], 0)
            end += 1
        out += [src[pos:m.start()], f"host_launch({m[2]}, {m[3]}, [&]() {{ "
                f"{m[1]}({src[m.end():end - 1]}); }})"]
        pos = end
    if len(out) != 6:
        raise AssertionError(f"frontend.cu: {len(out) // 2} launches found, "
                             "3 expected")
    return "".join(out) + src[pos:]


def host_library(out_dir: Path) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "host_shim.h").write_text(SHIM)
    (out_dir / "frontend_host.cpp").write_text(host_source())
    lib = out_dir / "libfrontend_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", "-o", str(lib),
                    str(out_dir / "frontend_host.cpp")], check=True,
                   capture_output=True)
    return lib


def on_host(monkeypatch, lib: Path):
    """ops/frontend.py's wrappers launch the host library on CPU tensors."""
    monkeypatch.setitem(cuda_build._loaded, "frontend.cu",
                        ctypes.CDLL(str(lib)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(FE, "_stream", lambda: 0)
