"""The package's CUDA sources (csrc/frontend.cu, csrc/adam.cu) built for the
host with g++, so the CPU tests run the kernels' own arithmetic without a
card.

The CUDA they use is stood in for: each __*_rn intrinsic is the IEEE
operation it names (compiled with -ffp-contract=off, so nothing is
contracted into an FMA, as on the card), rsqrtf is 1 / sqrtf, a launch
runs its blocks one after another with one std::thread per CUDA thread,
__syncthreads, __syncthreads_or and __shfl_down_sync meet at a barrier of
the block, atomicOr is the host's atomic OR and cudaMemsetAsync a memset.
expf, logf and the reciprocal square root are the host's, so the front
end's columns agree with the card's to an ulp or two, not bit for bit.

`host_library(source, out_dir)` builds csrc/<source> and returns the
library's path; `on_host(monkeypatch, source, lib, module)` makes the
wrappers of `module` (ops/frontend.py, ops/adam.py) launch it on CPU
tensors.
"""

import contextlib
import ctypes
import re
import subprocess
from pathlib import Path

import torch

from instantsplat_tpu_torch.ops import cuda_build

SHIM = r"""
#pragma once
#include <atomic>
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
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int cudaGetLastError() { return 0; }
inline int cudaMemsetAsync(void* p, int value, size_t n, cudaStream_t) {
  std::memset(p, value, n);
  return 0;
}
inline int atomicOr(int* address, int value) {
  return __atomic_fetch_or(address, value, __ATOMIC_SEQ_CST);
}
inline std::barrier<>* host_barrier = nullptr;
inline float host_lanes[1024];
inline std::atomic<int> host_or{0};
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
inline int __syncthreads_or(int x) {
  host_barrier->arrive_and_wait();
  if (threadIdx.x == 0) host_or = 0;
  host_barrier->arrive_and_wait();
  if (x) host_or |= 1;
  host_barrier->arrive_and_wait();
  const int out = host_or;
  host_barrier->arrive_and_wait();
  return out;
}
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
# the kernel launches written in each source
LAUNCHES = {"frontend.cu": 3, "adam.cu": 3}


def host_source(source: str) -> str:
    """csrc/<source> with the shim included and each kernel<<<grid, block,
    0, stream>>>(args) launch made host_launch(grid, block, ...)."""
    src = (cuda_build.CSRC / source).read_text().replace(
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
    if len(out) != 2 * LAUNCHES[source]:
        raise AssertionError(f"{source}: {len(out) // 2} launches found, "
                             f"{LAUNCHES[source]} expected")
    return "".join(out) + src[pos:]


def host_library(source: str, out_dir: Path) -> Path:
    stem = Path(source).stem
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "host_shim.h").write_text(SHIM)
    (out_dir / f"{stem}_host.cpp").write_text(host_source(source))
    lib = out_dir / f"lib{stem}_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", "-o", str(lib),
                    str(out_dir / f"{stem}_host.cpp")], check=True,
                   capture_output=True)
    return lib


def on_host(monkeypatch, source: str, lib: Path, module):
    """`module`'s wrappers (its Kernels of csrc/<source>) launch the host
    library on CPU tensors."""
    monkeypatch.setitem(cuda_build._loaded, source, ctypes.CDLL(str(lib)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(module, "_stream", lambda: 0)
