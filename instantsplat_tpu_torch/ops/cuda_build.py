"""Build and load the package's CUDA sources (plain C interface, ctypes).

`load_library("rasterize.cu")` compiles csrc/rasterize.cu with nvcc for
sm_90a into build/instantsplat_tpu_torch/<name>-<hash>/ under the repository
root, keyed by a hash of the source, of every header of csrc/ (the sources
share compositor.cuh; an edited header must not load a stale library) and
of the flags, and loads it. The
compiler's `-Xptxas -v` report (registers, shared memory, spills) is kept
beside the library. A missing nvcc or a failed build raises; nothing falls
back to another implementation. Each compile (not a cached library)
counts in the counter `cuda_build.builds` (utils/profiling.py).
`Kernel` is one entry point of such a library, called through ctypes and
counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from instantsplat_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "instantsplat_tpu_torch"
# no --use_fast_math: approximate expf/log1pf move pixels across the 1/255
# and 1e-4 thresholds
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "$CUDA_HOME/bin, default /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def headers() -> list[Path]:
    """The headers of csrc/, which any source may include."""
    return sorted(CSRC.glob("*.cuh"))


def library_path(source: str) -> Path:
    h = hashlib.sha256()
    for path in (CSRC / source, *headers()):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    stem = Path(source).stem
    return BUILD_ROOT / f"{stem}-{digest[:16]}" / f"lib{stem}.so"


def build(source: str) -> Path:
    """Compile csrc/<source> unless the cached library exists; returns its
    path. The ptxas report is written to <library>.ptxas.txt."""
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    Path(str(out) + ".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    profiling.count("cuda_build.builds")
    return out


def ptxas_report(source: str) -> str:
    return Path(str(library_path(source)) + ".ptxas.txt").read_text()


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and dlopen csrc/<source>, once per process."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        _loaded[source] = lib
    return lib


class Kernel:
    """One CUDA entry point of csrc/<source>: its ctypes signature and a
    launch count.

    A call made while the current stream is being captured into a CUDA
    graph (utils/cuda_graphs.py) launches nothing: it is counted in
    `captured`, and every replay of that graph adds its launches to
    `launches` (`replayed`), so `launches` counts what ran on the device."""

    registry: list = []  # every Kernel, in the order defined

    def __init__(self, name: str, argtypes, source: str = "rasterize.cu"):
        self.name = name
        self.argtypes = argtypes
        self.source = source
        self.launches = 0  # incremented once per kernel launch
        self.captured = 0  # calls recorded into the graph being captured
        Kernel.registry.append(self)

    def __call__(self, *args):
        fn = getattr(load_library(self.source), self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed "
                               f"(cudaError {err})")

    def replayed(self, n: int):
        """`n` launches of this kernel by replays of a captured graph."""
        self.launches += n
