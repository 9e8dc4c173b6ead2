"""A guard against host reads inside the steps of a device-resident loop
(instantsplat_tpu_torch/utils/cuda_graphs.StepLoop), usable on the CPU.

On a card a StepLoop captures one step into a CUDA graph after WARMUP
eager steps; a step that reads a device value on the host (`.item()`,
`bool(t)`, `float(t)`, `.tolist()`, `.cpu()`, `.numpy()`, `int(t)`) or
builds a tensor from host data (`torch.tensor`, `torch.as_tensor` of a
number or a list: a pageable copy to the card) either breaks the capture
or freezes the value it read into the graph. The operators that read a
device value inside PyTorch's own C++ (a scalar's value, `nonzero`,
`masked_select`, `unique`, as the backwards of `prod` and `cumprod` do)
are refused too, through a dispatch mode that sees every operator a step
dispatches, its backward included. `guarded_loops()` runs every
StepLoop's steps after its first WARMUP with those calls raising, so the
CPU tests find such a read before the card does. The kernels' plain
versions (what a wrapper runs for a CPU tensor; on a card the kernel runs
instead) may read the host. Imported by tests/test_torch_capture_guard.py
and tests/torch_parallel_worker.py.
"""

import contextlib

import torch
import torch.utils._python_dispatch

from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP, StepLoop

READS = ("item", "__bool__", "__float__", "__int__", "tolist", "cpu",
         "numpy")


# the plain versions of the kernels, by module: they stand in for the
# kernels on the CPU only
PLAIN = {"instantsplat_tpu_torch.ops.rasterize_pallas": ("composite_plain",
                                                         "scan_plain"),
         "instantsplat_tpu_torch.ops.rasterize_lists": (
             "composite_lists_plain",)}

_allowed = [0]  # > 0 inside a kernel's plain version

# operators whose result on a card needs a device value on the host
SYNCING_OPS = ("_local_scalar_dense", "is_nonzero", "equal", "nonzero",
               "masked_select", "_unique", "_unique2", "unique_dim",
               "unique_consecutive", "unique_dim_consecutive")


class _SyncingOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, where):
        super().__init__()
        self.where = where

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if not _allowed[0] and (name in SYNCING_OPS or (
                name == "repeat_interleave"
                and (kwargs or {}).get("output_size") is None)):
            raise HostRead(f"{self.where}: aten.{name} inside a step")
        return func(*args, **(kwargs or {}))


class HostRead(RuntimeError):
    pass


@contextlib.contextmanager
def no_host_reads(where: str):
    """Inside, the host reads of READS and host-data tensor construction
    raise HostRead naming `where`."""
    saved = {name: getattr(torch.Tensor, name) for name in READS}
    made = {name: getattr(torch, name) for name in ("tensor", "as_tensor")}

    def refuse(name):
        def read(self, *a, **k):
            if _allowed[0]:
                return saved[name](self, *a, **k)
            raise HostRead(f"{where}: Tensor.{name} inside a step")
        return read

    def from_host(name):
        def make(data, *a, **k):
            if not torch.is_tensor(data) and not _allowed[0]:
                raise HostRead(f"{where}: torch.{name} of host data inside "
                               "a step")
            return made[name](data, *a, **k)
        return make

    for name in READS:
        setattr(torch.Tensor, name, refuse(name))
    for name in made:
        setattr(torch, name, from_host(name))
    try:
        with _SyncingOps(where):
            yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        for name, fn in made.items():
            setattr(torch, name, fn)


@contextlib.contextmanager
def guarded_loops():
    """Every StepLoop's Python loop (the CPU path) runs its steps after
    the loop's first WARMUP under no_host_reads. Yields {loop name: steps
    run guarded}."""
    import importlib

    guarded: dict = {}
    real = StepLoop._loop
    plain = [(importlib.import_module(m), name) for m, names in PLAIN.items()
             for name in names]
    saved = [getattr(module, name) for module, name in plain]

    def allowed(fn):
        def call(*a, **k):
            _allowed[0] += 1
            try:
                return fn(*a, **k)
            finally:
                _allowed[0] -= 1
        return call

    def loop(self, n):
        out = None
        for _ in range(n):
            done = getattr(self, "_guard_steps", 0)
            self._guard_steps = done + 1
            if done < WARMUP:
                out = self.step()
                continue
            with no_host_reads(self.name):
                out = self.step()
            guarded[self.name] = guarded.get(self.name, 0) + 1
        return out

    StepLoop._loop = loop
    for (module, name), fn in zip(plain, saved):
        setattr(module, name, allowed(fn))
    try:
        yield guarded
    finally:
        StepLoop._loop = real
        for (module, name), fn in zip(plain, saved):
            setattr(module, name, fn)
