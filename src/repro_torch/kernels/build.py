"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into a shared library with a plain C
entry point, loaded with ``ctypes`` and called through ``launch``; no
PyTorch headers are involved, so a build takes seconds, and ``load_all``
runs one ``nvcc`` per source at once.  Libraries land in ``build/repro_torch/`` at the root
of the checkout, named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads from disk.

Flags: ``sm_90a`` for Hopper, ``-O3``, and no ``--use_fast_math`` /
``-ftz=true`` — the pruning kernels compare IEEE f32 values, denormals
included.  ``-Xptxas -v``: each kernel's registers, shared memory and
spills, kept beside the library (``ptxas_log``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_entries: Dict[str, Callable] = {}          # name -> bound C entry point


class KernelError(RuntimeError):
    """A CUDA kernel failed to build, was handed inputs it does not take,
    or failed to launch.  Never a degradation: the serving layer lets it
    through instead of demoting the work to a host rung."""


def check_tensor(name: str, t, dtype, shape, device,
                 rows: bool = False) -> None:
    """Raise ``KernelError`` unless ``t`` is a contiguous tensor of this
    dtype and shape on this device: what every kernel's wrapper checks
    before it launches.  ``rows=True`` also takes a 2-D block of wider
    rows: each row contiguous, the row stride the caller's to check."""
    if not isinstance(t, torch.Tensor):
        raise KernelError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype:
        raise KernelError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelError(f"{name} must have shape {tuple(shape)}, "
                          f"got {tuple(t.shape)}")
    if t.device != device:
        raise KernelError(f"{name} is on {t.device}, expected {device}")
    if rows and t.dim() == 2 and (t.shape[1] <= 1 or t.stride(1) == 1):
        return
    if not t.is_contiguous():
        raise KernelError(f"{name} must be contiguous")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(names) -> None:
    """Compile the missing libraries of ``names``, one ``nvcc`` process
    per source, all started together."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            out.with_suffix(".ptxas").write_text(log)
            os.replace(tmp, out)         # atomic: a reader never sees half
    if failed:
        raise KernelError("\n".join(failed))


def ptxas_log(name: str) -> str:
    """What ``ptxas -v`` said when ``csrc/<name>.cu`` was built."""
    return library_path(name).with_suffix(".ptxas").read_text()


def load_all(names) -> None:
    """Build every missing library of ``names`` in parallel, then load
    them all and resolve their entry points."""
    with _lock:
        _compile([n for n in names if n not in _entries])
        for name in names:
            if name not in _entries:
                lib = ctypes.CDLL(str(library_path(name)))
                fn = getattr(lib, f"{name}_launch")
                fn.restype = ctypes.c_int
                _entries[name] = fn


def entry(name: str):
    """The C entry point ``<name>_launch`` of ``csrc/<name>.cu`` (built at
    first use): device pointers and C ints in, a ``cudaError_t`` out."""
    if name not in _entries:
        load_all([name])
    return _entries[name]


def runs_kernel(device) -> bool:
    """Which version a wrapper runs on ``device``: the CUDA kernel (True)
    or, on the CPU, the plain version (False).  Any other device raises."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise KernelError(f"unsupported device {device}")
    return True


def launch(name: str, device, *args) -> None:
    """Launch the kernel of ``csrc/<name>.cu`` on ``device``, on PyTorch's
    current stream.  Tensors pass as device pointers, Python floats as C
    floats (the caller rounds them to f32 first) and ints as C ints (each
    must fit in int32); a CUDA error from the launch raises
    ``KernelError``."""
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            cargs.append(ctypes.c_void_p(a.data_ptr()))
        elif isinstance(a, float):
            cargs.append(ctypes.c_float(a))
        elif -2 ** 31 <= int(a) < 2 ** 31:
            cargs.append(ctypes.c_int(int(a)))
        else:
            raise KernelError(f"{name}: dimension {a} does not fit in int32")
    fn = entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*cargs, ctypes.c_void_p(stream))
    if err != 0:
        raise KernelError(f"{name} launch failed: cudaError {err}")
