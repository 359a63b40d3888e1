"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into a shared library with a plain C
entry point, loaded with ``ctypes``; no PyTorch headers are involved, so a
build takes seconds.  Libraries land in ``build/repro_torch/`` at the root
of the checkout, named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads from disk.

Flags: ``sm_90a`` for Hopper, ``-O3``, and no ``--use_fast_math`` /
``-ftz=true`` — the pruning kernels compare IEEE f32 values, denormals
included.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A CUDA kernel failed to build, was handed inputs it does not take,
    or failed to launch.  Never a degradation: the serving layer lets it
    through instead of demoting the work to a host rung."""


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


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    with _lock:
        if name not in _loaded:
            out = library_path(name)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise KernelError(
                        f"{name}: nvcc exit {proc.returncode}\n"
                        f"{proc.stdout.decode(errors='replace')}")
                os.replace(tmp, out)     # atomic: a reader never sees half
            _loaded[name] = ctypes.CDLL(str(out))
        return _loaded[name]
