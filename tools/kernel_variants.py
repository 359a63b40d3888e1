"""What the variant-timing tools share: edited copies of a kernel's source,
built side by side, and times taken in turns.

``tools/flash_variants.py`` and ``tools/prune_variants.py`` import it.
Every helper that builds or times needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
from pathlib import Path


def edited(text: str, subs, what: str) -> str:
    """``text`` with each (old, new) of ``subs`` substituted; exits when an
    ``old`` is not in it, so a stale edit never builds the source as it
    is under a variant's name."""
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{what}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def compile_all(jobs: dict, out: Path) -> dict:
    """Build each (label -> (kernel, source text)) into its own library
    with the port's flags, one nvcc each, all at once, and register its
    ``<kernel>_launch`` under ``label`` for ``build.launch``; label ->
    ptxas's register and spill lines."""
    from repro_torch.kernels import build

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, (kernel, text)) in enumerate(jobs.items()):
        cu, so = out / f"job{i}.cu", out / f"job{i}.so"
        cu.write_text(text)
        procs[label] = (kernel, so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    regs = {}
    for label, (kernel, so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{label}: nvcc exit {proc.returncode}\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), f"{kernel}_launch")
        fn.restype = ctypes.c_int
        build._entries[label] = fn
        regs[label] = "; ".join(m.group(0) for m in re.finditer(
            r"Used \d+ registers[^\n]*|\d+ bytes spill stores", log))
    return regs


def time_in_turns(calls: dict, reps: int) -> dict:
    """name -> [ms forward, ms backward]: ``chip_smoke.cuda_ms`` of each
    call over ``reps`` runs, the calls taken in order and then in reverse,
    so that a drift of the card's clock favours none of them."""
    import chip_smoke as cs

    times = {}
    for name in list(calls) + list(calls)[::-1]:
        times.setdefault(name, []).append(cs.cuda_ms(calls[name], reps))
    return times


def write_json(path, obj) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(obj, indent=1))
