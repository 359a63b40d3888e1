"""What the variant-timing tools share: edited copies of a kernel's source,
built side by side, and times taken in turns.

``tools/flash_variants.py``, ``tools/prune_variants.py`` and
``tools/per_query_variants.py`` import it.
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


def parent_jobs(parent, kernels) -> dict:
    """``"<kernel>: parent" -> (kernel, source)`` for each of ``kernels``
    whose source in the checkout at ``parent`` differs from this one's:
    the sources to build and time beside the checkout's.  A source that
    is the same would only be timed twice; each differing one is called
    through the checkout's entry point, so its signature is the same."""
    from repro_torch.kernels import build

    if not parent:
        return {}
    csrc = Path(parent) / "src" / "repro_torch" / "kernels" / "csrc"
    jobs = {}
    for kernel in kernels:
        text = (csrc / f"{kernel}.cu").read_text()
        if text != (build.CSRC / f"{kernel}.cu").read_text():
            jobs[f"{kernel}: parent"] = (kernel, text)
    return jobs


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


# Cycles of the device-side spin ``spin_ms`` queues ahead of each run:
# ~0.5 ms at the H100's clock, longer than a wrapper's host enqueue.
SPIN_CYCLES = 1_000_000


def spin_ms(fn, reps: int) -> float:
    """``chip_smoke.cuda_ms`` with a device-side spin (``torch.cuda._sleep``)
    between the L2 flush and the start event: the card is busy while the
    host enqueues the events and ``fn``'s launches, so the events time the
    device alone, not the enqueue."""
    import torch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for e0, e1 in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / reps


def profile_device_us(fn, reps: int = 10) -> dict:
    """Kernel name -> mean device microseconds a call of ``fn``, from
    ``torch.profiler`` over ``reps`` calls, the L2 flushed before each
    (the flush's own kernel left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        name = re.search(r"(\w+(?:<\w+>)?)\(", e.key)
        if us and name and "FillFunctor<unsigned char>" not in e.key \
                and not e.key.startswith(("aten::", "cuda", "Activity")):
            out[name.group(1)] = us / reps
    return out


def time_in_turns(calls: dict, reps: int, timer=None) -> dict:
    """name -> [ms forward, ms backward]: ``timer`` (``chip_smoke.cuda_ms``
    unless given) of each call over ``reps`` runs, the calls taken in order
    and then in reverse, so that a drift of the card's clock favours none
    of them."""
    import chip_smoke as cs

    timer = timer or cs.cuda_ms
    times = {}
    for name in list(calls) + list(calls)[::-1]:
        times.setdefault(name, []).append(timer(calls[name], reps))
    return times


def write_json(path, obj) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(obj, indent=1))
