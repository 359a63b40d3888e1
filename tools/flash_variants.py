#!/usr/bin/env python3
"""Time variants of the port's bf16 flash-attention kernel side by side.

    python3 tools/flash_variants.py [--json PATH]

Needs one CUDA card and ``nvcc``.  Each variant is an edited copy of
``src/repro_torch/kernels/csrc/flash_attention.cu`` (a design constant
changed by text substitution), built with the port's own flags into
``build/flash_variants/`` and called through the port's launcher.  Every
variant is first held to the plain version within the bf16 bound at a
ragged causal shape, then timed (CUDA events, L2 flushed) at the serving
prefill's shape, BH = 128, S = 2048, causal, at D = 128 and 64, in turns
(forward, then backward over the variants) so that a drift of the card's
clock does not favour one of them.  Prints the card's name and power
limit and one line a (variant, D) with both times.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from kernel_variants import compile_all, edited, time_in_turns, write_json

ROOT = Path(__file__).resolve().parents[1]

RESCALE = """#pragma unroll
          for (int n = 0; n < ND; ++n) {
            acc[mt][n][2 * h] *= corr;
            acc[mt][n][2 * h + 1] *= corr;
          }
"""
# name -> (what it changes, [(text in the source, its replacement)])
VARIANTS = {
    "as built": ("the source as it is", []),
    "one row tile": ("16 query rows a warp at every DP (64-row blocks)", [
        ("static constexpr int MT = DP <= 128 ? 2 : 1;",
         "static constexpr int MT = 1;")]),
    "32-key tiles": ("key tiles of 32 at DP = 64 and 128", [
        ("static constexpr int BK = DP > 192 ? 32 : 64;",
         "static constexpr int BK = DP > 192 || DP % 64 == 0 ? 32 : 64;")]),
    "mask every tile": ("the causal and length mask applied to every tile, "
                        "not only to those that cross the diagonal or Sk", [
        ("      if (edge) {", "      if (true) {")]),
    "skip unit rescales": ("no rescale where all of a warp's corr are 1", [
        (RESCALE, "          if (!__all_sync(0xffffffffu, corr == 1.0f)) {\n"
                  + RESCALE + "          }\n")]),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="also write the times here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import flash_attention_ref

    card = cs.card_line()
    dev = torch.device("cuda")
    src = (build.CSRC / "flash_attention.cu").read_text()
    compile_all({f"variant: {name}": ("flash_attention",
                                      edited(src, subs, name))
                 for name, (_what, subs) in VARIANTS.items()},
                ROOT / "build" / "flash_variants")

    def run(name, q, k, v, causal=True):
        o = torch.empty_like(q)
        BH, Sq, D = q.shape
        build.launch(f"variant: {name}", dev, q, k, v, o, BH, Sq,
                     int(k.shape[1]), D, int(causal), 1, float(D) ** -0.5)
        return o

    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((3, S, 100), generator=gen, device=dev).bfloat16()
               for S in (130, 300, 300))
    want = flash_attention_ref(q, k, v, causal=True)
    for name in VARIANTS:
        cs.require_close(name, run(name, q, k, v), want,
                         cs.FLASH_TOL["bfloat16"], "BH=3 Sq=130 Sk=300 D=100")
    times = {}
    for D in (128, 64):
        q, k, v = (torch.randn((128, 2048, D), generator=gen, device=dev)
                   .bfloat16() for _ in range(3))
        _ms, _by, ops_n = cs.flash_bound(128, 2048, 2048, D, True, 2)
        got = time_in_turns({name: lambda name=name: run(name, q, k, v)
                             for name in VARIANTS}, 10)
        for name, t in got.items():
            times[f"{name}, D={D}"] = t
            print(f"[variants] {card}: D={D} {name} ({VARIANTS[name][0]}): "
                  f"{t[0]:.4f} / {t[1]:.4f} ms, "
                  f"{ops_n / (min(t) * 1e9):.1f} TFLOP/s at the faster",
                  flush=True)
    print(card)
    if args.json:
        write_json(args.json, dict(card=card, ms=times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
