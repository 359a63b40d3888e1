"""End-to-end driver: pruned data curation feeding LM pre-training.

The paper's engine curates the corpus (filter pruning over shard
metadata), the training loop runs with checkpoint/restart, and the run
reports how much storage I/O pruning avoided.

CPU-scale by default (~20M params, 120 steps):
    PYTHONPATH=src python examples_torch/pruned_pretraining.py --device cpu
Full-scale (same code path, on the GPU):
    PYTHONPATH=src python examples_torch/pruned_pretraining.py --steps 500 \
        --batch 32 --seq 512
"""

import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main

# the JAX example's defaults
DEFAULT_ARGV = ["--steps", "120", "--batch", "8", "--seq", "128",
                "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                           "repro_torch_quick_ckpt")]


def main(argv=None, device=None):
    """Train with ``argv`` (the driver's flags; the JAX example's defaults
    when None) on ``device`` (None: the GPU; ``"cpu"`` for the CPU)."""
    argv = list(DEFAULT_ARGV if argv is None else argv)
    if device is not None:
        argv += ["--device", str(device)]
    return train_main(argv)


if __name__ == "__main__":
    args = sys.argv[1:]
    device = None
    if "--device" in args:             # the examples' shared flag
        at = args.index("--device")
        device = args[at + 1]
        del args[at:at + 2]
    main(args or None, device)
