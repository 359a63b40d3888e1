"""Batched serving: prefill + decode loop with greedy/temperature sampling.

``Generator`` drives the model's prefill and decode steps from the host:
prefill the prompt batch, then step the decode function, which writes each
step's K/V into the cache in place (PyTorch runs eagerly: no ``jit``, no
donated buffers).  The counterpart of the JAX package's
``serve/serve_step.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.device_stats import resolve_device
from ..models.model import Model


@dataclasses.dataclass
class Generator:
    model: Model
    params: object
    max_seq: int = 256
    device: object = None      # None: the GPU (raises without one); "cpu"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @torch.no_grad()
    def generate(
        self,
        tokens: np.ndarray,                 # [B, S] prompt
        steps: int,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
        prefix=None,
    ) -> np.ndarray:
        """Generate ``steps`` tokens a row; returns them as [B, steps]
        int64.

        ``prefix`` [B, n_prefix, d_model] (an array or a tensor) is the
        ``vlm``'s patch embeddings or the ``encdec``'s frames.  A ``vlm``
        puts it before the prompt, so its first decode position is S +
        n_prefix; an ``encdec`` encodes it apart, and decodes from S.

        Greedy (argmax) unless ``temperature > 0`` and a ``generator`` is
        given: then each token is drawn from softmax(logits / temperature)
        with that ``torch.Generator`` (not JAX's bits for the same seed;
        it takes the place of the JAX version's ``key``).
        """
        dev = self.device
        tokens = torch.as_tensor(np.asarray(tokens), device=dev)
        B, S = tokens.shape
        batch = {"tokens": tokens}
        pos0 = S
        if prefix is not None:
            batch["prefix"] = torch.as_tensor(prefix, device=dev)
            if self.model.cfg.family == "vlm":
                pos0 += batch["prefix"].shape[1]
        logits, cache = self.model.prefill_fn(self.params, batch,
                                              self.max_seq)
        out = []
        tok = self._sample(logits, temperature, generator)
        for i in range(steps):
            out.append(tok)
            position = torch.full((B,), pos0 + i, dtype=torch.int64,
                                  device=dev)
            logits, cache = self.model.decode_fn(self.params, cache, tok,
                                                 position)
            tok = self._sample(logits, temperature, generator)
        if not out:
            return np.zeros((B, 0), dtype=np.int64)
        return torch.cat(out, dim=1).long().cpu().numpy()

    @staticmethod
    def _sample(logits, temperature, generator):
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
