"""Continuous batching: slot-based serving with per-request decode depth.

Requests are admitted into SLOTS as they arrive, every decode step
advances all active slots (each at its own position — the per-request
indexed write in ``layers.decode_attention``), and finished slots are
recycled at once.  The counterpart of the JAX package's
``serve/batcher.py``, with its fixes: an overlong prompt is rejected at
submit, a request can finish at admit time (``max_new=1``, or eos as the
first token) and then frees its slot for the queue, and a released slot's
``last_tok`` and position are zeroed.  Decoder-only LMs only: the
``ssm``, ``hybrid``, ``encdec`` and ``vlm`` families are refused, as the
JAX package refuses them.

Host-side control, device-side state: the slot caches are one batched
dict of tensors on the model's device, updated in place by the decode
step; a request's prefill is written into its slot with an in-place slice
write.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.model import Model, alloc_cache


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # prompt
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    def __init__(self, model: Model, params, n_slots: int = 4,
                 max_seq: int = 128, eos_id: Optional[int] = None):
        if model.cfg.family in ("ssm", "hybrid", "encdec", "vlm"):
            # their caches are not [L, slots, ...] K/V regions (the
            # hybrid's are [groups, attn_every, slots, ...], an encdec's
            # and a vlm's prefill needs a prefix): as the JAX package
            raise NotImplementedError(
                "slot-insert prefill is implemented for decoder-only LMs")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.device = params["embed"].device
        self.cache = alloc_cache(model.init_cache(n_slots, max_seq),
                                 self.device)
        self.positions = np.zeros(n_slots, dtype=np.int32)
        self.last_tok = np.zeros(n_slots, dtype=np.int32)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._rid = 0

    # -- API ----------------------------------------------------------------

    def submit(self, tokens: np.ndarray, max_new: int = 16) -> int:
        tokens = np.asarray(tokens, np.int32)
        if len(tokens) >= self.max_seq:
            # A slot's KV region holds max_seq positions and decode writes
            # at positions[slot] onward: admitting a longer prompt would
            # write past the slot's region.  Rejecting at submit keeps
            # _admit unconditional and the failure visible to the caller.
            raise ValueError(
                f"prompt of {len(tokens)} tokens exceeds slot capacity "
                f"{self.max_seq - 1} (max_seq={self.max_seq}, and decoding "
                f"needs at least one free position)")
        req = Request(self._rid, tokens, max_new)
        self._rid += 1
        self.queue.append(req)
        return req.rid

    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def run(self) -> Dict[int, List[int]]:
        """Drive until queue + slots drain; returns rid -> generated ids."""
        while self.queue or self.active():
            self._admit()
            self._step()
        return {rid: r.out for rid, r in self.finished.items()}

    # -- internals ----------------------------------------------------------

    def _write_slot(self, kv: Dict[str, torch.Tensor], slot: int) -> None:
        # kv: per-layer [L, 1, max_seq, KV, D] from a single-request prefill
        for name, c in self.cache.items():
            c[:, slot:slot + 1] = kv[name]

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            # A request can finish at admit time (max_new=1 satisfied by
            # the prefill token, or eos as the first token), leaving this
            # slot free — keep admitting from the queue until the slot is
            # actually occupied or the queue drains.
            while self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                logits, kv = self.model.prefill_fn(
                    self.params,
                    {"tokens": torch.as_tensor(req.tokens[None, :],
                                               device=self.device)},
                    self.max_seq)
                tok = int(torch.argmax(logits[0]))
                req.out.append(tok)
                if len(req.out) >= req.max_new or tok == self.eos_id:
                    # Done before any decode step: finish now and never
                    # occupy the slot (an eos-first request must not keep
                    # decoding, and max_new=1 must emit exactly one token).
                    # The prefilled KV is dropped.
                    req.done = True
                    self.finished[req.rid] = req
                    continue
                self._write_slot(kv, slot)
                self.slot_req[slot] = req
                self.positions[slot] = len(req.tokens)
                self.last_tok[slot] = tok

    def _step(self) -> None:
        # Snapshot the occupied slots up front: the decode step always runs
        # the full [n_slots] batch (fixed shape), but only slots in this
        # snapshot are read back — freed slots carry zeroed last_tok /
        # positions and their logits are discarded.
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        toks = torch.tensor(self.last_tok[:, None], device=self.device)
        pos = torch.tensor(self.positions, device=self.device)
        logits, self.cache = self.model.decode_fn(self.params, self.cache,
                                                  toks, pos)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for slot in active:
            req = self.slot_req[slot]
            self.positions[slot] += 1
            tok = int(nxt[slot])
            req.out.append(tok)
            self.last_tok[slot] = tok
            full = self.positions[slot] + 1 >= self.max_seq
            if len(req.out) >= req.max_new or tok == self.eos_id or full:
                req.done = True
                self.finished[req.rid] = req
                self.slot_req[slot] = None
                self.positions[slot] = 0
                # Zero on release: a recycled slot must never observe its
                # predecessor's token.
                self.last_tok[slot] = 0
