"""Batched serving, ported (``repro.serving.serve_loop``): prefill + decode
with slot-based continuous batching.

``Server`` owns a fixed batch of ``n_slots`` sequences with one shared KV
cache of ``max_seq`` rows per slot; finished slots are refilled from the
request queue without stalling the others.  Each admitted request gets
one B = 1 prefill, whose k/v are written straight into rows [slot, :s] of
the batch cache; each decode step runs every slot at its own position and
writes the cache in place.  Idle slots decode at position 0 and are
overwritten by the next prefill.

Sampling: greedy or temperature (``np.random.default_rng(seed)``, as in
the reference, so the same logits give the same draws); per-slot EOS/len
stop.  The EOS token is a stop signal, not content: it is never included
in the returned tokens.  One scalar read per sampled token.

Admission contract: requests are validated before any device work: an
empty prompt, a prompt with ``len(prompt) >= max_seq`` or
``max_new_tokens < 1`` raises ``ValueError`` naming the request.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import model_zoo


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0   # 0 = greedy
    rid: int = 0


class Server:
    def __init__(self, model, *, n_slots: int = 4, max_seq: int = 512,
                 eos_id: int | None = None, seed: int = 0):
        self.model = model
        self.cfg = model.cfg
        self.device = model.embed.device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.rng = np.random.default_rng(seed)
        self.caches = model_zoo.init_cache(self.cfg, n_slots, max_seq,
                                           self.device)

    def _fill_slot(self, slot: int, prompt: list[int]):
        toks = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits, caches = self.model.prefill(toks)
        s = toks.shape[1]
        for batch, one in zip(self.caches, caches):
            batch["k"][slot, :s] = one["k"][0]
            batch["v"][slot, :s] = one["v"][0]
        return logits[0, -1]

    def _sample(self, logits, temperature: float):
        if temperature <= 0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        probs = probs.cpu().numpy().astype(np.float64)
        probs = probs / probs.sum()
        return int(self.rng.choice(probs.shape[0], p=probs))

    def admit_check(self, req: Request) -> None:
        """Validate a request before any device work (loud admission)."""
        n = len(req.prompt)
        if n < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if n >= self.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt length {n} >= max_seq "
                f"{self.max_seq} — the KV cache cannot hold it")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1, got "
                f"{req.max_new_tokens}")

    @torch.inference_mode()
    def generate(self, requests: list[Request]) -> dict[int, list[int]]:
        """Run all requests to completion; returns {rid: generated tokens}.

        The EOS token (when configured) terminates a sequence and is
        stripped — returned token lists never contain ``eos_id``.
        """
        for req in requests:
            self.admit_check(req)
        queue = list(requests)
        slots: list[dict | None] = [None] * self.n_slots
        done: dict[int, list[int]] = {}

        def admit():
            for i in range(self.n_slots):
                while slots[i] is None and queue:
                    req = queue.pop(0)
                    last_logits = self._fill_slot(i, req.prompt)
                    tok = self._sample(last_logits, req.temperature)
                    # the prefill-sampled token gets the same stop checks
                    # as decode steps: EOS ends (and is stripped from) the
                    # output, and max_new_tokens==1 completes immediately
                    if self.eos_id is not None and tok == self.eos_id:
                        done[req.rid] = []
                        continue
                    if req.max_new_tokens <= 1:
                        done[req.rid] = [tok]
                        continue
                    slots[i] = {"req": req, "pos": len(req.prompt),
                                "out": [tok], "next": tok}

        admit()
        step_tokens = np.zeros((self.n_slots, 1), np.int64)
        step_pos = np.zeros((self.n_slots,), np.int64)
        while any(s is not None for s in slots):
            active = [i for i, s in enumerate(slots) if s is not None]
            for i in range(self.n_slots):
                step_tokens[i, 0] = slots[i]["next"] if slots[i] else 0
                step_pos[i] = slots[i]["pos"] if slots[i] else 0
            logits, self.caches = self.model.decode_step(
                torch.from_numpy(step_tokens).to(self.device), self.caches,
                torch.from_numpy(step_pos).to(self.device))
            for i in active:
                s = slots[i]
                tok = self._sample(logits[i], s["req"].temperature)
                s["pos"] += 1
                if self.eos_id is not None and tok == self.eos_id:
                    done[s["req"].rid] = s["out"]
                    slots[i] = None
                    continue
                s["out"].append(tok)
                s["next"] = tok
                if (len(s["out"]) >= s["req"].max_new_tokens
                        or s["pos"] >= self.max_seq - 1):
                    done[s["req"].rid] = s["out"]
                    slots[i] = None
            admit()
        return done
