"""Continuous-batching scheduler: the host-side request lifecycle around the
hash-paged decode engine.

Port of ``repro.serving.scheduler``.  A fixed device batch of B slots runs
lock-step decode; the scheduler admits queued requests into free slots
(the prompt is fed token by token), detects finished sequences (EOS or
max tokens), releases their pages (atomic indicator-bit deletes), and
immediately reuses the slots — the standard continuous-batching loop
(Orca/vLLM), with the continuity hash table as the page index.

Each step's page translations are posted to the batcher's one-sided
transport, if it has one: ``transport`` given, or built from the page
table store's policy (``RemoteMemory.from_policy``: an endpoint for
``ExecPolicy(transport="sim")``, none for the default ``"none"``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serving import engine as E
from repro_torch.serving import kvcache as KC


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, geom: KC.PageGeometry, params,
                 pad_id: int = 0, transport=None):
        self.cfg = cfg
        self.geom = geom
        self.params = params
        self.pad_id = pad_id
        self.cache = KC.create_cache(geom)
        self.B = geom.batch
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * self.B
        self.prompt_pos = np.zeros(self.B, np.int64)  # next prompt token idx
        self._logits = None
        # one-sided transport the page-table traffic is accounted against
        # (None, or a repro_torch.rdma.RemoteMemory).  The scheduler step
        # is the doorbell FLUSH BOUNDARY: every page translation of one
        # decode step posts as one doorbell-batched round.
        if transport is None:
            from repro_torch.rdma import RemoteMemory
            transport = RemoteMemory.from_policy(geom.store.policy)
        self.transport = transport

    # -- request API ---------------------------------------------------------

    def submit(self, req: Request):
        self.queue.append(req)

    def _slot_coords(self, b: int):
        return b // self.geom.batch_per_shard, b % self.geom.batch_per_shard

    def _admit(self):
        for b in range(self.B):
            if self.slots[b] is None and self.queue:
                self._scrub(b)          # drop any idle-slot pad pages
                self.slots[b] = self.queue.popleft()
                self.prompt_pos[b] = 0

    def _scrub(self, b: int):
        """Idle slots still ride the fixed-shape decode batch (pad tokens),
        accumulating junk pages; release them before reuse/shutdown."""
        ds, sl = self._slot_coords(b)
        if int(self.cache.seq_lens[ds, sl]) > 0:
            self.cache = E.release_sequence(self.geom, self.cache, ds, sl)

    def _release(self, b: int):
        ds, sl = self._slot_coords(b)
        self.cache = E.release_sequence(self.geom, self.cache, ds, sl)
        self.slots[b] = None

    # -- the lock-step loop --------------------------------------------------

    def step(self) -> int:
        """One global decode step; returns number of live requests."""
        self._admit()
        toks = np.full((self.B,), self.pad_id, np.int32)
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            if self.prompt_pos[b] < len(req.prompt):      # feeding the prompt
                toks[b] = req.prompt[self.prompt_pos[b]]
                self.prompt_pos[b] += 1
            elif self._logits is not None:                # generating
                toks[b] = int(np.argmax(self._logits[b]))
                req.out.append(int(toks[b]))
                if (len(req.out) >= req.max_new_tokens
                        or (req.eos_id is not None
                            and toks[b] == req.eos_id)):
                    req.done = True
        logits, self.cache = E.serve_step(
            self.cfg, self.geom, self.params,
            torch.from_numpy(toks).to(self.geom.device), self.cache)
        self._logits = logits.cpu().numpy()
        if self.transport is not None:
            # flush boundary: the step's page translations, ONE doorbell
            self.transport.post(KC.step_read_plan(self.geom, self.cache))
        live = 0
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            if req.done:
                self._release(b)
            else:
                live += 1
        return live

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive until queue + slots drain; returns {rid: generated tokens}."""
        finished: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            before = [r for r in self.slots if r is not None]
            live = self.step()
            for r in before:
                if r.done and r.rid not in finished:
                    finished[r.rid] = r.out
            if live == 0 and not self.queue:
                break
        for b in range(self.B):        # shutdown: scrub idle pad pages
            if self.slots[b] is None:
                self._scrub(b)
        return finished
