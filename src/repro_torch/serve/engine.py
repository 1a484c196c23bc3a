"""Batched serving engine: continuous batching over a decode step, with
RAG-style retrieval reads through a cache client.

Counterpart of ``repro.serve.engine``: the same fixed decode batch whose
finished slots are refilled from the queue, the same shared scalar ``pos``
(a refilled slot decodes at the batch's position, over the previous
request's KV entries), and the same ``numpy.random.default_rng(seed)`` zipf
passage draws.  The retrieval client is duck-typed — the engine uses only
``client.meta.datasets[name].files`` (items with ``.path`` and ``.size``) and
``client.read(path, offset, length, now)`` — because the port has no cache
engine of its own yet.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import init_decode_state
from .serve_step import make_serve_step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S_prompt,)
    max_new: int = 16
    retrieved: int = 0
    output: List[int] = field(default_factory=list)
    submitted: float = 0.0
    finished: float = 0.0


class ServingEngine:
    def __init__(self, params, cfg: ModelConfig, *, batch: int = 4,
                 max_seq: int = 512, cache_engine: Optional[Any] = None,
                 knowledge_dataset: Optional[str] = None,
                 retrieval_k: int = 4, zipf_a: float = 1.3,
                 seed: int = 0, device="cuda") -> None:
        self.device = resolve_device(device)
        embed = params["embed"]
        if embed.device.type != self.device.type:
            raise ValueError(f"params live on {embed.device}, engine device "
                             f"is {self.device}")
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.max_seq = max_seq
        self.cache = cache_engine
        self.knowledge = knowledge_dataset
        self.retrieval_k = retrieval_k
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a
        self.queue: Deque[Request] = deque()
        self.done: List[Request] = []
        self._slots: List[Optional[Request]] = [None] * batch
        self.state = init_decode_state(cfg, batch, max_seq, device=embed.device)
        self._decode = make_serve_step(cfg, embed.device)
        self.steps = 0

    # ---------------------------------------------------------------- admit
    def submit(self, req: Request) -> None:
        req.submitted = time.monotonic()
        self.queue.append(req)

    def _retrieve(self, req: Request) -> None:
        """RAG retrieval: zipf-hot passage reads through the cache client."""
        if self.cache is None or self.knowledge is None:
            return
        ds = self.cache.meta.datasets[self.knowledge]
        n = len(ds.files)
        for _ in range(self.retrieval_k):
            r = int((self.rng.zipf(self.zipf_a) - 1) % n)
            f = ds.files[r]
            self.cache.read(f.path, 0, min(f.size, 64 * 1024),
                            time.monotonic())
            req.retrieved += 1

    def _admit(self) -> None:
        for i in range(self.batch):
            if self._slots[i] is None and self.queue:
                req = self.queue.popleft()
                self._retrieve(req)
                self._slots[i] = req

    # ----------------------------------------------------------------- step
    def run(self, max_steps: int = 1000) -> List[Request]:
        """Decode until queue + slots drain (token-level continuous batching).

        Prompts are fed token-by-token through the decode path, as the JAX
        engine feeds them."""
        feed_pos = [0] * self.batch
        for _ in range(max_steps):
            self._admit()
            if all(s is None for s in self._slots) and not self.queue:
                break
            toks = np.zeros((self.batch, 1), np.int64)
            for i, req in enumerate(self._slots):
                if req is None:
                    continue
                if feed_pos[i] < len(req.prompt):
                    toks[i, 0] = req.prompt[feed_pos[i]]
                elif req.output:
                    toks[i, 0] = req.output[-1]
            logits, self.state = self._decode(self.params, self.state,
                                              torch.from_numpy(toks))
            self.steps += 1
            nxt = logits[:, -1].argmax(-1).cpu().numpy()
            for i, req in enumerate(self._slots):
                if req is None:
                    continue
                if feed_pos[i] < len(req.prompt):
                    feed_pos[i] += 1
                    if feed_pos[i] == len(req.prompt):
                        req.output.append(int(nxt[i]))
                else:
                    req.output.append(int(nxt[i]))
                    if len(req.output) >= req.max_new:
                        req.finished = time.monotonic()
                        self.done.append(req)
                        self._slots[i] = None
                        feed_pos[i] = 0
        return self.done
