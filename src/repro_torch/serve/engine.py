"""Continuous-batching decode engine over the contiguous slotted KV pool
(port of ``repro.serve.engine``: greedy decoding, one prompt token per
step, no mesh).

Every :meth:`Engine.step` is one iteration of

1. **admit** — pending requests are popped into free slots; the freshly
   acquired slot ids form the step's ``reset`` mask, so slot
   re-initialization happens inside the serve step;
2. **decode** — one call of :func:`repro_torch.train.step.make_serve_step`
   advances every occupied lane by one token: a prompt token while the
   lane is prefilling, its last output afterwards;
3. **evict** — lanes whose token completed a sequence (EOS or
   ``max_new_tokens``) release their slot, which the next iteration's
   admission refills mid-flight.

A request of prompt length ``S0`` occupies its lane for
``S0 + n_generated - 1`` steps; the first generated token is the model
output of the step that consumed the last prompt token. Under nearest
rounding the engine is token-for-token identical to lock-step
:func:`repro_torch.serve.decode.generate` run at the engine's lane count.

The paged pool, chunked prefill, prefix caching and sampling arrive with
later slices; asking for them raises.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.serve.cache import CachePool
from repro_torch.train.step import make_serve_step

__all__ = ["Request", "Completion", "EngineStats", "Engine"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``prompt`` is a 1-D i32 token array.

    ``temperature == 0`` (default) decodes greedily; ``temperature > 0``
    samples with optional top-k / top-p filtering, deterministically per
    ``(seed, rid)`` (see :mod:`repro.serve.sampling`). The two ``*_step``
    fields are engine-internal carry: recompute preemption re-queues the
    request with its *original* admission/first-token steps, so TTFT
    accounting spans the preemption instead of restarting at it.
    """
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    admitted_step: int = -1       # engine carry across preemption
    first_token_step: int = -1    # engine carry across preemption


@dataclasses.dataclass(frozen=True)
class Completion:
    """A finished request: generated tokens + accounting."""
    rid: int
    prompt: np.ndarray
    tokens: np.ndarray            # generated continuation (EOS included)
    finish_reason: str            # "eos" | "length"
    slot: int
    admitted_step: int
    finished_step: int
    first_token_step: int = -1    # step whose output was the first sample


@dataclasses.dataclass
class EngineStats:
    """Iteration-level counters (see docs/serving.md for the math)."""
    steps: int = 0                # engine iterations = compiled-step calls
    slot_steps: int = 0           # steps × n_slots (lane capacity spent)
    active_slot_steps: int = 0    # lanes that actually computed this step
    prefill_slot_steps: int = 0   # … of which were still mid-prompt after
    tokens_generated: int = 0     # sampled continuation tokens kept
    admitted: int = 0             # requests that entered service (once each)
    finished: int = 0
    preemptions: int = 0          # lanes evicted to reclaim pages
    prefix_hits: int = 0          # admissions that matched a cached prefix
    prefix_tokens_reused: int = 0  # prefill tokens skipped via the cache
    kv_capacity_tokens: int = 0   # token capacity of the KV pool
    kv_token_steps: int = 0       # Σ over steps of live KV tokens
    kv_tokens_live: int = 0       # live KV tokens right now
    kv_pages_live: int = 0        # live pages right now (paged pool only)

    @property
    def lane_occupancy(self) -> float:
        """Fraction of lane capacity computing (active / total lanes)."""
        return self.active_slot_steps / max(self.slot_steps, 1)

    @property
    def utilization(self) -> float:
        """Fraction of KV *token* capacity holding live tokens, averaged
        over steps. This is memory utilization, not lane occupancy: a
        10-token sequence parked in a 512-token stripe counts as 10/512
        of a slot, not as a fully utilized lane (the distortion the
        paged pool exists to fix — see docs/serving.md)."""
        return self.kv_token_steps / max(self.steps *
                                         max(self.kv_capacity_tokens, 1), 1)


@dataclasses.dataclass
class _Slot:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    admitted_step: int
    fed: int = 0                  # tokens consumed so far (= next position)
    last_token: int = 0           # model output of the previous step
    first_token_step: int = -1
    generated: list = dataclasses.field(default_factory=list)


class Engine:
    """Continuous-batching engine bound to (params, cfg, policy).

    ``n_slots`` bounds concurrency, ``max_len`` bounds per-request
    ``len(prompt) + max_new_tokens``. The engine runs on ``device`` (CUDA
    unless ``"cpu"``), where ``params`` must live; the KV pool is
    allocated there once. ``fused_decode=True`` runs decode attention
    through the CUDA kernel (its plain version on the CPU).
    """

    def __init__(self, params, cfg, policy: PrecisionPolicy, *,
                 n_slots: int = 8, max_len: int = 128,
                 eos_id: Optional[int] = None, fused_decode: bool = False,
                 paged: bool = False, prefill_chunk: int = 1, device=None):
        if paged:
            raise ValueError("paged=True: the paged KV pool is ported with "
                             "the paged-serving slice")
        if prefill_chunk != 1:
            raise ValueError("prefill_chunk > 1: chunked prefill is ported "
                             "with the paged-serving slice")
        self.device = resolve_device(device)
        p_dev = params["embed"]["embedding"].device
        if p_dev.type != self.device.type:
            raise ValueError(f"params are on {p_dev}, the engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.policy = policy
        self.params = params
        self.eos_id = eos_id
        self.pool = CachePool(params, cfg, policy, n_slots=n_slots,
                              max_len=max_len)
        self._step_fn = make_serve_step(cfg, policy, fused_decode=fused_decode)
        self._slots: list[Optional[_Slot]] = [None] * n_slots
        self._pending: deque[Request] = deque()
        self._next_rid = 0
        self.stats = EngineStats()
        self.stats.kv_capacity_tokens = n_slots * max_len

    # -- request intake -----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               rid: Optional[int] = None, temperature: float = 0.0) -> int:
        """Queue a greedy request; returns its rid. Admission happens in
        step()."""
        if temperature > 0:
            raise ValueError("temperature > 0: sampling is ported with the "
                             "sampling slice; the engine decodes greedily")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.pool.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the pool max_len ({self.pool.max_len})")
        if rid is None:
            rid = self._next_rid
        else:
            taken = {r.rid for r in self._pending}
            taken.update(s.rid for s in self._slots if s is not None)
            if rid in taken:
                raise ValueError(
                    f"rid {rid} collides with a pending or in-flight "
                    "request (completions would be ambiguous)")
        self._next_rid = max(self._next_rid, rid) + 1
        self._pending.append(Request(rid, prompt, int(max_new_tokens)))
        return rid

    def has_work(self) -> bool:
        return bool(self._pending) or any(s is not None for s in self._slots)

    # -- the iteration ------------------------------------------------------
    def _admit(self, reset: np.ndarray) -> None:
        """Pop pending requests into free slots (FIFO, no reordering)."""
        while self._pending and self.pool.n_free:
            req = self._pending.popleft()
            slot = self.pool.acquire()
            self._slots[slot] = _Slot(req.rid, req.prompt, req.max_new_tokens,
                                      self.stats.steps)
            reset[slot] = True
            self.stats.admitted += 1

    def step(self) -> list[Completion]:
        """One continuous-batching iteration; returns requests finished."""
        n = self.pool.n_slots
        reset = np.zeros((n,), bool)
        self._admit(reset)
        token = np.zeros((n, 1), np.int32)
        pos = np.zeros((n,), np.int32)
        active = np.zeros((n,), bool)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            active[i] = True
            pos[i] = s.fed
            token[i, 0] = s.prompt[s.fed] if s.fed < s.prompt.size else s.last_token
        dev = self.device
        out, self.pool.cache = self._step_fn(
            self.params, self.pool.cache, torch.from_numpy(token).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(active).to(dev),
            torch.from_numpy(reset).to(dev))
        sampled = out.reshape(n).cpu().numpy()

        self.stats.steps += 1
        self.stats.slot_steps += n
        done: list[Completion] = []
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            self.stats.active_slot_steps += 1
            s.fed += 1
            if s.fed < s.prompt.size:
                self.stats.prefill_slot_steps += 1
                continue                      # prompt not exhausted yet
            tok = int(sampled[i])
            if s.first_token_step < 0:
                s.first_token_step = self.stats.steps
            s.generated.append(tok)
            s.last_token = tok
            self.stats.tokens_generated += 1
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if hit_eos or len(s.generated) >= s.max_new_tokens:
                done.append(Completion(
                    s.rid, s.prompt, np.asarray(s.generated, np.int32),
                    "eos" if hit_eos else "length", i,
                    s.admitted_step, self.stats.steps, s.first_token_step))
                self._slots[i] = None
                self.pool.release(i)
                self.stats.finished += 1
        live_tokens = sum(s.fed for s in self._slots if s is not None)
        self.stats.kv_token_steps += live_tokens
        self.stats.kv_tokens_live = live_tokens
        return done

    def run(self, max_steps: Optional[int] = None) -> list[Completion]:
        """Step until drained (or ``max_steps`` *further* iterations);
        completions in finish order."""
        out: list[Completion] = []
        start = self.stats.steps
        while self.has_work():
            if max_steps is not None and self.stats.steps - start >= max_steps:
                break
            out.extend(self.step())
        return out
