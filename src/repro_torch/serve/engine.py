"""Continuous-batching decode engine over a slotted KV pool (port of
``repro.serve.engine``).

The engine owns ``n_slots`` decode lanes backed by one
:class:`repro_torch.serve.cache.CachePool` allocation — or, with
``paged=True``, one :class:`repro_torch.serve.paged.PagedCachePool` whose
KV memory is allocated page by page as sequences grow. Every
:meth:`Engine.step` is one iteration of

1. **admit** — pending requests are popped into free slots; the freshly
   acquired slot ids form the step's ``reset`` mask, so slot
   re-initialization happens inside the serve step. The paged pool
   additionally gates admission on pages covering the prompt — and, with
   the **prefix cache** on, first maps the longest cached prefix of the
   prompt into the lane's block table *shared* (refcounted pages, no
   copy), so those tokens skip prefill;
2. **plan** — per lane (oldest admission first): prefilling lanes are
   scheduled up to ``prefill_chunk`` prompt tokens, decode lanes exactly
   one. Under paging each lane's block table is extended to cover its
   scheduled positions and any *shared* block it is about to write is
   copy-on-write remapped (private page + row copy in the step); when the
   free list runs dry, cached-but-unreferenced prefix pages are reclaimed
   LRU-first, then the *youngest* lane is preempted (pages and slot freed,
   request re-queued at the front — greedy decode regenerates its tokens
   identically), and a lane that still cannot be covered parks;
3. **decode** — one call of :func:`repro_torch.train.step.make_serve_step`
   (width 1, or the prefill chunk when some lane feeds more than one
   token) advances every scheduled lane. Its numpy inputs are staged
   into static buffers of that width (one packed host-to-device copy);
   on CUDA the step is a CUDA graph, captured lazily per (width,
   with_logits) the way the reference compiles one executable per
   variant, and replayed. A step in which some lane keeps a token at
   ``temperature > 0`` takes the logits-returning variant; its sampling
   lanes are re-decided on the device from the logits the step leaves in
   its output buffer (:mod:`repro_torch.serve.sampling`), and the read of
   the tokens is the step's only sync. On the CPU the step function runs
   eagerly on the same buffers;
4. **evict** — lanes whose token completed a sequence (EOS or
   ``max_new_tokens``) release their slot (and one reference per mapped
   page), which the next iteration's admission refills mid-flight. Lanes
   that just finished their prompt publish its full pages into the prefix
   index first.

A request of prompt length ``S0`` occupies its lane for
``ceil(S0 / C) + n_generated - 1`` steps (minus the prefill a prefix hit
skips); the first generated token is the model output of the step that
consumed the last prompt token. Under nearest rounding the engine with
``prefill_chunk=1`` is token-for-token identical to lock-step
:func:`repro_torch.serve.decode.generate` run at the engine's lane count,
paged or not, prefix hits included: a paged lane's gathered view is
index for index the contiguous cache. A chunk step carries N·C token rows
where a single-token step carries N. With ``fused_decode`` on the card
every op of the step gives a row the same bits at either count (the
dense products on ``qmatmul``, RMSNorm's mean on ``row_mean_sq``, the
chunk's attention on the decode kernels with each query row a lane;
ROADMAP C10), so chunked prefill gives the unchunked engine's tokens bit
for bit (``chip_smoke.py``, tests/test_torch_cuda.py). On the CPU the
step is the reference's own arithmetic, whose matmul rows depend on the
row count (C6), so there chunked prefill is held to the unchunked engine
at the logit level (tests/test_torch_paged_engine.py).

**On a mesh** (``mesh=``, a :class:`repro_torch.launch.mesh.Mesh` of the
processes; the reference's ``Engine(mesh=)``) every rank runs the same
host scheduler — admission, planning, preemption, the prefix index — on
the same requests, so every rank makes the same decisions. The device
step computes this rank's slots (``pool.slots``: its share when the data
axes divide ``n_slots``, else all of them) with this rank's shards of the
weights and of the KV heads on a model axis; with the slots split over
the data axes, one int32 all-gather of the step's tokens over the data
ranks keeps the schedulers identical. A sampling lane is drawn by the
ranks that compute it, from the whole-vocabulary logits and with the
(seed, rid, position) key, so every rank that holds it draws the same
token. Under a model group of more than one rank the step runs eagerly
(its collectives are host operations on a gloo group, which a CUDA graph
cannot capture) and ``graphs`` stays empty; the kernels still launch.

A paged pool under a data axis above 1 (ROADMAP A12 item 3) holds this
rank's page rows (``partition.page_rows``) and its lanes' slot-indexed
state; the page ids, the free list and the block tables stay global and
the same on every rank. Each step the engine plans the pool's page
exchange (:mod:`repro_torch.dist.pages`: the rows this rank's lanes name
that other ranks own, and the cells they write into them), hands the step
this rank's lanes' tables remapped onto the exchange's working buffers and
its own rows of ``page_reset``, and the step pulls and pushes around the
model: at most two collectives per step (``pool.exchange.stats``) beside
the token gather. That step runs eagerly too; capturing a sharded step as
a graph is ROADMAP A12 item 4.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.dist import axes
from repro_torch.dist import multihost as MH
from repro_torch.dist import partition as PT
from repro_torch.kernels import launch_counts
from repro_torch.optim.grad_compress import gather_parts
from repro_torch.serve import sampling
from repro_torch.serve.cache import ENCDEC_ROUTE, CachePool
from repro_torch.serve.paged import PagedCachePool
from repro_torch.train.step import make_serve_step

__all__ = ["Request", "Completion", "EngineStats", "Engine", "GraphStats"]


def _not_full_context_attention(cfg, max_len: int) -> Optional[str]:
    """Why (cfg, max_len) is *not* an attention-only full-context stack
    — ``None`` when it is. Chunked prefill and the prefix cache share
    this gate: both assume a lane's KV at position ``p`` is a pure
    function of tokens ``[0, p]`` addressable at cache index ``p``
    (recurrent state advances strictly one token per step; ring-window
    cells are slot-contiguous and overwritten, so they can be neither
    chunk-written nor shared between lanes).
    """
    if cfg.family == "ssm" or any(
            k in ("rec", "mamba") for k in cfg.block_pattern):
        return ("an attention-only stack is required "
                "(recurrent state advances one token per step)")
    windows = [cfg.swa_window]
    if "local_attn" in cfg.block_pattern:
        windows.append(cfg.local_attn_window)
    for w in windows:
        if w is not None and w < max_len:
            return ("full-context attention is required "
                    f"(ring window {w} < max_len {max_len})")
    return None


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``prompt`` is a 1-D i32 token array.

    ``temperature == 0`` (default) decodes greedily; ``temperature > 0``
    samples with optional top-k / top-p filtering, deterministically per
    ``(seed, rid)`` (see :mod:`repro_torch.serve.sampling`). The two
    ``*_step`` fields are engine-internal carry: recompute preemption
    re-queues the request with its *original* admission/first-token
    steps, so TTFT accounting spans the preemption instead of restarting
    at it.
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
class GraphStats:
    """One step variant's CUDA graph (a token width, with or without the
    logits): how often it was replayed, and the hand-written kernels it
    launches per replay (their wrappers' counts while it was captured)."""
    replays: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.bool_): torch.bool}


class _Staging:
    """Static input buffers of one step width on the engine's device, and
    a host mirror they are loaded from in one copy.

    Every input lives in one byte buffer (each at a 4-byte-aligned
    offset, viewed as its dtype and shape), so a step's inputs cross to
    the card in one asynchronous copy from pinned memory; the step's
    output read, after the copy and the step on the same stream, is what
    waits for it."""

    def __init__(self, arrays: dict, device: torch.device):
        spans, total = {}, 0
        for name, a in arrays.items():
            spans[name] = slice(total, total + a.nbytes)
            total += -(-a.nbytes // 4) * 4
        pin = device.type == "cuda"
        self.host = torch.empty((total,), dtype=torch.uint8, pin_memory=pin)
        self.device = torch.empty((total,), dtype=torch.uint8, device=device)
        host = self.host.numpy()
        self._mirror = {n: host[spans[n]].view(a.dtype).reshape(a.shape)
                        for n, a in arrays.items()}
        self.inputs = {n: self.device[spans[n]].view(_TORCH_DTYPES[a.dtype]).reshape(a.shape)
                       for n, a in arrays.items()}

    def load(self, arrays: dict) -> dict:
        """Copy ``arrays`` into the static buffers; returns them."""
        if arrays.keys() != self._mirror.keys():
            raise ValueError(f"step inputs {sorted(arrays)} != {sorted(self._mirror)}")
        for name, a in arrays.items():
            self._mirror[name][...] = a
        self.device.copy_(self.host, non_blocking=True)
        return self.inputs


@dataclasses.dataclass
class _Slot:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    admitted_step: int
    seq: int                      # global admission order (preemption rank)
    fed: int = 0                  # tokens consumed so far (= next position)
    last_token: int = 0           # model output of the previous step
    first_token_step: int = -1
    published: bool = False       # prompt prefix pushed to the index
    generated: list = dataclasses.field(default_factory=list)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


class Engine:
    """Continuous-batching engine bound to (params, cfg, policy).

    ``n_slots`` bounds concurrency, ``max_len`` bounds per-request
    ``len(prompt) + max_new_tokens``. The engine runs on ``device`` (CUDA
    unless ``"cpu"``), where ``params`` must live; the KV pool is
    allocated there once. ``fused_decode=True`` runs the serve step
    inside :func:`repro_torch.kernels.dispatch.fused_decode`: decode
    attention through the CUDA kernels (their plain versions on the CPU)
    and, on CUDA, the dense products, norms and chunk attention on their
    row-independent kernels.

    ``paged=True`` backs full-context attention layers with a
    :class:`~repro_torch.serve.paged.PagedCachePool` (``page_size`` tokens
    per page, ``n_pages`` pages — default byte parity with the contiguous
    pool; undersubscribe it to serve more lanes per byte).
    ``prefill_chunk=C > 1`` admits prompts C tokens per iteration instead
    of one, interleaved with in-flight decodes; it requires an
    attention-only, full-context stack.

    ``prefix_cache=None`` (default) enables prompt-prefix sharing whenever
    it is sound — paged pool + attention-only full-context stack (the same
    gate as chunked prefill). Pass ``False`` to disable, ``True`` to
    require (raises when the config is ineligible).

    ``mesh`` (see the module's note) serves on the processes' ``(data,
    model)`` mesh: ``params`` are this rank's shards
    (``partition.param_specs``; ``convert.from_jax_params(specs=, mesh=)``
    or ``dist.fsdp.shard_state``). A model axis above 1 takes every
    decoder-only family (``partition.serve_refusal``); a paged pool on a
    data axis above 1 shards its rows over the data ranks.
    """

    def __init__(self, params, cfg, policy: PrecisionPolicy, *,
                 n_slots: int = 8, max_len: int = 128,
                 eos_id: Optional[int] = None, fused_decode: bool = False,
                 paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None, prefill_chunk: int = 1,
                 prefix_cache: Optional[bool] = None, device=None, mesh=None):
        if cfg.encdec:
            raise ValueError(f"Engine is decoder-only; encoder-decoder {ENCDEC_ROUTE}")
        refusal = PT.serve_refusal(cfg, mesh)
        if refusal is not None:
            raise ValueError(refusal)
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        reason = _not_full_context_attention(cfg, max_len)
        if prefill_chunk > 1 and reason is not None:
            raise ValueError(f"chunked prefill: {reason}")
        self.device = resolve_device(device)
        p_dev = params["embed"]["embedding"].device
        if p_dev.type != self.device.type:
            raise ValueError(f"params are on {p_dev}, the engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.policy = policy
        self.params = params
        self.eos_id = eos_id
        self.paged = bool(paged)
        self.prefill_chunk = int(prefill_chunk)
        if prefix_cache is None:
            self.prefix_cache = self.paged and reason is None
        elif prefix_cache:
            if not self.paged:
                raise ValueError("prefix_cache requires paged=True "
                                 "(sharing works on page refcounts)")
            if reason is not None:
                raise ValueError(f"prefix cache: {reason}")
            self.prefix_cache = True
        else:
            self.prefix_cache = False
        if paged:
            self.pool: Any = PagedCachePool(
                params, cfg, policy, n_slots=n_slots, max_len=max_len,
                page_size=page_size, n_pages=n_pages, mesh=mesh)
        else:
            self.pool = CachePool(params, cfg, policy, n_slots=n_slots,
                                  max_len=max_len, mesh=mesh)
        self.mesh = mesh
        # the model axis's collectives (None in one process or at model 1)
        self.axis = axes.for_mesh(mesh)
        # whether this rank computes a share of the slots: the step's tokens
        # are then gathered over the data ranks
        lo, hi = self.pool.slots
        self._split = hi - lo < n_slots
        self.token_gather = axes.AxisStats()
        # the paged pool's page exchange (None: this rank holds every row)
        self.pages = self.pool.exchange if paged else None
        # one step function per (token width, with_logits): the greedy
        # variants of widths 1 and C now, a logits variant at the first
        # step that samples at its width; on CUDA each is captured as a
        # graph at its first step
        self._fused_decode = fused_decode
        self._fns = {(w, False): make_serve_step(cfg, policy, fused_decode=fused_decode,
                                                 paged=self.paged, chunk=w, mesh=mesh,
                                                 exchange=self.pages)
                     for w in {1, self.prefill_chunk}}
        self._staging: dict[tuple, _Staging] = {}
        self._graphs: dict[tuple, tuple[torch.cuda.CUDAGraph, tuple]] = {}
        # a model group's collectives and the page exchange run on the host:
        # no graph captures them
        self._use_graphs = (self.device.type == "cuda" and self.axis is None
                            and self.pages is None)
        self.graphs: dict[tuple, GraphStats] = {}
        # static width of the per-step copy-on-write list (the reference's
        # _max_copies): each scheduled lane's write range spans at most
        # (C-1)//P + 2 blocks
        self._max_copies = (n_slots * ((self.prefill_chunk - 1) // self.pool.page_size + 2)
                            if paged else 0)
        self._slots: list[Optional[_Slot]] = [None] * n_slots
        self._pending: deque[Request] = deque()
        self._next_rid = 0
        self._next_seq = 0
        self.stats = EngineStats()
        self.stats.kv_capacity_tokens = (
            self.pool.capacity_tokens if paged else n_slots * max_len)

    def _fn(self, width: int, with_logits: bool):
        key = (width, with_logits)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = make_serve_step(
                self.cfg, self.policy, fused_decode=self._fused_decode, paged=self.paged,
                chunk=width, return_logits=with_logits, mesh=self.mesh,
                exchange=self.pages)
        return fn

    # -- request intake -----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *,
               rid: Optional[int] = None, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0) -> int:
        """Queue a request; returns its rid. Admission happens in step().

        ``temperature == 0`` decodes greedily (the bitwise-parity path);
        ``temperature > 0`` samples with optional top-k/top-p,
        deterministically per ``(seed, rid)`` — resubmitting the same
        request with the same seed and rid reproduces its tokens.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.pool.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the pool max_len ({self.pool.max_len})")
        sampling.validate_sampling(temperature, top_k, top_p)
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
        self._pending.append(Request(
            rid, prompt, int(max_new_tokens), temperature=float(temperature),
            top_k=int(top_k), top_p=float(top_p), seed=int(seed)))
        return rid

    def has_work(self) -> bool:
        return bool(self._pending) or any(s is not None for s in self._slots)

    # -- scheduling helpers -------------------------------------------------
    def _admit(self, reset: np.ndarray) -> None:
        """Pop pending requests into free slots (FIFO, no reordering).

        The paged pool additionally gates on pages covering the request's
        prompt plus one decode page — counting reclaimable cached-prefix
        pages as available, and *not* counting the blocks a prefix-cache
        match already covers (those pages are adopted shared, and are
        excluded from reclaim so admission cannot evict its own match).
        A request whose prompt prefix is cached starts with ``fed`` past
        the matched blocks: the skipped positions never enter prefill.
        """
        while self._pending and self.pool.n_free:
            req = self._pending[0]
            matched: list[int] = []
            if self.paged:
                if self.prefix_cache:
                    matched = self.pool.match_prefix(req.prompt)
                need = self.pool.blocks_for(min(req.prompt.size + 1,
                                                self.pool.max_len))
                avail = (self.pool.n_free_pages +
                         self.pool.n_reclaimable(exclude=matched))
                if avail < need - len(matched):
                    break
            self._pending.popleft()
            slot = self.pool.acquire()
            fed0 = 0
            if matched:
                self.pool.adopt_prefix(slot, matched)
                # never skip the whole prompt: the last prompt token is
                # re-fed to produce the first-token logits (its write
                # into the shared final block copy-on-write remaps it)
                fed0 = min(len(matched) * self.pool.page_size,
                           req.prompt.size - 1)
                self.stats.prefix_hits += 1
                self.stats.prefix_tokens_reused += fed0
            admitted = (req.admitted_step if req.admitted_step >= 0
                        else self.stats.steps)
            self._slots[slot] = _Slot(
                req.rid, req.prompt, req.max_new_tokens, admitted,
                self._next_seq, fed=fed0,
                first_token_step=req.first_token_step,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, seed=req.seed)
            self._next_seq += 1
            reset[slot] = True
            if req.admitted_step < 0:   # first admission, not a re-entry
                self.stats.admitted += 1

    def _preempt(self, victim: int, reset: np.ndarray) -> None:
        """Evict a lane to reclaim its pages; its request re-queues at the
        front and — decode and sampling keys both being deterministic —
        regenerates the same tokens on re-admission (vLLM's recompute
        preemption). The original ``admitted_step``/``first_token_step``
        ride along on the re-queued request: TTFT and admission counts
        span the preemption rather than restarting at re-admission."""
        s = self._slots[victim]
        self._slots[victim] = None
        self.pool.release(victim)
        reset[victim] = False   # nothing left to reset; slot is free again
        self._pending.appendleft(Request(
            s.rid, s.prompt, s.max_new_tokens, temperature=s.temperature,
            top_k=s.top_k, top_p=s.top_p, seed=s.seed,
            admitted_step=s.admitted_step,
            first_token_step=s.first_token_step))
        self.stats.preemptions += 1
        # regenerated tokens are recounted on re-admission; admitted is
        # deliberately NOT decremented (it counts requests, not events)
        self.stats.tokens_generated -= len(s.generated)

    def _plan(self, reset: np.ndarray, page_reset: Optional[np.ndarray],
              copies: list) -> np.ndarray:
        """Tokens to feed per lane this step ((N,) i32, 0 = parked).

        Oldest admission first, so page pressure falls on the youngest
        lanes: a lane that cannot get its blocks preempts strictly
        younger lanes (never an already-planned one), and parks if it is
        the youngest itself. Under paging each scheduled lane's write
        range is readied by ``prepare_write`` — fresh pages join the
        step's ``page_reset`` mask, copy-on-write remaps of shared
        blocks append (dst, src) rows to ``copies``.
        """
        n = self.pool.n_slots
        feeds = np.zeros((n,), np.int32)
        order = sorted((i for i in range(n) if self._slots[i] is not None),
                       key=lambda i: self._slots[i].seq)
        for i in order:
            s = self._slots[i]
            if s is None:        # preempted by an older lane this step
                continue
            remaining = s.prompt.size - s.fed
            c = min(self.prefill_chunk, remaining) if remaining > 0 else 1
            if self.paged:
                while True:
                    got = self.pool.prepare_write(i, s.fed, c)
                    if got is not None:
                        fresh, cow = got
                        for p in fresh:
                            page_reset[p] = True
                        copies.extend(cow)
                        break
                    young = [j for j in order
                             if self._slots[j] is not None
                             and self._slots[j].seq > s.seq]
                    if not young:
                        c = 0    # youngest lane and no pages: park
                        break
                    victim = max(young, key=lambda j: self._slots[j].seq)
                    self._preempt(victim, reset)
            feeds[i] = c
        return feeds

    # -- the iteration ------------------------------------------------------
    def step(self) -> list[Completion]:
        """One continuous-batching iteration; returns requests finished."""
        n = self.pool.n_slots
        C = self.prefill_chunk
        reset = np.zeros((n,), bool)
        page_reset = (np.zeros((self.pool.n_rows,), bool)
                      if self.paged else None)
        copies: list[tuple[int, int]] = []
        # 1. admit into free slots
        self._admit(reset)
        # 2. plan feeds (and, when paged, map blocks / CoW / preempt / park)
        feeds = self._plan(reset, page_reset, copies)
        width = C if C > 1 and int(feeds.max(initial=0)) > 1 else 1
        # a lane samples iff it keeps a token this step (prompt exhausted
        # after feeding) at temperature > 0; its key is that token's position
        draws = [(i, s.temperature, s.top_k, s.top_p,
                  sampling.request_key(s.seed, s.rid, s.prompt.size + len(s.generated)))
                 for i, s in enumerate(self._slots)
                 if s is not None and feeds[i] > 0 and s.temperature > 0
                 and s.fed + int(feeds[i]) >= s.prompt.size]
        # 3. assemble slot-indexed inputs
        token = np.zeros((n, width), np.int32)
        pos = np.zeros((n,), np.int32)
        active = np.zeros((n,), bool)
        for i, s in enumerate(self._slots):
            if s is None or feeds[i] == 0:
                continue
            active[i] = True
            pos[i] = s.fed
            if s.fed < s.prompt.size:
                c = int(feeds[i])
                token[i, :c] = s.prompt[s.fed:s.fed + c]
            else:
                token[i, 0] = s.last_token
        # 4. one serve step for every lane
        args = {"token": token, "pos": pos, "active": active, "reset": reset}
        plan = None
        if self.paged:
            args["block_table"] = self.pool.block_table
            args["page_reset"] = page_reset
            # static-width CoW row lists; in one pool padding dst = n_rows
            # copies nothing
            K = self._max_copies
            if len(copies) > K:
                raise RuntimeError(f"{len(copies)} copy-on-write rows exceed the "
                                   f"static width {K}")
            if self.pages is None:
                dst = np.full((K,), self.pool.n_rows, np.int32)
                src = np.zeros((K,), np.int32)
                for j, (d, sp) in enumerate(copies):
                    dst[j], src[j] = d, sp
            else:
                # the exchange's plan from every lane's token positions (−1:
                # none); the step copies the pairs of this rank's own rows
                offs = np.arange(width, dtype=np.int32)
                positions = np.where(offs[None, :] < feeds[:, None],
                                     pos[:, None] + offs[None, :], -1)
                plan = self.pages.plan(self.pool.block_table, page_reset, copies, positions,
                                       copy_width=K)
                dst, src = plan.copy_dst, plan.copy_src
            args["copy_dst"], args["copy_src"] = dst, src
        if width > 1:
            args["n_tok"] = feeds
        lo, hi = self.pool.slots
        if self.mesh is not None:
            # this rank's slots (and its lanes' draws), its own page rows
            specs = PT.serve_input_specs(n, self.mesh, paged=self.paged, chunk=width,
                                         n_rows=self.pool.n_rows if self.paged else None)
            args = {k: (v if k not in specs or specs[k][0] is None else
                        v[slice(*self.pool.rows)] if k == "page_reset" else v[lo:hi])
                    for k, v in args.items()}
            draws = [(i - lo, *rest) for i, *rest in draws if lo <= i < hi]
        if plan is not None:
            args["block_table"] = plan.table
        sampled = self._gather_tokens(
            self._serve((width, bool(draws)), args, draws, plan)).reshape(n)
        # 5. account, publish prefixes, evict
        self.stats.steps += 1
        self.stats.slot_steps += n
        done: list[Completion] = []
        for i, s in enumerate(self._slots):
            if s is None or feeds[i] == 0:
                continue
            self.stats.active_slot_steps += 1
            s.fed += int(feeds[i])
            if s.fed < s.prompt.size:
                self.stats.prefill_slot_steps += 1
                continue                      # prompt not exhausted yet
            if self.prefix_cache and not s.published:
                # prefill just completed: the lane's full prompt blocks
                # now hold exactly the shared-prefix KV — index them
                self.pool.publish_prefix(i, s.prompt)
                s.published = True
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
        # every occupied slot holds KV — parked lanes included (their
        # pages are exactly the ones pinning the pool under pressure)
        live_tokens = sum(s.fed for s in self._slots if s is not None)
        self.stats.kv_token_steps += live_tokens
        self.stats.kv_tokens_live = live_tokens
        self.stats.kv_pages_live = (self.pool.n_live_pages
                                    if self.paged else 0)
        return done

    def _serve(self, key: tuple, args: dict, draws: list, pages=None) -> np.ndarray:
        """Run the serve step variant ``key`` = (width, with_logits) on
        ``args`` (numpy) and ``pages`` (the page exchange's plan: eager
        steps only); its tokens, the lanes of ``draws`` sampled.

        The inputs are staged into the variant's static buffers. On the
        CPU the step function runs on them eagerly. On CUDA the variant's
        first step runs eagerly on a side stream (it loads the kernels'
        libraries and sets their attributes, cuBLAS's handles and
        workspaces) and its tokens are that step's; the step is then
        captured as a graph over the same buffers, the params and the KV
        pool (both updated in place, never reallocated), and every later
        step of the variant is a replay. A failed capture raises."""
        staging = self._staging.get(key)
        if staging is None:
            staging = self._staging[key] = _Staging(args, self.device)
        inputs = staging.load(args)
        fn = self._fn(*key)
        if not self._use_graphs:
            with torch.no_grad():
                *out, self.pool.cache = fn(self.params, self.pool.cache, **inputs, pages=pages)
            return self._read(out, draws)
        with torch.cuda.device(self.device):
            graph = self._graphs.get(key)
            if graph is not None:
                graph[0].replay()
                self.graphs[key].replays += 1
                return self._read(graph[1], draws)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.no_grad(), torch.cuda.stream(side):
                *out, _ = fn(self.params, self.pool.cache, **inputs)
                tokens = self._read(out, draws)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            with torch.no_grad(), torch.cuda.graph(graph):
                *captured, _ = fn(self.params, self.pool.cache, **inputs)
            after = launch_counts()
        self._graphs[key] = (graph, tuple(captured))
        self.graphs[key] = GraphStats(kernels={
            k: after[k] - before[k] for k in after if after[k] != before[k]})
        return tokens

    def _gather_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """Every slot's token: this rank's ``tokens`` gathered in rank order
        over the data ranks when the slots are split over them."""
        if not self._split:
            return tokens
        t0 = time.perf_counter()
        group = self.mesh.dp_group()
        local = torch.from_numpy(np.ascontiguousarray(tokens).reshape(-1)).to(
            MH.group_device(group))
        parts = gather_parts(local, group, self.token_gather.wire)
        self.token_gather.calls += 1
        self.token_gather.seconds += time.perf_counter() - t0
        return torch.cat(parts).cpu().numpy()

    def _read(self, out, draws: list) -> np.ndarray:
        """The step's tokens on the host: ``out`` is (tokens,) or (tokens,
        logits) on the device; the lanes of ``draws`` are sampled from
        their logits rows first, on the device."""
        tokens = out[0]
        if draws:
            tokens = self._sample(tokens, out[1], draws)
        return tokens.cpu().numpy()

    def _sample(self, tokens: torch.Tensor, logits: torch.Tensor, draws: list) -> torch.Tensor:
        """``tokens`` with each lane of ``draws`` (lane, temperature,
        top_k, top_p, key) replaced by its draw from its logits row."""
        lanes, temperature, top_k, top_p, keys = (list(c) for c in zip(*draws))
        idx = sampling.to_device(lanes, torch.int64, tokens.device)
        drawn = sampling.sample(logits.index_select(0, idx), temperature, top_k, top_p, keys)
        return tokens.index_copy(0, idx, drawn.to(tokens.dtype)[:, None])

    def run(self, max_steps: Optional[int] = None) -> list[Completion]:
        """Step until drained (or ``max_steps`` *further* iterations —
        relative to this call); completions in finish order."""
        out: list[Completion] = []
        start = self.stats.steps
        while self.has_work():
            if max_steps is not None and self.stats.steps - start >= max_steps:
                break
            out.extend(self.step())
        return out
