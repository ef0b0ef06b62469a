"""Ranks of tests/test_torch_tp_serve.py and tests/test_torch_tp_families.py:
a reduced config (``ARCH``, or the one a scenario is given) served on
``(data, model)`` meshes of gloo ranks, from the reference's weights.

    python -m repro_torch.launch.dist_launch -n 2 -- python tests/_torch_tp_worker.py pair OUT
    python -m repro_torch.launch.dist_launch -n 4 -- python tests/_torch_tp_worker.py quad OUT
    python -m repro_torch.launch.dist_launch -n 2 -- python tests/_torch_tp_worker.py family OUT A...
    python -m repro_torch.launch.dist_launch -n 4 -- python tests/_torch_tp_worker.py family_quad OUT A
    python -m repro_torch.launch.dist_launch -n 2 -- python tests/_torch_tp_worker.py hybrid OUT S...
    python -m repro_torch.launch.dist_launch -n 4 -- python tests/_torch_tp_worker.py hybrid_quad OUT

``pair`` (2 ranks) serves qwen2.5-3b on 1 x 2 (contiguous, paged, paged
with chunk 4, sampled lanes, and the teacher-forced schedule's logits), on
2 x 1 and in one process; ``quad`` (4 ranks) on 2 x 2. ``family`` serves
each arch A (MoE, Mamba) on 1 x 2 (contiguous, paged, the schedule's
logits under ``bf16_standard`` and ``fp32``) and in one process, and
holds ``axes.own_halves`` against the unsplit product; ``family_quad``
serves A on 2 x 2. ``hybrid`` takes config specs S (``arch[:field=N...]``:
the reduced config with those fields replaced, :func:`configs`): an
RG-LRU spec as ``family`` does (the engine for the plain arch only), an
encoder-decoder spec's lock-step decode logits (:func:`encdec_logits`),
and ``axes.gather_shards`` against the unsplit product; ``hybrid_quad``
serves recurrentgemma on 2 x 2 and qwen2.5-3b and recurrentgemma with 5
query heads on 1 x 4. ``dp_paged`` (2 ranks) serves paged pools whose rows
shard over the data ranks (ROADMAP A12 item 3) on 2 x 1, and on 1 x 2 for
``dp_paged_quad`` (4 ranks: 2 x 2) to be held against (:func:`paged_run`).
Each rank saves what it saw to ``OUT/rank<r>_<scenario>[_<arch or spec>].pt``.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from repro.core import get_policy as j_get_policy
from repro.models import registry as JR
from repro_torch.convert import from_jax_params
from repro_torch.core.policy import get_policy
from repro_torch.core.qarith import QArith
from repro_torch.dist import axes
from repro_torch.dist import fsdp as F
from repro_torch.dist import multihost as MH
from repro_torch.dist import partition as PT
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import registry as R
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_serve_step

from _torch_ranks import config_overrides

ARCH = "qwen2.5-3b"
POLICY = "bf16_standard"
N_SLOTS, MAX_LEN = 8, 24
# the requests of tests/test_serve.py's sharded engine test
SIZES = (5, 7, 5, 7, 5, 7, 5, 7, 5, 7)
GENS = (6, 8, 6, 8, 6, 8, 6, 8, 6, 8)
# the teacher-forced schedule: every lane one random token a step
SCHEDULE_STEPS = 12


def requests(vocab: int) -> list:
    rng = np.random.default_rng(2)
    return [(rng.integers(0, vocab, size=s).astype(np.int32), g) for s, g in zip(SIZES, GENS)]


def schedule(vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (SCHEDULE_STEPS, N_SLOTS)).astype(np.int32)


# the encoder-decoder's source frames (one flash chunk) in its lock-step decode
SRC_LEN = 16


def configs(spec: str):
    """(the port's config, the reference's) of ``spec`` = ``arch`` or
    ``arch:field=N:...``: the reduced config with those integer fields
    replaced on both sides (e.g. ``recurrentgemma-2b:n_heads=5``, 2.5 query
    heads per rank on 1 x 2; ``whisper-base:vocab=515``, a vocabulary no
    even axis divides)."""
    arch, over = config_overrides(spec)
    return (dataclasses.replace(R.get_config(arch).reduced(), **over),
            dataclasses.replace(JR.get_config(arch).reduced(), **over))


def src_embeds(d_model: int) -> np.ndarray:
    return np.random.default_rng(4).standard_normal((N_SLOTS, SRC_LEN, d_model)).astype(
        np.float32)


def reference_tree(arch: str = ARCH):
    cfg = configs(arch)[1]
    params = JR.init(cfg, jax.random.PRNGKey(0), j_get_policy(POLICY).param_dtype)
    return jax.tree_util.tree_map(np.asarray, params)


def shards(tree, cfg, mesh):
    if mesh is None:
        return from_jax_params(tree, device="cpu")
    return from_jax_params(tree, device="cpu", specs=PT.param_specs(tree, cfg, mesh), mesh=mesh)


def serve(tree, cfg, mesh, *, sampled=False, **kw) -> dict:
    """Every request's tokens from an engine on ``mesh`` (None: one process)."""
    eng = Engine(shards(tree, cfg, mesh), cfg, get_policy(POLICY), n_slots=N_SLOTS,
                 max_len=MAX_LEN, device="cpu", mesh=mesh, **kw)
    for i, (p, g) in enumerate(requests(cfg.vocab)):
        knobs = dict(temperature=0.8, top_k=50, top_p=0.95, seed=3) if sampled and i % 2 else {}
        eng.submit(p, g, **knobs)
    done = eng.run()
    assert len(done) == len(SIZES) and not eng.graphs
    out = {c.rid: c.tokens for c in done}
    if kw.get("paged"):
        out["preemptions"] = eng.stats.preemptions
    return out


def schedule_logits(tree, cfg, mesh, policy=None) -> np.ndarray:
    """The serve step's logits (steps, slots, vocab) on the teacher-forced
    schedule, from an empty pool. ``tree`` None: the port's own f32
    weights from seed 0 under ``policy`` (``fp32``)."""
    params, policy = _params(tree, cfg, mesh, policy)
    step = make_serve_step(cfg, policy, return_logits=True, mesh=mesh)
    cache = R.make_cache(params, cfg, batch_size=N_SLOTS, max_len=MAX_LEN,
                         dtype=policy.compute_dtype, mesh=mesh)
    toks = schedule(cfg.vocab)
    out = []
    with torch.no_grad():
        for t, row in enumerate(toks):
            _, logits, cache = step(params, cache, torch.from_numpy(row)[:, None],
                                    torch.full((N_SLOTS,), t, dtype=torch.int32),
                                    torch.ones(N_SLOTS, dtype=torch.bool),
                                    torch.full((N_SLOTS,), t == 0))
            out.append(logits.numpy())
    return np.stack(out)


def _params(tree, cfg, mesh, policy):
    """The reference's weights (``tree``) under ``bf16_standard``, or the
    port's own from seed 0 (``tree`` None) under ``policy``, sharded on
    ``mesh``; and the policy."""
    if tree is not None:
        return shards(tree, cfg, mesh), get_policy(POLICY)
    full = R.init(cfg, 0, torch.float32, device="cpu")
    return (full if mesh is None else
            F.shard_state(full, PT.param_specs(full, cfg, mesh), mesh)), policy


def encdec_logits(tree, cfg, mesh, policy=None) -> np.ndarray:
    """An encoder-decoder's lock-step decode logits (steps, slots, vocab)
    on the schedule: ``make_cache`` encodes :func:`src_embeds`, then the
    serve step advances every lane one token a step."""
    params, policy = _params(tree, cfg, mesh, policy)
    step = make_serve_step(cfg, policy, return_logits=True, mesh=mesh)
    cache = R.make_cache(params, cfg, batch_size=N_SLOTS, max_len=MAX_LEN,
                         dtype=policy.compute_dtype, qa=QArith(policy), mesh=mesh,
                         batch={"src_embeds": torch.from_numpy(src_embeds(cfg.d_model))})
    out = []
    with torch.no_grad():
        for t, row in enumerate(schedule(cfg.vocab)):
            _, logits, cache = step(params, cache, torch.from_numpy(row)[:, None],
                                    torch.full((N_SLOTS,), t, dtype=torch.int32))
            out.append(logits.numpy())
    return np.stack(out)


def lockstep_logits(tree, cfg, mesh, seqs) -> list:
    """Teacher-forced logits after every token of each sequence (one lane
    each), under the mesh's model axis."""
    policy = get_policy(POLICY)
    params = shards(tree, cfg, mesh)
    step = make_serve_step(cfg, policy, return_logits=True, mesh=mesh)
    out = []
    with torch.no_grad():
        for seq in seqs:
            cache = R.make_cache(params, cfg, batch_size=1, max_len=MAX_LEN,
                                 dtype=policy.compute_dtype, mesh=mesh)
            rows = []
            for t, tok in enumerate(seq):
                _, logits, cache = step(params, cache, torch.tensor([[int(tok)]], dtype=torch.int32),
                                        torch.tensor([t], dtype=torch.int32))
                rows.append(logits[0].numpy())
            out.append(np.stack(rows))
    return out


def scenario_pair(out: Path, rank: int):
    cfg = R.get_config(ARCH).reduced()
    tree = reference_tree()
    tp, dp = make_local_mesh(1, 2), make_local_mesh(2, 1)
    res = {"coords": tp.coords(rank)}
    res["tp"] = serve(tree, cfg, tp)
    stats = axes.for_mesh(tp).stats
    res["collectives"] = (stats.calls, stats.bytes)
    res["tp_paged"] = serve(tree, cfg, tp, paged=True, page_size=4, n_pages=12)
    res["tp_chunk"] = serve(tree, cfg, tp, paged=True, page_size=4, n_pages=12,
                            prefill_chunk=4)
    base = res["tp_paged"]
    reqs = requests(cfg.vocab)
    res["tp_lockstep"] = lockstep_logits(tree, cfg, tp, [np.concatenate([p, base[r]])
                                                         for r, (p, _) in enumerate(reqs)])
    res["tp_sampled"] = serve(tree, cfg, tp, sampled=True)
    res["tp_schedule"] = schedule_logits(tree, cfg, tp)
    res["dp"] = serve(tree, cfg, dp)
    res["one"] = serve(tree, cfg, None)
    res["one_schedule"] = schedule_logits(tree, cfg, None)
    fp32 = get_policy("fp32")
    res["fp32_schedule"] = (schedule_logits(None, cfg, tp, fp32),
                            schedule_logits(None, cfg, None, fp32))
    torch.save(res, out / f"rank{rank}_pair.pt")


def own_halves_check(rank: int, mesh) -> dict:
    """``axes.own_halves`` after a column-parallel product split
    contiguously, forward and backward, against the unsplit product (f64:
    exact comparisons)."""
    axis = axes.for_mesh(mesh)
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 3, 8), generator=g, dtype=torch.float64)
    w = torch.randn((8, 16), generator=g, dtype=torch.float64)
    cot = torch.randn((2, 3, 16), generator=g, dtype=torch.float64)
    width, own = 16 // axis.size, 8 // axis.size
    w_local = w[:, rank * width:(rank + 1) * width].clone().requires_grad_(True)
    with axes.model_axis(axis):
        got = axes.own_halves(x @ w_local)
    take = lambda t: torch.cat([h[..., rank * own:(rank + 1) * own]       # noqa: E731
                                for h in t.chunk(2, dim=-1)], dim=-1)
    (got * take(cot)).sum().backward()
    return {"fwd": got.detach(), "want": take(x @ w), "grad": w_local.grad,
            "want_grad": (x.reshape(-1, 8).T @ cot.reshape(-1, 16))[:, rank * width:
                                                                     (rank + 1) * width]}


def scenario_family(out: Path, rank: int, *archs: str):
    tp = make_local_mesh(1, 2)
    fp32 = get_policy("fp32")
    for arch in archs:
        cfg = R.get_config(arch).reduced()
        tree = reference_tree(arch)
        res = {"coords": tp.coords(rank)}
        stats = axes.for_mesh(tp).stats
        calls = stats.calls
        res["tp"] = serve(tree, cfg, tp)
        res["steps_calls"] = stats.calls - calls
        res["tp_paged"] = serve(tree, cfg, tp, paged=True, page_size=4, n_pages=12)
        res["one"] = serve(tree, cfg, None)
        calls = stats.calls
        res["tp_schedule"] = schedule_logits(tree, cfg, tp)
        res["schedule_calls"] = stats.calls - calls
        res["one_schedule"] = schedule_logits(tree, cfg, None)
        res["fp32_schedule"] = (schedule_logits(None, cfg, tp, fp32),
                                schedule_logits(None, cfg, None, fp32))
        res["own_halves"] = own_halves_check(rank, tp)
        torch.save(res, out / f"rank{rank}_family_{arch}.pt")


def gather_shards_check(rank: int, mesh) -> dict:
    """``axes.gather_shards`` of two column-parallel products, forward and
    backward, against the unsplit products (f64: the forward is exact,
    the backward's sum runs in f32). Each
    rank's later work reads the whole outputs with its own cotangents, so
    a shard's gradient is the sum of every rank's at its columns."""
    axis = axes.for_mesh(mesh)
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 3, 8), generator=g, dtype=torch.float64)
    w = [torch.randn((8, 12), generator=g, dtype=torch.float64) for _ in range(2)]
    cots = [[torch.randn((2, 3, 12), generator=g, dtype=torch.float64) for _ in range(2)]
            for _ in range(axis.size)]
    width = 12 // axis.size
    cols = slice(rank * width, (rank + 1) * width)
    local = [t[:, cols].clone().requires_grad_(True) for t in w]
    calls = axis.stats.calls
    with axes.model_axis(axis):
        got = axes.gather_shards(*(x @ t for t in local))
    sum((o * c).sum() for o, c in zip(got, cots[rank])).backward()
    flat = x.reshape(-1, 8).T
    return {"fwd": [o.detach() for o in got], "want": [x @ t for t in w],
            "grad": [t.grad for t in local],
            "want_grad": [(flat @ sum(c[i] for c in cots).reshape(-1, 12))[:, cols]
                          for i in range(2)],
            "calls": axis.stats.calls - calls}


def scenario_hybrid(out: Path, rank: int, *specs: str):
    tp = make_local_mesh(1, 2)
    fp32 = get_policy("fp32")
    stats = axes.for_mesh(tp).stats
    torch.save(gather_shards_check(rank, tp), out / f"rank{rank}_hybrid_gather.pt")
    for spec in specs:
        cfg = configs(spec)[0]
        tree = reference_tree(spec)
        logits = encdec_logits if cfg.encdec else schedule_logits
        res = {"coords": tp.coords(rank)}
        if spec == "recurrentgemma-2b":
            res["tp"] = serve(tree, cfg, tp)
            res["tp_paged"] = serve(tree, cfg, tp, paged=True, page_size=4, n_pages=12)
            res["one"] = serve(tree, cfg, None)
        calls = stats.calls
        res["tp_schedule"] = logits(tree, cfg, tp)
        res["schedule_calls"] = stats.calls - calls
        res["one_schedule"] = logits(tree, cfg, None)
        res["fp32_schedule"] = (logits(None, cfg, tp, fp32), logits(None, cfg, None, fp32))
        torch.save(res, out / f"rank{rank}_hybrid_{spec}.pt")


def scenario_hybrid_quad(out: Path, rank: int):
    """recurrentgemma's engine on 2 x 2 (the sharded RG-LRU state under a
    data axis); on 1 x 4 qwen2.5-3b (2 kv heads: each rank keeps the one
    its query heads read) contiguous and paged, and recurrentgemma with 5
    query heads (padded to 8), the schedule's logits beside one process's."""
    quad = make_local_mesh(2, 2)
    res = {"coords": quad.coords(rank)}
    rg = "recurrentgemma-2b"
    res["rg_tokens"] = serve(reference_tree(rg), configs(rg)[0], quad)
    wide = make_local_mesh(1, 4)
    for spec in ("qwen2.5-3b", "recurrentgemma-2b:n_heads=5"):
        cfg, tree = configs(spec)[0], reference_tree(spec)
        res[spec] = {"tp_schedule": schedule_logits(tree, cfg, wide),
                     "one_schedule": schedule_logits(tree, cfg, None)}
    q = configs("qwen2.5-3b")[0]
    tree = reference_tree("qwen2.5-3b")
    res["qwen_tp"] = serve(tree, q, wide)
    res["qwen_paged"] = serve(tree, q, wide, paged=True, page_size=4, n_pages=12)
    res["qwen_one"] = serve(tree, q, None)
    torch.save(res, out / f"rank{rank}_hybrid_quad.pt")


def scenario_family_quad(out: Path, rank: int, arch: str):
    cfg = R.get_config(arch).reduced()
    mesh = make_local_mesh(2, 2)
    torch.save({"coords": mesh.coords(rank), "tokens": serve(reference_tree(arch), cfg, mesh)},
               out / f"rank{rank}_family_quad_{arch}.pt")


def scenario_quad(out: Path, rank: int):
    cfg = R.get_config(ARCH).reduced()
    mesh = make_local_mesh(2, 2)
    eng_tokens = serve(reference_tree(), cfg, mesh)
    torch.save({"coords": mesh.coords(rank), "tokens": eng_tokens}, out / f"rank{rank}_quad.pt")


# the paged engines under a data axis: the stream of the reference's
# sharded paged engine test (rng 15, 6 requests), 4 slots, pages of 4
DP_SIZES, DP_GENS = (5, 7, 5, 7, 5, 7), (6, 8, 6, 8, 6, 8)
DP_SLOTS, DP_PAGE, DP_PAGES = 4, 4, 12
# a stream that crosses ranks in every way the exchange handles: 8
# requests, two in three behind one 8-token prefix (two pages), on 10 pages
FORCED_REQUESTS, FORCED_PAGES = 8, 10


def dp_requests(vocab: int) -> list:
    rng = np.random.default_rng(15)
    return [(rng.integers(0, vocab, size=s).astype(np.int32), g) for s, g in zip(DP_SIZES, DP_GENS)]


def forced_requests(vocab: int) -> list:
    """Prompts behind a shared 8-token prefix (some of them the prefix
    alone: their last token's write copies a shared page) and unrelated
    ones, on a pool tight enough to preempt."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, 8).astype(np.int32)
    out = []
    for _ in range(FORCED_REQUESTS):
        shared = int(rng.integers(0, 3))
        tail = rng.integers(0, vocab, int(rng.integers(0, 6))).astype(np.int32)
        prompt = (np.concatenate([prefix, tail]) if shared else
                  rng.integers(0, vocab, int(rng.integers(3, 10))).astype(np.int32))
        out.append((prompt, int(rng.integers(3, 9))))
    return out


class CrossRank:
    """Counts, on an engine whose pool shards its rows over 2 data ranks
    with split slots, the steps' cases that cross ranks: a copy-on-write
    whose source and destination lie on different ranks, a recycled page
    owned by a rank other than its lane's, a prefix hit adopting another
    rank's pages, a preemption of a lane on another rank than the lane
    that needed the pages, and a lane whose table names rows of both."""

    def __init__(self, eng):
        self.counts = dict(cow=0, reset=0, hit=0, preempt=0, both=0)
        ex, pool = eng.pages, eng.pool
        lane = lambda slot: next(d for d, (a, b) in enumerate(ex.lanes)    # noqa: E731
                                 if a <= slot < b)
        planning = {}
        prepare, adopt, preempt, plan = pool.prepare_write, pool.adopt_prefix, eng._preempt, ex.plan

        def prepare_write(slot, start, n):
            planning["slot"] = slot
            got = prepare(slot, start, n)
            if got is not None:
                self.counts["cow"] += sum(ex.owner(d) != ex.owner(s) for d, s in got[1])
                self.counts["reset"] += sum(ex.owner(p) != lane(slot) for p in got[0])
            return got

        def adopt_prefix(slot, pages):
            self.counts["hit"] += any(ex.owner(p) != lane(slot) for p in pages)
            return adopt(slot, pages)

        def preempt_lane(victim, reset):
            self.counts["preempt"] += lane(victim) != lane(planning["slot"])
            return preempt(victim, reset)

        def plan_step(table, *args, **kw):
            for row in table:
                owners = {ex.owner(g) for g in row if g != pool.null_page}
                self.counts["both"] += len(owners) == 2
            return plan(table, *args, **kw)
        pool.prepare_write, pool.adopt_prefix = prepare_write, adopt_prefix
        eng._preempt, ex.plan = preempt_lane, plan_step


def paged_run(tree, cfg, mesh, reqs, *, n_slots=DP_SLOTS, n_pages=DP_PAGES, chunk=1,
              count=False) -> dict:
    """A paged engine's tokens, stats, this rank's page rows of every paged
    leaf, its pool bytes and its exchange's counts on ``mesh`` (None: one
    process) over ``reqs``."""
    eng = Engine(shards(tree, cfg, mesh), cfg, get_policy(POLICY), n_slots=n_slots,
                 max_len=MAX_LEN, device="cpu", mesh=mesh, paged=True, page_size=DP_PAGE,
                 n_pages=n_pages, prefill_chunk=chunk)
    counter = CrossRank(eng) if count else None
    for p, g in reqs:
        eng.submit(p, g)
    done = eng.run()
    assert len(done) == len(reqs) and not eng.graphs
    eng.pool.check_invariants()
    st, pool = eng.stats, eng.pool
    out = {"tokens": {c.rid: c.tokens for c in done},
           "stats": (st.steps, st.preemptions, st.prefix_hits, st.prefix_tokens_reused),
           "rows": pool.rows, "n_rows": pool.n_rows, "slots": pool.slots,
           "pages": {f"{root}.{name}.{k}": t.clone() for root, blocks in pool.cache.items()
                     for name, leaf in blocks.items() if isinstance(leaf, dict) and
                     "k_pages" in leaf for k, t in leaf.items()},
           "page_nbytes": pool.page_nbytes(), "global_page_nbytes": pool.global_page_nbytes()}
    if eng.pages is not None:
        ex = eng.pages.stats
        out["exchange"] = dict(calls=ex.calls, planned_calls=ex.planned_calls, bytes=ex.bytes,
                               planned_bytes=ex.planned_bytes, steps=ex.steps,
                               rows_sent=ex.rows_sent, cells_sent=ex.cells_sent)
    if counter is not None:
        out["cross"] = counter.counts
    return out


DP_FAMILIES = ("mixtral-8x22b", "recurrentgemma-2b")


def scenario_dp_paged(out: Path, rank: int):
    """2 x 1 (and 1 x 2) paged engines; the one-process runs they are held
    to are split between the two ranks."""
    cfg = R.get_config(ARCH).reduced()
    tree = reference_tree()
    dp, tp = make_local_mesh(2, 1), make_local_mesh(1, 2)
    ref, forced = dp_requests(cfg.vocab), forced_requests(cfg.vocab)
    res = {"coords": dp.coords(rank)}
    cases = {}                                   # name: (tree, cfg, requests, keywords)
    for chunk in (1, 4):
        cases[f"ref_{chunk}"] = (tree, cfg, ref, dict(chunk=chunk))
        cases[f"forced_{chunk}"] = (tree, cfg, forced, dict(chunk=chunk, n_pages=FORCED_PAGES))
    cases["slots_3"] = (tree, cfg, ref, dict(n_slots=3))
    for arch in DP_FAMILIES:
        fcfg = R.get_config(arch).reduced()
        cases[arch] = (reference_tree(arch), fcfg, dp_requests(fcfg.vocab), {})
    for name, (t, c, reqs, kw) in cases.items():
        res[f"dp_{name}"] = paged_run(t, c, dp, reqs, count=name.startswith("forced"), **kw)
    for chunk in (1, 4):
        res[f"tp_ref_{chunk}"] = paged_run(tree, cfg, tp, ref, chunk=chunk)
    res["one"] = {name: paged_run(t, c, None, reqs, **kw)
                  for i, (name, (t, c, reqs, kw)) in enumerate(cases.items()) if i % 2 == rank}
    torch.save(res, out / f"rank{rank}_dp_paged.pt")


def scenario_dp_paged_quad(out: Path, rank: int):
    cfg = R.get_config(ARCH).reduced()
    mesh = make_local_mesh(2, 2)
    tree, ref = reference_tree(), dp_requests(cfg.vocab)
    res = {"coords": mesh.coords(rank)}
    for chunk in (1, 4):
        res[f"ref_{chunk}"] = paged_run(tree, cfg, mesh, ref, chunk=chunk)
    torch.save(res, out / f"rank{rank}_dp_paged_quad.pt")


def main():
    scenario, out = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    MH.initialize(device="cpu", timeout_secs=float(os.environ.get("WORKER_TIMEOUT", 120)))
    try:
        globals()[f"scenario_{scenario}"](out, MH.process_index(), *sys.argv[3:])
    finally:
        MH.shutdown()


if __name__ == "__main__":
    main()
