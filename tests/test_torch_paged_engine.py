"""The port's paged, chunked and prefix-cached engine on the CPU.

* Schedule ≡ the reference's JAX engine on the same stream (no EOS, so
  the schedule does not depend on token values), step by step: token
  width, lane positions, ``active``/``reset`` masks, block tables,
  ``page_reset``, copy-on-write rows, chunk ``n_tok``, the prompt tokens
  fed, and the final ``EngineStats`` and completion accounting. Both
  pass the copy-on-write list at the reference's static width, padded
  with ``dst`` = R rows, and the comparison holds it entry for entry,
  padding included.
* Tokens against the reference at the logit level, as
  tests/test_torch_serve.py does: both models are teacher-forced on the
  reference's streams, their logits agree within ``LOGIT_TOL`` (XLA:CPU
  keeps some bf16 intermediates in f32 under ``jit``, ROADMAP C7), and a
  token may differ only where the reference's top-2 margin is within it.
* Within the port, token for token: paged ≡ contiguous ≡ ``generate``
  (each ``generate`` batch padded to the engine's lane count, ROADMAP C6),
  through preemption and prefix hits, fused or not.
* Chunked against unchunked (ROADMAP C10): a chunk step runs its dense
  products at N·C rows where a single-token step runs N, and a row can
  round differently (C6), so a chunk-written KV cell may differ by a bf16
  ulp. The chunked run's tokens equal the chunk-1 run's, or part only
  where the chunk-1 model's margin for its own token is within
  ``LOGIT_TOL``. (On this reduced config they happen to agree token for
  token.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.models import registry as JR
from repro.serve import Engine as JEngine
from repro_torch.convert import from_jax_params
from repro_torch.core.policy import get_policy
from repro_torch.core.qarith import QArith
from repro_torch.launch import serve as launch_serve
from repro_torch.models import registry as R
from repro_torch.serve.decode import generate
from repro_torch.serve.engine import Engine

from _torch_cpu import one_torch_thread  # noqa: F401

NEAREST = get_policy("bf16_standard")
LOGIT_TOL = 0.125
N_SLOTS, MAX_LEN = 4, 48


def _stream(vocab, n=10, seed=0):
    """Prompts of 6–25 tokens, 3 in 4 behind one common 8-token prefix,
    the fifth a repeat of the first cut to whole 4-token pages (a full
    prompt match: its last token is re-fed into a shared page, which
    copies on write); generations of 4–12 tokens."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, 8)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, int(rng.integers(6, 18)))
        if i % 4 != 3:
            p = np.concatenate([common, p])
        if i == 4:
            p = out[0][0][:out[0][0].size // 4 * 4]
        out.append((p.astype(np.int32), int(rng.integers(4, 13))))
    return out


@pytest.fixture(scope="module")
def models():
    jcfg = JR.get_config("qwen2.5-3b").reduced()
    jparams = JR.init(jcfg, jax.random.PRNGKey(0), j_get_policy("bf16_standard").param_dtype)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, R.get_config("qwen2.5-3b").reduced(), params


def _recorder(eng, log):
    """Wrap a step function of ``eng`` so that each call logs a copy of
    its inputs (the port's are static buffers that every step reloads):
    masks, positions, tables, the copy-on-write list, the token width and
    the tokens of prefilling lanes."""
    def wrap(fn):
        def step(params, cache, token, pos, active=None, reset=None, **kw):
            tok = np.array(token)
            rows = {k: np.array(v) for k, v in
                    dict(pos=pos, active=active, reset=reset, **kw).items() if v is not None}
            rows["width"] = tok.shape[1]
            rows["prefill_tokens"] = {
                i: tok[i].tolist() for i, s in enumerate(eng._slots)
                if s is not None and rows["active"][i] and s.fed < s.prompt.size}
            log.append(rows)
            return fn(params, cache, token, pos, active, reset, **kw)
        return step
    return wrap


CONFIGS = {
    "paged_prefix_preempt": dict(paged=True, page_size=4, n_pages=16),
    "paged_chunked": dict(paged=True, page_size=4, n_pages=16, prefill_chunk=4),
}


def _run_both(models, kw):
    jcfg, jparams, cfg, params = models
    jeng = JEngine(jparams, jcfg, j_get_policy("bf16_standard"), n_slots=N_SLOTS,
                   max_len=MAX_LEN, **kw)
    teng = Engine(params, cfg, NEAREST, n_slots=N_SLOTS, max_len=MAX_LEN, device="cpu", **kw)
    jlog, tlog = [], []
    jwrap, jfn = _recorder(jeng, jlog), jeng._fn
    jeng._fn = lambda width, with_logits: jwrap(jfn(width, with_logits))
    twrap = _recorder(teng, tlog)
    teng._fns = {w: twrap(f) for w, f in teng._fns.items()}
    for p, g in _stream(cfg.vocab):
        jeng.submit(p, g)
        teng.submit(p, g)
    return jeng, teng, jlog, tlog, jeng.run(), teng.run()


_RUNS: dict = {}


def _cached_run(models, config):
    """``_run_both`` once per config for the tests that read its logs."""
    if config not in _RUNS:
        _RUNS[config] = _run_both(models, CONFIGS[config])
    return _RUNS[config]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_schedule_matches_reference_step_by_step(models, config):
    jeng, teng, jlog, tlog, jdone, tdone = _cached_run(models, config)
    assert len(tlog) == len(jlog) == teng.stats.steps
    for step, (want, got) in enumerate(zip(jlog, tlog)):
        assert sorted(got) == sorted(want), (step, sorted(got), sorted(want))
        for name, value in want.items():
            if isinstance(value, np.ndarray):
                assert np.array_equal(got[name], value), (step, name)
            else:
                assert got[name] == value, (step, name)
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert teng.stats.preemptions >= 1 and teng.stats.prefix_hits >= 1
    n_rows = teng.pool.n_rows
    assert all(rows["copy_dst"].shape == (teng._max_copies,) for rows in tlog)
    assert any((rows["copy_dst"] < n_rows).any() for rows in tlog)     # copy-on-write ran
    assert any((rows["copy_dst"] == n_rows).sum() > 1 for rows in tlog)  # padding passed
    acct = lambda c: (c.rid, c.slot, c.admitted_step, c.finished_step,  # noqa: E731
                      c.first_token_step, c.finish_reason, c.tokens.size)
    assert [acct(c) for c in tdone] == [acct(c) for c in jdone]
    teng.pool.check_invariants()
    _tokens_at_logit_level(models, {c.rid: c.tokens for c in jdone},
                           {c.rid: c.tokens for c in tdone})


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_copy_list_has_the_reference_static_width(models, config):
    """Every paged step passes the copy-on-write list at the reference's
    static width K = n_slots · ((prefill_chunk − 1) // page_size + 2): the
    real rows first, then padding rows dst = R (the pool's row count),
    src = 0 — entry for entry the JAX engine's list."""
    jeng, teng, jlog, tlog, _, _ = _cached_run(models, config)
    kw = CONFIGS[config]
    K = N_SLOTS * ((kw.get("prefill_chunk", 1) - 1) // kw["page_size"] + 2)
    assert teng._max_copies == jeng._max_copies == K
    n_rows = teng.pool.n_rows
    for want, got in zip(jlog, tlog):
        dst, src = got["copy_dst"], got["copy_src"]
        assert dst.shape == src.shape == (K,) and dst.dtype == src.dtype == np.int32
        n_real = int((dst < n_rows).sum())
        assert (dst[:n_real] < n_rows).all()
        assert (dst[n_real:] == n_rows).all() and (src[n_real:] == 0).all()
        assert np.array_equal(dst, want["copy_dst"]) and np.array_equal(src, want["copy_src"])


def _tokens_at_logit_level(models, j_tok, t_tok):
    jcfg, jparams, cfg, params = models
    stream = _stream(cfg.vocab)
    n = len(stream)
    seqs = [np.concatenate([p, j_tok[r][:-1]]) for r, (p, _) in enumerate(stream)]
    T = max(s.size for s in seqs)
    batch = np.zeros((n, T), np.int32)
    for r, s in enumerate(seqs):
        batch[r, :s.size] = s
    jpol = j_get_policy("bf16_standard")
    from repro.core.qarith import QArith as JQArith
    jqa, tqa = JQArith(jpol), QArith(NEAREST)
    jcache = JR.make_cache(jqa, jparams, jcfg, {}, batch_size=n, max_len=T,
                           dtype=jpol.compute_dtype)
    tcache = R.make_cache(params, cfg, batch_size=n, max_len=T, dtype=NEAREST.compute_dtype)
    step = jax.jit(lambda p, c, t, pos: JR.decode(jqa, p, jcfg, t, c, pos))
    jl, tl = [], []
    for t in range(T):
        pos = np.full((n,), t, np.int32)
        a, jcache = step(jparams, jcache, jnp.asarray(batch[:, t:t + 1]), jnp.asarray(pos))
        b, tcache = R.decode(tqa, params, cfg, torch.from_numpy(batch[:, t:t + 1]), tcache,
                             torch.from_numpy(pos))
        jl.append(np.asarray(a)[:, 0])
        tl.append(b.numpy()[:, 0])
    jl, tl = np.stack(jl, 1), np.stack(tl, 1)                 # (n, T, V)
    compared = 0
    for r, (p, gen) in enumerate(stream):
        rows = slice(p.size - 1, p.size - 1 + gen)
        assert np.abs(jl[r, rows] - tl[r, rows]).max() <= LOGIT_TOL
        for t in range(gen):
            ref = jl[r, p.size - 1 + t]
            assert ref[j_tok[r][t]] >= ref.max() - LOGIT_TOL     # the reference's own pick
            if t_tok[r][t] != j_tok[r][t]:
                top2 = np.sort(ref)[-2:]
                assert top2[1] - top2[0] <= LOGIT_TOL, (r, t, top2)
                break                                           # the streams part here
            compared += 1
    assert compared >= sum(g for _, g in stream) // 2


def _port_run(params, cfg, stream, **kw):
    eng = Engine(params, cfg, NEAREST, n_slots=N_SLOTS, max_len=MAX_LEN, device="cpu", **kw)
    for p, g in stream:
        eng.submit(p, g)
    done = eng.run()
    return {c.rid: c.tokens for c in done}, eng


def test_paged_equals_contiguous_equals_generate(models):
    _, _, cfg, params = models
    stream = _stream(cfg.vocab, seed=1)
    base, _ = _port_run(params, cfg, stream)
    for kw in (dict(paged=True, page_size=4), dict(paged=True, page_size=4, n_pages=16),
               dict(paged=True, page_size=4, n_pages=16, fused_decode=True),
               dict(paged=True, page_size=8, n_pages=8, prefix_cache=False)):
        toks, eng = _port_run(params, cfg, stream, **kw)
        assert toks.keys() == base.keys()
        for rid in base:
            assert np.array_equal(toks[rid], base[rid]), (kw, rid)
        if kw.get("n_pages") == 16:
            assert eng.stats.preemptions >= 1 and eng.stats.prefix_hits >= 1
    groups = {}
    for rid, (p, g) in enumerate(stream):
        groups.setdefault((p.size, g), []).append(rid)
    for (s0, gen), rids in groups.items():
        rows = [stream[r][0] for r in rids] + [np.zeros(s0, np.int32)] * (N_SLOTS - len(rids))
        ref = generate(params, cfg, NEAREST, np.stack(rows), max_new_tokens=gen,
                       cache_len=MAX_LEN, device="cpu").numpy()
        for i, r in enumerate(rids):
            assert np.array_equal(ref[i, s0:], base[r]), r


def _lockstep(params, cfg, seqs):
    """Each sequence teacher-forced through single-token steps in batches
    of ``N_SLOTS`` lanes (the engine's row count): per sequence, the
    logits after every token."""
    qa = QArith(NEAREST)
    out = []
    for start in range(0, len(seqs), N_SLOTS):
        group = seqs[start:start + N_SLOTS]
        T = max(x.size for x in group)
        batch = np.zeros((N_SLOTS, T), np.int32)
        for i, x in enumerate(group):
            batch[i, :x.size] = x
        cache = R.make_cache(params, cfg, batch_size=N_SLOTS, max_len=MAX_LEN,
                             dtype=NEAREST.compute_dtype)
        logits = []
        for t in range(T):
            pos = torch.full((N_SLOTS,), t, dtype=torch.int32)
            out_t, cache = R.decode(qa, params, cfg, torch.from_numpy(batch[:, t:t + 1]),
                                    cache, pos)
            logits.append(out_t[:, 0])
        logits = torch.stack(logits, 1)
        out.extend(logits[i, :x.size] for i, x in enumerate(group))
    return out


@pytest.mark.parametrize("kw", [dict(), dict(paged=True, page_size=4, n_pages=20)],
                         ids=["contiguous", "paged"])
def test_chunked_holds_to_unchunked_at_the_logit_level(models, kw):
    """ROADMAP C10: a chunk step runs its dense products at N·C rows, and a
    row can round differently than at N rows (C6), so a chunk-written KV
    cell may differ by a bf16 ulp. The chunked run's tokens must equal the
    chunk-1 run's, or part where the chunk-1 model (teacher-forced on its
    own stream, at the engine's row count, so its logits are the engine's)
    prefers its token over the chunked one by at most ``LOGIT_TOL``."""
    _, _, cfg, params = models
    stream = _stream(cfg.vocab, seed=2)
    base, one = _port_run(params, cfg, stream, **kw)
    for chunk in (4, 8):
        toks, eng = _port_run(params, cfg, stream, prefill_chunk=chunk, **kw)
        assert eng.stats.steps < one.stats.steps
        seqs = [np.concatenate([p, base[r]]) for r, (p, _) in enumerate(stream)]
        for r, logits in enumerate(_lockstep(params, cfg, seqs)):
            s0 = stream[r][0].size
            assert torch.equal(logits[s0 - 1:-1].argmax(-1), torch.from_numpy(base[r]).long())
            parted = np.flatnonzero(toks[r] != base[r])
            if parted.size:
                t = int(parted[0])
                row = logits[s0 - 1 + t]
                assert 0 <= float(row[base[r][t]] - row[toks[r][t]]) <= LOGIT_TOL, (r, t)


def test_chunk_step_agrees_with_sequential_steps(models):
    """A chunk step's cache writes and last-real-row logits against feeding
    its tokens one by one: the KV cells within one bf16 ulp, the logits
    within ``LOGIT_TOL`` (ROADMAP C10)."""
    _, _, cfg, params = models
    qa = QArith(NEAREST)
    B, C = 4, 8
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, C)).astype(np.int32))
    n_tok = torch.tensor([C, 3, 5, 1])
    seq = R.make_cache(params, cfg, batch_size=B, max_len=16, dtype=NEAREST.compute_dtype)
    per_step = []
    for t in range(C):
        pos = torch.where(n_tok > t, t, -1).to(torch.int32)
        logits, seq = R.decode(qa, params, cfg, tokens[:, t:t + 1], seq, pos)
        per_step.append(logits[:, 0])
    chunk = R.make_cache(params, cfg, batch_size=B, max_len=16, dtype=NEAREST.compute_dtype)
    offs = torch.arange(C, dtype=torch.int32)
    pos = torch.where(offs[None] < n_tok[:, None], offs[None], -1)
    logits, chunk = R.decode(qa, params, cfg, tokens, chunk, pos, out_rows=n_tok - 1)
    assert logits.shape == (B, 1, cfg.vocab)
    for b in range(B):
        diff = (logits[b, 0] - per_step[int(n_tok[b]) - 1][b]).abs().max()
        assert float(diff) <= LOGIT_TOL
    k_seq, v_seq, pos_seq = seq["layers"]["b0"]
    k_chunk, v_chunk, pos_chunk = chunk["layers"]["b0"]
    assert torch.equal(pos_seq, pos_chunk)
    for a, b in ((k_seq, k_chunk), (v_seq, v_chunk)):
        a, b = a.float(), b.float()
        ulp = 2.0 ** (torch.floor(torch.log2(a.abs().clamp(min=2.0 ** -126))) - 7)
        assert bool(((a - b).abs() <= ulp).all())


def test_storm_holds_invariants_every_step(models):
    """Tiny page pool, long prompts, chunked prefill: repeated preemption,
    parking and prefix sharing, invariants after every step, refcounts
    draining to zero."""
    _, _, cfg, params = models
    eng = Engine(params, cfg, NEAREST, n_slots=4, max_len=24, paged=True, page_size=4,
                 n_pages=10, prefill_chunk=4, device="cpu")
    rng = np.random.default_rng(42)
    for s, g in zip((12, 10, 14, 9, 11, 13), (6, 8, 5, 7, 6, 5)):
        eng.submit(rng.integers(0, cfg.vocab, s), g)
    done = []
    while eng.has_work():
        done.extend(eng.step())
        eng.pool.check_invariants()
        assert eng.stats.kv_tokens_live == sum(s.fed for s in eng._slots if s is not None)
    assert len(done) == 6 and eng.stats.preemptions >= 1 and eng.stats.admitted == 6
    for c in done:
        assert c.admitted_step <= c.first_token_step <= c.finished_step
    assert eng.pool.n_live_pages == eng.pool.n_cached_pages
    eng.pool.clear_prefix()
    assert eng.pool.n_live_pages == 0 and int(eng.pool._ref.sum()) == 0


def test_paged_engine_validation(models):
    _, _, cfg, params = models
    with pytest.raises(ValueError, match="prefix_cache requires paged"):
        Engine(params, cfg, NEAREST, prefix_cache=True, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        Engine(params, cfg, NEAREST, prefill_chunk=0, device="cpu")
    windowed = dataclasses.replace(cfg, swa_window=16)
    with pytest.raises(ValueError, match="ring window"):
        Engine(params, windowed, NEAREST, max_len=32, prefill_chunk=4, device="cpu")
    eng = Engine(params, windowed, NEAREST, max_len=32, paged=True, device="cpu")
    assert eng.prefix_cache is False          # auto-off on ineligible stacks


def test_launcher_runs_paged_chunked_on_cpu(capsys):
    launch_serve.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                       "--requests", "6", "--max-len", "32", "--paged", "--page-size", "4",
                       "--n-pages", "12", "--prefill-chunk", "4", "--fused-decode"])
    out = capsys.readouterr().out
    assert "6/6 finished" in out and "paged page=4 pages=12" in out
    assert "[serve] pages: 12 total" in out and "[serve] prefix cache:" in out
