"""Sampled serving in the port against the reference, on the CPU.

* ``validate_sampling`` raises the reference's errors on the same inputs;
  ``top_k=1`` and a vanishing ``top_p`` give the argmax in both packages.
* The key is a pure function of (seed, rid, position).
* Torch's bits are not JAX's, so sampling is held statistically: on fixed
  vocab-32 logits rows under temperature, top-k, top-p and all three,
  each package's token frequencies over 4000 positions are within 5σ of
  the exact filtered softmax (the binomial bound of
  tests/test_formats_properties.py). A token whose expected count is
  under 10 is judged with the other such tokens as one bucket, where the
  normal approximation behind 5σ holds. The reference's draws are its
  own filter (read out of ``sample_token``) plus its own
  ``jax.random.gumbel`` under ``request_key``, batched; the first
  positions are also drawn through ``sample_token`` itself and must agree.
* The filter's support is exactly the reference filter's.
* The engine (reference ``tests/test_serve.py:609-697``): the same (seed,
  rid) reproduces its tokens and another seed changes them; greedy lanes
  next to a sampling lane equal the port's ``generate``; temperature 0
  with top-k and top-p is greedy; sampled tokens survive recompute
  preemption (paged, tight against roomy pages, ``prefill_chunk=1``: on
  the CPU a row's bits depend on the row count, ROADMAP C6); ``submit``
  validates its parameters.
* ``generate(temperature>0)``: one seed gives the same tokens every time;
  512 identical lanes give first tokens within 5σ of
  ``softmax(logits / T)``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as ref_sampling
from repro_torch.core.policy import get_policy
from repro_torch.core.qarith import QArith
from repro_torch.launch import serve as launch_serve
from repro_torch.models import registry as R
from repro_torch.serve import sampling
from repro_torch.serve.decode import generate
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_serve_step
from _torch_cpu import one_torch_thread  # noqa: F401

NEAREST = get_policy("bf16_standard")
FIVE_SIGMA = 5.0
N_DRAWS = 4000
MIN_EXPECTED = 10          # expected count below which tokens share one bucket
ROW = (np.random.default_rng(42).normal(size=32) * 2.0).astype(np.float32)
FILTERS = {"temperature": dict(temperature=0.7, top_k=0, top_p=1.0),
           "top_k": dict(temperature=1.0, top_k=5, top_p=1.0),
           "top_p": dict(temperature=1.0, top_k=0, top_p=0.8),
           "all three": dict(temperature=0.8, top_k=8, top_p=0.9)}


def _cfg():
    return R.get_config("qwen2.5-3b").reduced()


@pytest.fixture(scope="module")
def params():
    return R.init(_cfg(), 0, NEAREST.param_dtype, device="cpu")


def _ref_filtered(row, monkeypatch, **kw) -> np.ndarray:
    """The reference filter's output on ``row``: ``sample_token`` run with
    zero noise, its argmax input read out."""
    seen = []

    class _Np:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def argmax(a, *args, **kwargs):
            seen.append(np.array(a))
            return np.argmax(a, *args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(ref_sampling, "np", _Np())
        m.setattr(jax.random, "gumbel", lambda key, shape, dtype: jnp.zeros(shape, dtype))
        ref_sampling.sample_token(row, key=ref_sampling.request_key(0, 0, 0), **kw)
    return seen[-1]


def _assert_frequencies(tokens, probs, support):
    """Each token with an expected count of at least MIN_EXPECTED within 5σ
    of its probability, the rest as one bucket; nothing outside support."""
    n = len(tokens)
    counts = np.bincount(tokens, minlength=probs.size)
    assert counts[~support].sum() == 0, np.nonzero(counts * ~support)
    small = probs * n < MIN_EXPECTED
    buckets = [(f"token {t}", counts[t], probs[t]) for t in np.nonzero(~small)[0]]
    if probs[small].sum() > 0:
        buckets.append(("rare tokens", counts[small].sum(), probs[small].sum()))
    for name, c, p in buckets:
        sigma = math.sqrt(p * (1 - p) / n)
        assert abs(c / n - p) <= FIVE_SIGMA * sigma + 1e-12, (name, c / n, p, sigma)


@pytest.mark.parametrize("bad", [dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                                 dict(top_p=1.5), dict(temperature=0.5, top_k=3, top_p=0.5)])
def test_validation_matches_reference(bad):
    kw = dict(temperature=1.0, top_k=0, top_p=1.0) | bad
    try:
        ref_sampling.validate_sampling(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            sampling.validate_sampling(**kw)
        assert str(got.value) == str(e)
    else:
        sampling.validate_sampling(**kw)


@pytest.mark.parametrize("kw", [dict(top_k=1), dict(top_p=1e-6)], ids=["top_k=1", "top_p=1e-6"])
def test_collapsing_filters_give_argmax_in_both(kw):
    logits = np.asarray([0.1, 2.0, -1.0, 1.9, 0.0], np.float32)
    for trial in range(5):
        assert ref_sampling.sample_token(logits, temperature=1.0, **kw,
                                         key=ref_sampling.request_key(0, 7, trial)) == 1
        assert sampling.sample_token(logits, temperature=1.0, **kw,
                                     key=sampling.request_key(0, 7, trial)) == 1


def test_key_is_a_pure_function_of_seed_rid_position():
    key = sampling.request_key(3, 11, 40)
    assert key == sampling.request_key(3, 11, 40) and 0 <= key < 2 ** 64
    others = {sampling.request_key(*t) for t in ((4, 11, 40), (3, 12, 40), (3, 11, 41))}
    assert key not in others and len(others) == 3
    g = sampling.gumbel([key, key], 32, "cpu")
    assert torch.equal(g[0], g[1]) and torch.isfinite(g).all()
    draws = [sampling.sample_token(ROW, temperature=1.0, key=key) for _ in range(3)]
    assert len(set(draws)) == 1


def test_cpu_draw_is_argmax_over_the_whole_noisy_row():
    """The CPU draw, noise only on the finite logits, is argmax of the
    filtered row plus the full stream's noise; a row with no finite logit
    draws 0, as that argmax does."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(48, 300, generator=g)
    filtered = sampling.filter_logits(logits, [0.8] * 48, [20] * 48, [0.9] * 48)
    filtered[5] = -torch.inf
    keys = [sampling.request_key(1, r, 7) for r in range(48)]
    dense = torch.argmax(filtered + sampling.gumbel(keys, 300, "cpu"), -1)
    got = sampling.draw(filtered, keys)
    assert torch.equal(got, dense) and got[5] == 0


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_support_matches_reference_filter(name, monkeypatch):
    kw = FILTERS[name]
    rows = np.random.default_rng(5).normal(size=(6, 32)).astype(np.float32) * 2.0
    for row in np.concatenate([ROW[None], rows]):
        want = np.isfinite(_ref_filtered(row, monkeypatch, **kw))
        got = sampling.filter_logits(torch.from_numpy(row)[None], [kw["temperature"]],
                                     [kw["top_k"]], [kw["top_p"]])[0]
        assert np.array_equal(torch.isfinite(got).numpy(), want), (name, row)


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_frequencies_within_5_sigma_in_both_packages(name, monkeypatch):
    kw = FILTERS[name]
    filtered = _ref_filtered(ROW, monkeypatch, **kw)
    support = np.isfinite(filtered)
    exact = np.where(support, ROW.astype(np.float64) / kw["temperature"], -np.inf)
    probs = np.exp(exact - exact[support].max())
    probs /= probs.sum()
    seed, rid = 3, 11
    # the port: N_DRAWS positions of one request in one batched call
    keys = [sampling.request_key(seed, rid, p) for p in range(N_DRAWS)]
    rows = torch.from_numpy(ROW)[None].expand(N_DRAWS, -1)
    port = sampling.sample(rows, [kw["temperature"]] * N_DRAWS, [kw["top_k"]] * N_DRAWS,
                           [kw["top_p"]] * N_DRAWS, keys).numpy()
    _assert_frequencies(port, probs, support)
    # the reference: its filter plus its gumbel draw under its key, batched
    rkeys = jax.vmap(lambda p: ref_sampling.request_key(seed, rid, p))(jnp.arange(N_DRAWS))
    noise = jax.vmap(lambda k: jax.random.gumbel(k, ROW.shape, jnp.float32))(rkeys)
    ref = np.argmax(filtered[None] + np.asarray(noise), axis=-1)
    for p in range(20):
        assert ref[p] == ref_sampling.sample_token(
            ROW, key=ref_sampling.request_key(seed, rid, p), **kw), p
    _assert_frequencies(ref, probs, support)


def test_serve_step_logits_variant_keeps_the_greedy_tokens(params):
    cfg = _cfg()
    greedy = make_serve_step(cfg, NEAREST)
    with_logits = make_serve_step(cfg, NEAREST, return_logits=True)
    rng = np.random.default_rng(3)
    token = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32))
    pos = torch.zeros(3, dtype=torch.int32)

    def cache():
        return R.make_cache(params, cfg, batch_size=3, max_len=8, dtype=NEAREST.compute_dtype)
    with torch.no_grad():
        tok_a, _ = greedy(params, cache(), token, pos)
        tok_b, logits, _ = with_logits(params, cache(), token, pos)
        want, _ = R.decode(QArith(NEAREST), params, cfg, token, cache(), pos)
    assert torch.equal(tok_a, tok_b)
    assert logits.dtype == torch.float32 and logits.shape == (3, cfg.vocab)
    assert torch.equal(logits, want[:, -1].float())
    assert torch.equal(tok_b[:, 0], torch.argmax(logits, -1).to(torch.int32))


def test_engine_sampling_is_deterministic_per_seed_and_rid(params):
    cfg = _cfg()
    prompt = np.random.default_rng(20).integers(0, cfg.vocab, size=6).astype(np.int32)

    def run_once(seed):
        eng = Engine(params, cfg, NEAREST, n_slots=2, max_len=24, device="cpu")
        eng.submit(prompt, 10, rid=7, temperature=1.0, seed=seed)
        done = eng.run()
        assert set(eng._fns) == {(1, False), (1, True)}
        return done[0].tokens.tolist()

    assert run_once(3) == run_once(3)
    assert run_once(3) != run_once(4)


def test_greedy_lanes_next_to_sampling_equal_generate(params):
    cfg = _cfg()
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab, size=5).astype(np.int32) for _ in range(4)]
    eng = Engine(params, cfg, NEAREST, n_slots=4, max_len=24, device="cpu")
    for p in prompts[:3]:
        eng.submit(p, 8)
    eng.submit(prompts[3], 8, temperature=0.9, top_k=20, top_p=0.9, seed=1)
    done = {c.rid: c.tokens for c in eng.run()}
    assert len(done) == 4
    # the reference batch at the engine's lane count (ROADMAP C6)
    ref = generate(params, cfg, NEAREST, np.stack(prompts), max_new_tokens=8,
                   cache_len=24, device="cpu").numpy()
    for rid in range(3):
        assert np.array_equal(done[rid], ref[rid, 5:]), rid


def test_temperature_zero_is_greedy(params):
    cfg = _cfg()
    prompt = np.random.default_rng(22).integers(0, cfg.vocab, size=5).astype(np.int32)
    outs = []
    for kw in ({}, {"temperature": 0.0, "top_k": 5, "top_p": 0.5, "seed": 9}):
        eng = Engine(params, cfg, NEAREST, n_slots=1, max_len=16, device="cpu")
        eng.submit(prompt, 8, **kw)
        outs.append(eng.run()[0].tokens.tolist())
        assert set(eng._fns) == {(1, False)}          # no logits variant built
    assert outs[0] == outs[1]


def test_sampling_survives_recompute_preemption(params):
    cfg = _cfg()
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab, size=s).astype(np.int32) for s in (5, 9, 3, 12, 7)]
    gens = (6, 4, 8, 5, 6)
    outs = {}
    for tag, n_pages in (("tight", 6), ("roomy", None)):
        eng = Engine(params, cfg, NEAREST, n_slots=4, max_len=32, paged=True, page_size=8,
                     n_pages=n_pages, device="cpu")
        for i, (p, g) in enumerate(zip(prompts, gens)):
            eng.submit(p, g, rid=i, temperature=0.8, top_k=20, seed=5)
        done = eng.run()
        assert len(done) == 5
        if tag == "tight":
            assert eng.stats.preemptions >= 1
        outs[tag] = {c.rid: c.tokens.tolist() for c in done}
    assert outs["tight"] == outs["roomy"]


@pytest.mark.parametrize("bad", [dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                                 dict(top_p=1.5)])
def test_submit_validates_sampling_params(params, bad):
    eng = Engine(params, _cfg(), NEAREST, n_slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.arange(1, 5, dtype=np.int32), 4, **bad)
    assert not eng.has_work()


def test_generate_sampling_is_reproducible(params):
    cfg = _cfg()
    prompts = np.random.default_rng(24).integers(0, cfg.vocab, size=(2, 4))
    runs = [generate(params, cfg, NEAREST, prompts, max_new_tokens=6, temperature=0.9,
                     seed=s, device="cpu") for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert torch.equal(runs[0][:, :4], torch.from_numpy(prompts).to(torch.int32))


def test_generate_first_tokens_follow_the_softmax(params):
    cfg = _cfg()
    T, lanes = 0.5, 512
    prompt = np.random.default_rng(25).integers(0, cfg.vocab, size=3)
    out = generate(params, cfg, NEAREST, np.tile(prompt, (lanes, 1)), max_new_tokens=1,
                   temperature=T, seed=1, device="cpu")
    qa = QArith(NEAREST)
    cache = R.make_cache(params, cfg, batch_size=1, max_len=4, dtype=NEAREST.compute_dtype)
    with torch.no_grad():
        for t in range(3):
            tok = torch.tensor([[prompt[t]]], dtype=torch.int32)
            logits, cache = R.decode(qa, params, cfg, tok, cache,
                                     torch.tensor([t], dtype=torch.int32))
    scaled = logits[0, -1].double().numpy() / T
    probs = np.exp(scaled - scaled.max())
    probs /= probs.sum()
    _assert_frequencies(out[:, -1].numpy(), probs, np.ones_like(probs, bool))


def test_launcher_samples_on_cpu(capsys):
    launch_serve.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                       "--requests", "4", "--max-len", "32", "--temperature", "0.8",
                       "--top-k", "50", "--top-p", "0.95", "--sample-seed", "1"])
    out = capsys.readouterr().out
    assert "4/4 finished" in out and "sampling: temperature=0.8 top_k=50" in out
