"""The encoder-decoder (whisper) in the port ≡ the reference, on the CPU at
the reduced size (2 encoder and 3 decoder layers, d 128, 4 query heads on
2 kv heads of 32, vocab 512).

From the reference's ``R.init`` weights (``from_jax_params``), against the
reference compiled without excess precision (C7): the sinusoidal rows
within 1 bf16 ulp (JAX's and torch's f32 ``sin``/``cos``/``pow`` differ in
the last ulp, C5). The two frameworks' f32 row sums differ in the last
bit now and then, which flips the bf16 rounding of a LayerNorm row's mean
or inverse; a flipped bf16 ulp moves the logits of later layers by up to
~1% of their scale (as for the other families). So the decoder — the
teacher-forced logits and 6 lock-step decode steps — is held within
``RTOL`` on the reference's own encoder output. In the bidirectional
encoder one flipped row reaches every row of its sequence: its output is
held within ``ENC_ULPS`` bf16 ulps of its scale (measured ≤ 1.5, seeds
1–5), and the logits of the whole model, encoder included, within
``E2E_RTOL`` (measured ≤ 1.04%). Also: the decode cache with the
reference's self and cross leaves; the port's prefill ≡ decode under the
reference's bound, through the serve step; one train step's loss within
1% of the reference's. Then the refusals: the engine, both pools and
``generate`` are decoder-only, as the reference's are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread, to_torch  # noqa: F401 (autouse fixture)
from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.models import encdec as JED
from repro.models import registry as JR
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.serve.cache import CachePool as JCachePool
from repro.serve.engine import Engine as JEngine
from repro.serve.paged import PagedCachePool as JPagedCachePool
from repro.train.step import make_train_step as j_make_train_step
from repro.train.train_state import make_train_state as j_make_train_state
from repro_torch.convert import from_jax_params, from_jax_train_state
from repro_torch.core.policy import get_policy as t_get_policy
from repro_torch.core.qarith import QArith as TQArith
from repro_torch.models import encdec as TED
from repro_torch.models import registry as TR
from repro_torch.optim import adamw, constant
from repro_torch.serve.cache import CachePool
from repro_torch.serve.decode import generate
from repro_torch.serve.engine import Engine
from repro_torch.serve.paged import PagedCachePool
from repro_torch.train.step import make_serve_step, make_train_step
from test_torch_core import assert_within_one_bf16_ulp

ARCH = "whisper-base"
POLICY = "bf16_standard"
RTOL = 1e-2
ENC_ULPS = 2
E2E_RTOL = 2e-2
NO_EXCESS = {"xla_allow_excess_precision": False}
B, S_SRC, S = 2, 32, 16


def _pair():
    jcfg, tcfg = JR.get_config(ARCH).reduced(), TR.get_config(ARCH).reduced()
    params = JR.init(jcfg, jax.random.PRNGKey(0), j_get_policy(POLICY).param_dtype)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, tparams


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    return {"src_embeds": rng.normal(size=(B, S_SRC, cfg.d_model)).astype(np.float32),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, rtol=RTOL):
    err = float(np.abs(_np(got) - np.asarray(want, np.float32)).max())
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    assert err <= rtol * scale, (err, scale)


def _within_ulps(got, want, n):
    """max |got − want| ≤ n bf16 ulps of max |want|."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert float(np.abs(_np(got) - want).max()) <= n * ulp


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{prefix}.{i}")
    else:
        yield prefix, tree


def test_sinusoidal_within_one_bf16_ulp():
    want = np.asarray(JED.sinusoidal(1500, 512))
    got = TED.sinusoidal(1500, 512)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1500, 512)
    assert_within_one_bf16_ulp(got.numpy(), want, 1.0)
    pos = torch.tensor([[0], [7], [1499]], dtype=torch.int32)
    at = TED.sinusoidal_at(pos, 512)
    assert tuple(at.shape) == (3, 1, 512)
    assert torch.equal(at[:, 0], got[pos[:, 0].long()])
    assert_within_one_bf16_ulp(
        TED.sinusoidal_at(torch.tensor(1499), 512).numpy(),
        np.asarray(JED.sinusoidal_at(jnp.int32(1499), 512)), 1.0)


def test_init_has_the_reference_tree():
    jcfg, tcfg, params, tparams = _pair()
    mine = TR.init(tcfg, 0, torch.bfloat16, device="cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(
        jax.tree_util.tree_map(np.asarray, params))}
    for tree in (tparams, mine):
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _leaves(tree)}
        assert got == want
    with pytest.raises(KeyError, match="not in the ported decoder-only LM or encoder-dec"):
        from_jax_params({"dec_layers": {"ln1": {"scale": np.ones(3)}, "conv": {}}},
                        device="cpu")


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(*args)


def test_encode_and_decoder_forward_match_reference():
    jcfg, tcfg, params, tparams = _pair()
    batch = _batch(jcfg)
    jqa, tqa = JQArith(j_get_policy(POLICY)), TQArith(t_get_policy(POLICY))
    src = jnp.asarray(batch["src_embeds"])
    toks = jnp.asarray(batch["tokens"])
    enc = _jit(lambda p, s: JED.encode(jqa, p, jcfg, s), params, src)
    want_dec = _jit(lambda p, t, e: JED.decoder_forward(jqa, p, jcfg, t, e), params, toks, enc)
    want = _jit(lambda p, b: JR.forward_logits(jqa, p, jcfg, b), params,
                {"src_embeds": src, "tokens": toks})
    tb = {k: torch.from_numpy(batch[k]) for k in ("src_embeds", "tokens")}
    with torch.no_grad():
        t_enc = TED.encode(tqa, tparams, tcfg, tb["src_embeds"])
        dec = TED.decoder_forward(tqa, tparams, tcfg, tb["tokens"], to_torch(enc))
        got = TR.forward_logits(tqa, tparams, tcfg, tb)
        e2e = TED.decoder_forward(tqa, tparams, tcfg, tb["tokens"], t_enc, remat=False)
    assert t_enc.dtype == torch.bfloat16 and tuple(t_enc.shape) == (B, S_SRC, tcfg.d_model)
    _within_ulps(t_enc, enc, ENC_ULPS)
    assert dec.dtype == torch.float32 and tuple(dec.shape) == (B, S, tcfg.vocab)
    _close(dec, want_dec)
    _close(got, want, E2E_RTOL)
    assert torch.equal(e2e, got)


def test_decode_steps_match_reference():
    """6 lock-step decode steps (the reference's scalar position, the
    port's per-lane one) from caches of the reference's encoder output;
    the port's own ``make_cache`` has the reference's leaves."""
    jcfg, tcfg, params, tparams = _pair()
    batch = _batch(jcfg, seed=3)
    jpol, tpol = j_get_policy(POLICY), t_get_policy(POLICY)
    jqa, tqa = JQArith(jpol), TQArith(tpol)
    src = jnp.asarray(batch["src_embeds"])
    jcache = JR.make_cache(jqa, params, jcfg, {"src_embeds": src}, batch_size=B, max_len=S)
    enc = _jit(lambda p, s: JED.encode(jqa, p, jcfg, s, remat=False), params, src)
    with torch.no_grad():
        own = TR.make_cache(tparams, tcfg, batch_size=B, max_len=S, qa=tqa,
                            batch={"src_embeds": torch.from_numpy(batch["src_embeds"])})
        tcache = TED.init_decode_cache(tcfg, tparams, tqa, to_torch(enc), B, S)
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jcache)))
    for tree in (own, tcache):
        tl = dict(_leaves(tree))
        assert set(tl) == set(jl) | {".cross_pos"}
        for k in jl:
            assert tuple(tl[k].shape) == jl[k].shape, k
            assert str(tl[k].dtype).split(".")[-1] == str(jl[k].dtype), k
        assert tl[".cross_pos"].is_contiguous() and tl[".cross_pos"].dtype == torch.int32
    tl = dict(_leaves(tcache))
    for k in (".cross.0", ".cross.1"):
        _close(tl[k], jl[k])
    step = jax.jit(lambda p, c, t, pos: JR.decode(jqa, p, jcfg, t, c, pos))
    for t in range(6):
        tok = batch["tokens"][:, t:t + 1]
        want, jcache = step(params, jcache, jnp.asarray(tok), jnp.int32(t))
        with torch.no_grad():
            got, tcache = TR.decode(tqa, tparams, tcfg, torch.from_numpy(tok), tcache,
                                    torch.full((B,), t, dtype=torch.int32))
        _close(got, want)


def test_prefill_equals_decode_through_the_serve_step():
    """The port's teacher-forced logits ≡ its lock-step decode through
    ``make_serve_step(fused_decode=True)`` (the kernels' plain versions on
    the CPU), within the reference's bound; two runs give equal tokens."""
    _, cfg, _, params = _pair()
    pol = t_get_policy(POLICY)
    qa = TQArith(pol)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=4).items()}
    step = make_serve_step(cfg, pol, fused_decode=True, return_logits=True)
    runs = []
    with torch.no_grad():
        full = TR.forward_logits(qa, params, cfg, batch, remat=False)
        for _ in range(2):
            cache = TR.make_cache(params, cfg, batch_size=B, max_len=S, qa=qa, batch=batch)
            toks = []
            for t in range(S):
                tok, logits, cache = step(params, cache, batch["tokens"][:, t:t + 1],
                                          torch.full((B,), t, dtype=torch.int32))
                toks.append(tok)
            runs.append(torch.cat(toks, 1))
    err = float((logits - full[:, -1]).abs().max())
    assert err / (float(full[:, -1].abs().max()) + 1e-6) < 0.05
    assert torch.equal(runs[0], runs[1])


def test_one_train_step_matches_reference():
    jcfg, tcfg = JR.get_config(ARCH).reduced(), TR.get_config(ARCH).reduced()
    jp, tp = j_get_policy("bf16_kahan"), t_get_policy("bf16_kahan")
    params = JR.init(jcfg, jax.random.PRNGKey(0), jp.param_dtype)
    jopt = j_adamw(jp, b2=0.99609375, weight_decay=0.01)
    jstate = j_make_train_state(params, jopt)
    tstate = from_jax_train_state(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    batch = _batch(jcfg, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(j_make_train_step(jcfg, jp, jopt, j_constant(1e-3))).lower(
        jstate, jb, 0).compile(compiler_options=NO_EXCESS)
    _, jm = jstep(jstate, jb, 0)
    step = make_train_step(tcfg, tp, adamw(tp, b2=0.99609375, weight_decay=0.01),
                           constant(1e-3), grad_accum=2)
    new, tm = step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-2 * abs(float(jm[k])), k
    assert new.step == 1


def test_decoder_only_paths_refuse_the_encoder_decoder():
    jcfg, tcfg, params, tparams = _pair()
    jpol, tpol = j_get_policy(POLICY), t_get_policy(POLICY)
    for ctor, jctor, msg in ((Engine, JEngine, "Engine is decoder-only"),
                             (CachePool, JCachePool, "CachePool is decoder-only"),
                             (PagedCachePool, JPagedCachePool, "PagedCachePool is decoder-only")):
        kw = {"n_slots": 2, "max_len": 16}
        with pytest.raises(ValueError, match=msg):
            jctor(params, jcfg, jpol, **kw)
        with pytest.raises(ValueError, match=msg):
            ctor(tparams, tcfg, tpol, **kw, **({"device": "cpu"} if ctor is Engine else {}))
    with pytest.raises(ValueError, match="generate is decoder-only"):
        generate(tparams, tcfg, tpol, np.zeros((1, 2), np.int32), device="cpu")
    with pytest.raises(ValueError, match="pass batch="):
        TR.make_cache(tparams, tcfg, batch_size=1, max_len=4)
    with pytest.raises(ValueError, match="paged KV cache is not supported for enc-dec"):
        TR.make_cache(tparams, tcfg, batch_size=1, max_len=4, page_size=4, n_rows=3)
