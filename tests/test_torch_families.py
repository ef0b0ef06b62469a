"""The decoder-only families (untied heads, MoE, Mamba, the RG-LRU hybrid)
in the port ≡ the reference, on the CPU at the reduced size.

Per family, from the reference's ``R.init`` weights (``from_jax_params``):
teacher-forced logits of ``forward_logits`` and of 8 ``decode`` steps
against the reference compiled without excess precision (C7), within
``LOGIT_RTOL`` of the largest logit. The two frameworks' f32 ``exp``
differ in the last ulp on ~10% of inputs (C5), which flips the bf16
rounding of an attention probability now and then; one flipped bf16 ulp of
a hidden state moves the logits of later layers by up to ~1% of their
scale (measured in the forward: ≤ 1e-6 absolute on mistral-nemo,
command-r, the MoE and Mamba configs; 0.6% on yi-9b, 0.3% on
recurrentgemma; up to 0.8% in
the decode steps, all through their attention layers — each block alone is
bitwise, tests/test_torch_ssm.py, tests/test_torch_moe.py). recurrentgemma
runs 5 layers: one stacked (rec, rec, local_attn) group and an unstacked
remainder (rec, rec). The cache the port builds has
the reference's leaves, shapes and dtypes. Then the engine: its greedy
tokens equal ``generate``'s at the engine's lane count (RG-LRU with its
local-attention ring wrapping, mixtral's SWA ring, paged pools), the cache
helpers on hybrid trees, and the engine's refusals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.models import registry as JR
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.convert import from_jax_params
from repro_torch.core.policy import get_policy as t_get_policy
from repro_torch.core.qarith import QArith as TQArith
from repro_torch.models import registry as TR
from repro_torch.serve import cache as SC
from repro_torch.serve.decode import generate
from repro_torch.serve.engine import Engine

ARCHS = ("yi-9b", "mistral-nemo-12b", "command-r-35b", "mixtral-8x22b",
         "llama4-scout-17b-a16e", "falcon-mamba-7b", "recurrentgemma-2b")
POLICY = "bf16_standard"
LOGIT_RTOL = 1e-2
NO_EXCESS = {"xla_allow_excess_precision": False}
B, S = 2, 16


def _cfgs(arch):
    extra = {"n_layers": 5} if arch == "recurrentgemma-2b" else {}
    return (dataclasses.replace(JR.get_config(arch).reduced(), **extra),
            dataclasses.replace(TR.get_config(arch).reduced(), **extra))


def _pair(arch):
    jcfg, tcfg = _cfgs(arch)
    jpol = j_get_policy(POLICY)
    params = JR.init(jcfg, jax.random.PRNGKey(0), jpol.param_dtype)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, tparams


def _np(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, tcfg, params, tparams = _pair(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, size=(B, S)).astype(np.int32)
    jqa, tqa = JQArith(j_get_policy(POLICY)), TQArith(t_get_policy(POLICY))
    fwd = jax.jit(lambda p, t: JR.forward_logits(jqa, p, jcfg, {"tokens": t}))
    want = fwd.lower(params, jnp.asarray(toks)).compile(compiler_options=NO_EXCESS)(
        params, jnp.asarray(toks))
    with torch.no_grad():
        got = TR.forward_logits(tqa, tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, jcfg.vocab)
    assert ("lm_head" in tparams) == (not tcfg.tie_embeddings)
    want = np.asarray(want)
    err = float(np.abs(_np(got) - want).max())
    assert err <= LOGIT_RTOL * np.abs(want).max(), err


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves_with_paths(t, f"{prefix}.{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """8 teacher-forced decode steps of 3 lanes at staggered depths (lane 2
    parked for the first 3 steps) from the reference's weights."""
    jcfg, tcfg, params, tparams = _pair(arch)
    jpol, tpol = j_get_policy(POLICY), t_get_policy(POLICY)
    jqa, tqa = JQArith(jpol), TQArith(tpol)
    n, L, steps = 3, 16, 8
    jcache = JR.make_cache(jqa, params, jcfg, {}, batch_size=n, max_len=L,
                           dtype=jpol.compute_dtype)
    tcache = TR.make_cache(tparams, tcfg, batch_size=n, max_len=L, dtype=tpol.compute_dtype)
    # the cache tree: the reference's leaves, shapes and dtypes
    jl = dict(_leaves_with_paths(jax.tree_util.tree_map(np.asarray, jcache)))
    tl = dict(_leaves_with_paths(tcache))
    assert jl.keys() == tl.keys()
    for k in jl:
        assert tuple(tl[k].shape) == jl[k].shape, k
        assert str(tl[k].dtype).split(".")[-1] == str(jl[k].dtype), k
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, size=(n, steps)).astype(np.int32)
    step = jax.jit(lambda p, c, t, pos: JR.decode(jqa, p, jcfg, t, c, pos)).lower(
        params, jcache, jnp.asarray(toks[:, :1]), jnp.zeros((n,), jnp.int32)).compile(
        compiler_options=NO_EXCESS)
    worst, scale = 0.0, 0.0
    for t in range(steps):
        pos = np.array([t, t + 2, t - 3], np.int32)       # lane 2 parked at -1 .. -3
        if t < 3:
            pos[2] = -1
        want, jcache = step(params, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        with torch.no_grad():
            got, tcache = TR.decode(tqa, tparams, tcfg, torch.from_numpy(toks[:, t:t + 1]),
                                    tcache, torch.from_numpy(pos))
        live = pos >= 0
        want = np.asarray(want)[live]
        worst = max(worst, float(np.abs(_np(got)[live] - want).max()))
        scale = max(scale, float(np.abs(want).max()))
    assert worst <= LOGIT_RTOL * scale, (worst, scale)


def _engine_vs_generate(arch, *, max_len, prompt_lens, gen, n_slots=3, n_req=5, **kw):
    cfg = _cfgs(arch)[1]
    pol = t_get_policy(POLICY)
    params = TR.init(cfg, 0, pol.param_dtype, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(*prompt_lens))).astype(np.int32)
               for _ in range(n_req)]
    eng = Engine(params, cfg, pol, n_slots=n_slots, max_len=max_len, device="cpu", **kw)
    for p in prompts:
        eng.submit(p, gen)
    got = {c.rid: c.tokens for c in eng.run()}
    assert len(got) == n_req
    for rid, p in enumerate(prompts):
        ref = generate(params, cfg, pol, np.stack([p] * n_slots), max_new_tokens=gen,
                       cache_len=max_len, device="cpu").numpy()
        np.testing.assert_array_equal(got[rid], ref[0, p.size:], err_msg=f"rid {rid}")
    return eng


@pytest.mark.parametrize("arch,kw", [
    ("recurrentgemma-2b", dict(max_len=96, prompt_lens=(30, 50), gen=30)),  # ring wraps
    ("falcon-mamba-7b", dict(max_len=40, prompt_lens=(3, 12), gen=8)),
    ("mixtral-8x22b", dict(max_len=96, prompt_lens=(30, 50), gen=30)),      # SWA ring
    ("llama4-scout-17b-a16e", dict(max_len=40, prompt_lens=(3, 12), gen=8, paged=True,
                                   page_size=4)),
    ("recurrentgemma-2b", dict(max_len=48, prompt_lens=(3, 12), gen=8, paged=True,
                               page_size=4)),
    ("command-r-35b", dict(max_len=40, prompt_lens=(3, 12), gen=8, paged=True,
                           page_size=4, prefill_chunk=4)),
])
def test_engine_tokens_equal_generate(arch, kw):
    """Greedy engine tokens == ``generate`` at the engine's lane count,
    recycled slots included (5 requests on 3 slots)."""
    eng = _engine_vs_generate(arch, **kw)
    if kw["max_len"] > 64 and arch == "recurrentgemma-2b":
        assert eng.pool.cache["layers"]["b2"][0].shape[2] == 64     # the local ring
    if kw.get("prefill_chunk", 1) > 1:
        assert eng.prefix_cache


def test_engine_refuses_chunked_prefill_for_recurrent_state():
    pol = t_get_policy(POLICY)
    for arch in ("falcon-mamba-7b", "recurrentgemma-2b"):
        cfg = _cfgs(arch)[1]
        params = TR.init(cfg, 0, pol.param_dtype, device="cpu")
        with pytest.raises(ValueError, match="chunked prefill: an attention-only stack"):
            Engine(params, cfg, pol, n_slots=2, max_len=32, prefill_chunk=4, device="cpu")
        with pytest.raises(ValueError, match="prefix cache: an attention-only stack"):
            Engine(params, cfg, pol, n_slots=2, max_len=32, paged=True, prefix_cache=True,
                   device="cpu")
        eng = Engine(params, cfg, pol, n_slots=2, max_len=32, paged=True, device="cpu")
        assert not eng.prefix_cache
        with pytest.raises(ValueError, match="one token per step"):
            TR.decode(TQArith(pol), params, cfg, torch.zeros((2, 3), dtype=torch.int32),
                      eng.pool.cache, torch.zeros((2, 3), dtype=torch.int32),
                      block_table=torch.zeros((2, 8), dtype=torch.int32))


def test_cache_helpers_walk_hybrid_trees():
    """reset_slots and keep_active on recurrentgemma's tree: the stacked
    ``layers`` (slot dim 1) and the ``rem`` remainder (slot dim 0)."""
    cfg = _cfgs("recurrentgemma-2b")[1]
    params = TR.init(cfg, 0, torch.bfloat16, device="cpu")
    cache = TR.make_cache(params, cfg, batch_size=4, max_len=32)
    assert set(cache) == {"layers", "rem"} and set(cache["rem"]) == {"b0", "b1"}
    for _, t in _leaves_with_paths(cache):
        t.fill_(1)
    reset = torch.tensor([False, True, False, True])
    SC.reset_slots(cache, reset)
    for root, sdim in (("layers", 1), ("rem", 0)):
        for name, leaf in cache[root].items():
            if isinstance(leaf, tuple):
                k_pos = leaf[2].movedim(sdim, 0)
                assert bool((k_pos[reset] == -1).all()) and bool((k_pos[~reset] == 1).all())
                assert bool((leaf[0] == 1).all())                  # KV values stay
            else:
                for t in leaf.values():
                    t = t.movedim(sdim, 0)
                    assert bool((t[reset] == 0).all()) and bool((t[~reset] == 1).all())
    new = {root: {name: ({k: torch.full_like(t, 2) for k, t in leaf.items()}
                         if isinstance(leaf, dict) else leaf)
                  for name, leaf in blocks.items()} for root, blocks in cache.items()}
    active = torch.tensor([True, True, False, False])
    h_before = cache["rem"]["b1"]["h"]
    out = SC.keep_active(active, new, cache)
    assert out is cache and cache["rem"]["b1"]["h"] is h_before    # in place
    # active lanes took the new state; parked ones kept theirs: lane 2 its
    # old ones, lane 3 the zeros of its reset
    for root, sdim in (("layers", 1), ("rem", 0)):
        for leaf in cache[root].values():
            if isinstance(leaf, dict):
                for t in leaf.values():
                    per_lane = t.movedim(sdim, 0).reshape(4, -1)
                    assert per_lane.amin(1).tolist() == per_lane.amax(1).tolist() == [
                        2.0, 2.0, 1.0, 0.0]
    SC.keep_active(None, new, cache)
    assert float(cache["rem"]["b0"]["h"].min()) == 2.0
    assert SC.nbytes(cache) == sum(t.numel() * t.element_size()
                                   for _, t in _leaves_with_paths(cache))
