"""The port's continuous-batching engine on the CPU.

* Port ``Engine`` ≡ port ``generate``, token for token, on staggered
  requests through eviction and slot refill. Each reference batch is
  padded with dummy prompts to the engine's ``n_slots`` rows: torch's CPU
  matmul (like cuBLAS) picks its kernel by the row count, so a row's
  result depends on how many rows the product has.
* The reference's JAX engine against the port's engine on the same
  prompts and weights, compared at the logit level: both token streams
  are teacher-forced through both models and their logits must agree
  within ``LOGIT_TOL``; a token may differ only where the reference's
  top-2 logit margin is within that tolerance (after which the two
  continuations legitimately part). The JAX engine runs XLA's default
  compile, which keeps some bf16 intermediates in f32 (see
  tests/test_torch_model.py), hence the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.models import registry as JR
from repro.serve import Engine as JEngine
from repro_torch.convert import from_jax_params
from repro_torch.core.policy import get_policy
from repro_torch.core.qarith import QArith
from repro_torch.launch import serve as launch_serve
from repro_torch.models import registry as R
from repro_torch.serve.decode import generate
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_serve_step

NEAREST = get_policy("bf16_standard")
LOGIT_TOL = 0.125


def _cfg():
    return R.get_config("qwen2.5-3b").reduced()


def _prompts(rng, sizes, vocab):
    return [rng.integers(0, vocab, size=s).astype(np.int32) for s in sizes]


def _parity(done, params, cfg, policy, *, n_slots, cache_len):
    groups = {}
    for c in done:
        groups.setdefault((c.prompt.size, c.tokens.size), []).append(c)
    for (s0, gen), cs in groups.items():
        rows = [c.prompt for c in cs] + [np.zeros(s0, np.int32)] * (n_slots - len(cs))
        ref = generate(params, cfg, policy, np.stack(rows), max_new_tokens=gen,
                       cache_len=cache_len, device="cpu").numpy()
        for i, c in enumerate(cs):
            assert np.array_equal(ref[i, s0:], c.tokens), \
                f"rid {c.rid}: engine {c.tokens} != reference {ref[i, s0:]}"


@pytest.mark.parametrize("policy_name,fused", [("bf16_standard", True), ("fp32", False)])
def test_engine_matches_generate(policy_name, fused):
    policy = get_policy(policy_name)
    cfg = _cfg()
    params = R.init(cfg, 0, policy.param_dtype, device="cpu")
    eng = Engine(params, cfg, policy, n_slots=3, max_len=24, fused_decode=fused,
                 device="cpu")
    assert eng.pool.dtype == policy.compute_dtype
    sizes, gens = (5, 7, 5, 7, 5, 7, 5, 7), (8, 6, 8, 6, 8, 6, 8, 6)
    for p, g in zip(_prompts(np.random.default_rng(0), sizes, cfg.vocab), gens):
        eng.submit(p, g)
    done = eng.run()
    assert len(done) == 8 and not eng.has_work()
    assert eng.stats.admitted == 8 and {c.slot for c in done} == {0, 1, 2}
    assert eng.stats.tokens_generated == sum(gens)
    assert eng.stats.slot_steps == eng.stats.steps * 3
    _parity(done, params, cfg, policy, n_slots=3, cache_len=24)


def test_eos_evicts_early():
    cfg = _cfg()
    params = R.init(cfg, 0, NEAREST.param_dtype, device="cpu")
    prompt = np.arange(1, 6, dtype=np.int32)
    free = Engine(params, cfg, NEAREST, n_slots=1, max_len=32, device="cpu")
    free.submit(prompt, 12)
    full = free.run()[0]
    assert full.finish_reason == "length" and full.tokens.size == 12
    eos = int(full.tokens[3])
    cut = int(np.argmax(full.tokens == eos))
    eng = Engine(params, cfg, NEAREST, n_slots=1, max_len=32, eos_id=eos, device="cpu")
    eng.submit(prompt, 12)
    c = eng.run()[0]
    assert c.finish_reason == "eos"
    assert c.tokens.tolist() == full.tokens[:cut + 1].tolist()


def test_jax_engine_matches_port_engine_at_logit_level():
    jcfg = JR.get_config("qwen2.5-3b").reduced()
    jpolicy = j_get_policy("bf16_standard")
    jparams = JR.init(jcfg, jax.random.PRNGKey(0), jpolicy.param_dtype)
    cfg = _cfg()
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    n_slots, max_len, s0, gen, n_req = 3, 20, 6, 8, 5
    prompts = _prompts(np.random.default_rng(7), [s0] * n_req, cfg.vocab)

    jeng = JEngine(jparams, jcfg, jpolicy, n_slots=n_slots, max_len=max_len)
    teng = Engine(params, cfg, NEAREST, n_slots=n_slots, max_len=max_len, device="cpu")
    for p in prompts:
        jeng.submit(p, gen)
        teng.submit(p, gen)
    j_tok = {c.rid: c.tokens for c in jeng.run()}
    t_tok = {c.rid: c.tokens for c in teng.run()}
    assert sorted(j_tok) == sorted(t_tok) == list(range(n_req))

    # teacher-force the reference's streams through both models
    seqs = np.stack([np.concatenate([prompts[r], j_tok[r][:-1]]) for r in range(n_req)])
    jqa, tqa = JQArith(jpolicy), QArith(NEAREST)
    jcache = JR.make_cache(jqa, jparams, jcfg, {}, batch_size=n_req, max_len=max_len,
                           dtype=jpolicy.compute_dtype)
    tcache = R.make_cache(params, cfg, batch_size=n_req, max_len=max_len,
                          dtype=NEAREST.compute_dtype)
    step = jax.jit(lambda p, c, t, pos: JR.decode(jqa, p, jcfg, t, c, pos))
    j_logits, t_logits = [], []
    for t in range(seqs.shape[1]):
        pos = np.full((n_req,), t, np.int32)
        jl, jcache = step(jparams, jcache, jnp.asarray(seqs[:, t:t + 1]), jnp.asarray(pos))
        tl, tcache = R.decode(tqa, params, cfg, torch.from_numpy(seqs[:, t:t + 1]),
                              tcache, torch.from_numpy(pos))
        if t >= s0 - 1:
            j_logits.append(np.asarray(jl)[:, 0])
            t_logits.append(tl.numpy()[:, 0])
    j_logits, t_logits = np.stack(j_logits, 1), np.stack(t_logits, 1)   # (R, gen, V)
    assert np.abs(j_logits - t_logits).max() <= LOGIT_TOL
    assert (j_logits.argmax(-1) == np.stack([j_tok[r] for r in range(n_req)])).all()

    compared = 0
    for r in range(n_req):
        for t in range(gen):
            top2 = np.sort(j_logits[r, t])[-2:]
            if t_tok[r][t] != j_tok[r][t]:
                assert top2[1] - top2[0] <= LOGIT_TOL, (r, t, top2)
                break                     # the continuations part here
            compared += 1
    assert compared >= n_req * gen // 2


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.init(cfg, 0, NEAREST.param_dtype)
    params = R.init(cfg, 0, NEAREST.param_dtype, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(params, cfg, NEAREST)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(params, cfg, NEAREST, np.zeros((1, 3), np.int32), max_new_tokens=2)


def test_later_slice_features_raise():
    cfg = _cfg()
    params = R.init(cfg, 0, NEAREST.param_dtype, device="cpu")
    paged = Engine(params, cfg, NEAREST, paged=True, prefill_chunk=4, device="cpu")
    assert paged.paged and paged.prefill_chunk == 4 and paged.prefix_cache
    # sampling is ported (tests/test_torch_sampling.py): the logits variant
    # of the serve step and sampled requests work
    step = make_serve_step(cfg, NEAREST, return_logits=True)
    cache = R.make_cache(params, cfg, batch_size=1, max_len=4, dtype=NEAREST.compute_dtype)
    with torch.no_grad():
        tok, logits, _ = step(params, cache, torch.zeros((1, 1), dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32))
    assert logits.shape == (1, cfg.vocab) and tok.shape == (1, 1)
    eng = Engine(params, cfg, NEAREST, n_slots=1, max_len=16, device="cpu")
    rid = eng.submit(np.arange(3), 2, temperature=0.7)
    assert eng.run()[0].rid == rid
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(10), 10)
    # every architecture is ported (the encoder-decoder and M-RoPE:
    # tests/test_torch_encdec.py, tests/test_torch_mrope.py)
    for arch in R.ARCH_IDS:
        assert R.get_config(arch).name == arch


def test_launcher_runs_on_cpu(capsys):
    launch_serve.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                       "--requests", "4", "--max-len", "32", "--fused-decode"])
    out = capsys.readouterr().out
    assert "4/4 finished" in out and "device=cpu" in out
