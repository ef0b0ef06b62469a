"""M-RoPE and the qwen2-vl backbone in the port ≡ the reference, on the CPU
at the reduced size (d 128, head_dim 32: rotary sections (4, 6, 6)).

``mrope`` is within 1 bf16 ulp of the reference's (JAX's and torch's f32
``cos``/``sin`` differ in the last ulp, ROADMAP C5), and with t = h = w it
is the port's own ``rope`` bit for bit. The vlm forward from converted
weights, on embeddings and 3-D positions (a text run, an image grid, text
after it), is within ``LOGIT_RTOL`` of the largest logit (C5, C7, as for
the other families); its stepwise decode meets the reference's
prefill ≡ decode bound; one train step's loss is the reference's within
1%, and splitting the batch into 2 microbatches (``mrope_positions`` on
its dim 1) gives the one-batch loss and gradient norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread, to_torch  # noqa: F401 (autouse fixture)
from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.models import layers as JL
from repro.models import registry as JR
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.train.step import make_train_step as j_make_train_step
from repro.train.train_state import make_train_state as j_make_train_state
from repro_torch.convert import from_jax_params, from_jax_train_state
from repro_torch.core.policy import get_policy as t_get_policy
from repro_torch.core.qarith import QArith as TQArith
from repro_torch.data.synthetic import vlm_positions
from repro_torch.models import layers as TL
from repro_torch.models import registry as TR
from repro_torch.optim import adamw, constant
from repro_torch.serve.decode import generate
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_serve_step, make_train_step
from repro_torch.train.train_state import make_train_state
from test_torch_core import assert_within_one_bf16_ulp

ARCH = "qwen2-vl-7b"
POLICY = "bf16_standard"
LOGIT_RTOL = 1e-2
NO_EXCESS = {"xla_allow_excess_precision": False}
B, S = 2, 24


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
            "mrope_positions": vlm_positions(B, 4, 4, S - 20, device="cpu").numpy(),
            "labels": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}


def _pair():
    jcfg, tcfg = JR.get_config(ARCH).reduced(), TR.get_config(ARCH).reduced()
    params = JR.init(jcfg, jax.random.PRNGKey(0), j_get_policy(POLICY).param_dtype)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, tcfg, params, tparams


def _np(t):
    return t.detach().to(torch.float32).numpy()


def test_vlm_positions_layout():
    pos = vlm_positions(1, 3, 2, 2, device="cpu")[:, 0]
    assert pos.dtype == torch.int32
    assert pos.T.tolist() == [[0, 0, 0], [1, 1, 1], [2, 2, 2], [3, 3, 3], [3, 3, 4],
                              [3, 4, 3], [3, 4, 4], [5, 5, 5], [6, 6, 6]]


@pytest.mark.parametrize("sections,theta", [((16, 24, 24), 1e6), ((4, 6, 6), 1e4)])
def test_mrope_within_one_bf16_ulp(sections, theta):
    d = 2 * sum(sections)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 4, d)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(3, 2, 9)).astype(np.int32)
    want = np.asarray(jnp.float32(JL.mrope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                                           sections, theta)))
    got = TL.mrope(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos), sections,
                   theta)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    xb = to_torch(jnp.asarray(x, jnp.bfloat16)).float().numpy()
    pair = np.maximum(np.abs(xb[..., : d // 2]), np.abs(xb[..., d // 2:]))
    assert_within_one_bf16_ulp(got.float().numpy(), want, np.concatenate([pair, pair], -1))


def test_mrope_is_rope_when_streams_agree():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 7, 3, 128)).astype(np.float32)).to(torch.bfloat16)
    pos = torch.from_numpy(rng.integers(0, 32768, size=(2, 7)).astype(np.int32))
    got = TL.mrope(x, pos[None].expand(3, 2, 7), (16, 24, 24), 1e6)
    assert torch.equal(got, TL.rope(x, pos, 1e6))
    # distinct streams rotate differently
    assert not torch.equal(TL.mrope(x, torch.stack([pos, pos + 1, pos]), (16, 24, 24), 1e6),
                           got)
    with pytest.raises(ValueError, match="do not cover"):
        TL.mrope(x, pos[None].expand(3, 2, 7), (16, 24, 16), 1e6)


def test_vlm_forward_matches_reference():
    jcfg, tcfg, params, tparams = _pair()
    batch = _batch(jcfg)
    jqa, tqa = JQArith(j_get_policy(POLICY)), TQArith(t_get_policy(POLICY))
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    fwd = jax.jit(lambda p, b: JR.forward_logits(jqa, p, jcfg, b))
    want = np.asarray(fwd.lower(params, jb).compile(compiler_options=NO_EXCESS)(params, jb))
    tb = {k: torch.from_numpy(v) for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        got = TR.forward_logits(tqa, tparams, tcfg, tb)
        text = TR.forward_logits(tqa, tparams, tcfg, {"embeds": tb["embeds"]})
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, jcfg.vocab)
    err = float(np.abs(_np(got) - want).max())
    assert err <= LOGIT_RTOL * np.abs(want).max(), err
    # the grid's positions matter: without them the run is standard RoPE
    assert not torch.equal(text, got)


def test_vlm_prefill_equals_decode():
    """Teacher-forced logits ≡ stepwise decode of the embeddings with their
    3-D positions through the serve step (the reference's bound)."""
    _, cfg, _, params = _pair()
    pol = t_get_policy(POLICY)
    qa = TQArith(pol)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=5).items()}
    with torch.no_grad():
        full = TR.forward_logits(qa, params, cfg, batch, remat=False)
        cache = TR.make_cache(params, cfg, batch_size=B, max_len=S)
        step = make_serve_step(cfg, pol, fused_decode=True, return_logits=True)
        for t in range(S):
            _, logits, cache = step(params, cache, batch["embeds"][:, t:t + 1],
                                    torch.full((B,), t, dtype=torch.int32),
                                    mrope_positions=batch["mrope_positions"][:, :, t:t + 1])
    err = float((logits - full[:, -1]).abs().max())
    assert err / (float(full[:, -1].abs().max()) + 1e-6) < 0.05


def test_text_engine_equals_generate():
    """qwen2-vl serves text as any decoder: standard RoPE, G = 2 here."""
    _, cfg, _, params = _pair()
    pol = t_get_policy(POLICY)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (3, 5, 8)]
    eng = Engine(params, cfg, pol, n_slots=2, max_len=24, device="cpu")
    for p in prompts:
        eng.submit(p, 6)
    got = {c.rid: c.tokens for c in eng.run()}
    for rid, p in enumerate(prompts):
        ref = generate(params, cfg, pol, np.stack([p] * 2), max_new_tokens=6, cache_len=24,
                       device="cpu").numpy()
        np.testing.assert_array_equal(got[rid], ref[0, p.size:])


def test_one_train_step_matches_reference_and_microbatches():
    jcfg, tcfg = JR.get_config(ARCH).reduced(), TR.get_config(ARCH).reduced()
    jp, tp = j_get_policy("bf16_kahan"), t_get_policy("bf16_kahan")
    params = JR.init(jcfg, jax.random.PRNGKey(0), jp.param_dtype)
    jopt = j_adamw(jp, b2=0.99609375, weight_decay=0.01)
    jstate = j_make_train_state(params, jopt)
    batch = _batch(jcfg, seed=2)
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(j_make_train_step(jcfg, jp, jopt, j_constant(1e-3))).lower(
        jstate, jb, 0).compile(compiler_options=NO_EXCESS)
    _, jm = jstep(jstate, jb, 0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for accum in (1, 2):
        tstate = from_jax_train_state(np_state, device="cpu")
        step = make_train_step(tcfg, tp, adamw(tp, b2=0.99609375, weight_decay=0.01),
                               constant(1e-3), grad_accum=accum)
        _, m = step(tstate, tb, 0)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    assert abs(metrics[0]["loss"] - float(jm["loss"])) <= 1e-2 * abs(float(jm["loss"]))
    for k in ("loss", "grad_norm"):
        assert abs(metrics[1][k] - metrics[0][k]) <= 1e-3 * abs(metrics[0][k]), (k, metrics)


def test_train_step_refuses_a_leaf_the_loss_misses():
    """Under an embeddings batch the token embedding gets a zero gradient
    (as ``jax.grad`` gives it); any other leaf the loss does not reach is
    a wiring fault and raises."""
    _, cfg, _, params = _pair()
    pol = t_get_policy("bf16_standard")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=3).items()}
    opt = adamw(pol)
    grads = make_train_step(cfg, pol, opt, constant(1e-3)).phases[0](
        make_train_state(params, opt), batch, 0).grads
    assert torch.count_nonzero(grads["embed"]["embedding"]) == 0
    assert torch.count_nonzero(grads["final_norm"]["scale"]) > 0
    spare = {**params, "spare": torch.ones(3, dtype=pol.param_dtype)}
    step = make_train_step(cfg, pol, opt, constant(1e-3))
    with pytest.raises(RuntimeError, match="does not reach parameter 'spare'"):
        step(make_train_state(spare, opt), batch, 0)
    tokens = {"tokens": torch.zeros((B, S), dtype=torch.int32), "labels": batch["labels"]}
    with pytest.raises(RuntimeError, match="does not reach parameter 'spare'"):
        step(make_train_state(spare, opt), tokens, 0)
