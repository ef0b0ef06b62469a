"""The port's mixture-of-experts layer ≡ the reference (``repro.models.moe``).

Routing: the port's ``_route`` against the reference's on the same numpy
tokens and router, with capacity drops — the dispatch one-hots equal, the
combine weights within ``GATE_RTOL`` (the f32 router product sums its 64
terms in another order on the two sides, C6: within its accumulation bound
n·ε·Σ|x·w| the logits move by ~1e-6, the softmax's gates by ~1e-5 of
themselves; the f32 ``exp`` may differ in the last ulp, C5).
The port dispatches and combines by index where the reference multiplies
one-hots; every output of those einsums selects exact values, so the index
form is held *bitwise* to the port's own one-hot einsums on the same
expert outputs. Each strategy (global one-hot, grouped, gather) and the
shared expert, end to end against the reference compiled without excess
precision (C7): expert indices equal (a flip is allowed only within 4 f32
ulps of a tie, C5/C6), outputs bitwise equal on these inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.models import moe as JM
from repro.models import registry as JR
from _torch_cpu import one_torch_thread  # noqa: F401 (autouse fixture)
from repro_torch.convert import from_jax_params
from repro_torch.core.policy import get_policy as t_get_policy
from repro_torch.core.qarith import QArith as TQArith
from repro_torch.models import moe as TM
from repro_torch.models import registry as TR

GATE_RTOL = 1e-5


def _ulps32(x):
    return np.spacing(np.abs(np.asarray(x, np.float32)))


@pytest.mark.parametrize("T,E,k,cap", [(32, 4, 2, 5), (24, 8, 2, 48), (16, 4, 1, 2)])
def test_route_matches_reference_with_drops(T, E, k, cap):
    rng = np.random.default_rng(T * E)
    x = rng.normal(size=(T, 64)).astype(np.float32)
    router = (rng.normal(size=(64, E)) / 8).astype(np.float32)
    jd, jc = JM._route(jnp.asarray(x), jnp.asarray(router), k, cap)
    td, tc = TM._route(torch.from_numpy(x), torch.from_numpy(router), k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=GATE_RTOL, atol=0)
    kept = int(np.asarray(jd).sum())
    assert kept < T * k if cap * E < T * k else kept == T * k   # drops where tight


@pytest.mark.parametrize("k", [1, 2])
def test_index_dispatch_is_the_onehot_einsums_bitwise(k):
    """The port's index dispatch/combine == the reference's one-hot einsum
    form (written with the port's own ``_route`` and ``qa.einsum``), bit
    for bit, drops included."""
    cfg = dataclasses.replace(TR.get_config("mixtral-8x22b").reduced(), top_k=k)
    qa = TQArith(t_get_policy("bf16_standard"))
    p = TR.init(cfg, 0, torch.bfloat16, device="cpu")["layers"]["b0"]["ffn"]
    p = {n: t[0] for n, t in p.items()}
    x = torch.randn((40, cfg.d_model), generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16)
    cap = 9                                          # 40·k/4 claims per expert: drops
    got = TM._dispatch_combine(qa, p, x, cfg, cap)
    dispatch, combine = TM._route(x, p["router"], k, cap)
    xe = qa.einsum("tec,td->ecd", dispatch, x)
    ye = TM._experts_ffn(qa, p, xe, cfg.act_fn)
    want = qa.einsum("tec,ecd->td", combine, ye)
    assert int(dispatch.sum()) < 40 * k
    assert torch.equal(got, want)


def _first(tree):
    """Layer 0 of a stacked tree of tensors or arrays."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


def _moe_pair(arch, **overrides):
    """Both packages' reduced configs and layer 0's MoE weights, the
    port's converted from the reference's."""
    jcfg = dataclasses.replace(JR.get_config(arch).reduced(), **overrides)
    tcfg = dataclasses.replace(TR.get_config(arch).reduced(), **overrides)
    ffn = JR.init(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)["layers"]["b0"]["ffn"]
    tree = {"layers": {"b0": {"ffn": jax.tree_util.tree_map(np.asarray, ffn)}}}
    tp = from_jax_params(tree, device="cpu")["layers"]["b0"]["ffn"]
    return jcfg, tcfg, _first(ffn), _first(tp)


@pytest.mark.parametrize("arch,strategy,B,S,group", [
    ("mixtral-8x22b", "onehot", 2, 16, 1024),      # global, capacity drops
    ("mixtral-8x22b", "grouped", 2, 16, 8),        # four groups of 8
    ("mixtral-8x22b", "gather", 2, 16, 1024),
    ("mixtral-8x22b", "grouped", 4, 1, 1024),      # decode: no-drop capacity T·k
    ("llama4-scout-17b-a16e", "grouped", 2, 16, 8),  # top-1 + shared expert
])
def test_moe_apply_matches_reference(arch, strategy, B, S, group):
    jcfg, tcfg, jp, tp = _moe_pair(arch, moe_strategy=strategy, moe_group_size=group)
    jqa = JQArith(j_get_policy("bf16_standard"))
    tqa = TQArith(t_get_policy("bf16_standard"))
    x = np.random.default_rng(B * S).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    fn = jax.jit(lambda p, x: JM.moe_apply(jqa, p, x, jcfg)).lower(jp, xb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(fn(jp, xb), np.float32)
    got = TM.moe_apply(tqa, tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    # the routing: the same experts for every token (a flip only within 4
    # f32 ulps of a tie between the k-th and (k+1)-th probability)
    xt = np.asarray(xb.reshape(-1, jcfg.d_model), np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1))
    _, j_idx = jax.lax.top_k(jnp.asarray(probs), jcfg.top_k)
    _, t_idx, _, _ = TM._claims(torch.from_numpy(xt), tp["router"], tcfg.top_k, 1)
    for t in np.nonzero((t_idx.numpy() != np.asarray(j_idx)).any(-1))[0]:
        srt = np.sort(probs[t])[::-1]
        assert srt[jcfg.top_k - 1] - srt[jcfg.top_k] <= 4 * _ulps32(srt[jcfg.top_k])
    np.testing.assert_array_equal(got.float().numpy(), want)
