"""The port's reduced qwen2.5-3b ≡ the reference, teacher-forced.

``from_jax_params`` carries the reference's ``R.init`` weights over; the
port's ``decode`` and the reference's ``R.decode`` then take the same
token sequence for 12 steps (teacher-forced, so one near-tie argmax
cannot make the two runs diverge), and the f32 logits are compared.

The reference is compiled with ``xla_allow_excess_precision=False``.
XLA:CPU otherwise keeps some fused bf16 intermediates in f32 — it skips
roundings the FMAC model prescribes — and its bf16 logits then differ
from the port's by up to ~0.05 on this config. With the model's
roundings, the logits agree to within ``LOGIT_TOL``: what is left is the
order of the final f32 logits product and the f32 ulps of ``exp``
(RoPE frequencies), ``cos``/``sin`` and ``silu`` in the two frameworks,
which can flip a bf16 rounding somewhere in the stack.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.models import registry as JR
from repro_torch.convert import from_jax_params
from repro_torch.core.policy import get_policy as t_get_policy
from repro_torch.core.qarith import QArith as TQArith
from repro_torch.models import registry as TR

LOGIT_TOL = {"bf16_standard": 1e-2, "fp32": 1e-4}
B, STEPS, SC = 4, 12, 16


def _jax_params(policy_name):
    cfg = JR.get_config("qwen2.5-3b").reduced()
    policy = j_get_policy(policy_name)
    return cfg, JR.init(cfg, jax.random.PRNGKey(0), policy.param_dtype)


def test_from_jax_params_keeps_layout_and_dtypes():
    _, params = _jax_params("bf16_standard")
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = from_jax_params(tree, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat_j:
        node = port
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.bfloat16 and leaf.dtype == jnp.bfloat16
        np.testing.assert_array_equal(node.float().numpy(), np.asarray(leaf, np.float32))
    assert port["layers"]["b0"]["mixer"]["wq"]["kernel"].shape[0] == 3   # stacked L
    with pytest.raises(KeyError, match="not in the ported decoder-only LM"):
        from_jax_params({**tree, "lm_head": tree["final_norm"]}, device="cpu")
    with pytest.raises(KeyError, match="not in the ported decoder-only LM"):
        from_jax_params({**tree, "vision": tree["final_norm"]}, device="cpu")


@pytest.mark.parametrize("policy_name", ["bf16_standard", "fp32"])
def test_teacher_forced_logits_match_reference(policy_name):
    cfg, params = _jax_params(policy_name)
    jp, tp = j_get_policy(policy_name), t_get_policy(policy_name)
    jqa, tqa = JQArith(jp), TQArith(tp)
    tcfg = TR.get_config("qwen2.5-3b").reduced()
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, STEPS)).astype(np.int32)

    jcache = JR.make_cache(jqa, params, cfg, {}, batch_size=B, max_len=SC,
                           dtype=jp.compute_dtype)
    tcache = TR.make_cache(tparams, tcfg, batch_size=B, max_len=SC, dtype=tp.compute_dtype)
    pos0 = jnp.zeros((B,), jnp.int32)
    step = jax.jit(lambda p, c, t, pos: JR.decode(jqa, p, cfg, t, c, pos)).lower(
        params, jcache, jnp.asarray(tokens[:, :1]), pos0).compile(
        compiler_options={"xla_allow_excess_precision": False})

    worst = 0.0
    for t in range(STEPS):
        pos = np.full((B,), t, np.int32)
        want, jcache = step(params, jcache, jnp.asarray(tokens[:, t:t + 1]), jnp.asarray(pos))
        got, tcache = TR.decode(tqa, tparams, tcfg, torch.from_numpy(tokens[:, t:t + 1]),
                                tcache, torch.from_numpy(pos))
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, 1, cfg.vocab)
        worst = max(worst, float(np.abs(got.numpy() - np.asarray(want)).max()))
    assert worst <= LOGIT_TOL[policy_name], worst
