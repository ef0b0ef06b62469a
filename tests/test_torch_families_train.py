"""One train step of each decoder-only family in the port ≡ the reference,
on the CPU at the reduced size.

From one ``TrainState`` (the reference's, carried over with
``from_jax_train_state``), one ``make_train_step`` of each package under
``bf16_kahan`` (nearest rounding: no random bits to line up) with AdamW,
the reference compiled without excess precision (C7): the loss and the
gradient norm within ``STEP_RTOL`` (an f32 ``exp`` ulp, C5, flips a bf16
rounding now and then; measured ≤ 9e-4 relative), every updated leaf of
the reference's dtype — the f32 router, ``A_log``, ``D_skip`` and
``lambda`` of the bf16 tree come out bf16 on both sides — and within
``W_TOL`` (a bf16 ulp) of the reference's on all but ``MOVED_FRAC`` of a
leaf's entries, which stay within 2·lr of it: AdamW's first step is
lr·sign(g) wherever |g| ≫ eps, so a near-zero gradient entry whose sign a
flipped rounding changes moves its weight by 2·lr. Then
an f32 leaf through both AdamWs of both packages, bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.core import get_policy as j_get_policy
from repro.models import registry as JR
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.optim.fused import fused_adamw_optimizer as j_fused_adamw
from repro.train.step import make_train_step as j_make_train_step
from repro.train.train_state import make_train_state as j_make_train_state
from repro_torch.convert import from_jax_train_state
from repro_torch.core.policy import get_policy
from repro_torch.models import registry as R
from repro_torch.optim import StepKey, adamw, constant, fused_adamw_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves, tree_paths

ARCHS = ("yi-9b", "mistral-nemo-12b", "command-r-35b", "mixtral-8x22b",
         "llama4-scout-17b-a16e", "falcon-mamba-7b", "recurrentgemma-2b")
STEP_RTOL = 2e-3
W_TOL = 2 ** -7          # relative: a bf16 ulp of a leaf's value
MOVED_FRAC = 0.02        # of a leaf's entries beyond that (measured: ≤ 1.6%)
LR = 2e-3
B, S = 2, 16


def _batch(vocab):
    toks = np.random.default_rng(3).integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch):
    jcfg, tcfg = JR.get_config(arch).reduced(), R.get_config(arch).reduced()
    jp, tp = j_get_policy("bf16_kahan"), get_policy("bf16_kahan")
    params = JR.init(jcfg, jax.random.PRNGKey(0), jp.param_dtype)
    jopt = j_adamw(jp, b2=0.99609375, weight_decay=0.01)
    jstate = j_make_train_state(params, jopt)
    tstate = from_jax_train_state(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    batch = _batch(jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(j_make_train_step(jcfg, jp, jopt, j_constant(LR))).lower(
        jstate, jb, 0).compile(compiler_options={"xla_allow_excess_precision": False})
    jstate, jm = jstep(jstate, jb, 0)
    tstep = make_train_step(tcfg, tp, adamw(tp, b2=0.99609375, weight_decay=0.01),
                            constant(LR))
    tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    for key in ("loss", "grad_norm"):
        j, t = float(jm[key]), float(tm[key])
        assert np.isfinite(t) and abs(t - j) <= STEP_RTOL * abs(j), (key, t, j)
    jleaves = jax.tree_util.tree_leaves(jstate.params)
    tleaves = tree_leaves(tstate.params)
    assert len(jleaves) == len(tleaves)
    for path, j, t in zip(tree_paths(tstate.params), jleaves, tleaves):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
        j = np.asarray(j, np.float32)
        err = np.abs(t.float().numpy() - j)
        assert np.all(err <= W_TOL * np.abs(j) + 2 * LR * (1 + W_TOL)), (path, float(err.max()))
        moved = err > W_TOL * np.abs(j)
        assert moved.mean() <= MOVED_FRAC, (path, float(moved.mean()))


@pytest.mark.parametrize("fused", [False, True])
def test_f32_leaves_update_as_the_reference(fused):
    """An f32 leaf of a bf16 tree (the router's shape) beside a bf16 leaf,
    two AdamW steps under ``bf16_kahan``: the port's ``adamw`` == the
    reference's (the update reads the f32 value and writes bf16) and the
    port's ``fused_adamw_optimizer`` == the reference's (the wrapper casts
    the leaf to bf16 before the kernel), each bitwise, the f32 leaf bf16
    after the first step on both sides. The two optimizers differ from
    each other on that leaf, as the reference's do."""
    rng = np.random.default_rng(11)
    w0 = {"router": rng.normal(size=(64, 8)).astype(np.float32) / 8,
          "w": rng.normal(size=(64, 8)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 0.1 for k, v in w0.items()}
             for _ in range(2)]
    jp, tp = j_get_policy("bf16_kahan"), get_policy("bf16_kahan")
    jopt = (j_fused_adamw if fused else j_adamw)(jp, b2=0.99609375, weight_decay=0.01)
    topt = (fused_adamw_optimizer if fused else adamw)(tp, b2=0.99609375, weight_decay=0.01)
    jparams = {"router": jnp.asarray(w0["router"]), "w": jnp.asarray(w0["w"], jnp.bfloat16)}
    tparams = {"router": torch.from_numpy(w0["router"]),
               "w": torch.from_numpy(w0["w"]).to(torch.bfloat16)}
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for step, g in enumerate(grads):
        jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()}
        jparams, jstate = jopt.update(jg, jstate, jparams, step=step,
                                      key=jax.random.PRNGKey(step), lr=LR)
        tparams, tstate = topt.update(tg, tstate, tparams, step=step,
                                      key=StepKey(0, step), lr=LR)
        for k in ("router", "w"):
            assert tparams[k].dtype == torch.bfloat16 and jparams[k].dtype == jnp.bfloat16
            np.testing.assert_array_equal(tparams[k].float().numpy(),
                                          np.asarray(jparams[k], np.float32), err_msg=k)
