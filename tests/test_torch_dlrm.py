"""The port's DLRM ≡ the reference, on the CPU, from the same weights.

* ``dlrm_batches``: numpy draws on both sides, so the dense features,
  ids and labels are bitwise the reference's, for two seeds.
* ``dlrm_apply`` and the gradient of the stable logistic loss on every
  leaf, from converted reference weights (``from_jax_dlrm_params``):
  - ``fp32``: logits, loss and every gradient within ``F32_REL`` of the
    leaf's largest magnitude (f32 sums in another order);
  - ``bf16_standard``: the logits, the loss and the gradients of every
    kernel and of the embedding tables bitwise — the tables' gradient sums
    the rows of repeated ids, a scatter-add on both sides, in the same
    order and precision, so no ulp bound is needed. A bias's gradient sums
    its cotangent over the batch: the port sums in f32 and rounds once,
    and equals that sum taken in f64 and rounded to bf16; the reference's
    CPU path (the transpose of a broadcast) sums in bf16, so it lies
    within ``BIAS_REL`` of the leaf's largest magnitude (ROADMAP C13);
  - ``bf12_kahan`` (f32 carriers on the bf12 grid, straight-through
    gradients): within ``F32_REL``, as for fp32.
* One SR SGD step under ``bf16_sr`` with the reference's own bits
  (``GivenKey``): the tables and kernels bitwise.
* ``train_dlrm`` 30 steps at Fig 9's settings (lr 1.0 with decay, the
  cancellation recorded) under ``fp32`` and ``bf16_standard``, against
  the reference's ``benchmarks.common.train_dlrm`` from the same weights:
  per-step losses within ``LOSS_TOL`` (the reference's step is jitted,
  and XLA:CPU keeps some bf16 intermediates in f32, ROADMAP C7), the
  cancellation fractions within ``CANCEL_TOL`` of the reference's and
  below 1 (the port's update is in place: read after it, the old tables
  would equal the new ones everywhere), the AUC within ``AUC_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.common import train_dlrm as j_train_dlrm
from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.data.synthetic import dlrm_batches as j_dlrm_batches
from repro.models.dlrm import DLRM_KAGGLE_SMALL as J_CFG
from repro.models.dlrm import dlrm_apply as j_dlrm_apply
from repro.models.dlrm import dlrm_init as j_dlrm_init
from repro.optim import sgd as j_sgd
from repro.optim.base import init_params_for_policy as j_init_params_for_policy
from repro_torch.benchmarks.common import dlrm_loss, train_dlrm
from repro_torch.convert import from_jax_dlrm_params
from repro_torch.core.policy import get_policy
from repro_torch.core.qarith import QArith
from repro_torch.data.synthetic import dlrm_batches
from repro_torch.models import dlrm as TD
from repro_torch.core import jrandom
from repro_torch.models.dlrm import DLRM_KAGGLE_SMALL, dlrm_apply, dlrm_init
from repro_torch.optim import GivenKey, sgd
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten
from _torch_cpu import one_torch_thread, to_torch  # noqa: F401 (autouse fixture)


F32_REL = 1e-6
BIAS_REL = 2e-2
LOSS_TOL = 2e-3
CANCEL_TOL = 0.02
AUC_TOL = 0.02
B = 128
NO_EXCESS = {"xla_allow_excess_precision": False}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _ref_params(policy_name, seed=0):
    return j_init_params_for_policy(j_dlrm_init(jax.random.PRNGKey(seed), J_CFG),
                                    j_get_policy(policy_name))


def _port(tree):
    return from_jax_dlrm_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _j_loss(qa, params, batch):
    logits = j_dlrm_apply(qa, params, batch["dense"], batch["sparse"])
    y = batch["labels"]
    return jnp.mean(jnp.maximum(logits, 0) - logits * y
                    + jnp.log1p(jnp.exp(-jnp.abs(logits))))


def _jit(fn, *args):
    """``fn(*args)`` compiled once, without XLA:CPU's excess precision (so
    every bf16 rounding the FMAC model prescribes happens, ROADMAP C7)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS)(*args)


def _batch(seed=1):
    return next(j_dlrm_batches(J_CFG, B, seed=seed)), next(
        dlrm_batches(DLRM_KAGGLE_SMALL, B, seed=seed, device="cpu"))


@pytest.mark.parametrize("seed", [0, 7])
def test_dlrm_batches_match_reference_bitwise(seed):
    assert DLRM_KAGGLE_SMALL == J_CFG
    want = j_dlrm_batches(J_CFG, 64, seed=seed)
    got = dlrm_batches(DLRM_KAGGLE_SMALL, 64, seed=seed, device="cpu")
    for _ in range(3):
        w, g = next(want), next(got)
        assert set(w) == set(g) == {"dense", "sparse", "labels"}
        for k in w:
            a = np.asarray(w[k])
            assert g[k].dtype == to_torch(a).dtype and g[k].shape == a.shape, k
            np.testing.assert_array_equal(g[k].numpy(), a, err_msg=k)


def test_dlrm_init_shapes_and_tree():
    p = dlrm_init(jrandom.PRNGKey(0), DLRM_KAGGLE_SMALL, torch.bfloat16, device="cpu")
    ref = jax.eval_shape(lambda k: j_dlrm_init(k, J_CFG, jnp.bfloat16), jax.random.PRNGKey(0))
    assert tree_paths(p) == ["bottom.0.bias", "bottom.0.kernel", "bottom.1.bias",
                             "bottom.1.kernel", "bottom.2.bias", "bottom.2.kernel",
                             "tables", "top.0.bias", "top.0.kernel", "top.1.bias",
                             "top.1.kernel", "top.2.bias", "top.2.kernel"]
    for a, b in zip(tree_leaves(p), jax.tree_util.tree_leaves(ref)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
    with pytest.raises(KeyError, match="not in the DLRM"):
        from_jax_dlrm_params({"tables": np.zeros((1, 1, 1)), "head": []}, device="cpu")


def _grads(policy_name):
    """Loss, logits and per-leaf gradients of both packages on one batch,
    and the port's cotangent of each dense layer's output."""
    jp, tp = j_get_policy(policy_name), get_policy(policy_name)
    params = _ref_params(policy_name)
    jb, tb = _batch()
    j_logits, (j_loss, j_g) = _jit(lambda p, b: (
        j_dlrm_apply(JQArith(jp), p, b["dense"], b["sparse"]),
        jax.value_and_grad(lambda q: _j_loss(JQArith(jp), q, b))(p)), params, jb)
    tparams = _port(params)
    leaves = [w.detach().requires_grad_(True) for w in tree_leaves(tparams)]
    outs = []

    def dense(qa, p, x):                 # keep each layer's output's cotangent
        y = real_dense(qa, p, x)
        y.retain_grad()
        outs.append((p["bias"], y))
        return y

    real_dense = TD.dense
    TD.dense = dense
    try:
        t_loss = dlrm_loss(QArith(tp), tree_unflatten(tparams, leaves), tb)
        t_loss.backward()
    finally:
        TD.dense = real_dense
    with torch.no_grad():
        t_logits = dlrm_apply(QArith(tp), tparams, tb["dense"], tb["sparse"])
    cot = {id(bias): y.grad for bias, y in outs}
    return dict(j_loss=float(j_loss), t_loss=float(t_loss.detach()), j_logits=j_logits,
                t_logits=t_logits, paths=tree_paths(tparams),
                j_g=jax.tree_util.tree_leaves(j_g), t_g=[w.grad for w in leaves],
                cot=[cot.get(id(w)) for w in leaves])


@pytest.mark.parametrize("policy_name", ["fp32", "bf12_kahan"])
def test_dlrm_forward_and_grads_f32_carriers(policy_name):
    r = _grads(policy_name)
    assert r["t_loss"] == pytest.approx(r["j_loss"], rel=F32_REL)
    want = np.asarray(r["j_logits"], np.float32)
    assert np.abs(_np(r["t_logits"]) - want).max() <= F32_REL * np.abs(want).max()
    for path, a, b in zip(r["paths"], r["t_g"], r["j_g"]):
        b = np.asarray(b, np.float32)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, path
        assert np.abs(_np(a) - b).max() <= F32_REL * np.abs(b).max(), path


def test_dlrm_forward_and_grads_bf16():
    r = _grads("bf16_standard")
    assert r["t_loss"] == r["j_loss"]
    assert torch.equal(r["t_logits"], to_torch(r["j_logits"]))
    for path, a, b, cot in zip(r["paths"], r["t_g"], r["j_g"], r["cot"]):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape, path
        if not path.endswith("bias"):
            assert torch.equal(a, to_torch(b)), path
            continue
        exact = cot.to(torch.float64).reshape(-1, cot.shape[-1]).sum(0)
        assert torch.equal(a, exact.to(torch.bfloat16)), path
        b = np.asarray(b, np.float32)
        assert np.abs(_np(a) - b).max() <= BIAS_REL * np.abs(b).max(), path


def _reference_bits(key, params):
    leaves = jax.tree_util.tree_leaves(params)
    keys = jax.random.split(key, len(leaves))
    return GivenKey([to_torch(np.asarray(jax.random.bits(k, w.shape, jnp.uint32)))
                     for k, w in zip(keys, leaves)])


def test_sr_sgd_step_with_reference_bits_bitwise():
    jp, tp = j_get_policy("bf16_sr"), get_policy("bf16_sr")
    params = _ref_params("bf16_sr")
    jb, tb = _batch()
    jopt = j_sgd(jp, momentum=0.0)
    key = jax.random.PRNGKey(3)
    want, _ = _jit(lambda p, b, k: jopt.update(
        jax.grad(lambda q: _j_loss(JQArith(jp), q, b))(p), jopt.init(p), p, step=0, key=k,
        lr=0.1), params, jb, key)
    tparams = _port(params)
    leaves = [w.detach().requires_grad_(True) for w in tree_leaves(tparams)]
    t_g = torch.autograd.grad(dlrm_loss(QArith(tp), tree_unflatten(tparams, leaves), tb),
                              leaves)
    topt = sgd(tp, momentum=0.0)
    got, _ = topt.update(tree_unflatten(tparams, list(t_g)), topt.init(tparams), tparams,
                         step=0, key=_reference_bits(key, params), lr=0.1)
    assert not torch.equal(got["tables"], to_torch(params["tables"]))
    assert torch.equal(got["tables"], to_torch(want["tables"]))
    for a, b in zip(got["bottom"] + got["top"], want["bottom"] + want["top"]):
        assert torch.equal(a["kernel"], to_torch(b["kernel"]))


@pytest.mark.parametrize("policy_name", ["fp32", "bf16_standard"])
def test_train_dlrm_matches_reference(policy_name):
    kw = dict(steps=30, lr=1.0, lr_decay=True, record_cancellation=True)
    j_losses, j_auc, j_frac = j_train_dlrm(policy_name, **kw)
    init = _port(j_dlrm_init(jax.random.PRNGKey(0), J_CFG))
    losses, auc, frac, us = train_dlrm(policy_name, device="cpu", init_params=init, **kw)
    assert len(losses) == 30 and len(frac) == len(j_frac) == 3 and us > 0
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(frac, j_frac, rtol=0, atol=CANCEL_TOL)
    assert max(frac) < 1.0
    assert abs(auc - j_auc) <= AUC_TOL
    if policy_name == "bf16_standard":      # nearest rounding cancels most updates
        assert min(frac) > 0.5
