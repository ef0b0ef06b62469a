"""The CIFAR ResNet and its image stream in the port ≡ the reference, on the
CPU (``RESNET_CIFAR_SMALL``: widths 16/32/64, one block per stage, 10
classes; batch 8 of 32 × 32 images).

``image_batches`` gives the reference's batches bit for bit (both draw
with numpy). From the reference's ``resnet_init`` weights
(``from_jax_resnet_params``): logits within ``RTOL`` of their scale under
``bf16_standard`` (a flipped bf16 rounding of a BatchNorm statistic — the
frameworks' f32 sums differ in the last bit, C5 — moves them by up to ~1%)
and ``fp32``; under ``fp32`` the gradient of every float leaf within
``GRAD_RTOL`` of that leaf's largest |g| against ``jax.grad``. The
reference cannot differentiate its ResNet under a 16-bit policy (ROADMAP
C16: JAX's transpose of the f32-result convolution of bf16 operands mixes
dtypes), which a test pins; under ``bf16_standard``, ``bf16_sr`` and
``bf16_kahan`` the gradients are held against a plain f32 torch ResNet
rounded to bf16 where the policy rounds, itself held against ``jax.grad``
under ``fp32``. The stride-2 blocks pad as XLA's "SAME" does,
(0, 1): the symmetric (1, 1) padding of ``conv2d(padding=1)`` misses the
reference's convolution by far more than the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_cpu import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.data.synthetic import image_batches as j_image_batches
from repro.models import resnet as JRN
from repro_torch.convert import from_jax_resnet_params
from repro_torch.core.policy import get_policy as t_get_policy
from repro_torch.core.qarith import QArith as TQArith
from repro_torch.data.synthetic import image_batches
from repro_torch.models import resnet as TRN
from repro_torch.optim import StepKey, sgd
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

RTOL = 1e-2
GRAD_RTOL = 2e-2
NO_EXCESS = {"xla_allow_excess_precision": False}
BATCH = 8


def test_image_batches_are_the_reference_bits():
    mine = image_batches(10, BATCH, seed=3, device="cpu")
    theirs = j_image_batches(10, BATCH, seed=3)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        assert a["images"].dtype == torch.float32 and a["labels"].dtype == torch.int32
        np.testing.assert_array_equal(a["images"].numpy(), np.asarray(b["images"]))
        np.testing.assert_array_equal(a["labels"].numpy(), np.asarray(b["labels"]))


def _pair(policy):
    jp = j_get_policy(policy)
    params = JRN.resnet_init(jax.random.PRNGKey(0), JRN.RESNET_CIFAR_SMALL, jp.param_dtype)
    tparams = from_jax_resnet_params(jax.tree_util.tree_map(np.asarray, params),
                                     device="cpu")
    return params, tparams


def _xent(logits, labels):
    return -torch.mean(torch.log_softmax(logits, -1).gather(1, labels.long()[:, None]))


def _jloss(jqa, strides):
    def loss(floats, x, y):
        p = {**floats, "stages": [[{**b, "stride": s} for b, s in zip(st, ss)]
                                  for st, ss in zip(floats["stages"], strides)]}
        logits = JRN.resnet_apply(jqa, p, x)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(x.shape[0]), y]), logits
    return loss


def _case(policy):
    params, tparams = _pair(policy)
    batch = next(image_batches(10, BATCH, seed=1, device="cpu"))
    jfloats, strides = TRN.split_strides(params)
    jb = (jnp.asarray(batch["images"].numpy()), jnp.asarray(batch["labels"].numpy()))
    return (JQArith(j_get_policy(policy)), TQArith(t_get_policy(policy)), jfloats, strides,
            jb, tparams, batch["images"], batch["labels"])


@pytest.mark.parametrize("policy", ["bf16_standard", "fp32"])
def test_logits_match_reference(policy):
    jqa, tqa, jfloats, strides, jb, tparams, x, _ = _case(policy)
    loss = _jloss(jqa, strides)
    want = np.asarray(jax.jit(lambda f, x, y: loss(f, x, y)[1]).lower(jfloats, *jb).compile(
        compiler_options=NO_EXCESS)(jfloats, *jb))
    with torch.no_grad():
        got = TRN.resnet_apply(tqa, tparams, x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (BATCH, 10)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= RTOL * np.abs(want).max(), err


def test_reference_cannot_differentiate_bf16():
    """ROADMAP C16, a standing finding of the reference."""
    jqa, _, jfloats, strides, jb, *_ = _case("bf16_standard")
    with pytest.raises(TypeError, match="conv_general_dilated requires arguments to have "
                                        "the same dtypes"):
        jax.grad(lambda f: _jloss(jqa, strides)(f, *jb)[0])(jfloats)


def test_gradients_match_reference_fp32():
    jqa, tqa, jfloats, strides, jb, tparams, x, y = _case("fp32")
    (_, want), jgrads = jax.jit(jax.value_and_grad(_jloss(jqa, strides), has_aux=True)).lower(
        jfloats, *jb).compile(compiler_options=NO_EXCESS)(jfloats, *jb)
    floats, tstrides = TRN.split_strides(tparams)
    assert tstrides == strides == [[1], [2], [2]]
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(floats)]
    logits = TRN.resnet_apply(tqa, TRN.join_strides(tree_unflatten(floats, leaves), tstrides),
                              x)
    grads = torch.autograd.grad(_xent(logits, y), leaves)
    want = np.asarray(want)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (BATCH, 10)
    err = float(np.abs(logits.detach().numpy() - want).max())
    assert err <= RTOL * np.abs(want).max(), err
    for path, g, jg in zip(tree_paths(floats), grads, jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg, np.float32)
        assert tuple(g.shape) == jg.shape, path
        err = float(np.abs(g.float().numpy() - jg).max())
        assert err <= GRAD_RTOL * np.abs(jg).max(), (path, err, float(np.abs(jg).max()))


# XLA's "SAME" pads (before, after) for a (kernel, stride) on the even sizes here
_SAME = {(3, 1): (1, 1), (3, 2): (0, 1), (1, 2): (0, 0)}


def _plain_resnet(params, strides, x, rnd):
    """The reference's ResNet written anew in plain f32 torch: a convolution
    is ``conv2d`` of XLA-"SAME"-padded input, BatchNorm the reference's
    formula with population statistics; ``rnd`` is applied where a policy
    rounds — the images, every convolution's, BatchNorm's, ReLU's and
    residual sum's output, and the pooled mean (the weights come in on the
    policy's grid).

    The variance is ``var(unbiased=False)``, the port's f32 reduction: at
    bf16 a BatchNorm's backward cancels (the cotangent less its projections
    on 1 and x̂), so a last-bit change of σ flips output roundings whose
    cotangents that cancellation magnifies. Summed as
    ``mean((h − μ)²)`` (jnp's order) instead, one leaf's gradient moved by up to 21% of
    its largest |g| (seeds 0–3 × batches 1–6), as far as the f32 gradient
    is from the bf16 one. With the same reduction the port is within 1%."""
    def conv(w, h, s):
        lo, hi = _SAME[(w.shape[0], s)]
        return rnd(F.conv2d(F.pad(h, (lo, hi, lo, hi)), w.permute(3, 2, 0, 1), stride=s))

    def bn(p, h):
        mu = h.mean(dim=(0, 2, 3), keepdim=True)
        var = h.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
        return rnd((h - mu) * torch.rsqrt(var + 1e-5) * p["scale"][:, None, None]
                   + p["bias"][:, None, None])

    h = rnd(x).permute(0, 3, 1, 2)
    h = rnd(F.relu(bn(params["stem_bn"], conv(params["stem"], h, 1))))
    for stage, ss in zip(params["stages"], strides):
        for blk, s in zip(stage, ss):
            y = rnd(F.relu(bn(blk["bn1"], conv(blk["conv1"], h, s))))
            y = bn(blk["bn2"], conv(blk["conv2"], y, 1))
            sc = conv(blk["proj"], h, s) if "proj" in blk else h
            h = rnd(F.relu(rnd(y + sc)))
    return rnd(h.mean(dim=(2, 3))) @ params["head"]["kernel"] + params["head"]["bias"]


def _plain_grads(floats, strides, x, y, rnd):
    leaves = [t.detach().float().requires_grad_(True) for t in tree_leaves(floats)]
    logits = _plain_resnet(tree_unflatten(floats, leaves), strides, x, rnd)
    return logits, torch.autograd.grad(_xent(logits, y), leaves)


def _port_grads(tqa, tparams, x, y):
    floats, strides = TRN.split_strides(tparams)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(floats)]
    logits = TRN.resnet_apply(tqa, TRN.join_strides(tree_unflatten(floats, leaves), strides),
                              x)
    return logits, torch.autograd.grad(_xent(logits, y), leaves)


def test_plain_reference_is_the_reference_fp32():
    """The plain ResNet, with no rounding, is the reference's model:
    its logits and gradients against ``jax.grad`` under ``fp32``."""
    jqa, _, jfloats, strides, jb, tparams, x, y = _case("fp32")
    (_, want), jgrads = jax.jit(jax.value_and_grad(_jloss(jqa, strides), has_aux=True)).lower(
        jfloats, *jb).compile(compiler_options=NO_EXCESS)(jfloats, *jb)
    floats, _ = TRN.split_strides(tparams)
    logits, grads = _plain_grads(floats, strides, x, y, lambda t: t)
    want = np.asarray(want)
    assert float(np.abs(logits.detach().numpy() - want).max()) <= RTOL * np.abs(want).max()
    for path, g, jg in zip(tree_paths(floats), grads, jax.tree_util.tree_leaves(jgrads)):
        jg = np.asarray(jg, np.float32)
        err = float(np.abs(g.numpy() - jg).max())
        assert err <= GRAD_RTOL * np.abs(jg).max(), (path, err, float(np.abs(jg).max()))


@pytest.mark.parametrize("policy", ["bf16_standard", "bf16_sr", "bf16_kahan"])
def test_gradients_match_plain_reference_bf16(policy):
    """The 16-bit policies' gradients, which the reference cannot take
    (C16): every float leaf's within ``GRAD_RTOL`` of that leaf's largest
    |g| of the plain f32 ResNet rounded to bf16 where the policy rounds
    (the rounding's backward rounds the cotangent there too), on the same
    bf16 weights and images. A dropped or mis-scaled gradient is off by
    the leaf's whole scale: halving every convolution's cotangent, doubling
    the pooled one, dropping the shortcut's or detaching a BatchNorm
    statistic each fails all three cases."""
    _, tqa, _, strides, _, tparams, x, y = _case(policy)
    logits, grads = _port_grads(tqa, tparams, x, y)
    floats, _ = TRN.split_strides(tparams)
    want_logits, want = _plain_grads(floats, strides, x, y,
                                     lambda t: t.to(torch.bfloat16).to(torch.float32))
    err = float((logits - want_logits).abs().max().detach())
    assert err <= RTOL * float(want_logits.abs().max().detach()), err
    for path, g, w, p in zip(tree_paths(floats), grads, want, tree_leaves(floats)):
        assert g.dtype == p.dtype == torch.bfloat16 and g.shape == w.shape, path
        scale = float(w.abs().max())
        err = float((g.float() - w).abs().max())
        assert scale > 0 and err <= GRAD_RTOL * scale, (path, err, scale)


def test_stride_two_pads_as_same():
    """A 3×3 stride-2 conv on 32×32 pads (0, 1) per axis, a 1×1 one none."""
    qa_j, qa_t = JQArith(j_get_policy("fp32")), TQArith(t_get_policy("fp32"))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 32, 32, 16)).astype(np.float32)
    for k in (3, 1):
        w = rng.normal(size=(k, k, 16, 32)).astype(np.float32)
        want = np.asarray(JRN._conv(qa_j, jnp.asarray(w), jnp.asarray(x), 2))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = TRN._conv(qa_t, torch.from_numpy(w), xt, 2).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, 16, 16, 32)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        if k == 3:
            sym = F.conv2d(xt, torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=1)
            assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 1.0


def test_convert_keeps_strides_and_sgd_steps_in_place():
    params, tparams = _pair("bf16_sr")
    assert [[type(b["stride"]) for b in st] for st in tparams["stages"]] == [[int]] * 3
    assert "proj" not in tparams["stages"][0][0] and "proj" in tparams["stages"][1][0]
    with pytest.raises(KeyError, match="not in the ResNet"):
        from_jax_resnet_params({"stem": np.ones(1), "fc": np.ones(1)}, device="cpu")
    pol = t_get_policy("bf16_sr")
    floats, strides = TRN.split_strides(tparams)
    opt = sgd(pol, momentum=0.9)
    state = opt.init(floats)
    before = [t.clone() for t in tree_leaves(floats)]
    grads = [torch.ones_like(t) for t in tree_leaves(floats)]
    new, _ = opt.update(tree_unflatten(floats, grads), state, floats, step=0,
                        key=StepKey(0, 0), lr=0.1)
    joined = TRN.join_strides(new, strides)
    assert joined["stages"][1][0]["stride"] == 2
    # the update wrote the tensors the full tree holds
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(TRN.split_strides(
        tparams)[0])))
    qa = TQArith(pol)
    x = next(image_batches(10, 2, seed=0, device="cpu"))["images"]
    assert torch.isfinite(TRN.resnet_apply(qa, joined, x)).all()
