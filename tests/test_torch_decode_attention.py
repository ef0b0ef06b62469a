"""The port's decode attention ≡ both of the reference's decode paths.

Same numpy inputs (bf16-valued) through

* ``repro.models.layers.decode_attention`` (the generic XLA path, output
  rounded to bf16 by the policy) against the port's
  ``repro_torch.models.layers.decode_attention``: within 1 bf16 ulp of the
  output — both compute f32 scores and an f32 softmax, but the sums run in
  different orders, so an f32-ulp difference can flip a bf16 rounding (of
  a probability, or of the output);
* ``repro.kernels.decode_attention.fused_decode_attention`` (the Pallas
  kernel in interpret mode, unrounded f32 output) against the port's
  ``fused_decode_attention`` on CPU tensors (its plain version):
  atol = rtol = 2^-8 — the same f32-order effect, before any output
  rounding: one flipped bf16 probability moves the output by at most one
  bf16 ulp of p times |v|.

Parked lanes (``q_pos < 0``) must be exact zeros in the port (as in the
Pallas kernel); the generic reference computes garbage there, which the
serve step discards, so only active lanes are compared with it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.kernels.decode_attention import fused_decode_attention as j_fused
from repro.models.layers import decode_attention as j_decode_attention
from repro_torch.core.policy import get_policy as t_get_policy
from repro_torch.core.qarith import QArith as TQArith
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels import decode_attention as DA
from repro_torch.models.layers import decode_attention as t_decode_attention

B, SC, HKV, GROUP, D = 4, 16, 2, 4, 32
TOL = 2.0 ** -8


def _inputs(seed, *, filled=10, q_pos=None):
    rng = np.random.default_rng(seed)
    bf16 = lambda a: np.asarray(jnp.float32(jnp.asarray(a, jnp.bfloat16)))  # noqa: E731
    q = bf16(rng.standard_normal((B, 1, HKV * GROUP, D)))
    k = bf16(rng.standard_normal((B, SC, HKV, D)))
    v = bf16(rng.standard_normal((B, SC, HKV, D)))
    cells = np.arange(SC)[None, :].repeat(B, 0)
    k_pos = np.where(cells < filled, cells, -1).astype(np.int32)
    if q_pos is None:
        q_pos = np.full((B,), filled - 1, np.int32)
    return q, k, v, k_pos, np.asarray(q_pos, np.int32)


def _jax(a, dtype=jnp.bfloat16):
    return jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)


def _torch(a, dtype=torch.bfloat16):
    t = torch.from_numpy(a.copy())
    return t.to(dtype) if a.dtype == np.float32 else t


def _both_layers(inputs, **kw):
    q, k, v, k_pos, q_pos = inputs
    jqa, tqa = JQArith(j_get_policy("bf16_standard")), TQArith(t_get_policy("bf16_standard"))
    want = j_decode_attention(jqa, _jax(q), _jax(k), _jax(v), _jax(k_pos),
                              q_pos=_jax(q_pos), **kw)
    got = t_decode_attention(tqa, _torch(q), _torch(k), _torch(v), _torch(k_pos),
                             q_pos=_torch(q_pos), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(jnp.float32(want))


def _both_kernels(inputs, **kw):
    q, k, v, k_pos, q_pos = inputs
    want = j_fused(_jax(q), _jax(k), _jax(v), _jax(k_pos), _jax(q_pos),
                   p_dtype=jnp.bfloat16, interpret=True, **kw)
    got = DA.fused_decode_attention(_torch(q), _torch(k), _torch(v), _torch(k_pos),
                                    _torch(q_pos), p_dtype=torch.bfloat16, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.numpy(), np.asarray(want)


def _assert_one_bf16_ulp(got, want):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp).all()


CASES = {
    "plain": (dict(seed=0), {}),
    "window_softcap": (dict(seed=1, filled=12), dict(window=5, softcap=30.0)),
    "ragged": (dict(seed=3, q_pos=[2, 9, 0, 5]), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_generic_reference(case):
    inp, kw = CASES[case]
    got, want = _both_layers(_inputs(**inp), **kw)
    _assert_one_bf16_ulp(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel(case):
    inp, kw = CASES[case]
    got, want = _both_kernels(_inputs(**inp), **kw)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_parked_lanes_are_exact_zeros():
    inputs = _inputs(2, q_pos=[9, -1, 9, -1])
    got, want = _both_kernels(inputs)
    assert (got[[1, 3]] == 0).all() and (want[[1, 3]] == 0).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    got, want = _both_layers(inputs)
    assert (got[[1, 3]] == 0).all()
    _assert_one_bf16_ulp(got[[0, 2]], want[[0, 2]])


def test_f32_cache_matches_pallas_kernel():
    q, k, v, k_pos, q_pos = _inputs(4, q_pos=[3, 15, 7, 11], filled=16)
    want = j_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_pos),
                   jnp.asarray(q_pos), p_dtype=jnp.float32, interpret=True)
    got = DA.fused_decode_attention(*(torch.from_numpy(a.copy()) for a in
                                      (q, k, v, k_pos, q_pos)), p_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_cpu_wrapper_takes_plain_path_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError(f"CPU tensors must not build {name}")

    monkeypatch.setattr(_build, "load", no_build)
    q, k, v, k_pos, q_pos = (_torch(a) for a in _inputs(0))
    before = DA.LAUNCHES
    with dispatch.fused_decode():
        got = t_decode_attention(TQArith(t_get_policy("bf16_standard")), q, k, v, k_pos,
                                 q_pos=q_pos)
    want = DA.decode_attention_ref(q, k, v, k_pos, q_pos).to(torch.bfloat16)
    assert DA.LAUNCHES == before
    assert torch.equal(got, want)


def test_dispatch_context_restores():
    assert not dispatch.fused_decode_enabled()
    with dispatch.fused_decode():
        assert dispatch.fused_decode_enabled()
        with dispatch.fused_decode(False):
            assert not dispatch.fused_decode_enabled()
        assert dispatch.fused_decode_enabled()
    assert not dispatch.fused_decode_enabled()
