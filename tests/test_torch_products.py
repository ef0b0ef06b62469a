"""The products with an f32 result (``core.qarith.f32_product`` and
``QArith.matmul_f32out``) on the CPU, against the reference.

On CUDA, 16-bit operands run one tensor-core GEMM with an f32 result
(tests/test_torch_cuda.py holds it to the upcast product within the f32
accumulation bound). Everywhere else — the CPU, and f32 operands on any
device (the ``fp32`` policy, an f32 cotangent) — the operands are upcast
and multiplied in f32, as the reference does on its CPU path: bitwise the
upcast product, and no ``out_dtype`` GEMM is called. The logits product's
autograd.Function backward repeats the arithmetic autograd runs through
the upcast product, so its gradients are those bit for bit; and the
logits match the reference's ``matmul_f32out`` on the same numpy inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro_torch.core import qarith as Q
from repro_torch.core.policy import get_policy

SHAPES = [((5, 24), (24, 7)),                    # 2-D
          ((2, 3, 24), (24, 7)),                 # batch folded into rows (the logits)
          ((2, 3, 5, 24), (2, 3, 24, 7)),        # batched (attention's chunks)
          ((2, 1, 5, 24), (1, 3, 24, 7))]        # broadcast batch dims


def _rand(shape, seed, dtype):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(dtype)


@pytest.fixture
def no_out_dtype_gemm(monkeypatch):
    """Fail if a product reaches torch.mm / torch.bmm with ``out_dtype``."""
    for name in ("mm", "bmm"):
        real = getattr(torch, name)

        def guard(*a, _real=real, **kw):
            assert "out_dtype" not in kw, "an out_dtype GEMM ran off the tensor-core path"
            return _real(*a, **kw)
        monkeypatch.setattr(torch, name, guard)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("sa,sb", SHAPES)
def test_cpu_and_f32_operands_stay_on_the_f32_path(no_out_dtype_gemm, sa, sb, dtype):
    a, b = _rand(sa, 0, dtype), _rand(sb, 1, dtype)
    assert not Q.on_tensor_cores(a, b)
    got = Q.f32_product(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.matmul(a.float(), b.float()))
    # a transposed view, as attention passes k^T
    bt = _rand(sb[:-2] + sb[-1:] + sb[-2:-1], 2, dtype).transpose(-1, -2)
    assert torch.equal(Q.f32_product(a, bt), torch.matmul(a.float(), bt.float()))


def test_mixed_operand_dtypes_are_not_tensor_core_pairs():
    a, b = _rand((4, 8), 0, torch.bfloat16), _rand((8, 3), 1, torch.float16)
    assert not Q.on_tensor_cores(a, b)
    assert torch.equal(Q.f32_product(a, b), a.float() @ b.float())


@pytest.mark.parametrize("b_layout", ["transposed", "contiguous"])
def test_logits_function_backward_is_the_upcast_products_backward(b_layout):
    """_F32OutProduct's backward ≡ autograd through matmul(a.float(),
    b.float()) bit for bit, for the tied embedding's transposed layout
    (column-major b, as ``_logits`` passes ``embedding.T``) and a
    row-major b, on an f32 cotangent."""
    a0 = _rand((2, 6, 24), 0, torch.bfloat16)
    e0 = _rand((40, 24), 1, torch.bfloat16)
    g = _rand((2, 6, 40), 2, torch.float32)
    grads = []
    for fn in (Q._F32OutProduct.apply, lambda a, b: torch.matmul(a.float(), b.float())):
        a = a0.clone().requires_grad_(True)
        e = e0.clone().requires_grad_(True)
        b = e.T if b_layout == "transposed" else e.T.contiguous()
        out = fn(a, b)
        assert out.dtype == torch.float32
        grads.append(torch.autograd.grad(out, (a, e), g))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("policy", ["bf16_standard", "fp32"])
def test_matmul_f32out_matches_reference(no_out_dtype_gemm, policy):
    """The logits product on the CPU ≡ the reference's ``matmul_f32out`` on
    the same numpy inputs (both upcast the rounded operands)."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    emb = rng.standard_normal((48, 32)).astype(np.float32)
    pol = get_policy(policy)
    got = Q.QArith(pol).matmul_f32out(torch.from_numpy(h).to(pol.compute_dtype),
                                      torch.from_numpy(emb).to(pol.compute_dtype).T)
    jpol = j_get_policy(policy)
    want = jax.jit(JQArith(jpol).matmul_f32out)(jnp.asarray(h, jpol.compute_dtype),
                                                jnp.asarray(emb, jpol.compute_dtype).T)
    assert got.dtype == torch.float32
    # two f32 sums of the same products, in different orders: within the
    # f32 accumulation bound K·2⁻²³·(|h|@|E|ᵀ)
    hq = torch.from_numpy(h).to(pol.compute_dtype).double()
    eq = torch.from_numpy(emb).to(pol.compute_dtype).double()
    bound = 32 * 2.0 ** -23 * (hq.abs() @ eq.abs().T)
    assert ((got.double() - torch.from_numpy(np.array(want)).double()).abs() <= bound).all()
