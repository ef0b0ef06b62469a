"""The SR bits of the port's optimizers: Philox4x32-10 per leaf, on the CPU.

* the plain generator against the Random123 known-answer vectors;
* the element → counter layout of a leaf stream (element i takes word
  i % 4 of block i // 4) at ragged lengths, against the generator called
  block by block;
* ``fused_adamw`` with a seed (the bits drawn "in the kernel": its plain
  version here) ≡ the same update fed the plain stream's bits, bit for
  bit, nearest or SR × Kahan off or on; and ≡ the reference's Pallas
  kernel (interpret mode) and ``ref.py`` fed those bits;
* ``StepKey``: ``LeafNoise.bits`` is the leaf seed's stream, and fused
  AdamW takes the seed (not bits) from a ``StepKey`` leaf and the bits from
  a ``GivenKey`` leaf, equal to the non-fused AdamW either way (the fused
  ≡ non-fused optimizers over several steps and policies are in
  ``tests/test_torch_update_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro_torch.core.policy import get_policy
from repro_torch.kernels.fused_adamw import fused_adamw, fused_adamw_ref
from repro_torch.kernels.philox import philox4x32_10, philox_bits, philox_bits_ref, split_seed
from repro_torch.models import registry as R
from repro_torch.optim import adamw, fused_adamw_optimizer
from repro_torch.optim import fused as FUSED
from repro_torch.optim.base import GivenKey, StepKey
from repro_torch.tree import tree_leaves, tree_map
from _torch_cpu import one_torch_thread  # noqa: F401

M32 = 0xFFFFFFFF
# Random123's kat_vectors for philox4x32_10: (counter, key) -> output
KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
HP = dict(lr=1e-3, b1=0.8984375, b2=0.99609375, eps=1e-8, wd=0.01, c1=0.9, c2=0.99609375)
VARIANTS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = philox4x32_10(ctr, key)
    assert [int(w) for w in got] == list(want)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4099])
@pytest.mark.parametrize("seed", [0, 7, 0x1234_5678_9ABC_DEF0, 2**63 - 1])
def test_leaf_stream_layout(n, seed):
    bits = philox_bits_ref(seed, n)
    assert bits.dtype == torch.int32 and bits.shape == (n,)
    key = split_seed(seed)
    assert key == (seed & M32, seed >> 32)
    for i in sorted({0, 1, 2, 3, n // 2, n - 1} & set(range(n))):
        j = i // 4
        words = philox4x32_10((j & M32, j >> 32, 0, 0), key)
        assert int(bits[i]) & M32 == int(words[i % 4]), i
    # a longer stream starts with the shorter one; the wrapper on the CPU
    # is the plain version, in the shape asked for
    assert torch.equal(philox_bits_ref(seed, n + 9)[:n], bits)
    if n % 5 == 0 or n == 4099:
        assert torch.equal(philox_bits(seed, (1, n), "cpu").reshape(n), bits)


def test_counter_high_word():
    """Blocks past 2^32 carry j >> 32 into the counter's second word."""
    j = (5 << 32) + 3
    w = philox4x32_10((j & M32, j >> 32, 0, 0), split_seed(11))
    v = philox4x32_10((j & M32, 0, 0, 0), split_seed(11))
    assert [int(a) for a in w] != [int(a) for a in v]


def _adamw_inputs(n, seed):
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return dict(w=bf(rng.standard_normal(n)), m=bf(rng.standard_normal(n) * 0.1),
                v=bf(np.abs(rng.standard_normal(n)) * 0.01), g=bf(rng.standard_normal(n)),
                c=bf(rng.standard_normal(n) * 2.0 ** -9))


@pytest.mark.parametrize("stochastic,kahan", VARIANTS)
@pytest.mark.parametrize("n", [5, 4099])
def test_seeded_fused_adamw_is_the_update_on_the_streams_bits(n, stochastic, kahan):
    x = _adamw_inputs(n, n)
    seed = 0xDEADBEEF12345
    bits = philox_bits_ref(seed, n)
    c = x["c"] if kahan else None
    want = fused_adamw_ref(x["w"], x["m"], x["v"], x["g"], c=c, bits=bits,
                           stochastic=stochastic, **HP)
    got = fused_adamw_ref(x["w"], x["m"], x["v"], x["g"], c=c, seed=seed,
                          stochastic=stochastic, **HP)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    # the wrapper, in place on CPU tensors, with the seed
    w, m, v = x["w"].clone(), x["m"].clone(), x["v"].clone()
    cc = x["c"].clone() if kahan else None
    fused_adamw(w, m, v, x["g"], c=cc, seed=seed if stochastic else None,
                stochastic=stochastic, **HP)
    for a, b in zip((w, m, v, cc), want):
        if a is not None:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    # the reference's ref.py fed the stream's bits
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)   # noqa: E731
    ref = JREF.fused_adamw_ref(j(x["w"]), j(x["m"]), j(x["v"]), j(x["g"]),
                               c=j(x["c"]) if kahan else None,
                               bits=jnp.asarray(bits.numpy().view(np.uint32)),
                               stochastic=stochastic,
                               **{k: np.float32(val) for k, val in HP.items()})
    np.testing.assert_array_equal(np.asarray(ref[0]).view(np.int16),
                                  want[0].view(torch.int16).numpy())


def test_fused_adamw_takes_bits_or_a_seed():
    x = _adamw_inputs(8, 0)
    with pytest.raises(ValueError, match="bits or a seed"):
        fused_adamw(x["w"], x["m"], x["v"], x["g"], **HP)
    with pytest.raises(ValueError, match="bits or a seed"):
        fused_adamw(x["w"], x["m"], x["v"], x["g"], bits=philox_bits_ref(1, 8), seed=1, **HP)


def test_leaf_noise_is_the_seeds_stream():
    key = StepKey(3, 5)
    for i in range(3):
        leaf = key.leaf(i)
        assert torch.equal(leaf.bits((4, 7), "cpu").reshape(-1),
                           philox_bits_ref(leaf.seed, 28))
    assert key.leaf(0).seed != key.leaf(1).seed != StepKey(3, 6).leaf(1).seed


def _model(seed=0):
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, seed, torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    grads = [tree_map(lambda w: (torch.randn(w.shape, generator=gen) * 0.05)
                      .to(torch.bfloat16), params) for _ in range(2)]
    return params, grads


@pytest.mark.parametrize("given", [False, True], ids=["StepKey", "GivenKey"])
def test_fused_adamw_optimizer_picks_seed_or_bits(monkeypatch, given):
    policy = get_policy("bf16_sr_kahan")
    params, grads = _model()
    seen = []
    real = FUSED.fused_adamw

    def spy(*a, **kw):
        seen.append(("seed" in kw, "bits" in kw))
        return real(*a, **kw)
    monkeypatch.setattr(FUSED, "fused_adamw", spy)
    plain, fused = adamw(policy, b2=0.997), fused_adamw_optimizer(policy, b2=0.997)
    n = len(tree_leaves(params))
    if given:
        key = GivenKey([philox_bits_ref(10 + i, w.numel()).reshape(w.shape)
                        for i, w in enumerate(tree_leaves(params))])
    else:
        key = StepKey(4, 0)
    p_plain, p_fused = tree_map(torch.clone, params), tree_map(torch.clone, params)
    s_plain, s_fused = plain.init(p_plain), fused.init(p_fused)
    p_plain, s_plain = plain.update(grads[0], s_plain, p_plain, step=0, key=key, lr=3e-3)
    p_fused, s_fused = fused.update(grads[0], s_fused, p_fused, step=0, key=key, lr=3e-3)
    assert seen == [(not given, given)] * n
    for t_plain, t_fused in zip((p_plain, s_plain.m, s_plain.v, s_plain.kahan_c),
                                (p_fused, s_fused.m, s_fused.v, s_fused.kahan_c)):
        for a, b in zip(tree_leaves(t_plain), tree_leaves(t_fused)):
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
