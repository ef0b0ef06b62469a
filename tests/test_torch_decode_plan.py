"""The decode kernels' long views and launch plan, on the CPU.

* The port's plain decode attention (``fused_decode_attention`` on CPU
  tensors) against the reference's Pallas kernel in interpret mode, on
  views of 8192 keys — above the 4636 keys one block's shared memory once
  held at G = 8 — at a narrow D and G, so each case takes seconds: deep
  and shallow lanes, an active lane with no visible key (uniform p over
  every key), a ring cache whose cells hold ``pos % Sc`` (with and without
  a window that crosses the ring's end). Tolerance: one bf16 ulp of the
  output, as ``tests/test_torch_decode_attention.py``'s
  ``_assert_one_bf16_ulp``: both compute f32 scores and an f32 softmax,
  but the sums run in different orders, so an f32-ulp difference can flip
  the bf16 rounding of a probability.
* The plain paged version on a shuffled pool of the same view: bitwise
  equal to the plain contiguous version.
* The wrapper's shared-memory arithmetic (``smem_bytes``, which mirrors
  ``csrc/decode_attention.cu``, and ``max_keys``): views of 32768 keys fit
  at G = 8, D = 128; a view one page longer than ``max_keys`` does not.
  Both wrappers, called on meta tensors (they reach the launch's checks
  but launch nothing), admit and refuse a view by its length alone: a
  paged view and a contiguous cache of equal length are held alike, at the
  cap and one page above it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import fused_decode_attention as j_fused
from repro_torch.kernels import decode_attention as DA

B, SC, HKV, GROUP, D = 3, 8192, 1, 2, 16
PAGE = 16


def _bf16(a):
    return np.asarray(jnp.float32(jnp.asarray(a, jnp.bfloat16)))


def _linear(depths):
    """Cells hold positions 0..depth of each lane, the rest are empty."""
    cells = np.arange(SC)[None, :]
    return np.where(cells <= np.asarray(depths)[:, None], cells, -1).astype(np.int32)


def _ring(depths):
    """A ring cache past its length: cell c holds the newest position
    p <= depth with p % SC == c."""
    d = np.asarray(depths)[:, None]
    return (d - (d - np.arange(SC)[None, :]) % SC).astype(np.int32)


def _inputs(seed, k_pos, q_pos):
    rng = np.random.default_rng(seed)
    q = _bf16(rng.standard_normal((B, 1, HKV * GROUP, D)))
    k = _bf16(rng.standard_normal((B, SC, HKV, D)))
    v = _bf16(rng.standard_normal((B, SC, HKV, D)))
    return q, k, v, k_pos, np.asarray(q_pos, np.int32)


CASES = {
    "deep_and_shallow": (lambda: _linear([SC - 1, 5000, 100]), [SC - 1, 5000, 100], {}),
    "no_visible_key": (lambda: np.stack([_linear([SC - 1])[0], np.full(SC, -1, np.int32),
                                         _linear([40])[0]]), [SC - 1, 50, 40], {}),
    "ring": (lambda: _ring([20000, 9000, SC - 1]), [20000, 9000, SC - 1], {}),
    "ring_window_across_the_end": (lambda: _ring([2 * SC + 20, 9000, SC + 3]),
                                   [2 * SC + 20, 9000, SC + 3], dict(window=64)),
}


def _torch(a):
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if a.dtype == np.float32 else t


def _assert_one_bf16_ulp(got, want):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel_on_a_long_view(case):
    k_pos, q_pos, kw = CASES[case]
    q, k, v, k_pos, q_pos = _inputs(sorted(CASES).index(case), k_pos(), q_pos)
    want = j_fused(*(jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32 else jnp.asarray(a)
                     for a in (q, k, v, k_pos, q_pos)),
                   p_dtype=jnp.bfloat16, interpret=True, **kw)
    got = DA.fused_decode_attention(*(_torch(a) for a in (q, k, v, k_pos, q_pos)),
                                    p_dtype=torch.bfloat16, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _assert_one_bf16_ulp(got.numpy(), np.asarray(want))


def test_no_visible_key_is_the_mean_of_every_value_row():
    """Uniform p = 1/SC over all SC keys, empty cells included."""
    k_pos, q_pos, _ = CASES["no_visible_key"]
    q, k, v, k_pos, q_pos = _inputs(9, k_pos(), q_pos)
    got = DA.fused_decode_attention(*(_torch(a) for a in (q, k, v, k_pos, q_pos)))
    mean = v[1].astype(np.float64).mean(axis=0)                       # (HKV, D)
    np.testing.assert_allclose(got.numpy()[1, 0].reshape(HKV, GROUP, D),
                               np.repeat(mean[:, None], GROUP, 1), atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_paged_equals_plain_contiguous_on_a_long_view(case):
    k_pos, q_pos, kw = CASES[case]
    q, k, v, k_pos, q_pos = (_torch(a) for a in _inputs(4, k_pos(), q_pos))
    n = SC // PAGE
    perm = torch.from_numpy(np.random.default_rng(5).permutation(B * n))

    def pool(t):
        out = torch.empty((B * n, PAGE, *t.shape[2:]), dtype=t.dtype)
        out[perm] = t.reshape(B * n, PAGE, *t.shape[2:])
        return out
    table = perm.reshape(B, n).to(torch.int32)
    got = DA.fused_paged_decode_attention(q, pool(k), pool(v), pool(k_pos), table, q_pos, **kw)
    want = DA.fused_decode_attention(q, k, v, k_pos, q_pos, **kw)
    assert torch.equal(got, want)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _refusal(fn, *args):
    """The ValueError the wrapper raises on meta tensors: the shared-memory
    refusal, or — when the view fits — that meta is not CUDA."""
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def _contiguous(B, Hkv, G, D, n_keys):
    q_pos = _meta(B, dtype=torch.int32)
    return _refusal(DA.fused_decode_attention, _meta(B, 1, Hkv * G, D),
                    _meta(B, n_keys, Hkv, D), _meta(B, n_keys, Hkv, D),
                    _meta(B, n_keys, dtype=torch.int32), q_pos)


def _paged(B, Hkv, G, D, n_blocks, P):
    R = B * n_blocks + 1
    return _refusal(DA.fused_paged_decode_attention, _meta(B, 1, Hkv * G, D),
                    _meta(R, P, Hkv, D), _meta(R, P, Hkv, D), _meta(R, P, dtype=torch.int32),
                    _meta(B, n_blocks, dtype=torch.int32), _meta(B, dtype=torch.int32))


def test_the_cap_admits_32768_keys_at_the_serving_group():
    G, D = 8, 128
    assert DA.max_keys(G, D) >= 32768
    assert DA.smem_bytes(32768, G, D) <= DA.MAX_SMEM
    assert DA.smem_bytes(DA.max_keys(G, D), G, D) <= DA.MAX_SMEM
    assert DA.smem_bytes(DA.max_keys(G, D) + 1, G, D) > DA.MAX_SMEM
    # the single-block kernel's cap (4636 keys) is far inside the new one
    assert DA.smem_bytes(4637, G, D) <= DA.MAX_SMEM // 2


@pytest.mark.parametrize("n_keys", [16, 256, 1024, 4096, 32768, "cap", "above"])
@pytest.mark.parametrize("G,D", [(8, 128), (2, 32), (5, 64), (4, 256), (10, 256), (16, 128)])
def test_wrappers_admit_a_view_by_its_length(n_keys, G, D):
    """Every view up to ``max_keys`` passes the launch's checks (on meta
    tensors the wrapper then refuses the device); one page more is refused
    for its shared memory, naming the cap."""
    cap = DA.max_keys(G, D)
    n = {"cap": cap, "above": cap + PAGE}.get(n_keys, n_keys)
    msg = _contiguous(3, 2, G, D, n)
    if n <= cap:
        assert "runs on CUDA or CPU, not meta" in msg
    else:
        assert "shared memory" in msg and f"at most {cap} keys" in msg


@pytest.mark.parametrize("n_blocks,P", [(16, 16), (64, 16), (2048, 16), (5, 4), (640, 8),
                                        (2192, 16), (2193, 16)])
def test_paged_and_contiguous_views_of_equal_length_are_held_alike(n_blocks, P):
    """The paged wrapper admits or refuses a view of n_blocks·P keys with
    the contiguous wrapper's words on a cache of that length: 2192 pages of
    16 are the cap at G = 8, D = 128, 2193 one page above it."""
    assert DA.max_keys(8, 128) == 2192 * 16
    assert _paged(8, 2, 8, 128, n_blocks, P) == _contiguous(8, 2, 8, 128, n_blocks * P)


def test_groups_above_eight_heads_split_into_even_parts():
    """A block holds at most 8 query rows: G = 9..16 run as two even parts
    (recurrentgemma's 10 as 5 + 5), so a view's shared memory at G is the
    part's; above MAX_GROUP the wrapper refuses, naming it."""
    assert [DA.part_rows(G) for G in (1, 8, 9, 10, 15, 16)] == [1, 8, 5, 5, 8, 8]
    for G in range(1, DA.MAX_GROUP + 1):
        assert DA.smem_bytes(2048, G, 256) == DA.smem_bytes(2048, DA.part_rows(G), 256)
    assert DA.max_keys(8, 128) == 35072                  # unchanged at the serving group
    assert DA.max_keys(10, 256) >= 2048                  # recurrentgemma's local window
    msg = _contiguous(3, 1, DA.MAX_GROUP + 1, 32, 64)
    assert f"G <= {DA.MAX_GROUP} query heads per kv head" in msg
