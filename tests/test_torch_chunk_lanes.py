"""The serve step's row-independent ops (ROADMAP C10) on the CPU.

* A prefill chunk's attention with every query row a decode lane of its
  own (``attention_as_lanes``, ``paged_attention_as_lanes``, through the
  decode kernels' plain versions here) against the port's multi-query
  path and the reference's ``repro.models.layers.decode_attention`` on the
  same numpy inputs, real rows within atol = rtol = 2^-8 of the f32 output
  before rounding (f32 sums in other orders; one flipped bf16 probability
  moves an output by at most a bf16 ulp of p times |v|), padding rows
  exact zeros; the paged form ≡ the contiguous form bit for bit.
* ``row_mean_sq_ref`` (RMSNorm's mean of squares in the kernel's order)
  against the exact mean within the f32 bound of its own summation order
  and against ``torch.mean`` and the reference's ``jnp.mean`` within the
  sum of the two orders' bounds (they differ by up to 3 f32 ulps at these
  widths, so no 1-ulp agreement holds), and bitwise across row counts.
* The routing: only inside ``fused_decode``, on CUDA, do dense products,
  norms and chunk attention take the kernels; on the CPU the serve step
  stays the reference's arithmetic (the engine ≡ ``generate`` tests).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.models.layers import decode_attention as j_decode_attention
from repro_torch.core.policy import get_policy
from repro_torch.core.qarith import QArith
from repro_torch.kernels import dispatch
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels.row_mean_sq import row_mean_sq, row_mean_sq_ref
from repro_torch.models import layers as L

B, S, HKV, GROUP, D, SC, PAGE = 3, 8, 2, 2, 32, 40, 4
TOL = 2.0 ** -8
U = 2.0 ** -24          # f32 unit roundoff


def _chunk(seed):
    """A chunk of S rows per lane at depth d_b (its own K/V written), lane
    2's rows from 5 on padding (position −1)."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    q = bf(rng.standard_normal((B, S, HKV * GROUP, D)))
    k = bf(rng.standard_normal((B, SC, HKV, D)))
    v = bf(rng.standard_normal((B, SC, HKV, D)))
    depth = np.array([0, 9, 20], np.int32)
    q_pos = depth[:, None] + np.arange(S, dtype=np.int32)[None]
    q_pos[2, 5:] = -1
    cells = np.arange(SC, dtype=np.int32)[None]
    k_pos = np.where(cells <= q_pos.max(1, keepdims=True), cells, -1).astype(np.int32)
    return q, k, v, torch.from_numpy(k_pos), torch.from_numpy(q_pos)


def _pages(k, v, k_pos, seed):
    """The contiguous caches as a shuffled page pool whose gathered view
    ``pages[table]`` is the cache again (plus a trailing null row)."""
    n = SC // PAGE
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(B * n))

    def pool(t):
        out = torch.zeros((B * n + 1, PAGE, *t.shape[2:]), dtype=t.dtype)
        out[perm] = t.reshape(B * n, PAGE, *t.shape[2:])
        return out
    pos = pool(k_pos)
    pos[-1] = -1
    return pool(k), pool(v), pos, perm.reshape(B, n).to(torch.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_chunk_rows_as_lanes_match_the_multi_query_paths(seed):
    q, k, v, k_pos, q_pos = _chunk(seed)
    qa = QArith(get_policy("bf16_standard"))
    lanes = L.attention_as_lanes(q, k, v, k_pos, q_pos, p_dtype=torch.bfloat16)
    plain = L.decode_attention(qa, q, k, v, k_pos, q_pos=q_pos)       # multi-query
    jqa = JQArith(j_get_policy("bf16_standard"))
    ref = j_decode_attention(jqa, jnp.asarray(q.float().numpy(), jnp.bfloat16),
                             jnp.asarray(k.float().numpy(), jnp.bfloat16),
                             jnp.asarray(v.float().numpy(), jnp.bfloat16),
                             jnp.asarray(k_pos.numpy()), q_pos=jnp.asarray(q_pos.numpy()))
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    real = q_pos >= 0
    assert lanes.dtype == torch.float32 and lanes.shape == q.shape
    for other in (plain.float(), ref):
        torch.testing.assert_close(lanes[real], other[real], atol=TOL, rtol=TOL)
    assert bool((lanes[~real] == 0).all())
    # under fused_decode on the CPU a chunk keeps the multi-query path
    with dispatch.fused_decode():
        assert torch.equal(L.decode_attention(qa, q, k, v, k_pos, q_pos=q_pos), plain)


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_rows_as_lanes_equal_the_contiguous_rows(seed):
    q, k, v, k_pos, q_pos = _chunk(seed)
    kp, vp, pp, table = _pages(k, v, k_pos, seed + 7)
    lanes = L.attention_as_lanes(q, k, v, k_pos, q_pos)
    paged = L.paged_attention_as_lanes(q, kp, vp, pp, table, q_pos)
    assert torch.equal(paged, lanes)


def test_a_chunk_row_is_the_single_token_step_at_its_position():
    """Row i of a lane, as a lane of its own, equals the single-token call
    over a cache that holds only positions up to its own."""
    q, k, v, k_pos, q_pos = _chunk(3)
    lanes = L.attention_as_lanes(q, k, v, k_pos, q_pos)
    for b in range(B):
        for i in range(S):
            p = int(q_pos[b, i])
            if p < 0:
                continue
            kp = torch.where(k_pos[b:b + 1] <= p, k_pos[b:b + 1], -1)
            one = DA.decode_attention_ref(q[b:b + 1, i:i + 1], k[b:b + 1], v[b:b + 1], kp,
                                          q_pos[b:b + 1, i])
            assert torch.equal(one[0, 0], lanes[b, i]), (b, i)


def test_lane_map_reads_the_lanes_cache_rows():
    """``lane_rows`` ≡ the caches gathered to one row per lane."""
    q, k, v, k_pos, q_pos = _chunk(4)
    rows = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    ql = q[:, 0][rows.long()][:, None].contiguous()
    qp = torch.tensor([25, 3, 22, 12], dtype=torch.int32)
    got = DA.fused_decode_attention(ql, k, v, k_pos, qp, lane_rows=rows)
    r = rows.long()
    want = DA.decode_attention_ref(ql, k[r], v[r], k_pos[r], qp)
    assert torch.equal(got, want)


@pytest.mark.parametrize("width", [32, 77, 128, 2048])
def test_row_mean_sq_plain_version_against_the_mean(width):
    rng = np.random.default_rng(width)
    x = torch.from_numpy((rng.standard_normal((64, width)) * 3).astype(np.float32))
    x = x.to(torch.bfloat16)
    got = row_mean_sq_ref(x)
    assert got.shape == (64, 1) and got.dtype == torch.float32
    exact = torch.mean(torch.square(x.double()), -1, keepdim=True)
    # a chain of ceil(D/32) adds per lane, 5 butterfly adds, the squares and
    # the division: relative error at most (ceil(D/32) + 7)·u
    own = (-(-width // 32) + 7) * U
    assert bool(((got.double() - exact).abs() <= own * exact).all())
    # torch.mean and jnp.mean sum in other orders: each within (D + 2)·u
    other = (width + 2) * U
    tmean = torch.mean(torch.square(x.float()), -1, keepdim=True)
    jmean = torch.from_numpy(np.array(jnp.mean(jnp.square(
        jnp.asarray(x.float().numpy())), axis=-1, keepdims=True)))
    for m in (tmean, jmean):
        assert bool(((got.double() - m.double()).abs() <= (own + other) * exact).all())
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(row_mean_sq(x), got)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_mean_sq_rows_do_not_depend_on_the_row_count(dtype):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((256, 200))
                         .astype(np.float32)).to(dtype)
    full = row_mean_sq_ref(x)
    for M in (1, 8, 129):
        assert torch.equal(row_mean_sq_ref(x[:M]), full[:M])
    assert torch.equal(row_mean_sq_ref(x.reshape(16, 16, 200)).reshape(256, 1), full)


def test_rmsnorm_with_the_row_reduction_keeps_the_op_order():
    """``mean_sq`` changes only the reduction: with torch.mean passed in it
    is the default rmsnorm bit for bit."""
    qa = QArith(get_policy("bf16_standard"))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((8, 64))
                         .astype(np.float32)).to(torch.bfloat16)
    scale = torch.linspace(0.5, 1.5, 64).to(torch.bfloat16)

    def tmean(t):
        return torch.mean(torch.square(t.float()), -1, keepdim=True)
    assert torch.equal(qa.rmsnorm(x, scale, mean_sq=tmean), qa.rmsnorm(x, scale))
    out = qa.rmsnorm(x, scale, mean_sq=row_mean_sq_ref)
    inv = torch.rsqrt(row_mean_sq_ref(x) + 1e-6).to(torch.bfloat16)
    assert torch.equal(out, (x * inv) * scale)


def test_serve_ops_route_to_the_kernels_only_on_cuda(monkeypatch):
    """Inside ``fused_decode`` a CUDA bf16 product goes to qmatmul, a norm
    to row_mean_sq; CPU tensors, or no context, keep the reference's ops."""
    qa = QArith(get_policy("bf16_standard"))
    x = torch.randn(2, 3, 16).to(torch.bfloat16)
    w = torch.randn(16, 8).to(torch.bfloat16)
    calls = []
    monkeypatch.setattr(L, "qmatmul", lambda a, b: calls.append("qmatmul") or a @ b)
    with dispatch.fused_decode():
        assert torch.equal(L.project(qa, x, w), qa.einsum("...d,df->...f", x, w))
    assert calls == []
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    assert not L._kernel_route(cuda)
    with dispatch.fused_decode():
        assert L._kernel_route(cuda, cuda)
        assert not L._kernel_route(cuda, cpu)
        assert not L._kernel_route(cpu)
    with dispatch.fused_decode(False):
        assert not L._kernel_route(cuda)
