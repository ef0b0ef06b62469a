"""The port's paged and chunked attention ≡ the reference's, on the CPU.

Same numpy inputs (bf16-valued) through ``repro.*`` and ``repro_torch.*``:

* ``paged_decode_attention_ref`` (rounded once by the policy) against the
  reference's generic gathered path — ``repro.models.layers
  .decode_attention`` on ``pages[block_table]``, which is what the
  reference's paged ``attention_apply`` runs with ``fused_decode`` off (its
  Pallas paged kernel is dead on jax 0.9, ROADMAP C1): within one bf16 ulp,
  as in tests/test_torch_decode_attention.py (f32 sums in different orders
  can flip one bf16 rounding). The pools hold shuffled pages, two lanes
  share prefix pages, null blocks trail, one lane is parked.
* the port's plain paged path against its plain contiguous path on the
  gathered view, and a chunk's rows against single-token rows: bitwise.
* the multi-token ``decode_attention`` against the reference's S>1 branch:
  within one bf16 ulp.
* ``copy_page_rows``, ``reset_pages`` and ``copy_pages`` against the
  reference's: bitwise, on exact copy lists and on lists padded to a
  static width with ``dst`` = R rows (the reference's scatter drops them;
  the port remaps them to a self-copy of the null row), which must equal
  the exact list's result, including a list that is all padding.
* the paged ``attention_apply`` (projections, RoPE, the scatter through
  the block table, attention) against the reference's on the same
  weights: the pages it writes and its output agree within one bf16 ulp
  of their scale (JAX's and torch's f32 ``cos``/``sin`` differ in the last
  ulp for some RoPE angles, ROADMAP C5).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.core.qarith import QArith as JQArith
from repro.models import layers as JL
from repro.models import registry as JR
from repro.serve import cache as JSC
from repro_torch.core.policy import get_policy as t_get_policy
from repro_torch.core.qarith import QArith as TQArith
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import layers as TL
from repro_torch.models import registry as TR
from repro_torch.serve import cache as TSC

B, HKV, GROUP, D, P, NB = 4, 2, 4, 32, 4, 5          # view of NB·P = 20 keys
R = 16                                               # pool rows, null row R−1
JQA = JQArith(j_get_policy("bf16_standard"))
TQA = TQArith(t_get_policy("bf16_standard"))


def _bf16(a):
    return np.asarray(jnp.float32(jnp.asarray(a, jnp.bfloat16)))


def _pool(seed, depths):
    """A paged pool and block table: lane b holds positions 0..depths[b]
    (depth −1 ⇒ parked lane, no pages), its blocks on shuffled rows; lanes
    0 and 1 share their first two blocks (same positions); unmapped blocks
    point at the null row, whose positions are −1."""
    rng = np.random.default_rng(seed)
    q = _bf16(rng.standard_normal((B, 1, HKV * GROUP, D)))
    k_pages = _bf16(rng.standard_normal((R, P, HKV, D)))
    v_pages = _bf16(rng.standard_normal((R, P, HKV, D)))
    pos_pages = np.full((R, P), -1, np.int32)
    rows = list(rng.permutation(R - 1))
    table = np.full((B, NB), R - 1, np.int32)
    for b, depth in enumerate(depths):
        for blk in range(NB):
            if blk * P > depth:
                break
            if b == 1 and blk < 2 and table[0, blk] != R - 1:
                table[b, blk] = table[0, blk]        # shared prefix page
                continue
            row = rows.pop()
            table[b, blk] = row
            cells = blk * P + np.arange(P)
            pos_pages[row] = np.where(cells <= depth, cells, -1)
    return q, k_pages, v_pages, pos_pages, table, np.asarray(depths, np.int32)


def _view(pages, table):
    return pages[table].reshape(B, NB * P, *pages.shape[2:])


def _torch(a, dtype=torch.bfloat16):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if a.dtype == np.float32 else t


def _jax(a):
    return jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32 else jnp.asarray(a)


def _assert_one_bf16_ulp(got, want):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


CASES = {
    "shared_null_parked": (dict(seed=0, depths=[13, 9, 19, -1]), {}),
    "window_softcap": (dict(seed=1, depths=[17, 11, 6, 19]), dict(window=5, softcap=30.0)),
    "one_token_lanes": (dict(seed=2, depths=[8, 0, -1, 3]), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_plain_matches_reference_gathered_path(case):
    inp, kw = CASES[case]
    q, kp, vp, pp, table, q_pos = _pool(**inp)
    want = JL.decode_attention(JQA, _jax(q), _jax(_view(kp, table)), _jax(_view(vp, table)),
                               _jax(_view(pp, table)), q_pos=_jax(q_pos), **kw)
    got = TQA.cast(DA.paged_decode_attention_ref(
        _torch(q), _torch(kp), _torch(vp), _torch(pp), _torch(table), _torch(q_pos),
        p_dtype=torch.bfloat16, **kw))
    active = q_pos >= 0
    assert bool((got[~torch.from_numpy(active)] == 0).all())      # parked: zeros
    _assert_one_bf16_ulp(got.float().numpy()[active], np.asarray(jnp.float32(want))[active])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fused", [False, True])
def test_paged_plain_is_contiguous_plain_on_the_view(case, fused):
    inp, kw = CASES[case]
    q, kp, vp, pp, table, q_pos = (_torch(a) for a in _pool(**inp))
    paged = DA.fused_paged_decode_attention if fused else DA.paged_decode_attention_ref
    got = paged(q, kp, vp, pp, table, q_pos, **kw)
    want = DA.decode_attention_ref(q, DA._gather_view(kp, table), DA._gather_view(vp, table),
                                   DA._gather_view(pp, table), q_pos, **kw)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_cpu_paged_wrapper_takes_plain_path_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError(f"CPU tensors must not build {name}")

    monkeypatch.setattr(_build, "load", no_build)
    before = DA.PAGED_LAUNCHES
    q, kp, vp, pp, table, q_pos = (_torch(a) for a in _pool(0, [13, 9, 19, -1]))
    DA.fused_paged_decode_attention(q, kp, vp, pp, table, q_pos)
    assert DA.PAGED_LAUNCHES == before


def _chunk_inputs(seed, S=6):
    rng = np.random.default_rng(seed)
    Sc = 16
    q = _bf16(rng.standard_normal((B, S, HKV * GROUP, D)))
    k = _bf16(rng.standard_normal((B, Sc, HKV, D)))
    v = _bf16(rng.standard_normal((B, Sc, HKV, D)))
    start = np.asarray([0, 3, 9, 5], np.int32)
    n_tok = np.asarray([S, 2, 4, 0], np.int32)           # lane 3 parked
    offs = np.arange(S, dtype=np.int32)
    q_pos = np.where(offs[None] < n_tok[:, None], start[:, None] + offs[None], -1)
    cells = np.arange(Sc, dtype=np.int32)[None]
    k_pos = np.where(cells <= q_pos.max(1, keepdims=True), cells, -1).astype(np.int32)
    return q, k, v, k_pos, q_pos.astype(np.int32)


@pytest.mark.parametrize("kw", [{}, dict(window=3, softcap=30.0)], ids=["plain", "window_softcap"])
def test_chunk_matches_reference_multi_token_branch(kw):
    q, k, v, k_pos, q_pos = _chunk_inputs(0)
    want = JL.decode_attention(JQA, _jax(q), _jax(k), _jax(v), _jax(k_pos),
                               q_pos=_jax(q_pos), **kw)
    got = TL.decode_attention(TQA, _torch(q), _torch(k), _torch(v), _torch(k_pos),
                              q_pos=_torch(q_pos), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _assert_one_bf16_ulp(got.float().numpy(), np.asarray(jnp.float32(want)))


@pytest.mark.parametrize("fused", [False, True])
def test_chunk_rows_equal_single_token_rows(fused):
    q, k, v, k_pos, q_pos = (_torch(a) for a in _chunk_inputs(1))
    with dispatch.fused_decode(fused):
        chunk = TL.decode_attention(TQA, q, k, v, k_pos, q_pos=q_pos)
        for s in range(q.shape[1]):
            one = TL.decode_attention(TQA, q[:, s:s + 1].contiguous(), k, v, k_pos,
                                      q_pos=q_pos[:, s].contiguous())
            live = q_pos[:, s] >= 0
            assert torch.equal(chunk[live, s], one[live, 0])


def _stacked_caches(seed, L=2, n_rows=9, page=4):
    """The same random paged cache in the reference's and the port's
    stacked layout (L layers)."""
    cfg = TR.get_config("qwen2.5-3b").reduced()
    rng = np.random.default_rng(seed)
    shape = (L, n_rows, page, cfg.n_kv_heads, cfg.head_dim)
    k = _bf16(rng.standard_normal(shape))
    v = _bf16(rng.standard_normal(shape))
    pos = rng.integers(-1, 40, (L, n_rows, page)).astype(np.int32)
    j = {"layers": {"b0": {"k_pages": _jax(k), "v_pages": _jax(v), "pos_pages": _jax(pos)}}}
    t = {"layers": {"b0": {"k_pages": _torch(k), "v_pages": _torch(v), "pos_pages": _torch(pos)}}}
    return j, t


def _same(j, t):
    for name in TSC.PAGED_KEYS:
        a = np.asarray(jnp.float32(j["layers"]["b0"][name])) if name != "pos_pages" \
            else np.asarray(j["layers"]["b0"][name])
        b = t["layers"]["b0"][name]
        b = b.float().numpy() if b.is_floating_point() else b.numpy()
        assert np.array_equal(a, b), name


def test_page_primitives_match_reference():
    j, t = _stacked_caches(0)
    n_rows = 9
    mask = np.zeros((n_rows,), bool)
    mask[[1, 4, 7]] = True
    _same(JSC.reset_pages(j, jnp.asarray(mask)), TSC.reset_pages(t, torch.from_numpy(mask)))
    j = JSC.reset_pages(j, jnp.asarray(mask))
    real = [(2, 5), (6, 2), (0, 3)]                       # 2 is read, then written
    K = 5
    dst = np.full((K,), n_rows, np.int32)
    src = np.zeros((K,), np.int32)
    for i, (d, s) in enumerate(real):
        dst[i], src[i] = d, s
    want = JSC.copy_pages(j, jnp.asarray(dst), jnp.asarray(src))
    d, s = np.asarray(real, np.int32).T
    got = TSC.copy_pages(t, torch.from_numpy(d.copy()), torch.from_numpy(s.copy()))
    _same(want, got)


@pytest.mark.parametrize("real,pad", [([(2, 5), (6, 2), (0, 3)], 4), ([(4, 1)], 1),
                                      ([], 3), ([], 1)])
def test_padded_copy_list_equals_exact_list(real, pad):
    """copy_pages on the static-width list (``pad`` rows of dst = R, src 0)
    ≡ copy_pages on the exact list ≡ the reference on the padded list, on
    k_pages, v_pages and pos_pages; an all-padding list changes nothing."""
    n_rows = 9
    dst = np.asarray([d for d, _ in real] + [n_rows] * pad, np.int32)
    src = np.asarray([s for _, s in real] + [0] * pad, np.int32)
    j, padded = _stacked_caches(1, n_rows=n_rows)
    _, exact = _stacked_caches(1, n_rows=n_rows)
    _, before = _stacked_caches(1, n_rows=n_rows)
    got = TSC.copy_pages(padded, torch.from_numpy(dst), torch.from_numpy(src))
    if real:
        d, sp = np.asarray(real, np.int32).T
        exact = TSC.copy_pages(exact, torch.from_numpy(d.copy()), torch.from_numpy(sp.copy()))
    for name in TSC.PAGED_KEYS:
        assert torch.equal(got["layers"]["b0"][name], exact["layers"]["b0"][name]), name
        if not real:
            assert torch.equal(got["layers"]["b0"][name], before["layers"]["b0"][name]), name
    _same(JSC.copy_pages(j, jnp.asarray(dst), jnp.asarray(src)), got)


@pytest.mark.parametrize("pdim", [0, 1])
def test_copy_page_rows_matches_reference(pdim):
    rng = np.random.default_rng(pdim)
    shape = (6, 4, 3) if pdim == 0 else (2, 6, 4)
    pages = _bf16(rng.standard_normal(shape))
    dst, src = np.asarray([1, 4, 0], np.int32), np.asarray([4, 2, 1], np.int32)
    pad_dst = np.concatenate([dst, [6, 6]]).astype(np.int32)
    pad_src = np.concatenate([src, [0, 0]]).astype(np.int32)
    want = JL.copy_page_rows(_jax(pages), jnp.asarray(pad_dst), jnp.asarray(pad_src), pdim)
    got = TL.copy_page_rows(_torch(pages), torch.from_numpy(dst), torch.from_numpy(src), pdim)
    assert np.array_equal(got.float().numpy(), np.asarray(jnp.float32(want)))


@functools.cache
def _layer_params():
    """One attention block's weights (bf16 values, QKV biases) in both
    layouts, from numpy."""
    jcfg = JR.get_config("qwen2.5-3b").reduced()
    tcfg = TR.get_config("qwen2.5-3b").reduced()
    rng = np.random.default_rng(11)
    hd, dm = tcfg.head_dim, tcfg.d_model
    shapes = {"wq": (dm, tcfg.n_heads * hd), "wk": (dm, tcfg.n_kv_heads * hd),
              "wv": (dm, tcfg.n_kv_heads * hd), "wo": (tcfg.n_heads * hd, dm)}
    raw = {}
    for name, (i, o) in shapes.items():
        raw[name] = {"kernel": _bf16(rng.standard_normal((i, o)) / np.sqrt(i))}
        if name != "wo":
            raw[name]["bias"] = _bf16(rng.standard_normal((o,)) * 0.1)
    jp = {n: {k: _jax(a) for k, a in leaf.items()} for n, leaf in raw.items()}
    tp = {n: {k: _torch(a) for k, a in leaf.items()} for n, leaf in raw.items()}
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("S", [1, 3])
def test_paged_attention_apply_matches_reference(S):
    jcfg, jp, tcfg, tp = _layer_params()
    rng = np.random.default_rng(5)
    n_rows, page, n_blocks = 12, 4, 4
    x = _bf16(rng.standard_normal((B, S, tcfg.d_model)))
    k = _bf16(rng.standard_normal((n_rows, page, tcfg.n_kv_heads, tcfg.head_dim)))
    v = _bf16(rng.standard_normal((n_rows, page, tcfg.n_kv_heads, tcfg.head_dim)))
    pos = np.full((n_rows, page), -1, np.int32)
    table = np.full((B, n_blocks), n_rows - 1, np.int32)
    table[0, :3] = [3, 7, 1]
    table[1, :2] = [3, 5]                 # shares page 3 with lane 0 (not written)
    table[2, :1] = [9]
    pos[3] = np.arange(4)
    pos[7] = 4 + np.arange(4)
    pos[1, :1] = 8
    pos[5, :2] = [4, 5]
    start = np.asarray([9, 6, 0, 0], np.int32)   # lane 3 parked
    n_tok = np.asarray([S, min(S, 2), S, 0])
    offs = np.arange(S)
    positions = np.where(offs[None] < n_tok[:, None], start[:, None] + offs[None], -1)
    positions = positions.astype(np.int32)
    jcache = {"k_pages": _jax(k), "v_pages": _jax(v), "pos_pages": _jax(pos)}
    tcache = {"k_pages": _torch(k), "v_pages": _torch(v), "pos_pages": _torch(pos)}
    def ref(jp, x, positions, cache, table):
        return JL.attention_apply(JQA, jp, x, jcfg, positions=positions, cache=cache,
                                  cache_pos=positions, block_table=table)

    args = (jp, _jax(x), _jax(positions), jcache, _jax(table))
    jout, jnew = jax.jit(ref).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    tout, tnew = TL.attention_apply(TQA, tp, _torch(x), tcfg,
                                    positions=_torch(positions), cache=tcache,
                                    block_table=_torch(table))
    assert tnew is tcache
    want_pos = np.asarray(jnew["pos_pages"])
    got_pos = tcache["pos_pages"].numpy()
    assert np.array_equal(got_pos[:-1], want_pos[:-1])      # every real row
    assert (got_pos[-1] == -1).all()                        # null row stays empty
    for name in ("k_pages", "v_pages"):
        got = tcache[name].float().numpy()[:-1]
        want = np.asarray(jnp.float32(jnew[name]))[:-1]
        _assert_one_bf16_ulp(got, want)
    live = positions >= 0
    _assert_within_scale_ulp(tout.float().numpy()[live], np.asarray(jnp.float32(jout))[live])


def _assert_within_scale_ulp(got, want):
    """|got − want| ≤ one bf16 ulp of the largest |want| (cancellation in
    the output projection turns a one-ulp input difference into one ulp at
    the operands' scale, not at the result's)."""
    scale = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= scale, (np.abs(got - want).max(), scale)


def test_paged_attention_apply_equals_contiguous_on_the_same_cells():
    """The paged branch writes and attends exactly as the contiguous
    branch does on a cache holding the same cells: outputs bitwise equal,
    and the gathered pages equal the contiguous cache."""
    _, _, tcfg, tp = _layer_params()
    rng = np.random.default_rng(6)
    S, n_rows, page, n_blocks = 3, 10, 4, 4
    Sc = page * n_blocks
    x = _torch(_bf16(rng.standard_normal((B, S, tcfg.d_model))))
    k = _bf16(rng.standard_normal((B, Sc, tcfg.n_kv_heads, tcfg.head_dim)))
    v = _bf16(rng.standard_normal((B, Sc, tcfg.n_kv_heads, tcfg.head_dim)))
    depth = np.asarray([5, 9, -1, 2])
    cells = np.arange(Sc)[None]
    k_pos = np.where(cells <= depth[:, None], cells, -1).astype(np.int32)
    start = depth + 1
    n_tok = np.asarray([3, 1, 2, 0])
    offs = np.arange(S)
    positions = np.where(offs[None] < n_tok[:, None], start[:, None] + offs[None], -1)
    positions = _torch(positions.astype(np.int32))
    # pages: lane b's block j on a shuffled row; blocks beyond need → null
    table = np.full((B, n_blocks), n_rows - 1, np.int32)
    kp = np.zeros((n_rows, page, tcfg.n_kv_heads, tcfg.head_dim), np.float32)
    vp, pp = kp.copy(), np.full((n_rows, page), -1, np.int32)
    rows = list(np.random.default_rng(7).permutation(n_rows - 1))
    for b in range(B):
        for j in range(n_blocks):
            if j * page > start[b] + n_tok[b] - 1:
                break
            r = rows.pop()
            table[b, j] = r
            kp[r], vp[r], pp[r] = (a[b, j * page:(j + 1) * page] for a in (k, v, k_pos))
    contiguous = (_torch(k), _torch(v), _torch(k_pos))
    paged = {"k_pages": _torch(kp), "v_pages": _torch(vp), "pos_pages": _torch(pp)}
    for fused in (False, True):
        c = tuple(t.clone() for t in contiguous)
        pg = {n: t.clone() for n, t in paged.items()}
        with dispatch.fused_decode(fused):
            want, _ = TL.attention_apply(TQA, tp, x, tcfg, positions=positions, cache=c)
            got, _ = TL.attention_apply(TQA, tp, x, tcfg, positions=positions, cache=pg,
                                        block_table=_torch(table))
        live = positions >= 0                   # padding rows are discarded
        assert torch.equal(got[live], want[live])
        view = lambda t: DA._gather_view(t, _torch(table))  # noqa: E731
        mapped = torch.from_numpy(table != n_rows - 1).repeat_interleave(page, 1)
        for a, b in zip((view(pg["k_pages"]), view(pg["v_pages"]), view(pg["pos_pages"])), c):
            assert torch.equal(a[mapped], b[mapped])


def test_contiguous_chunk_scatter_leaves_padding_cells_alone():
    """A chunk's padding tokens (position −1) rewrite nothing: every cell
    not written by a real token keeps its value, even where a lane's real
    token writes cell 0 in the same step."""
    _, _, tcfg, tp = _layer_params()
    rng = np.random.default_rng(8)
    S, Sc = 4, 8
    x = _torch(_bf16(rng.standard_normal((B, S, tcfg.d_model))))
    k = _torch(_bf16(rng.standard_normal((B, Sc, tcfg.n_kv_heads, tcfg.head_dim))))
    v = _torch(_bf16(rng.standard_normal((B, Sc, tcfg.n_kv_heads, tcfg.head_dim))))
    k_pos = torch.full((B, Sc), -1, dtype=torch.int32)
    positions = torch.tensor([[0, -1, -1, -1], [6, 7, 8, -1], [-1] * 4, [2, 3, 4, 5]],
                             dtype=torch.int32)
    before = (k.clone(), v.clone(), k_pos.clone())
    TL.attention_apply(TQA, tp, x, tcfg, positions=positions, cache=(k, v, k_pos))
    written = torch.zeros((B, Sc), dtype=torch.bool)
    for b in range(B):
        for p_ in positions[b].tolist():
            if p_ >= 0:
                written[b, p_ % Sc] = True
                assert int(k_pos[b, p_ % Sc]) == p_
    for a, b in zip((k, v, k_pos), before):
        assert torch.equal(a[~written], b[~written])
