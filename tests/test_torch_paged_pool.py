"""The port's ``PagedCachePool`` ≡ the reference's, operation for operation.

Both pools run the same sequence of slot, page and prefix-cache
operations; after every one, their results and their whole host state
must be identical: block tables, refcounts, free lists (order included),
each lane's pages, the prefix index (keys and LRU order). The device side
is held by shape and bytes.
"""
import functools

import jax
import numpy as np
import pytest

from repro.core import get_policy as j_get_policy
from repro.models import registry as JR
from repro.serve.paged import PagedCachePool as JPool
from repro.serve.paged import _chain_key as j_chain_key
from repro_torch.core.policy import get_policy
from repro_torch.models import registry as R
from repro_torch.serve.cache import CachePool
from repro_torch.serve.paged import PagedCachePool, _chain_key

NEAREST = get_policy("bf16_standard")


@functools.cache
def _params():
    jcfg = JR.get_config("qwen2.5-3b").reduced()
    jparams = JR.init(jcfg, jax.random.PRNGKey(0), j_get_policy("bf16_standard").param_dtype)
    cfg = R.get_config("qwen2.5-3b").reduced()
    return jcfg, jparams, cfg, R.init(cfg, 0, NEAREST.param_dtype, device="cpu")


def _pools(**kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_len", 32)
    kw.setdefault("page_size", 8)
    jcfg, jparams, cfg, params = _params()
    return (JPool(jparams, jcfg, j_get_policy("bf16_standard"), **kw),
            PagedCachePool(params, cfg, NEAREST, **kw))


def _state(pool):
    return {"table": pool.block_table.tolist(), "ref": pool._ref.tolist(),
            "free_pages": list(pool._free_pages), "free_slots": list(pool._free_slots),
            "lane_pages": [list(p) for p in pool._lane_pages],
            "prefix": list(pool._prefix.items()), "live": pool.n_live_pages,
            "cached": pool.n_cached_pages}


class _Both:
    """Apply each call to both pools; results and states must agree."""

    def __init__(self, jpool, tpool):
        self.j, self.t = jpool, tpool

    def __getattr__(self, name):
        def call(*args, **kw):
            want = getattr(self.j, name)(*args, **kw)
            got = getattr(self.t, name)(*args, **kw)
            assert got == want, (name, args, got, want)
            assert _state(self.t) == _state(self.j), name
            self.t.check_invariants()
            return got
        return call


def test_chain_key_matches_reference():
    rng = np.random.default_rng(0)
    key_j = key_t = b""
    for _ in range(4):
        block = rng.integers(0, 512, 8).astype(np.int32)
        key_j, key_t = j_chain_key(key_j, block), _chain_key(key_t, block)
        assert key_j == key_t


def test_alloc_release_and_exhaustion_match_reference():
    both = _Both(*_pools(n_pages=9))
    a, b = both.acquire(), both.acquire()
    both.ensure_blocks(a, 17)                   # 3 pages
    both.ensure_blocks(a, 17)                   # already covered
    both.ensure_blocks(b, 31)                   # 4 pages
    c = both.acquire()
    both.ensure_blocks(c, 23)                   # needs 3, has 2: takes nothing
    both.release(a)
    both.ensure_blocks(c, 23)
    both.release(b)
    both.release(c)
    assert both.t.n_free_pages == both.t.n_pages


def test_prefix_sharing_cow_and_lru_reclaim_match_reference():
    both = _Both(*_pools(n_pages=6))
    prompt = np.arange(100, 124, dtype=np.int32)      # 3 full blocks
    a = both.acquire()
    both.prepare_write(a, 0, 24)
    both.publish_prefix(a, prompt)
    both.publish_prefix(a, prompt)                    # already indexed: none new
    both.match_prefix(prompt)
    both.match_prefix(prompt[:16])                    # shorter prefix, LRU refresh
    both.match_prefix(prompt[::-1])                   # different tokens: no hit
    b = both.acquire()
    both.adopt_prefix(b, both.match_prefix(prompt))
    fresh, copies = both.prepare_write(b, 23, 2)      # CoW block 2, fresh block 3
    assert len(fresh) == 1 and len(copies) == 1
    both.release(a)
    assert both.t.n_free_pages == 1 and both.n_reclaimable() == 1
    c = both.acquire()
    assert both.prepare_write(c, 0, 16) is not None   # reclaims the index-only page
    assert both.t.n_cached_pages == 2
    both.n_reclaimable(exclude=[int(both.t.block_table[b][0])])
    assert both.prepare_write(c, 16, 16) is None      # more than free + reclaimable
    both.release(b)
    both.release(c)
    both.clear_prefix()
    assert both.t.n_live_pages == 0


def test_pool_validation_nbytes_and_layout():
    jpool, tpool = _pools(n_pages=6)
    assert tpool.nbytes() == jpool.nbytes()
    assert (tpool.n_rows, tpool.null_page, tpool.max_blocks, tpool.capacity_tokens) == \
        (jpool.n_rows, jpool.null_page, jpool.max_blocks, jpool.capacity_tokens)
    leaf = tpool.cache["layers"]["b0"]
    cfg = _params()[2]
    assert tuple(leaf["k_pages"].shape) == (cfg.n_layers, 7, 8, cfg.n_kv_heads, cfg.head_dim)
    assert (leaf["pos_pages"] == -1).all()
    with pytest.raises(ValueError, match="n_pages"):
        _pools(n_pages=3)                                 # < blocks per sequence
    with pytest.raises(ValueError, match="page_size"):
        _pools(page_size=0)
    contig = CachePool(_params()[3], cfg, NEAREST, n_slots=3, max_len=32)
    full = _pools()[1]                                    # byte parity + the null row
    per_row = full.nbytes() / full.n_rows
    assert abs(full.nbytes() - contig.nbytes()) <= per_row
