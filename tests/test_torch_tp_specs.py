"""The model axis's partition rules against the reference's, in process.

``param_specs`` (tensor parallelism alone and with FSDP over ``data``),
``cache_specs`` (contiguous and paged pools) and ``serve_input_specs`` on
(1, 2), (2, 2) and (4, 2) ``(data, model)`` meshes equal the reference's
for every config of the registry, reduced. The reference's functions read
only ``mesh.axis_names`` and ``mesh.shape``, so a stand-in mesh serves.
Then what the model axis serves and still refuses (ROADMAP A12),
the training transport on it (A11; FSDP beside it is A13), the f32 plain
version of ``qmatmul`` and the vocab-parallel collectives' local
arithmetic.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qarith import QArith as JQArith
from repro.core import get_policy as j_get_policy
from repro.dist import partition as JPT
from repro.models import registry as JR
from repro_torch.core.policy import get_policy
from repro_torch.dist import axes
from repro_torch.dist import fsdp as F
from repro_torch.dist import partition as PT
from repro_torch.dist import transport as T
from repro_torch.kernels.qmatmul import plan, qmatmul, qmatmul_f32, qmatmul_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry as R
from repro_torch.serve.engine import Engine
from repro_torch.serve.paged import PagedCachePool

from _torch_cpu import one_torch_thread  # noqa: F401

MESHES = [(1, 2), (2, 2), (4, 2)]
DECODERS = [a for a in R.ARCH_IDS if a != "whisper-base"]


def _meshes(sizes):
    axes_ = ("data", "model")
    return SimpleNamespace(axis_names=axes_, shape=dict(zip(axes_, sizes))), Mesh(axes_, sizes)


def _flat(tree):
    """Spec leaves in the reference's leaf order (dicts by sorted key,
    tuples in order, a spec a leaf)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _flat(tree[k])]
    if isinstance(tree, tuple) and not isinstance(tree, PT.P):
        return [s for t in tree for s in _flat(t)]
    return [tree]


def _jflat(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def _norm(spec) -> tuple:
    """A spec's entries with a one-axis tuple as that axis: jax 0.9 writes
    ``("data",)`` as ``'data'`` (ROADMAP C3)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _same(got, want):
    got, want = _flat(got), _jflat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _norm(g) == _norm(w), (g, w)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("arch", R.ARCH_IDS)
def test_param_specs_match_reference(arch, sizes, fsdp):
    jmesh, tmesh = _meshes(sizes)
    jcfg = JR.get_config(arch).reduced()
    jparams = jax.eval_shape(lambda: JR.init(jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    tcfg = R.get_config(arch).reduced()
    tparams = R.init(tcfg, 0, torch.bfloat16, device="cpu")
    want = JPT.param_specs(jparams, jcfg, jmesh, JPT.default_placement(jmesh, fsdp=fsdp))
    got = PT.param_specs(tparams, tcfg, tmesh, PT.default_placement(tmesh, fsdp=fsdp))
    _same(got, want)
    # the rules read shapes, so the reference's own tree gives the same specs
    _same(PT.param_specs(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.int8), jparams),
                         tcfg, tmesh, PT.default_placement(tmesh, fsdp=fsdp)), want)
    assert any("model" in s.axes for s in _flat(got))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("sizes", MESHES)
@pytest.mark.parametrize("arch", DECODERS)
def test_cache_specs_match_reference(arch, sizes, paged):
    jmesh, tmesh = _meshes(sizes)
    jcfg = JR.get_config(arch).reduced()
    tcfg = R.get_config(arch).reduced()
    kw = dict(page_size=4, n_rows=8) if paged else {}
    jparams = jax.eval_shape(lambda: JR.init(jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    jcache = jax.eval_shape(lambda: JR.make_cache(JQArith(j_get_policy("bf16_standard")),
                                                  jparams, jcfg, {}, batch_size=4,
                                                  max_len=16, dtype=jnp.bfloat16, **kw))
    tparams = R.init(tcfg, 0, torch.bfloat16, device="cpu")
    tcache = R.make_cache(tparams, tcfg, batch_size=4, max_len=16, dtype=torch.bfloat16, **kw)
    _same(PT.cache_specs(tcache, tcfg, tmesh), JPT.cache_specs(jcache, jcfg, jmesh))


@pytest.mark.parametrize("sizes", MESHES + [(3, 2)])
def test_serve_input_specs_match_reference(sizes):
    jmesh, tmesh = _meshes(sizes)
    for n_slots in (4, 6, 8):
        for paged, n_rows, chunk in ((False, None, 1), (True, 24, 1), (True, 25, 4),
                                     (False, None, 8)):
            want = JPT.serve_input_specs(n_slots, jmesh, paged=paged, n_rows=n_rows,
                                         chunk=chunk)
            got = PT.serve_input_specs(n_slots, tmesh, paged=paged, n_rows=n_rows, chunk=chunk)
            assert got.keys() == want.keys()
            assert all(_norm(got[k]) == _norm(want[k]) for k in got), (n_slots, paged, chunk)


def _standin(sizes) -> Mesh:
    """A (data, model) mesh of this one process with a stand-in model
    group: enough to build an engine and its cache (no collective runs)."""
    ranks = tuple(range(sizes[1]))
    return Mesh(("data", "model"), sizes, groups={("model",): {ranks: object()}})


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-base"])
def test_other_families_refuse_the_model_axis(arch):
    """RG-LRU and the encoder-decoder on a model axis (A12 item 1b, ported):
    ``serve_refusal`` passes them on 1 x 2 and 2 x 1; on 1 x 2 rank 0's
    cache holds its share (recurrentgemma: the one kv head its query heads
    read, half of the RG-LRU channels) and its engine builds;
    whisper's cache needs its source (``batch=``), not a refusal."""
    cfg = R.get_config(arch).reduced()
    mesh = _standin((1, 2))
    assert PT.serve_refusal(cfg, mesh) is None
    assert PT.serve_refusal(cfg, Mesh(("data", "model"), (2, 1))) is None
    params = R.init(cfg, 0, torch.bfloat16, device="cpu")
    local = F.shard_state(params, PT.param_specs(params, cfg, mesh), mesh)
    if cfg.encdec:
        with pytest.raises(ValueError, match="pass batch="):
            R.make_cache(local, cfg, batch_size=2, max_len=8, mesh=mesh)
        return
    cache = R.make_cache(local, cfg, batch_size=2, max_len=8, mesh=mesh)
    rec, attn = cache["layers"]["b0"], cache["layers"]["b2"]
    assert rec["h"].shape[-1] == cfg.lru_width // 2 and rec["conv"].shape[-1] == cfg.lru_width // 2
    assert attn[0].shape[-2] == 1 == cfg.n_kv_heads
    eng = Engine(local, cfg, get_policy("bf16_standard"), n_slots=2, max_len=8, device="cpu",
                 mesh=mesh)
    assert eng.pool.cache["layers"]["b0"]["h"].shape == rec["h"].shape


def test_uneven_heads_and_paged_data_axes_serve():
    """Head counts the axis does not divide are served (A12 item 2:
    qwen2.5-3b's 2 kv heads and recurrentgemma-2b's 10 query heads on
    1 x 4, each rank's cache holding the kv heads its query heads read),
    and so is a paged pool under a data axis above 1 (item 3: the engine
    builds, its pool holding this rank's page rows); a channel width the
    axis does not divide is still refused, naming A12."""
    cfg = R.get_config("qwen2.5-3b").reduced()
    assert cfg.n_heads % 4 == 0 and cfg.n_kv_heads % 4
    odd = _standin((1, 4))
    for arch in ("qwen2.5-3b", "recurrentgemma-2b"):
        assert PT.serve_refusal(R.get_config(arch), odd) is None
    params = R.init(cfg, 0, torch.bfloat16, device="cpu")
    local = F.shard_state(params, PT.param_specs(params, cfg, odd), odd)
    cache = R.make_cache(local, cfg, batch_size=2, max_len=8, mesh=odd)
    assert cache["layers"]["b0"][0].shape[-2] == 1
    narrow = dataclasses.replace(cfg, d_ff=258)
    assert "A12" in PT.serve_refusal(narrow, odd) and "d_ff" in PT.serve_refusal(narrow, odd)
    # a paged pool under a data axis above 1: the engine on 2 x 1, its pool
    # on 2 x 2 (a model axis needs the ranks' process group: the engine on
    # 2 x 2 runs in tests/test_torch_dp_paged.py)
    for sizes in ((2, 1), (2, 2)):
        mesh = Mesh(("data", "model"), sizes)
        assert PT.serve_refusal(cfg, mesh) is None
        local = F.shard_state(params, PT.param_specs(params, cfg, mesh), mesh)
        kw = dict(n_slots=4, max_len=8, page_size=4, mesh=mesh)
        if sizes[1] == 1:
            eng = Engine(local, cfg, get_policy("bf16_standard"), device="cpu", paged=True, **kw)
            pool = eng.pool
            assert eng.pages is pool.exchange and eng.pages.lanes == [(0, 2), (2, 4)]
        else:
            pool = PagedCachePool(local, cfg, get_policy("bf16_standard"), **kw)
        assert pool.n_rows == 10 and pool.rows == (0, 5) and pool.slots == (0, 2)
        assert pool.cache["layers"]["b0"]["k_pages"].shape[1] == 5
        assert pool.cache["layers"]["b0"]["k_pages"].shape[-2] == cfg.n_kv_heads // sizes[1]
    assert PT.serve_refusal(cfg, Mesh(("data", "model"), (1, 2))) is None


def test_training_transport_on_the_model_axis():
    """A11: on a 2 x 2 mesh the gradient transport reduces over the data
    axis only (the step's mean; the bf16 wire on ``data``), a wire on the
    model axis is refused, FSDP beside the model axis is A13, and the
    train launcher takes ``--model-parallel``."""
    from repro_torch.launch import train as launch_train
    mesh = Mesh(("data", "model"), (2, 2))
    tr = T.make_transport(mesh=mesh)
    assert type(tr).__name__ == "Fp32Psum" and tr.wire_axis is None
    assert tr.hint_axes(mesh) == (("data",), 2)
    wire = T.make_transport(mesh=mesh, placement=PT.Placement(), wire="bf16")
    assert (wire.wire_axis, wire.wire_replicas, wire.hint_axes(mesh)) == ("data", 2, ((), 1))
    with pytest.raises(ValueError, match="already claimed"):
        T.make_transport(mesh=mesh, wire="bf16", wire_axis="model")
    with pytest.raises(ValueError, match="A13"):
        T.make_transport(mesh=Mesh(("data", "fsdp", "model"), (1, 2, 2)),
                         placement=PT.Placement(fsdp_axis="fsdp"), pspecs={})
    assert launch_train.parse_args(["--reduced", "--device", "cpu",
                                    "--model-parallel", "2"]).model_parallel == 2


def test_serve_launcher_model_flags_need_processes():
    """``--data-parallel --model-parallel`` build a mesh of processes: one
    process cannot hold a 1 x 2 mesh."""
    with pytest.raises(ValueError, match="needs 2 processes"):
        launch_serve.main(["--reduced", "--device", "cpu", "--data-parallel", "1",
                           "--model-parallel", "2", "--requests", "1"])


@pytest.mark.parametrize("shape", [(1, 64, 48), (8, 96, 40), (33, 128, 24), (5, 7, 9)])
def test_qmatmul_f32_plain_version_rounds_to_qmatmul(shape):
    """The f32 entry's plain version, rounded to bf16, is ``qmatmul_ref``
    (and ``qmatmul``'s CPU path) bit for bit; the path plan is the
    nearest entry's."""
    M, K, N = shape
    rng = np.random.default_rng(M * K + N)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(torch.bfloat16)
    y = torch.from_numpy(rng.standard_normal((K, N), np.float32)).to(torch.bfloat16)
    f32 = qmatmul_f32(x, y)
    assert f32.dtype == torch.float32 and f32.shape == (M, N)
    assert torch.equal(f32, qmatmul_ref(x, y, out_dtype=torch.float32))
    assert torch.equal(f32.to(torch.bfloat16), qmatmul_ref(x, y))
    assert torch.equal(f32.to(torch.bfloat16), qmatmul(x, y))
    assert plan(x, y).path == ("wgmma" if K % 8 == 0 and N % 8 == 0 else "mma.sync")
    with pytest.raises(ValueError, match="no rounding bits"):
        qmatmul_ref(x, y, bits=torch.zeros((M, N), dtype=torch.int32),
                    out_dtype=torch.float32)


def test_local_bias_slice_and_no_axis_outside_the_context():
    b = torch.arange(8.0)
    assert axes.current() is None and axes.local_slice(b, 8) is b
    with pytest.raises(ValueError, match="does not split"):
        axes.local_slice(b, 4)
    with axes.model_axis(axes.ModelAxis(2, 1, None)):
        assert torch.equal(axes.local_slice(b, 4), b[4:])
    assert axes.current() is None
    with axes.model_axis(axes.ModelAxis(1, 0, None)):
        assert axes.current() is None          # one rank: one process's arithmetic
