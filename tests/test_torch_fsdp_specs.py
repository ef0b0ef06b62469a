"""FSDP's placement rules, shard geometry and the mesh's groups against the
reference, in this process (the partition rules read a mesh's axis names
and sizes only, so a stand-in mesh serves both packages, as
``tests/test_fsdp.py`` does).

* ``param_specs`` under an FSDP placement equals the reference's, leaf for
  leaf, for every architecture of the registry (reduced) at fsdp 2 and 4;
  ``state_shardings`` equals it for AdamW and SGD with Kahan buffers.
* ``make_transport`` with an FSDP placement builds the reference's
  strategies (``ReduceScatter``, ``_Fp32Wire``, ``CompressedWire`` over a
  ``ReduceScatter``) on the same wire axes, refuses a wire on the FSDP
  axis, and its ``hint_axes`` leave out the reduce-scattered axis.
* A shard's Philox bits (``philox_bits(full_shape=, dim=, start=)``, what
  ``ShardKey`` draws) are the whole leaf's at the shard's positions.
* ``local_slice``/``full_shape``/``shard_state``, ``rank_index`` (the wire's
  chunk outermost, then the data axes in mesh order) and the ranks of each
  mesh group.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_policy as j_get_policy
from repro.dist import partition as JPT
from repro.dist import transport as JT
from repro.models import registry as JR
from repro.optim import adamw as j_adamw
from repro.optim import sgd as j_sgd
from repro_torch.core.policy import get_policy
from repro_torch.dist import fsdp as F
from repro_torch.dist import partition as PT
from repro_torch.dist import transport as T
from repro_torch.kernels.philox import philox_bits
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry as R
from repro_torch.optim import adamw, sgd
from repro_torch.optim.base import ShardKey, StepKey
from repro_torch.tree import tree_leaves

from _torch_cpu import one_torch_thread  # noqa: F401


def _meshes(axes, sizes):
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes))), Mesh(axes, sizes)


def _fsdp_meshes(fs: int):
    return _meshes(("data", "fsdp", "model"), (1, fs, 1))


def _specs_equal(got, want):
    """The port's spec tree against the reference's, leaf for leaf."""
    flat_w = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    flat_g = F.flat_specs(got)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert tuple(g) == tuple(w), (g, w)


@pytest.mark.parametrize("fs", [2, 4])
@pytest.mark.parametrize("arch", R.ARCH_IDS)
def test_param_specs_match_reference(arch, fs):
    jmesh, tmesh = _fsdp_meshes(fs)
    jcfg = JR.get_config(arch).reduced()
    jparams = jax.eval_shape(lambda: JR.init(jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    tcfg = R.get_config(arch).reduced()
    tparams = R.init(tcfg, 0, torch.bfloat16, device="cpu")
    want = JPT.param_specs(jparams, jcfg, jmesh, JPT.default_placement(jmesh, fsdp=True))
    got = PT.param_specs(tparams, tcfg, tmesh, PT.default_placement(tmesh, fsdp=True))
    _specs_equal(got, want)
    # something is sharded, and a shard is the leaf's 1/fs along its dim
    sharded = [(w, s) for w, s in zip(tree_leaves(tparams), tree_leaves(got))
               if F.sharded_dims(s)]
    assert sharded
    for w, s in sharded[:3]:
        part = F.local_slice(w, s, tmesh)
        assert part.numel() * fs == w.numel()
        assert F.full_shape(part.shape, s, tmesh) == tuple(w.shape)


@pytest.mark.parametrize("fs", [2, 4])
@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_state_shardings_match_reference(kind, fs):
    jmesh, tmesh = _fsdp_meshes(fs)
    jcfg = JR.get_config("qwen2.5-3b").reduced()
    jpol, tpol = j_get_policy("bf16_sr_kahan"), get_policy("bf16_sr_kahan")
    jparams = JR.init(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tparams = R.init(R.get_config("qwen2.5-3b").reduced(), 0, torch.bfloat16, device="cpu")
    jopt = (j_adamw(jpol, b2=0.997) if kind == "adamw" else j_sgd(jpol))
    topt = (adamw(tpol, b2=0.997) if kind == "adamw" else sgd(tpol))
    jp = JPT.param_specs(jparams, jcfg, jmesh, JPT.default_placement(jmesh, fsdp=True))
    tp = PT.param_specs(tparams, None, tmesh, PT.default_placement(tmesh, fsdp=True))
    want = JPT.state_shardings(jp, jopt.init(jparams), jmesh)
    got = PT.state_shardings(tp, topt.init(tparams), tmesh)
    _specs_equal(got, want)
    assert got.kahan_c is not None


def test_default_placement_and_refusals():
    for axes, sizes, axis in ((("data", "fsdp", "model"), (1, 2, 1), "fsdp"),
                              (("data", "model"), (2, 1), "data")):
        jmesh, tmesh = _meshes(axes, sizes)
        assert PT.default_placement(tmesh, fsdp=True).fsdp_axis == axis == \
            JPT.default_placement(jmesh, fsdp=True).fsdp_axis
        assert PT.default_placement(tmesh).fsdp_axis is None
    # the model axis counts in the specs (serving and training, A11); FSDP
    # beside it is refused (A13)
    tp = Mesh(("data", "model"), (1, 2))
    assert PT.Placement().tp_size(tp) == JPT.Placement().tp_size(tp) == 2
    assert type(T.make_transport(mesh=tp)).__name__ == "Fp32Psum"
    with pytest.raises(ValueError, match="A13"):
        T.make_transport(mesh=Mesh(("data", "model"), (2, 2)),
                         placement=PT.default_placement(tp, fsdp=True), pspecs={})


TRANSPORT_CASES = [
    # (mesh axes, sizes, wire)
    (("data", "fsdp", "model"), (1, 2, 1), "fp32"),
    (("data", "fsdp", "model"), (2, 2, 1), "fp32"),
    (("data", "fsdp", "model"), (2, 2, 1), "bf16"),
    (("pod", "data", "fsdp", "model"), (2, 1, 2, 1), "fp32"),
    (("pod", "data", "fsdp", "model"), (2, 1, 2, 1), "compressed"),
]


@pytest.mark.parametrize("axes,sizes,wire", TRANSPORT_CASES)
def test_make_transport_fsdp_matches_reference(axes, sizes, wire):
    jmesh, tmesh = _meshes(axes, sizes)
    jpl, tpl = JPT.Placement(fsdp_axis="fsdp"), PT.Placement(fsdp_axis="fsdp")
    params = {"w": torch.zeros(4, 6)}
    jps = JPT.param_specs({"w": jnp.zeros((4, 6))}, None, jmesh, jpl)
    tps = PT.param_specs(params, None, tmesh, tpl)
    want = JT.make_transport(mesh=jmesh, placement=jpl, pspecs=jps, wire=wire)
    got = T.make_transport(mesh=tmesh, placement=tpl, pspecs=tps, wire=wire)
    describe = lambda tr: (type(tr).__name__, tr.wire_axis, tr.wire_replicas,  # noqa: E731
                           type(getattr(tr, "inner", None)).__name__)
    assert describe(got) == describe(want)
    assert got.scatter_axis == "fsdp"
    # each data-parallel axis reduced once: not the wire's, not the scatter's
    axes_w = want.hint_axes(jmesh)[0]
    assert got.hint_axes(tmesh)[0] == tuple(a for a in axes_w if a != "fsdp")


def test_wire_on_the_fsdp_axis_is_refused():
    jmesh, tmesh = _meshes(("data", "model"), (2, 1))
    jpl, tpl = JPT.Placement(fsdp_axis="data"), PT.Placement(fsdp_axis="data")
    jps = JPT.param_specs({"w": jnp.zeros((4, 6))}, None, jmesh, jpl)
    tps = PT.param_specs({"w": torch.zeros(4, 6)}, None, tmesh, tpl)
    with pytest.raises(ValueError, match="already claimed") as want:
        JT.make_transport(mesh=jmesh, placement=jpl, pspecs=jps, wire="bf16")
    with pytest.raises(ValueError, match="already claimed") as got:
        T.make_transport(mesh=tmesh, placement=tpl, pspecs=tps, wire="bf16")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape,dim,parts", [((6, 8), 0, 2), ((6, 8), 1, 4),
                                            ((2, 12, 5), 1, 3), ((3, 4, 7, 2), 2, 7)])
def test_shard_bits_are_the_leaf_streams(shape, dim, parts):
    full = philox_bits(99, shape, "cpu")
    ext = shape[dim] // parts
    for p in range(parts):
        sh = list(shape)
        sh[dim] = ext
        got = philox_bits(99, sh, "cpu", full_shape=shape, dim=dim, start=p * ext)
        assert torch.equal(got, full.narrow(dim, p * ext, ext))
    # ShardKey: a seeded leaf's shard draws those words; a given leaf keeps its bits
    key = ShardKey(StepKey(3, 1), [(shape, dim, ext), None])
    sh = list(shape)
    sh[dim] = ext
    assert torch.equal(key.leaf(0).bits(sh, "cpu"),
                       StepKey(3, 1).leaf(0).bits(shape, "cpu").narrow(dim, ext, ext))
    assert key.leaf(1).seed == StepKey(3, 1).leaf(1).seed
    with pytest.raises(ValueError, match="does not lie"):
        philox_bits(99, sh, "cpu", full_shape=shape, dim=dim, start=shape[dim])


def test_shard_state_and_rank_geometry():
    mesh = Mesh(("pod", "data", "fsdp", "model"), (2, 2, 2, 1))
    # rank-major in axis order, as jax.make_mesh lays devices out
    assert mesh.coords(5) == {"pod": 1, "data": 0, "fsdp": 1, "model": 0}
    assert mesh.ranks_along("fsdp", rank=5) == [4, 5]
    assert mesh.ranks_along("data", rank=5) == [5, 7]
    assert mesh.ranks_along("pod", rank=5) == [1, 5]
    assert mesh.ranks_along(("pod", "data", "fsdp"), rank=5) == list(range(8))
    # the wire's chunk outermost, then the other data axes in mesh order
    assert [PT.rank_index(mesh, "pod", rank=r) for r in range(8)] == list(range(8))
    assert [PT.rank_index(mesh, "data", rank=r) for r in range(8)] == [
        0, 1, 4, 5, 2, 3, 6, 7]
    # process 0 of the mesh keeps the first shard; the step stays whole
    tree = {"a": torch.arange(24.).reshape(4, 6), "b": torch.ones(3), "n": 7}
    specs = {"a": PT.P(None, "fsdp"), "b": PT.P(), "n": PT.P()}
    got = F.shard_state(tree, specs, mesh)
    assert torch.equal(got["a"], tree["a"][:, :3]) and got["a"].is_contiguous()
    assert got["a"].untyped_storage().data_ptr() != tree["a"].untyped_storage().data_ptr()
    assert got["b"] is tree["b"] and got["n"] == 7
    np.testing.assert_array_equal(F.local_slice(tree["a"].numpy(), specs["a"], mesh),
                                  tree["a"][:, :3].numpy())
    assert F.unshard_spec(PT.P(None, "fsdp"), PT.Placement(fsdp_axis="fsdp")) == PT.P(None,
                                                                                        None)
