"""The port's gradient wire ≡ the reference's, on the CPU.

* ``compress_leaf`` — every wire format (bf16, bf14, bf12, bf10, fp16,
  e5m2, e4m3, fp32) — given the reference's own draws for a key (its u32
  bits, its uniforms, or both from the split key of the small-exponent
  grids) returns the reference's carrier payload and residual bit for bit,
  on inputs with a residual, subnormals, huge values and zeros.
* The residuals telescope: over 40 steps Σ q + r_T = Σ g + r_0 to f32
  rounding; the fp8 formats clamp at ``max_finite`` (no ±inf on the wire,
  the overflow kept in the residual); the fp32 passthrough's residual is 0.
* ``WirePolicy`` (every spec form) and ``CompressedWire.leaf_formats`` equal
  the reference's, leaf for leaf, on every family's reduced tree and the
  DLRM's; ``payload_bytes`` and ``wire_format`` too.
* ``make_transport``: the strategy, wire axis and replica count it picks
  for every (mesh, wire) of the reference's table, and its refusals, equal
  the reference's (which reads only a mesh's axis names and sizes).
"""
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.dist import partition as JPT
from repro.dist import transport as JT
from repro.models import registry as JR
from repro.models.dlrm import DLRM_KAGGLE_SMALL as J_DLRM_CFG
from repro.models.dlrm import dlrm_init as j_dlrm_init
from repro.optim import grad_compress as JGC
from repro_torch.core import formats as TF
from repro_torch.dist import partition as PT
from repro_torch.dist import transport as T
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry as R
from repro_torch.core import jrandom
from repro_torch.models.dlrm import DLRM_KAGGLE_SMALL, dlrm_init
from repro_torch.optim import GivenKey
from repro_torch.optim import grad_compress as GC

from _torch_cpu import one_torch_thread, to_torch  # noqa: F401

FORMATS = ["bf16", "bf14", "bf12", "bf10", "fp16", "e5m2", "e4m3", "fp32"]
N = 4099


def _inputs(fname, seed=0):
    """A gradient (bf16, as the step hands it) and an f32 residual at the
    format's scale, with zeros, subnormals and values past max_finite."""
    fmt = TF.FORMATS[fname]
    rng = np.random.default_rng(seed)
    scale = 1.0 if fmt.is_f32_exponent else fmt.max_finite / 64
    g = (rng.standard_normal(N) * scale).astype(np.float32)
    g[:6] = [0.0, -0.0, 1e-39, -3e-8, 3.0e38, -3.0e38]
    if not fmt.is_f32_exponent:
        g[6:10] = [fmt.max_finite * 3, -fmt.max_finite * 1.5, fmt.sub_spacing / 3,
                   fmt.max_finite]
    r = (rng.standard_normal(N) * scale * 2.0**-8).astype(np.float32)
    g_bf16 = np.asarray(jnp.asarray(g).astype(jnp.bfloat16))
    return g_bf16, r


def _reference_noise(fname, key, n):
    """What the reference's rounding draws from ``key`` for ``fname``, as
    a ``GivenKey`` leaf: bits (e8 grids), uniforms (fp16), or bits and
    uniforms from the split key (e5m2/e4m3)."""
    fmt = TF.FORMATS[fname]
    bits = u = None
    if fname == "fp16":
        u = jax.random.uniform(key, (n,), jnp.float32)
    elif fmt.is_f32_exponent:
        bits = jax.random.bits(key, (n,), jnp.uint32)
    else:
        k_bits, k_u = jax.random.split(key)
        bits = jax.random.bits(k_bits, (n,), jnp.uint32)
        u = jax.random.uniform(k_u, (n,), jnp.float32)
    conv = (lambda a: None if a is None else to_torch(np.asarray(a)))
    return GivenKey([conv(bits)], [conv(u)]).leaf(0)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.contiguous()
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _ref_bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("fname", FORMATS)
def test_compress_leaf_matches_reference(fname):
    g, r = _inputs(fname)
    key = jax.random.PRNGKey(11)
    want_q, want_r = JGC.compress_leaf(jnp.asarray(g), jnp.asarray(r), key,
                                       JF.FORMATS[fname])
    q, nr = GC.compress_leaf(to_torch(g), to_torch(r), _reference_noise(fname, key, N),
                             TF.FORMATS[fname])
    assert q.dtype == {"bfloat16": torch.bfloat16, "float16": torch.float16,
                       "float32": torch.float32}[np.asarray(want_q).dtype.name]
    assert q.dtype == TF.wire_carrier_dtype(TF.FORMATS[fname])
    np.testing.assert_array_equal(_bits(q), _ref_bits(want_q), err_msg=f"{fname} payload")
    np.testing.assert_array_equal(_bits(nr), _ref_bits(want_r), err_msg=f"{fname} residual")


@pytest.mark.parametrize("fname", ["bf16", "bf12", "e4m3"])
def test_residuals_telescope(fname):
    """q_t + r_t = g_t + r_{t-1} per step, so over T steps the payloads
    carry every gradient but the last residual: Σ q + r_T = Σ g + r_0, to
    the f32 rounding of the per-step sums."""
    fmt = TF.FORMATS[fname]
    rng = np.random.default_rng(3)
    r0 = torch.zeros(N)
    r, sum_q, sum_g = r0, np.zeros(N), np.zeros(N)
    for t in range(40):
        g = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
        q, r = GC.compress_leaf(g, r, GC.WireKey(0, t).leaf(0), fmt)
        assert torch.isfinite(q).all()
        sum_q += q.double().numpy()
        sum_g += g.double().numpy()
    lhs, rhs = sum_q + r.double().numpy(), sum_g + r0.double().numpy()
    tol = 40 * 2.0**-23 * (np.abs(sum_g).max() + 8)
    assert np.abs(lhs - rhs).max() <= tol
    # the residual stays below one step of the format's grid
    assert float(r.abs().max()) <= float(TF.ulp(torch.tensor(8.0), fmt))


@pytest.mark.parametrize("fname", ["e5m2", "e4m3"])
def test_fp8_wire_clamps_at_max_finite(fname):
    fmt = TF.FORMATS[fname]
    g = torch.tensor([fmt.max_finite * 10, -fmt.max_finite * 10, float("inf"), 1.0])
    q, r = GC.compress_leaf(g, torch.zeros(4), GC.WireKey(1, 0).leaf(0), fmt)
    assert torch.isfinite(q[:2]).all()
    assert q[0] == fmt.max_finite and q[1] == -fmt.max_finite
    assert q[2] == fmt.max_finite        # inf saturates too (its residual is inf)
    # the overflow stays in the residual, to be sent on later steps
    assert float(r[0]) == pytest.approx(fmt.max_finite * 9)


def test_fp32_passthrough_has_a_zero_residual():
    g = torch.randn(64).to(torch.bfloat16)
    r = torch.randn(64)
    q, nr = GC.compress_leaf(g, r, None, TF.FP32)
    assert q.dtype == torch.float32 and torch.equal(q, g.float() + r)
    assert torch.equal(nr, torch.zeros(64))


# ---------------------------------------------------------------------------
# the keep policy, leaf formats and payload bytes, every family's tree
# ---------------------------------------------------------------------------

def _ref_shapes(cfg):
    return jax.eval_shape(lambda: JR.init(cfg, jax.random.PRNGKey(0), jnp.float32))


POLICY_SPECS = [None, "default", "none", "4096,embed,norm", "mixer,ffn"]


@pytest.mark.parametrize("arch", R.ARCH_IDS + ("dlrm",))
def test_leaf_formats_match_reference(arch):
    if arch == "dlrm":
        jtree = jax.eval_shape(lambda: j_dlrm_init(jax.random.PRNGKey(0), J_DLRM_CFG))
        ttree = dlrm_init(jrandom.PRNGKey(0), DLRM_KAGGLE_SMALL, device="cpu")
    else:
        jtree = _ref_shapes(JR.get_config(arch).reduced())
        ttree = R.init(R.get_config(arch).reduced(), 0, torch.float32, device="cpu")
    for spec in POLICY_SPECS:
        for wire in ("bf16", "bf12", "e4m3"):
            jp = JT.WirePolicy.parse(spec) if spec is not None else None
            tp = T.WirePolicy.parse(spec) if spec is not None else None
            assert (jp is None and tp is None) or \
                (jp.keep_below, jp.keep_patterns, jp.describe()) == \
                (tp.keep_below, tp.keep_patterns, tp.describe())
            jw = JT.make_transport(wire=wire, wire_policy=jp)
            tw = T.make_transport(wire=wire, wire_policy=tp)
            assert [f.name for f in jw.leaf_formats(jtree)] == \
                [f.name for f in tw.leaf_formats(ttree)], (arch, spec, wire)
            assert jw.payload_bytes(jtree) == tw.payload_bytes(ttree)
            assert jw.wire_format == tw.wire_format


def test_leaf_names_are_the_reference_keystr():
    jtree = jax.eval_shape(lambda: j_dlrm_init(jax.random.PRNGKey(0), J_DLRM_CFG))
    flat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    ttree = dlrm_init(jrandom.PRNGKey(0), DLRM_KAGGLE_SMALL, device="cpu")
    assert T.leaf_names(ttree) == [jax.tree_util.keystr(p) for p, _ in flat]


# ---------------------------------------------------------------------------
# make_transport: selection and refusals
# ---------------------------------------------------------------------------

MESHES = {
    "none": None,
    "data2": (("data", "model"), (2, 1)),
    "pod2": (("pod", "data", "model"), (2, 1, 1)),
    "pod4": (("pod", "data", "model"), (4, 1, 1)),
    "single": (("data", "model"), (1, 1)),
}


def _meshes(name):
    """The reference reads a mesh's ``axis_names`` and ``shape`` only."""
    if MESHES[name] is None:
        return None, None
    axes, sizes = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes))), Mesh(axes, sizes)


def _describe(tr):
    return (type(tr).__name__, tr.wire_axis, tr.wire_replicas,
            getattr(tr, "wire_format", None))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("wire", ["fp32", "compressed", "bf16", "bf12", "e4m3"])
@pytest.mark.parametrize("wire_axis", [None, "data", "pod"])
def test_make_transport_selection_matches_reference(mesh, wire, wire_axis):
    jmesh, tmesh = _meshes(mesh)
    jpl = JPT.Placement() if jmesh is not None else None
    tpl = PT.Placement() if tmesh is not None else None
    want = JT.make_transport(mesh=jmesh, placement=jpl, wire=wire, wire_axis=wire_axis)
    got = T.make_transport(mesh=tmesh, placement=tpl, wire=wire, wire_axis=wire_axis)
    assert _describe(got) == _describe(want)
    if tmesh is not None:
        assert got.hint_axes(tmesh) == want.hint_axes(jmesh)


def test_make_transport_refusals_match_reference():
    for kw in (dict(wire="fp8"), dict(wire="fp64")):
        with pytest.raises(ValueError, match="unknown gradient wire") as want:
            JT.make_transport(**kw)
        with pytest.raises(ValueError, match="unknown gradient wire") as got:
            T.make_transport(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="Fp32Psum"):
        JT.CompressedWire(fmt=JF.FP32)
    with pytest.raises(ValueError, match="Fp32Psum"):
        T.CompressedWire(fmt=TF.FP32)
    # FSDP (ported with A9): the placement sizes its axis as the reference's
    # does, ReduceScatter takes its specs, and an FSDP placement without
    # specs leaves the plain inner under the wire in both packages
    smesh = SimpleNamespace(axis_names=("data", "fsdp", "model"),
                            shape={"data": 1, "fsdp": 2, "model": 1})
    assert PT.Placement(fsdp_axis="fsdp").fsdp_size(smesh) == \
        JPT.Placement(fsdp_axis="fsdp").fsdp_size(smesh) == 2
    assert T.ReduceScatter({}, PT.Placement(fsdp_axis="fsdp")).scatter_axis == "fsdp"
    pl = SimpleNamespace(fsdp_axis="data", tp_axis="model")
    want = JT.make_transport(placement=pl, wire="bf16")
    got = T.make_transport(placement=pl, wire="bf16")
    assert (type(got).__name__, type(got.inner).__name__) == \
        (type(want).__name__, type(want.inner).__name__) == ("CompressedWire", "Fp32Psum")
    # on a model axis (A11) the wire rides the data axis, never the model's
    tp = Mesh(("data", "model"), (1, 2))
    assert PT.Placement().tp_size(tp) == 2
    on_tp = T.make_transport(mesh=tp, wire="bf16")
    assert (type(on_tp).__name__, on_tp.wire_axis, on_tp.wire_replicas) == \
        ("CompressedWire", None, 1)
    with pytest.raises(ValueError, match="already claimed"):
        T.make_transport(mesh=tp, wire="bf16", wire_axis="model")
    # a compressed wire needs its residuals, in both packages
    with pytest.raises(ValueError, match="error-feedback residuals"):
        T.make_transport(wire="bf16").reduce({"w": torch.zeros(2)}, None, GC.WireKey(0, 0))


def test_payload_ratio_of_the_sweep():
    """bf12's accounted payload is 32/12 of fp32's (the sweep's bar 2.6)."""
    tree = {"w": torch.zeros(3, 1024)}
    fp32 = 4 * 3 * 1024
    assert fp32 / T.make_transport(wire="bf12").payload_bytes(tree) == pytest.approx(32 / 12)
    assert math.isclose(fp32 / T.make_transport(wire="bf16").payload_bytes(tree), 2.0)


# ---------------------------------------------------------------------------
# the batch rows of a rank
# ---------------------------------------------------------------------------

def _norm(spec):
    """A spec's entries with 1-tuples as names (jax 0.9 normalizes them so:
    ROADMAP C3)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@pytest.mark.parametrize("mesh", ["data2", "pod2", "pod4", "single"])
def test_batch_specs_match_reference(mesh):
    jmesh, tmesh = _meshes(mesh)
    batch = {"tokens": np.zeros((8, 5), np.int32), "labels": np.zeros((8, 5), np.int32),
             "mrope_positions": np.zeros((3, 8, 5), np.int32),
             "odd": np.zeros((6, 5), np.int32)}
    want = JPT.batch_specs({k: jnp.asarray(v) for k, v in batch.items()}, jmesh)
    got = PT.batch_specs({k: torch.from_numpy(v) for k, v in batch.items()}, tmesh)
    for k in batch:
        assert _norm(got[k]) == _norm(tuple(want[k])), k
    assert PT.dp_size(tmesh) == JPT.dp_size(jmesh)
    assert PT.dp_axes(tmesh) == JPT.dp_axes(jmesh)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_rank_rows_are_the_reference_replica_chunks(k, n):
    """Replica r's rows: of each of k microbatches (split first), chunk r of
    n (the reference's ``_split_microbatches`` twice, train/step.py:142
    and :167); ``mrope_positions`` on its dim 1."""
    B = 16
    tokens = np.arange(B * 3).reshape(B, 3)
    pos = np.arange(3 * B * 3).reshape(3, B, 3)
    mesh = Mesh(("pod", "data", "model"), (n, 1, 1))
    for r in range(n):
        got = PT.rank_rows({"tokens": torch.from_numpy(tokens),
                            "mrope_positions": torch.from_numpy(pos)}, mesh, r,
                           microbatches=k)
        want = tokens.reshape(k, n, B // (k * n), 3)[:, r].reshape(-1, 3)
        np.testing.assert_array_equal(got["tokens"].numpy(), want)
        want_pos = pos.reshape(3, k, n, B // (k * n), 3)[:, :, r].reshape(3, -1, 3)
        np.testing.assert_array_equal(got["mrope_positions"].numpy(), want_pos)
    with pytest.raises(ValueError, match="not divisible"):
        PT.rank_rows({"tokens": torch.zeros(6, 2)}, mesh, 0, microbatches=4)
