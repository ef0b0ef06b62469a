"""The port's FSDP (``repro_torch.dist.fsdp``) against the reference's 1 data
× 2 fsdp mesh, and its own invariants, on the CPU (2 gloo ranks).

* The reference runs in a subprocess with 2 virtual CPU devices on an
  ``Auto`` mesh it builds itself (ROADMAP C4: its own meshes fail on jax
  0.9), through its ``make_transport`` (the ``ReduceScatter``),
  ``train_state_shardings`` and ``make_train_step`` with an optimizer that
  hands back the reduced gradients (``fp32``, PR 22's bars: its f32
  gradients agree with the port's to ~1e-6). Two port ranks restore its
  initial checkpoint into their shards and run the gradient phase: loss and
  gradient norm within ``LOSS_RTOL``, each rank's reduced gradient shard
  within ``GRAD_TOL`` of the leaf's largest |g| of the reference's slice;
  the reduce-scatter moved every gradient element once in f32, and the
  gather every parameter shard once (f32 under this policy).
* The reference's shard-local fused AdamW update (``fused_adamw_optimizer(
  mesh=, pspecs=)``, the Pallas kernel in interpret mode inside
  ``shard_map``) of a random ``bf16_sr_kahan`` state, and each shard's
  folded bits (``fold_in(key_i, shard index)`` for a sharded leaf, the
  leaf's own key for a replicated one): the port's shard-local update given
  those bits equals the reference's ``ref.py`` on every lane and the Pallas
  output but on its FMA-tie lanes (ROADMAP C8, at most ``FMA_TIE_FRAC``).
* The port's own invariants: 3 non-fused ``bf16_sr_kahan`` steps under
  FSDP-2 equal DP-2's bitwise on every gathered leaf (params, m, v, c) and
  loss; both ranks' copies of a replicated leaf are bitwise equal (also
  after fused shard-local steps, where sharded leaves fold their seeds);
  the gather bytes of a step are the same at ``grad_accum`` 1 and 4; FSDP-2
  holds at least 1.9× fewer state bytes per rank than DP-2 (the reference's
  bar is 1.7×).
* The runner's ``fsdp_memory`` section prints the reference's three rows
  with a ratio of at least 1.9.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(Path(__file__).resolve().parent / "_torch_fsdp_worker.py")
LOSS_RTOL = 2e-3
GRAD_TOL = 1e-2
FMA_TIE_FRAC = 5e-4
TIMEOUT = 240

REF_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec
    from repro.core import get_policy
    from repro.dist import partition as PT
    from repro.dist import fsdp as F
    from repro.dist import transport as T
    from repro.dist.axes import activation_sharding
    from repro.kernels import ref as JREF
    from repro.models import registry as R
    from repro.optim import adamw, constant, fused_adamw_optimizer
    from repro.optim.adamw import AdamWState
    from repro.optim.base import Optimizer
    from repro.train import checkpoint as C
    from repro.train.step import make_train_step
    from repro.train.train_state import make_train_state

    out = sys.argv[1]
    cfg = R.get_config("qwen2.5-3b").reduced()
    mesh = jax.make_mesh((1, 2, 1), ("data", "fsdp", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    pl = PT.Placement(fsdp_axis="fsdp")
    saved = {}
    # the gradient phase under fp32: an optimizer that returns the gradients
    policy = get_policy("fp32")
    params = R.init(cfg, jax.random.PRNGKey(0), policy.param_dtype)
    opt = adamw(policy, b2=0.997)
    C.save(out + "/init", 0, make_train_state(params, opt))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
    saved.update(tokens=tokens, labels=np.roll(tokens, -1, 1))
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(saved["labels"])}
    capture = Optimizer("capture", policy, opt.init, lambda g, s, p, **kw: (g, s))
    pspecs = PT.param_specs(params, cfg, mesh, pl)
    tr = T.make_transport(mesh=mesh, placement=pl, pspecs=pspecs, wire="fp32")
    state = make_train_state(params, capture, transport=tr)
    state = jax.device_put(state, F.train_state_shardings(state, cfg, mesh, pl, transport=tr))
    step = make_train_step(cfg, policy, capture, constant(1e-3), attn_chunk=8, transport=tr)
    hints, hsize = tr.hint_axes(mesh)
    with mesh, activation_sharding(hints, hsize, "model", 1):
        new, m = jax.jit(step)(state, batch, 0)
    for i, g in enumerate(jax.tree_util.tree_leaves(new.params)):
        saved[f"grad_{i}"] = np.asarray(g, np.float32)
    saved["loss"], saved["grad_norm"] = np.asarray(m["loss"]), np.asarray(m["grad_norm"])
    # the shard-local fused AdamW update (bf16_sr_kahan) of a random state
    policy = get_policy("bf16_sr_kahan")
    params = R.init(cfg, jax.random.PRNGKey(0), policy.param_dtype)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    bf = lambda a: jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)
    g_l = [bf(rng.standard_normal(w.shape) * 0.01) for w in leaves]
    m_l = [bf(rng.standard_normal(w.shape) * 0.01) for w in leaves]
    v_l = [bf(np.abs(rng.standard_normal(w.shape)) * 1e-4) for w in leaves]
    c_l = [bf(rng.standard_normal(w.shape) * 2.0 ** -12) for w in leaves]
    for name, ls in (("w", leaves), ("g", g_l), ("m", m_l), ("v", v_l), ("c", c_l)):
        for i, a in enumerate(ls):
            saved[f"in_{name}_{i}"] = np.asarray(a).view(np.uint16)
    pspecs = PT.param_specs(params, cfg, mesh, pl)
    fopt = fused_adamw_optimizer(policy, b2=0.997, mesh=mesh, pspecs=pspecs)
    unf = lambda ls: jax.tree_util.tree_unflatten(treedef, ls)
    shard = lambda t: jax.device_put(t, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), pspecs, is_leaf=lambda x: isinstance(x, PartitionSpec)))
    one = jnp.ones((), jnp.bfloat16)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    with mesh:
        new_p, new_s = jax.jit(lambda g, s, p: fopt.update(g, s, p, step=0, key=key,
                                                           lr=1e-3))(
            shard(unf(g_l)), AdamWState(shard(unf(m_l)), shard(unf(v_l)), one, one,
                                        shard(unf(c_l))), shard(params))
    outs = {"w": new_p, "m": new_s.m, "v": new_s.v, "c": new_s.kahan_c}
    for name, t in outs.items():
        for i, a in enumerate(jax.tree_util.tree_leaves(t)):
            saved[f"pallas_{name}_{i}"] = np.asarray(a).view(np.uint16)
    # each shard's bits (optim/fused.py::_shard_key) and ref.py on the shard
    b1q = float(jnp.float32(jnp.bfloat16(0.9)))
    b2q = float(jnp.float32(jnp.bfloat16(0.997)))
    keys = list(jax.random.split(key, len(leaves)))
    specs = treedef.flatten_up_to(pspecs)
    dims = [next((d for d, e in enumerate(sp) if e == "fsdp"), -1) for sp in specs]
    saved["fsdp_dims"] = np.array(dims)
    for i, (w, dim) in enumerate(zip(leaves, dims)):
        for s in range(2):
            if dim < 0:
                k, sl = keys[i], (slice(None),) * w.ndim
            else:
                k, ext = jax.random.fold_in(keys[i], s), w.shape[dim] // 2
                sl = tuple(slice(s * ext, (s + 1) * ext) if d == dim else slice(None)
                           for d in range(w.ndim))
            bits = jax.random.bits(k, w[sl].shape, jnp.uint32)
            saved[f"bits{s}_{i}"] = np.asarray(bits)
            r = JREF.fused_adamw_ref(w[sl], m_l[i][sl], v_l[i][sl], g_l[i][sl], c=c_l[i][sl],
                                     bits=bits, lr=np.float32(1e-3), b1=np.float32(b1q),
                                     b2=np.float32(b2q), eps=np.float32(1e-8),
                                     wd=np.float32(0.01), c1=np.float32(b1q),
                                     c2=np.float32(b2q))
            for name, a in zip("wmvc", r):
                saved[f"ref{s}_{name}_{i}"] = np.asarray(a).view(np.uint16)
    np.savez(out + "/ref.npz", **saved)
""")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    # one thread each: the ranks and the other test workers share the cores
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _launch(scenario: str, out: Path, n: int = 2, timeout: float = TIMEOUT):
    """``scenario`` on n gloo ranks through the port's launcher."""
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dist_launch", "-n", str(n),
         "--timeout", str(timeout - 10), "--", sys.executable, WORKER, scenario, str(out)],
        capture_output=True, text=True, timeout=timeout, env=_env(), cwd=ROOT)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp_ref")
    flags = ("--xla_force_host_platform_device_count=2 --xla_allow_excess_precision=false "
             "--xla_cpu_multi_thread_eigen=false")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out)], capture_output=True,
                       text=True, timeout=TIMEOUT, env=_env(XLA_FLAGS=flags,
                                                            JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    run = _launch("ref", out)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    return out, np.load(out / "ref.npz")


def _slice(a, dim: int, index: int, n: int = 2):
    if dim < 0:
        return a
    ext = a.shape[dim] // n
    return np.take(a, np.arange(index * ext, (index + 1) * ext), axis=dim)


def test_gradient_shards_match_reference(reference):
    out, ref = reference
    dims = ref["fsdp_dims"]
    ranks = [torch.load(out / f"rank{r}_grads.pt") for r in range(2)]
    for r, got in enumerate(ranks):
        assert got["index"] == r
        assert float(got["loss"]) == pytest.approx(float(ref["loss"]), rel=LOSS_RTOL)
        assert float(got["grad_norm"]) == pytest.approx(float(ref["grad_norm"]),
                                                        rel=LOSS_RTOL)
        for i, g in enumerate(got["grads"]):
            full = ref[f"grad_{i}"]
            want = _slice(full, int(dims[i]), r)
            assert g.dtype == torch.float32 and tuple(g.shape) == want.shape, i
            scale = float(np.abs(full).max())
            err = float(np.abs(g.numpy() - want).max())
            assert err <= GRAD_TOL * scale, (r, i, err, scale)
    # the same loss and norm bits on both ranks; every gradient element
    # crossed the reduce-scatter once in f32, every parameter shard the gather
    assert torch.equal(ranks[0]["loss"], ranks[1]["loss"])
    assert torch.equal(ranks[0]["grad_norm"], ranks[1]["grad_norm"])
    n_full = sum(ref[f"grad_{i}"].size for i in range(len(dims)))
    n_sharded = sum(ref[f"grad_{i}"].size for i in range(len(dims)) if dims[i] >= 0)
    for got in ranks:
        assert got["scatter"] == 4 * n_sharded
        assert got["stats"]["float32"] == 4 * n_full
        assert got["gather"] == {"float32": 4 * n_sharded // 2}


def test_shard_local_fused_update_matches_reference(reference):
    out, ref = reference
    dims = ref["fsdp_dims"]
    for r in range(2):
        got = torch.load(out / f"rank{r}_fused.pt")
        for name in "wmvc":
            for i, t in enumerate(got[name]):
                bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
                want_ref = ref[f"ref{r}_{name}_{i}"]
                np.testing.assert_array_equal(bits, want_ref, err_msg=f"{name}{i} vs ref.py")
                pallas = _slice(ref[f"pallas_{name}_{i}"], int(dims[i]), r)
                ties = pallas != want_ref
                assert ties.mean() <= FMA_TIE_FRAC, (name, i, int(ties.sum()))
                np.testing.assert_array_equal(bits[~ties], pallas[~ties])


@pytest.fixture(scope="module")
def invariants(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp_inv")
    run = _launch("invariants", out)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-4000:]
    return [torch.load(out / f"rank{r}_invariants.pt") for r in range(2)]


def test_fsdp_equals_data_parallel_bitwise(invariants):
    a = invariants[0]
    assert len(a["fsdp_leaves"]) == len(a["dp_leaves"])
    for i, (x, y) in enumerate(zip(a["fsdp_leaves"], a["dp_leaves"])):
        assert x.dtype == y.dtype and torch.equal(x, y), i
    assert [m[0] for m in a["fsdp_metrics"]] == [m[0] for m in a["dp_metrics"]]
    for f, d in zip(a["fsdp_metrics"], a["dp_metrics"]):
        assert f[1] == pytest.approx(d[1], rel=1e-5)
    assert invariants[0]["fsdp_metrics"] == invariants[1]["fsdp_metrics"]


@pytest.mark.parametrize("run", ["fsdp_local", "fused_local"])
def test_replicated_leaves_equal_on_both_ranks(invariants, run):
    a, b = invariants
    specs = a["specs"]
    n_repl = 0
    for spec, x, y in zip(specs, a[run], b[run]):
        if any(e is not None for e in spec):
            assert x.shape == y.shape          # each rank its own shard
            continue
        n_repl += 1
        assert torch.equal(x, y), spec
    assert n_repl >= 2          # the bias-correction scalars at least
    # the sharded leaves differ between the ranks' shards
    assert not all(torch.equal(x, y) for spec, x, y in zip(specs, a[run], b[run])
                   if any(e is not None for e in spec))


def test_gather_bytes_flat_in_grad_accum(invariants):
    for res in invariants:
        assert res["gather_accum1"] == res["gather_accum4"]
        assert res["gather_accum1"]["bfloat16"] > 0
        assert res["scatter_accum1"] == res["scatter_accum4"] > 0


def test_state_bytes_ratio(invariants):
    for res in invariants:
        assert res["dp_bytes"] / res["fsdp_bytes"] >= 1.9


def test_runner_fsdp_memory_rows(tmp_path):
    # the caller finds the package on sys.path alone, as chip_smoke.py's
    # sections do: the ranks must find it without the caller's PYTHONPATH
    env = _env()
    env.pop("PYTHONPATH")
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'src')!r}); "
            "from repro_torch.benchmarks.run import main; "
            "sys.exit(main(['--only', 'fsdp_memory', '--device', 'cpu']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=TIMEOUT, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert [line.split(",")[0] for line in lines] == [
        "name", "fsdp_compare_dp_step", "fsdp_compare_fsdp_step",
        "fsdp_vs_dp_state_bytes_ratio"]
    dp, fs = (int(line.split("state_bytes_per_device=")[1]) for line in lines[1:3])
    assert float(lines[3].split(",")[2].rstrip("x")) >= 1.9 and dp / fs >= 1.9
