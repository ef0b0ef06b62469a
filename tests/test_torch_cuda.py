"""The CUDA kernels, the engine and the trainer on a GPU (marker ``cuda``).

Skipped without a CUDA device. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The decode kernel is held against its plain PyTorch version on the same
CUDA inputs at atol = rtol = 1e-2 on the f32 output (sums in another
order; an f32-ulp difference can flip the bf16 rounding of one
probability), and parked lanes must be exact zeros. The paged kernel
shares the contiguous kernel's body, so on a pool it must equal the
contiguous kernel on the gathered view ``pages[block_table]`` bit for bit. The update kernels
(``sr_cast``, ``fused_adamw``, ``fused_sgd``) must equal their plain
versions bit for bit in every variant at ragged sizes (NaN lanes: NaN on
both sides): every op rounds once, and none is contracted into an FMA.
The qmatmul kernel sums on the tensor cores, not by a chain of rounded
f32 adds, so it is held to its plain version within 1 bf16 ulp plus the
f32 accumulation bound on at most 0.5% of the outputs, and to the exact
product within that bound; where every sum is exact (edge lanes) bit for
bit.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.policy import get_policy
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import dispatch
from repro_torch.launch import train as launch_train
from repro_torch.models import registry as R
from repro_torch.serve.decode import generate
from repro_torch.serve.engine import Engine
from repro_torch.tree import tree_leaves

# the package attributes of these names are the wrapper functions; the
# modules hold each kernel's plain version and LAUNCHES count
FA = importlib.import_module("repro_torch.kernels.fused_adamw")
FS = importlib.import_module("repro_torch.kernels.fused_sgd")
QM = importlib.import_module("repro_torch.kernels.qmatmul")
SC = importlib.import_module("repro_torch.kernels.sr_cast")

PH = importlib.import_module("repro_torch.kernels.philox")
RM = importlib.import_module("repro_torch.kernels.row_mean_sq")

pytestmark = pytest.mark.cuda
TOL = 1e-2
# on long views an output is ~sqrt(e/keys), about TOL itself, so there the
# kernel is also held, lane by lane, to REL_RMS of the RMS of the plain
# version's output in that lane
REL_RMS = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, *, B=4, Sc=40, Hkv=2, G=2, D=32, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sc, Hkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sc, Hkv, D), generator=g, device=dev).to(dtype)
    q_pos = torch.randint(0, Sc, (B,), generator=g, device=dev, dtype=torch.int32)
    cells = torch.arange(Sc, device=dev, dtype=torch.int32)[None, :]
    k_pos = torch.where(cells <= q_pos[:, None], cells, -1).to(torch.int32)
    return q, k, v, k_pos, q_pos


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [dict(Sc=40, G=2, D=32), dict(Sc=300, G=8, D=128),
                                   dict(Sc=17, G=5, D=64), dict(Sc=70, G=4, D=256)])
@pytest.mark.parametrize("kw", [{}, dict(window=7, softcap=30.0)])
def test_kernel_matches_plain(cuda, dtype, shape, kw):
    q, k, v, k_pos, q_pos = _inputs(cuda, dtype=dtype, **shape)
    q_pos[1] = -1                                          # a parked lane
    before = DA.LAUNCHES
    got = DA.fused_decode_attention(q, k, v, k_pos, q_pos, p_dtype=dtype, **kw)
    want = DA.decode_attention_ref(q, k, v, k_pos, q_pos, p_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert DA.LAUNCHES == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool((got[1] == 0).all())
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kw", [{}, dict(window=64)])
def test_kernels_take_ten_query_heads_per_kv_head(cuda, dtype, kw):
    """recurrentgemma's group (G = 10 on 1 kv head, D = 256), split over
    two clusters of 5 rows: contiguous and paged within 1e-2 of their
    plain versions, paged == contiguous on the gathered view, a parked lane
    exactly zero, and each head's output the bits of a call on its part
    of the group alone (a head's arithmetic does not depend on G)."""
    q, k, v, k_pos, q_pos = _inputs(cuda, B=4, Sc=300, Hkv=1, G=10, D=256, dtype=dtype)
    q_pos[1] = -1                                          # a parked lane
    before = (DA.LAUNCHES, DA.PAGED_LAUNCHES)
    got = DA.fused_decode_attention(q, k, v, k_pos, q_pos, p_dtype=dtype, **kw)
    want = DA.decode_attention_ref(q, k, v, k_pos, q_pos, p_dtype=dtype, **kw)
    pages = lambda t: t.reshape(4 * 300 // 4, 4, *t.shape[2:])  # noqa: E731
    table = torch.arange(300, device=cuda, dtype=torch.int32).reshape(4, -1)
    paged = DA.fused_paged_decode_attention(q, pages(k), pages(v), pages(k_pos), table,
                                            q_pos, p_dtype=dtype, **kw)
    part = DA.fused_decode_attention(q[:, :, 5:].contiguous(), k, v, k_pos, q_pos,
                                     p_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert (DA.LAUNCHES, DA.PAGED_LAUNCHES) == (before[0] + 2, before[1] + 1)
    assert bool((got[1] == 0).all())
    assert torch.equal(paged, got)
    assert torch.equal(part, got[:, :, 5:])
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    ratio = _rms_ratio(got, want, q_pos)
    assert ratio <= REL_RMS, f"max |kernel - plain| / RMS(plain) = {ratio:.3e}"


def test_kernel_rejects_what_it_cannot_take(cuda):
    # above the cap at G = 8, D = 128: 35072 keys (DA.max_keys)
    q, k, v, k_pos, q_pos = _inputs(cuda, Sc=36000, G=8, D=128)
    with pytest.raises(ValueError, match="shared memory"):
        DA.fused_decode_attention(q, k, v, k_pos, q_pos)
    q, k, v, k_pos, q_pos = _inputs(cuda)
    with pytest.raises(ValueError, match="int32"):
        DA.fused_decode_attention(q, k, v, k_pos.long(), q_pos)
    with pytest.raises(ValueError, match="dtype"):
        DA.fused_decode_attention(q.half(), k.half(), v.half(), k_pos, q_pos)
    q, k, v, k_pos, q_pos = _inputs(cuda, Hkv=1, G=17, D=32)   # above MAX_GROUP
    with pytest.raises(ValueError, match="query heads per kv"):
        DA.fused_decode_attention(q, k, v, k_pos, q_pos)


def _run_launches(eng, name, counted):
    """Launches of kernel ``name`` a serve run really made: the wrapper's
    count (each step variant's eager first step and its capture) less the
    captures, plus each graph's replays times the launches it holds."""
    per = {w: g.kernels.get(name, 0) for w, g in eng.graphs.items()}
    return counted - sum(per.values()) + sum(g.replays * per[w] for w, g in eng.graphs.items())


def _width_steps(eng, width, with_logits=False):
    g = eng.graphs.get((width, with_logits))
    return 0 if g is None else 1 + g.replays


def test_engine_matches_generate_on_the_card(cuda):
    policy = get_policy("bf16_standard")
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, 0, policy.param_dtype)
    eng = Engine(params, cfg, policy, n_slots=3, max_len=24, fused_decode=True)
    rng = np.random.default_rng(0)
    for s, g in zip((5, 7, 5, 7, 5), (8, 6, 8, 6, 8)):
        eng.submit(rng.integers(0, cfg.vocab, size=s), g)
    before = DA.LAUNCHES
    done = eng.run()
    assert set(eng.graphs) == {(1, False)}                    # greedy: no logits graph
    assert eng.graphs[1, False].replays == eng.stats.steps - 1   # the first step is eager
    # the serve step's kernels: decode attention per layer, qmatmul for its
    # seven products, row_mean_sq under its two norms and the final one
    assert eng.graphs[1, False].kernels == {"decode_attention": cfg.n_layers,
                                     "qmatmul": 7 * cfg.n_layers,
                                     "row_mean_sq": 2 * cfg.n_layers + 1}
    assert _run_launches(eng, "decode_attention", DA.LAUNCHES - before) \
        == cfg.n_layers * eng.stats.steps
    groups = {}
    for c in done:
        groups.setdefault((c.prompt.size, c.tokens.size), []).append(c)
    with dispatch.fused_decode():
        for (s0, gen), cs in groups.items():
            rows = [c.prompt for c in cs] + [np.zeros(s0, np.int32)] * (3 - len(cs))
            ref = generate(params, cfg, policy, np.stack(rows), max_new_tokens=gen,
                           cache_len=24).cpu().numpy()
            for i, c in enumerate(cs):
                assert np.array_equal(ref[i, s0:], c.tokens)


def _paged(dev, *, B=4, n_blocks=6, P=8, Hkv=2, G=4, D=64, dtype=torch.bfloat16, seed=0):
    """A shuffled pool: lane b holds positions 0..q_pos[b]; lanes 0 and 1
    share their first block; unmapped blocks point at the null row R−1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    R = B * n_blocks + 1
    q = torch.randn((B, 1, Hkv * G, D), generator=g, device=dev).to(dtype)
    k = torch.randn((R, P, Hkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((R, P, Hkv, D), generator=g, device=dev).to(dtype)
    pos = torch.full((R, P), -1, dtype=torch.int32, device=dev)
    q_pos = torch.tensor([n_blocks * P - 3, P + 2, 0, 2 * P], dtype=torch.int32, device=dev)[:B]
    table = torch.full((B, n_blocks), R - 1, dtype=torch.int32, device=dev)
    rows = torch.randperm(R - 1, generator=g, device=dev).tolist()
    for b in range(B):
        for blk in range(int(q_pos[b]) // P + 1):
            if b == 1 and blk == 0:
                table[1, 0] = table[0, 0]
                continue
            r = rows.pop()
            table[b, blk] = r
            cells = blk * P + torch.arange(P, device=dev, dtype=torch.int32)
            pos[r] = torch.where(cells <= q_pos[b], cells, -1)
    return q, k, v, pos, table, q_pos


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kw", [{}, dict(window=7, softcap=30.0)])
def test_paged_kernel_equals_contiguous_kernel_on_the_view(cuda, dtype, kw):
    q, k, v, pos, table, q_pos = _paged(cuda, dtype=dtype)
    q_pos[2] = -1                                          # a parked lane
    view = lambda t: DA._gather_view(t, table).contiguous()  # noqa: E731
    before = (DA.LAUNCHES, DA.PAGED_LAUNCHES)
    got = DA.fused_paged_decode_attention(q, k, v, pos, table, q_pos, p_dtype=dtype, **kw)
    want = DA.fused_decode_attention(q, view(k), view(v), view(pos), q_pos, p_dtype=dtype,
                                     **kw)
    plain = DA.paged_decode_attention_ref(q, k, v, pos, table, q_pos, p_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert (DA.LAUNCHES, DA.PAGED_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)
    assert bool((got[2] == 0).all())
    torch.testing.assert_close(got, plain, atol=TOL, rtol=TOL)


def _rms_ratio(got, want, q_pos):
    """The largest ratio, over the active lanes, of a lane's max |got − want|
    to the RMS of want in that lane."""
    active = q_pos >= 0
    err = (got - want)[active].abs().flatten(1).amax(1)
    return float((err / want[active].pow(2).flatten(1).mean(1).sqrt()).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_equals_contiguous_kernel_on_a_long_view(cuda, dtype):
    """A view of 5120 keys (above the 4636 a single block once held at
    G = 8): paged ≡ contiguous on the gathered view, both within 1e-2 of
    the plain version and, lane by lane, within REL_RMS of its RMS, and a
    second call bitwise equal to the first."""
    q, k, v, pos, table, q_pos = _paged(cuda, n_blocks=640, P=8, G=8, D=128, dtype=dtype)
    q_pos[2] = -1                                          # a parked lane
    view = lambda t: DA._gather_view(t, table).contiguous()  # noqa: E731
    got = DA.fused_paged_decode_attention(q, k, v, pos, table, q_pos, p_dtype=dtype)
    again = DA.fused_paged_decode_attention(q, k, v, pos, table, q_pos, p_dtype=dtype)
    want = DA.fused_decode_attention(q, view(k), view(v), view(pos), q_pos, p_dtype=dtype)
    plain = DA.paged_decode_attention_ref(q, k, v, pos, table, q_pos, p_dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)
    assert bool((got[2] == 0).all())
    torch.testing.assert_close(got, plain, atol=TOL, rtol=TOL)
    ratio = _rms_ratio(got, plain, q_pos)
    assert ratio <= REL_RMS, f"max |kernel - plain| / RMS(plain) = {ratio:.3e}"


def test_kernels_take_a_view_at_the_cap(cuda):
    """A view of max_keys(8, 128) keys: the wrappers' shared-memory
    arithmetic admits no view the CUDA source refuses. Contiguous within
    1e-2 and REL_RMS of the plain version; paged on the same cache, as
    pages of 16 in order, bitwise equal to it."""
    Sc = DA.max_keys(8, 128)
    q, k, v, k_pos, q_pos = _inputs(cuda, B=2, Sc=Sc, Hkv=1, G=8, D=128)
    q_pos[0] = Sc - 1                                      # a lane at the view's end
    cells = torch.arange(Sc, device=cuda, dtype=torch.int32)[None, :]
    k_pos = torch.where(cells <= q_pos[:, None], cells, -1).to(torch.int32).contiguous()
    got = DA.fused_decode_attention(q, k, v, k_pos, q_pos)
    plain = DA.decode_attention_ref(q, k, v, k_pos, q_pos)
    pages = lambda t: t.reshape(2 * Sc // 16, 16, *t.shape[2:])  # noqa: E731
    table = torch.arange(2 * Sc // 16, device=cuda, dtype=torch.int32).reshape(2, -1)
    paged = DA.fused_paged_decode_attention(q, pages(k), pages(v), pages(k_pos), table, q_pos)
    torch.cuda.synchronize()
    assert torch.equal(paged, got)
    torch.testing.assert_close(got, plain, atol=TOL, rtol=TOL)
    ratio = _rms_ratio(got, plain, q_pos)
    assert ratio <= REL_RMS, f"max |kernel - plain| / RMS(plain) = {ratio:.3e}"


def test_paged_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v, pos, table, q_pos = _paged(cuda, G=8, D=128)
    wide = table.repeat(1, 4500 // table.shape[1] + 1)    # > 35072 keys at G = 8
    with pytest.raises(ValueError, match="shared memory"):
        DA.fused_paged_decode_attention(q, k, v, pos, wide.contiguous(), q_pos)
    with pytest.raises(ValueError, match="int32"):
        DA.fused_paged_decode_attention(q, k, v, pos, table.long(), q_pos)
    with pytest.raises(ValueError, match="paged GQA decode"):
        DA.fused_paged_decode_attention(q, k, v[:-1].contiguous(), pos, table, q_pos)


def test_paged_chunked_engine_matches_contiguous_on_the_card(cuda):
    policy = get_policy("bf16_standard")
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, 0, policy.param_dtype)
    rng = np.random.default_rng(0)
    common = rng.integers(0, cfg.vocab, 16)
    stream = [(np.concatenate([common, rng.integers(0, cfg.vocab, s)]), g)
              for s, g in zip((5, 9, 14, 3, 11, 7), (8, 6, 12, 9, 5, 10))]

    def run(**kw):
        eng = Engine(params, cfg, policy, n_slots=3, max_len=48, fused_decode=True, **kw)
        for p, g in stream:
            eng.submit(p, g)
        before = DA.PAGED_LAUNCHES
        done = eng.run()
        launched = _run_launches(eng, "paged_decode_attention", DA.PAGED_LAUNCHES - before)
        steps = sum(_width_steps(eng, *key) for key in eng.graphs)
        return {c.rid: c.tokens for c in done}, eng, launched, steps

    for chunk in (1, 4):
        want, _, launched, _ = run(prefill_chunk=chunk)
        assert launched == 0
        got, eng, launched, steps = run(prefill_chunk=chunk, paged=True, page_size=4,
                                        n_pages=20)
        assert eng.stats.preemptions >= 1 and eng.stats.prefix_hits >= 1
        # one paged launch per layer in every serve step: a chunk step runs
        # its query rows as lanes of the paged kernel too
        assert launched == cfg.n_layers * steps
        for rid in want:
            assert np.array_equal(got[rid], want[rid]), (chunk, rid)


@pytest.mark.parametrize("arch,kw", [("mixtral-8x22b", {}), ("llama4-scout-17b-a16e", {}),
                                     ("falcon-mamba-7b", {}), ("recurrentgemma-2b", {}),
                                     ("recurrentgemma-2b", dict(paged=True, page_size=4)),
                                     ("command-r-35b", dict(paged=True, page_size=4)),
                                     ("qwen2-vl-7b", dict(paged=True, page_size=4))])
def test_family_graph_engine_equals_eager_and_generate(cuda, arch, kw):
    """A reduced family served as CUDA graphs (7 requests on 3 slots, so
    slots are recycled and lanes park) == the eager step == ``generate`` at
    3 rows through the same kernels; its recurrent state stays in the
    pool's buffers across replays."""
    policy = get_policy("bf16_standard")
    cfg = R.get_config(arch).reduced()
    params = R.init(cfg, 0, policy.param_dtype)
    rng = np.random.default_rng(2)
    stream = [(rng.integers(0, cfg.vocab, s), g)
              for s, g in zip((5, 9, 5, 9, 5, 9, 5), (8, 12, 4, 12, 8, 4, 8))]

    def run(graphs):
        eng = Engine(params, cfg, policy, n_slots=3, max_len=32, fused_decode=True, **kw)
        eng._use_graphs = graphs
        for p, g in stream:
            eng.submit(p, g)
        return {c.rid: c for c in eng.run()}, eng

    got, eng = run(True)
    want, _ = run(False)
    assert set(eng.graphs) == {(1, False)} and eng.graphs[1, False].replays > 0
    for rid, c in got.items():
        assert np.array_equal(c.tokens, want[rid].tokens), rid
    with dispatch.fused_decode():
        for rid, c in got.items():
            ref = generate(params, cfg, policy, np.stack([c.prompt] * 3),
                           max_new_tokens=c.tokens.size, cache_len=32).cpu().numpy()
            assert np.array_equal(ref[0, c.prompt.size:], c.tokens), rid


ENGINES = {"contiguous": {},
           "paged, prefix hits and preemption": dict(paged=True, page_size=4, n_pages=20),
           "paged, chunk 4": dict(paged=True, page_size=4, n_pages=20, prefill_chunk=4),
           "paged, chunk 32": dict(paged=True, page_size=4, n_pages=40, prefill_chunk=32)}


@pytest.mark.parametrize("config", sorted(ENGINES))
def test_graph_engine_equals_the_eager_step(cuda, config):
    """The serve step as CUDA graphs (one per token width, captured at its
    first step, replayed after) ≡ the same engine stepping eagerly: the
    same schedule, the same tokens bit for bit."""
    policy = get_policy("bf16_standard")
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, 0, policy.param_dtype)
    rng = np.random.default_rng(1)
    common = rng.integers(0, cfg.vocab, 16)
    stream = [(np.concatenate([common, rng.integers(0, cfg.vocab, s)]), g)
              for s, g in zip((5, 9, 14, 3, 11, 7), (8, 6, 12, 9, 5, 10))]

    def run(graphs):
        eng = Engine(params, cfg, policy, n_slots=3, max_len=48, fused_decode=True,
                     **ENGINES[config])
        eng._use_graphs = graphs
        for p, g in stream:
            eng.submit(p, g)
        done = eng.run()
        return {c.rid: c.tokens for c in done}, eng

    got, eng = run(True)
    want, eager = run(False)
    assert eager.graphs == {} and eng.stats == eager.stats
    widths = {1, ENGINES[config].get("prefill_chunk", 1)}
    assert set(eng.graphs) == {(w, False) for w in widths}
    assert sum(_width_steps(eng, w) for w in widths) == eng.stats.steps
    assert all(g.replays > 0 for g in eng.graphs.values())
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), rid


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_chunk_32_graph_engine_equals_chunk_1(cuda, paged):
    """ROADMAP C10 on the card: the graph engine with ``prefill_chunk=32``
    gives exactly the chunk-1 engine's tokens, contiguous and paged: on
    the kernel route a token row gets the same bits at every row count."""
    policy = get_policy("bf16_standard")
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, 0, policy.param_dtype)
    rng = np.random.default_rng(2)
    stream = [(rng.integers(0, cfg.vocab, s).astype(np.int32), g)
              for s, g in zip((40, 25, 33, 12, 37, 21), (6, 9, 5, 8, 7, 6))]
    kw = dict(paged=True, page_size=4, n_pages=64) if paged else {}

    def run(chunk):
        eng = Engine(params, cfg, policy, n_slots=3, max_len=64, fused_decode=True,
                     prefill_chunk=chunk, **kw)
        for p, g in stream:
            eng.submit(p, g)
        done = {c.rid: c.tokens for c in eng.run()}
        assert set(eng.graphs) == {(1, False), (chunk, False)}
        return done, eng

    (want, one), (got, chunked) = run(1), run(32)
    assert chunked.stats.steps < one.stats.steps
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), rid


def _mixed_stream(cfg, seed):
    """Six requests behind a shared prefix; every other one sampled."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, cfg.vocab, 16)
    stream = [(np.concatenate([common, rng.integers(0, cfg.vocab, s)]), g)
              for s, g in zip((5, 9, 14, 3, 11, 7), (8, 6, 12, 9, 5, 10))]
    knobs = [dict(temperature=0.8, top_k=50, top_p=0.95, seed=1) if i % 2 else {}
             for i in range(len(stream))]
    return stream, knobs


@pytest.mark.parametrize("kw", [{}, dict(paged=True, page_size=4, n_pages=20, prefill_chunk=4)],
                         ids=["contiguous", "paged, chunk 4"])
def test_sampling_graph_engine_equals_the_eager_step(cuda, kw):
    """Sampled lanes beside greedy ones: the graph engine (a logits graph
    beside the greedy graph of each width) gives the eager step's tokens,
    and the sampler launches the Philox fill for each sampled token."""
    policy = get_policy("bf16_standard")
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, 0, policy.param_dtype)
    stream, knobs = _mixed_stream(cfg, 4)

    def run(graphs):
        eng = Engine(params, cfg, policy, n_slots=3, max_len=48, fused_decode=True, **kw)
        eng._use_graphs = graphs
        for (p, g), k in zip(stream, knobs):
            eng.submit(p, g, **k)
        before = PH.LAUNCHES
        done = eng.run()
        return {c.rid: c.tokens for c in done}, eng, PH.LAUNCHES - before

    got, eng, fills = run(True)
    want, _, _ = run(False)
    assert {with_logits for _, with_logits in eng.graphs} == {False, True}
    # one fill per sampled token (more where a preemption regenerates some)
    assert fills >= sum(g for (_, g), k in zip(stream, knobs) if k)
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), rid


def test_sampled_tokens_survive_preemption_and_chunking_on_the_card(cuda):
    """On the card a chunk step gives a row the single-token bits (C10),
    so tight pages with chunk 4 draw the tokens of roomy pages with chunk 1."""
    policy = get_policy("bf16_standard")
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, 0, policy.param_dtype)
    stream, knobs = _mixed_stream(cfg, 5)
    outs = []
    for n_pages, chunk in ((14, 4), (None, 1)):
        eng = Engine(params, cfg, policy, n_slots=3, max_len=48, fused_decode=True,
                     paged=True, page_size=4, n_pages=n_pages, prefill_chunk=chunk)
        for (p, g), k in zip(stream, knobs):
            eng.submit(p, g, **k)
        outs.append({c.rid: c.tokens.tolist() for c in eng.run()})
        if chunk == 4:
            assert eng.stats.preemptions >= 1
    assert outs[0] == outs[1]


def test_sampler_on_the_card_matches_the_cpu(cuda):
    """The same logits and keys: the card's noise words are the CPU's, and
    the draws agree but for last-ulp differences of f32 ``log``."""
    from repro_torch.serve import sampling
    logits = torch.randn((1, 4096), generator=torch.Generator().manual_seed(6)) * 2
    n = 2000
    keys = [sampling.request_key(1, 0, p) for p in range(n)]
    rows = logits.expand(n, -1)
    args = ([0.8] * n, [50] * n, [0.95] * n, keys)
    card = sampling.sample(rows.to(cuda), *args).cpu()
    cpu = sampling.sample(rows, *args)
    assert float((card == cpu).float().mean()) >= 0.999
    noise = sampling.gumbel(keys[:4], 4096, cuda).cpu()
    assert torch.isfinite(noise).all()
    torch.testing.assert_close(noise, sampling.gumbel(keys[:4], 4096, "cpu"), atol=0, rtol=1e-12)


def test_chunk_step_equals_single_token_steps_on_the_card(cuda):
    """One chunk step ≡ its tokens fed one by one: every layer's K, V and
    positions and the last row's logits, bit for bit."""
    from repro_torch.core.qarith import QArith
    policy = get_policy("bf16_standard")
    cfg = R.get_config("qwen2.5-3b").reduced()
    params = R.init(cfg, 1, policy.param_dtype)
    qa = QArith(policy)
    C = 12
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (3, C))
                            .astype(np.int32)).to(cuda)
    caches, logits = [], []
    with dispatch.fused_decode():
        for chunk in (1, C):
            cache = R.make_cache(params, cfg, batch_size=3, max_len=48,
                                 dtype=policy.compute_dtype)
            for t in range(0, C, chunk):
                pos = torch.arange(t, t + chunk, dtype=torch.int32, device=cuda)
                pos = pos[None].expand(3, chunk).contiguous()
                rows = torch.full((3,), chunk - 1, device=cuda)
                out, cache = R.decode(qa, params, cfg, toks[:, t:t + chunk], cache,
                                      pos if chunk > 1 else pos[:, 0], out_rows=rows)
            logits.append(out)
            caches.append(cache["layers"]["b0"])
    for a, b in zip(*caches):
        assert torch.equal(a, b)
    assert torch.equal(logits[0], logits[1])


def test_decode_kernel_lane_map_equals_the_gathered_cache(cuda):
    q, k, v, k_pos, q_pos = _inputs(cuda, B=4, Sc=300, G=8, D=128)
    rows = torch.tensor([3, 0, 3, 1, 2, 0], dtype=torch.int32, device=cuda)
    ql = q[rows.long()].contiguous()
    qp = q_pos[rows.long()].clone()
    qp[4] = -1                                             # a parked lane
    got = DA.fused_decode_attention(ql, k, v, k_pos, qp, lane_rows=rows)
    r = rows.long()
    want = DA.fused_decode_attention(ql, k[r].contiguous(), v[r].contiguous(),
                                     k_pos[r].contiguous(), qp)
    assert torch.equal(got, want)
    assert bool((got[4] == 0).all())
    torch.testing.assert_close(got, DA.decode_attention_ref(ql, k, v, k_pos, qp, lane_rows=rows),
                               atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="lane_rows"):
        DA.fused_decode_attention(ql, k, v, k_pos, qp, lane_rows=rows.long())


def test_chunk_rows_as_lanes_equal_single_token_calls(cuda):
    """Each row of a chunk, run as a lane of its own (contiguous and paged),
    ≡ the single-token kernel over a cache holding positions up to its own."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda).manual_seed(5)
    B, S, Sc, P = 3, 16, 64, 8
    q = torch.randn((B, S, 16, 128), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((B, Sc, 2, 128), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((B, Sc, 2, 128), generator=g, device=cuda).to(torch.bfloat16)
    depth = torch.tensor([0, 7, 30], dtype=torch.int32, device=cuda)
    q_pos = depth[:, None] + torch.arange(S, dtype=torch.int32, device=cuda)[None]
    q_pos[1, 10:] = -1
    cells = torch.arange(Sc, dtype=torch.int32, device=cuda)[None]
    k_pos = torch.where(cells <= q_pos.amax(1, keepdim=True), cells, -1).contiguous()
    got = L.attention_as_lanes(q, k, v, k_pos, q_pos)
    for b in range(B):
        for i in range(S):
            p = int(q_pos[b, i])
            if p < 0:
                assert bool((got[b, i] == 0).all())
                continue
            kp = torch.where(k_pos[b:b + 1] <= p, k_pos[b:b + 1], -1).contiguous()
            one = DA.fused_decode_attention(q[b:b + 1, i:i + 1].contiguous(), k[b:b + 1],
                                            v[b:b + 1], kp, q_pos[b:b + 1, i])
            assert torch.equal(one[0, 0], got[b, i]), (b, i)
    perm = torch.randperm(B * Sc // P, generator=g, device=cuda)

    def pool(t):
        out = torch.empty((B * Sc // P, P, *t.shape[2:]), dtype=t.dtype, device=cuda)
        out[perm] = t.reshape(B * Sc // P, P, *t.shape[2:])
        return out
    table = perm.reshape(B, Sc // P).to(torch.int32)
    paged = L.paged_attention_as_lanes(q, pool(k), pool(v), pool(k_pos), table, q_pos)
    assert torch.equal(paged, got)


# ---------------------------------------------------------------------------
# products with an f32 result (ROADMAP C12)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("sa,sb,transpose_b", [
    ((64, 256), (256, 96), False),                       # 2-D
    ((2, 24, 128), (300, 128), True),                    # rows folded; b = embedding.T
    ((2, 4, 80, 128), (2, 4, 128, 96), False),           # attention's chunks
    ((2, 4, 80, 128), (2, 4, 96, 128), True)])           # q @ k^T
def test_tensor_core_products_match_the_upcast_products(cuda, sa, sb, transpose_b, dtype):
    from repro_torch.core.qarith import f32_product, on_tensor_cores
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(sa, generator=g, device=cuda).to(dtype)
    b = torch.randn(sb, generator=g, device=cuda).to(dtype)
    if transpose_b:
        b = b.transpose(-1, -2)
    assert on_tensor_cores(a, b)
    got = f32_product(a, b)
    want = torch.matmul(a.float(), b.float())
    assert got.dtype == torch.float32 and got.shape == want.shape
    bound = a.shape[-1] * 2.0 ** -23 * torch.matmul(a.double().abs(), b.double().abs())
    assert bool(((got.double() - want.double()).abs() <= bound).all())


def test_logits_gradients_are_the_upcast_products_on_the_card(cuda):
    """matmul_f32out's tensor-core forward is within the f32 bound of the
    upcast product, and its backward (f32 cotangent, f32 GEMMs) gives the
    upcast product's gradients bit for bit."""
    from repro_torch.core.qarith import QArith
    qa = QArith(get_policy("bf16_standard"))
    g = torch.Generator(device=cuda).manual_seed(6)
    h0 = torch.randn((2, 48, 256), generator=g, device=cuda).to(torch.bfloat16)
    e0 = torch.randn((1000, 256), generator=g, device=cuda).to(torch.bfloat16)
    cot = torch.randn((2, 48, 1000), generator=g, device=cuda)
    outs, grads = [], []
    for fn in (qa.matmul_f32out, lambda a, b: torch.matmul(a.float(), b.float())):
        h, e = h0.clone().requires_grad_(True), e0.clone().requires_grad_(True)
        out = fn(h, e.T)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, (h, e), cot))
    bound = 256 * 2.0 ** -23 * (h0.double().abs() @ e0.double().abs().T)
    assert bool(((outs[0].double() - outs[1].double()).abs() <= bound).all())
    for got, want in zip(*grads):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# update kernels
# ---------------------------------------------------------------------------

VARIANTS = [(False, False), (True, False), (False, True), (True, True)]
ADAMW_HP = dict(lr=1e-3, b1=0.8984375, b2=0.99609375, eps=1e-8, wd=0.01,
                c1=0.8984375, c2=0.99609375)
SGD_HP = dict(lr=0.1, momentum=0.9, wd=1e-4)


def _same(got, want):
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16))


def _state(dev, n, seed, *, edges=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda s: (torch.randn(n, generator=g, device=dev) * s).to(torch.bfloat16)  # noqa: E731
    out = dict(w=r(1.0), m=r(0.1), v=r(0.1).abs(), g=r(1.0), c=r(2.0**-9),
               bits=torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                                  dtype=torch.int32))
    if edges and n >= 5:
        out["g"][:3] = torch.tensor([float("inf"), float("-inf"), float("nan")])
        out["w"][3:5] = torch.tensor([3.3895e38, -3.3895e38])
    return out


@pytest.mark.parametrize("n", [1, 5, 4099, 1_000_003])
def test_sr_cast_kernel_matches_plain(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, generator=g, device=cuda) * 7
    if n >= 5:
        x[:5] = torch.tensor([float("inf"), float("-inf"), float("nan"), 3.3961e38, -3.3961e38])
    bits = torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=cuda, dtype=torch.int32)
    before = SC.LAUNCHES
    got = SC.sr_cast(x, bits)
    torch.cuda.synchronize()
    assert SC.LAUNCHES == before + 1
    _same(got, SC.sr_cast_ref(x, bits))


@pytest.mark.parametrize("n", [1, 5, 4099, 1_000_003])
@pytest.mark.parametrize("stochastic,kahan", VARIANTS)
def test_fused_adamw_kernel_matches_plain(cuda, n, stochastic, kahan):
    x = _state(cuda, n, n)
    c = x["c"] if kahan else None
    bits = x["bits"] if stochastic else None
    want = FA.fused_adamw_ref(x["w"], x["m"], x["v"], x["g"], c=c, bits=bits,
                              stochastic=stochastic, **ADAMW_HP)
    before = FA.LAUNCHES
    got = FA.fused_adamw(x["w"], x["m"], x["v"], x["g"], c=c, bits=bits,
                         stochastic=stochastic, **ADAMW_HP)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
    for a, b in zip(got, want):
        if b is not None:
            _same(a, b)


@pytest.mark.parametrize("n", [1, 5, 4099, 1_000_003])
@pytest.mark.parametrize("stochastic,kahan", VARIANTS)
def test_fused_sgd_kernel_matches_plain(cuda, n, stochastic, kahan):
    x = _state(cuda, n, n + 1)
    c = x["c"] if kahan else None
    bits = x["bits"] if stochastic else None
    want = FS.fused_sgd_ref(x["w"], x["m"], x["g"], c=c, bits=bits, stochastic=stochastic,
                            **SGD_HP)
    before = FS.LAUNCHES
    got = FS.fused_sgd(x["w"], x["m"], x["g"], c=c, bits=bits, stochastic=stochastic,
                       **SGD_HP)
    torch.cuda.synchronize()
    assert FS.LAUNCHES == before + 1
    for a, b in zip(got, want):
        if b is not None:
            _same(a, b)


@pytest.mark.parametrize("n", [1, 5, 4099, 1_000_003])
def test_philox_fill_matches_plain(cuda, n):
    seed = 0x0123_4567_89AB_CDEF
    before = PH.LAUNCHES
    got = PH.philox_bits(seed, (n,), cuda)
    torch.cuda.synchronize()
    assert PH.LAUNCHES == before + 1
    assert torch.equal(got, PH.philox_bits_ref(seed, n, cuda))


@pytest.mark.parametrize("full_shape,dim,start,ext", [
    ((8, 6), 0, 4, 4), ((2, 12, 5), 1, 6, 6), ((3, 10, 7), 1, 5, 5), ((5, 9), 1, 3, 3),
    ((2, 2048, 11008), 2, 5504, 5504)])
def test_philox_shard_entry_matches_plain(cuda, full_shape, dim, start, ext):
    """An FSDP shard's words (the fill's shard entry) ≡ the plain version
    and the whole leaf's fill at the shard's positions."""
    seed = 0x0BAD_5EED + start
    shape = list(full_shape)
    shape[dim] = ext
    before = PH.LAUNCHES
    got = PH.philox_bits(seed, shape, cuda, full_shape=full_shape, dim=dim, start=start)
    torch.cuda.synchronize()
    assert PH.LAUNCHES == before + 1
    whole = PH.philox_bits(seed, full_shape, cuda)
    assert torch.equal(got, whole.narrow(dim, start, ext))
    if got.numel() <= 1 << 20:
        assert torch.equal(got.cpu(), PH.philox_bits(seed, shape, "cpu", full_shape=full_shape,
                                                     dim=dim, start=start))


@pytest.mark.parametrize("n", [1, 5, 4099, 1_000_003])
@pytest.mark.parametrize("offset", [(0, 0), (3, 3), (1, 0)], ids=["aligned", "head", "mixed"])
@pytest.mark.parametrize("kahan", [False, True])
def test_seeded_fused_adamw_kernel_matches_plain(cuda, n, offset, kahan):
    """The bits drawn in the kernel (Philox, vector body, scalar head and
    tail, tensors of unequal alignment) ≡ the plain version on the seed."""
    x = _state(cuda, n, n + 2)

    def at(t, off):
        buf = torch.empty(t.numel() + off, dtype=t.dtype, device=cuda)
        buf[off:].copy_(t)
        return buf[off:]
    y = {k: at(t, offset[1] if k == "g" else offset[0]) for k, t in x.items() if k != "bits"}
    seed = 0xFEDC_BA98_7654_3210 + n
    c = y["c"] if kahan else None
    want = FA.fused_adamw_ref(y["w"], y["m"], y["v"], y["g"], c=c, seed=seed, **ADAMW_HP)
    got = FA.fused_adamw(y["w"], y["m"], y["v"], y["g"], c=c, seed=seed, **ADAMW_HP)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if b is not None:
            _same(a, b)


@pytest.mark.parametrize("shape", [(1, 2048), (8, 2048), (256, 2048), (5, 77), (3, 4, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_mean_sq_kernel_matches_plain(cuda, shape, dtype):
    x = (torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(1),
                     device=cuda) * 3).to(dtype)
    before = RM.LAUNCHES
    got = RM.row_mean_sq(x)
    torch.cuda.synchronize()
    assert RM.LAUNCHES == before + 1
    assert torch.equal(got, RM.row_mean_sq_ref(x))
    rows = x.reshape(-1, shape[-1])
    assert torch.equal(RM.row_mean_sq(rows[:1].contiguous()), got.reshape(-1, 1)[:1])


def test_update_wrappers_reject_what_the_kernels_cannot_take(cuda):
    x = _state(cuda, 64, 0, edges=False)
    w, m, v, g, c, bits = (x[k] for k in ("w", "m", "v", "g", "c", "bits"))
    with pytest.raises(ValueError, match="contiguous"):
        FA.fused_adamw(w[::2], m[::2], v[::2], g[::2], bits=bits[::2], **ADAMW_HP)
    with pytest.raises(ValueError, match="bf16"):
        FA.fused_adamw(w.float(), m, v, g, bits=bits, **ADAMW_HP)
    with pytest.raises(ValueError, match="elements"):
        FS.fused_sgd(w, m[:32], g, bits=bits, **SGD_HP)
    with pytest.raises(ValueError, match="int32"):
        FS.fused_sgd(w, m, g, c=c, bits=bits.long(), **SGD_HP)
    with pytest.raises(ValueError, match="on cpu"):
        FS.fused_sgd(w, m, g.cpu(), bits=bits, **SGD_HP)
    with pytest.raises(ValueError, match="f32 x and int32 bits"):
        SC.sr_cast(w, bits)


@pytest.mark.parametrize("fused", [True, False])
def test_reduced_launcher_trains_on_the_card(cuda, fused):
    argv = ["--reduced", "--steps", "3", "--batch", "2", "--seq", "32",
            "--policy", "bf16_sr_kahan"] + (["--fused-update"] if fused else [])
    args = launch_train.parse_args(argv)
    run = launch_train.build(args)
    n_leaves = len(tree_leaves(run.state.params))
    counts = (FA, SC)
    before = [k.LAUNCHES for k in counts]
    state, info = launch_train.train(args, run, log=lambda *_: None)
    launched = [k.LAUNCHES - b for k, b in zip(counts, before)]
    assert state.step == 3
    assert launched == ([3 * n_leaves, 0] if fused else [0, 3 * n_leaves])
    assert all(np.isfinite(row["loss"]) for row in info["history"])


# ---------------------------------------------------------------------------
# qmatmul
# ---------------------------------------------------------------------------

def _qm_inputs(dev, M, N, K, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    y = torch.randn((K, N), generator=g, device=dev).to(torch.bfloat16)
    bits = torch.randint(-2**31, 2**31 - 1, (M, N), generator=g, device=dev,
                         dtype=torch.int32)
    return x, y, bits


def _qm_close(got, x, y, bits):
    """Within 1 bf16 ulp + e of the plain version on at most 0.5% of the
    outputs, and within ulp_bf16(|exact| + e) + e of the exact product,
    e = K·2⁻²³·(|x|@|y|)."""
    want = QM.qmatmul_ref(x, y, bits=bits).double()
    e = x.shape[1] * 2.0 ** -23 * (x.double().abs() @ y.double().abs())
    g = got.double()
    neq = g != want
    assert float(neq.double().mean()) <= 0.005
    assert bool(((g - want).abs() <= 2.0 ** -7 * want.abs().clamp_min(2.0 ** -126) + e).all())
    exact = x.double() @ y.double()
    mag = (exact.abs() + e).clamp_min(2.0 ** -126)
    assert bool(((g - exact).abs() <= torch.exp2(torch.floor(torch.log2(mag)) - 7) + e).all())


# (M, N, K): aligned, ragged in each dimension (N or K not a multiple of 8
# takes the scalar path), one row, K = 0
@pytest.mark.parametrize("mnk", [(128, 128, 128), (256, 384, 2048), (129, 77, 200),
                                 (129, 200, 77), (8, 1000, 512), (1, 1, 1), (300, 264, 1000),
                                 (4, 5, 0)])
@pytest.mark.parametrize("stochastic", [False, True])
def test_qmatmul_kernel_matches_plain(cuda, mnk, stochastic):
    M, N, K = mnk
    x, y, bits = _qm_inputs(cuda, M, N, K, M + N + K)
    bits = bits if stochastic else None
    before = QM.LAUNCHES
    got = QM.qmatmul(x, y, bits=bits)
    torch.cuda.synchronize()
    assert QM.LAUNCHES == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    _qm_close(got, x, y, bits)


def test_qmatmul_kernel_takes_an_unaligned_x(cuda):
    """An x that TMA cannot describe takes the mma.sync path, which meets
    the criterion too (the aligned x takes the wgmma path; the two promote
    at different K depths, so they need not agree bit for bit)."""
    M, N, K = 64, 64, 64
    x, y, bits = _qm_inputs(cuda, M, N, K, 3)
    buf = torch.empty(M * K + 1, dtype=torch.bfloat16, device=cuda)
    buf[1:] = x.reshape(-1)
    xu = buf[1:].view(M, K)
    assert xu.data_ptr() % 16 == 2
    assert QM.kernel_path(xu, y) == QM.plan(xu, y).path == "mma.sync"
    assert QM.kernel_path(x, y) == QM.plan(x, y).path == "wgmma"
    for b in (None, bits):
        _qm_close(QM.qmatmul(xu, y, bits=b), x, y, b)


@pytest.mark.parametrize("bits_value", [None, 0, 0xFFFF, 0x8000])
def test_qmatmul_kernel_edge_lanes_bitwise(cuda, bits_value):
    big = float(torch.finfo(torch.bfloat16).max)
    inf = float("inf")
    rows = [[inf], [-inf], [float("nan")], [inf, -inf], [big, 2.0 ** 110],
            [-big, -2.0 ** 110], [big, big], [big], [1.0, 2.0 ** -9], [0.0]]
    x = torch.zeros((len(rows), 40))
    for i, r in enumerate(rows):
        x[i, :len(r)] = torch.tensor(r)
    x = x.to(torch.bfloat16).to(cuda)
    y = torch.ones((40, 24), dtype=torch.bfloat16, device=cuda)
    bits = None if bits_value is None else torch.full((len(rows), 24), bits_value,
                                                      dtype=torch.int32, device=cuda)
    got = QM.qmatmul(x, y, bits=bits)
    _same(got, QM.qmatmul_ref(x, y, bits=bits))
    assert bool(torch.isposinf(got[6].float()).all())
    assert bool(torch.isinf(got[4:6].float()).all()) == (bits_value == 0xFFFF)


def test_qmatmul_k_accumulation_in_f32_on_the_card(cuda):
    K = 1024
    x = torch.full((128, K), 0.01, dtype=torch.bfloat16, device=cuda)
    out = QM.qmatmul(x, x.T.contiguous()).float()
    expect = K * float(torch.tensor(0.01, dtype=torch.bfloat16)) ** 2
    assert abs(float(out[0, 0]) / expect - 1) < 0.01


def test_qmatmul_op_on_the_card_is_the_kernel_on_the_generators_bits(cuda):
    from repro_torch.core.formats import random_bits
    from repro_torch.kernels import ops
    x, y, _ = _qm_inputs(cuda, 129, 77, 200, 4)
    before = QM.LAUNCHES
    got = ops.qmatmul_op(x, y, torch.Generator(device=cuda).manual_seed(9), stochastic=True)
    assert QM.LAUNCHES == before + 1
    bits = random_bits((129, 77), generator=torch.Generator(device=cuda).manual_seed(9))
    assert torch.equal(got, QM.qmatmul(x, y, bits=bits))
    assert torch.equal(ops.qmatmul_op(x, y), QM.qmatmul(x, y))


def test_qmatmul_rejects_what_the_kernel_cannot_take(cuda):
    x, y, bits = _qm_inputs(cuda, 16, 24, 32, 5)
    with pytest.raises(ValueError, match="contiguous"):
        QM.qmatmul(x, y.T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        QM.qmatmul(x, y, bits=bits.T.contiguous().T)
    with pytest.raises(ValueError, match="on cpu"):
        QM.qmatmul(x, y.cpu())
    with pytest.raises(ValueError, match="bf16"):
        QM.qmatmul(x.half(), y.half())


@pytest.mark.parametrize("nk", [(11008, 2048), (2048, 11008)])     # MLP gate/up, down
@pytest.mark.parametrize("stochastic", [False, True])
def test_qmatmul_rows_do_not_depend_on_the_row_count(cuda, nk, stochastic):
    """Row i of (M,K) @ (K,N) is the same bits for M in {1, 8, 256, 4096}
    at the model's products (the path and tiles depend on N, K and
    alignment only), and the full product meets the criterion."""
    N, K = nk
    x, y, bits = _qm_inputs(cuda, 4096, N, K, 17)
    bits = bits if stochastic else None
    full = QM.qmatmul(x, y, bits=bits)
    for M in (1, 8, 256):
        got = QM.qmatmul(x[:M], y, bits=None if bits is None else bits[:M])
        assert torch.equal(got, full[:M]), M
    _qm_close(full[:256], x[:256], y, None if bits is None else bits[:256])


@pytest.mark.parametrize("mnk,offset,path", [((64, 64, 64), 0, "wgmma"),
                                             ((64, 64, 64), 1, "mma.sync"),
                                             ((9, 77, 64), 0, "mma.sync"),
                                             ((9, 64, 77), 0, "mma.sync"),
                                             ((9, 64, 8), 0, "wgmma")])
def test_qmatmul_plan_is_the_librarys_path(cuda, mnk, offset, path):
    M, N, K = mnk
    buf = torch.zeros(M * K + offset, dtype=torch.bfloat16, device=cuda)
    x = buf[offset:].view(M, K)
    y = torch.zeros((K, N), dtype=torch.bfloat16, device=cuda)
    bits = torch.zeros(M * N + 2, dtype=torch.int32, device=cuda)
    for b in (None, bits[:M * N].view(M, N), bits[2:].view(M, N)):   # the last 8 bytes off
        assert QM.plan(x, y, b).path == QM.kernel_path(x, y, b)
    assert QM.plan(x, y).path == path
    assert QM.plan(x, y, bits[2:].view(M, N)).path == "mma.sync"


# (M, N, K): aligned, ragged (the mma.sync path), the row-parallel shapes
# of qwen2.5-3b at model 2 (wo, w_down), one element
@pytest.mark.parametrize("mnk", [(128, 128, 128), (129, 77, 200), (300, 264, 1000),
                                 (8, 2048, 1024), (8, 2048, 5504), (1, 1, 1)])
def test_qmatmul_f32_entry_rounds_to_the_bf16_entry(cuda, mnk):
    """The f32-result entry's accumulators rounded to bf16 are the bf16
    entry's output bit for bit, on both paths; they lie within the f32
    accumulation bound K·2⁻²³·(|x|@|y|) of the plain version's f32 product."""
    M, N, K = mnk
    x, y, _ = _qm_inputs(cuda, M, N, K, M + N + K)
    before = QM.F32_LAUNCHES
    f32 = QM.qmatmul_f32(x, y)
    torch.cuda.synchronize()
    assert QM.F32_LAUNCHES == before + 1
    assert f32.dtype == torch.float32 and f32.shape == (M, N)
    _same(f32.to(torch.bfloat16), QM.qmatmul(x, y))
    sync = QM._launch(x, y, None, entry="repro_qmatmul_f32_sync")
    _same(sync.to(torch.bfloat16), QM._launch(x, y, None, entry="repro_qmatmul_sync"))
    e = K * 2.0 ** -23 * (x.double().abs() @ y.double().abs())
    want = QM.qmatmul_ref(x, y, out_dtype=torch.float32).double()
    assert bool(((f32.double() - want).abs() <= e).all())


@pytest.mark.parametrize("nk", [(2048, 1024), (2048, 5504), (11008, 2048)])
def test_qmatmul_f32_rows_do_not_depend_on_the_row_count(cuda, nk):
    N, K = nk
    x, y, _ = _qm_inputs(cuda, 4096, N, K, 23)
    full = QM.qmatmul_f32(x, y)
    for M in (1, 8, 256):
        assert torch.equal(QM.qmatmul_f32(x[:M], y), full[:M]), M


def test_encdec_lock_step_on_the_card(cuda):
    """Reduced whisper decoded in lock-step through the fused serve step
    (self and cross attention on the decode kernel, the products on
    ``qmatmul``): two runs equal, 2 decode launches per layer per step,
    the last logits within the reference's prefill ≡ decode bound of
    ``decoder_forward``."""
    from repro_torch.core.qarith import QArith
    from repro_torch.models import encdec as ED
    from repro_torch.train.step import make_serve_step
    policy = get_policy("bf16_standard")
    qa = QArith(policy)
    cfg = R.get_config("whisper-base").reduced()
    params = R.init(cfg, 0, policy.param_dtype)
    g = torch.Generator(device=cuda).manual_seed(3)
    src = torch.randn((3, 40, cfg.d_model), generator=g, device=cuda)
    toks = torch.randint(0, cfg.vocab, (3, 12), generator=g, device=cuda, dtype=torch.int32)
    step = make_serve_step(cfg, policy, fused_decode=True, return_logits=True)

    def run():
        with torch.no_grad():
            cache = R.make_cache(params, cfg, batch_size=3, max_len=12, qa=qa,
                                 batch={"src_embeds": src})
            for t in range(12):
                _, logits, cache = step(params, cache, toks[:, t:t + 1],
                                        torch.full((3,), t, dtype=torch.int32, device=cuda))
        return logits

    DA.LAUNCHES = 0
    got = run()
    assert DA.LAUNCHES == 2 * cfg.n_layers * 12
    assert torch.equal(got, run())
    with torch.no_grad():
        full = ED.decoder_forward(qa, params, cfg, toks, ED.encode(qa, params, cfg, src,
                                                                   attn_chunk=40))[:, -1]
    assert float((got - full).abs().max()) < 0.05 * float(full.abs().max())


def test_vlm_decode_on_the_card(cuda):
    """Reduced qwen2-vl decoding embeddings with 3-D positions (text, a
    2 × 2 grid, text) through the fused serve step: the last logits within
    the prefill ≡ decode bound of ``forward_logits`` on the same batch."""
    from repro_torch.core.qarith import QArith
    from repro_torch.data.synthetic import vlm_positions
    from repro_torch.train.step import make_serve_step
    policy = get_policy("bf16_standard")
    cfg = R.get_config("qwen2-vl-7b").reduced()
    params = R.init(cfg, 0, policy.param_dtype)
    mp = vlm_positions(2, 2, 2, 2, device=cuda)
    emb = torch.randn((2, 8, cfg.d_model), generator=torch.Generator(device=cuda).manual_seed(4),
                      device=cuda)
    step = make_serve_step(cfg, policy, fused_decode=True, return_logits=True)
    with torch.no_grad():
        cache = R.make_cache(params, cfg, batch_size=2, max_len=8)
        for t in range(8):
            _, logits, cache = step(params, cache, emb[:, t:t + 1],
                                    torch.full((2,), t, dtype=torch.int32, device=cuda),
                                    mrope_positions=mp[:, :, t:t + 1])
        full = R.forward_logits(QArith(policy), params, cfg,
                                {"embeds": emb, "mrope_positions": mp})[:, -1]
    assert float((logits - full).abs().max()) < 0.05 * float(full.abs().max())
