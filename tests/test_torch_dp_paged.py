"""Paged pools under a data axis above 1 (ROADMAP A12 item 3) on the CPU:
the port's ``Engine(paged=True, mesh=)`` on gloo ranks, its page rows
sharded over the data ranks and moved by the page exchange
(``repro_torch.dist.pages``), against the reference's sharded paged engine
on an ``Auto`` mesh and against one process.

Reduced qwen2.5-3b from the reference's weights, ``bf16_standard``, the
stream of ``tests/test_serve.py``'s sharded paged engine test (rng 15, 6
requests), 4 slots, ``max_len`` 24, pages of 4, 12 pages, chunk 1 and 4:

* the port's 2 x 1 tokens equal the reference's (2, 1) engine's
  (``fused_decode=False``; its fused paged kernel is C1), and its 2 x 2
  tokens share at least ``TOKEN_AGREEMENT`` with the reference's (2, 2)
  (the model axis's rounding, C18);
* 2 x 1 ≡ one process and 2 x 2 ≡ 1 x 2, bitwise: tokens, the engine's
  stats, and the owned rows of every paged leaf gathered in data-rank
  order (rows ``[0, n_pages)``: the null row takes dropped writes);
* a stream behind a shared prefix on a tight pool makes, and counts, a
  copy-on-write across ranks, a recycled page of another rank than its
  lane's, a prefix hit and a preemption across ranks and lanes whose
  tables name rows of both ranks, bitwise one process's at chunk 1 and 4;
* 3 slots on 2 x 1 (every rank computes every lane; the rows still shard,
  the exchange still runs), reduced mixtral (MoE) and recurrentgemma (its
  RG-LRU state and local-attention ring split by slot) ≡ one process;
* each rank's page leaves are 1/D of one process's pool padded to the
  sharded row count; the exchange's collectives and bytes equal its plans';
* ``launch.serve --paged --data-parallel 2`` under ``dist_launch`` prints
  one process's tokens.
"""
import dataclasses
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from _torch_ranks import ROOT, rank_env, start_ranks, wait_ranks
from repro_torch.dist import pages as PG
from repro_torch.dist import partition as PT
from repro_torch.launch.mesh import Mesh
from repro_torch.models import registry as R
from test_torch_tp_serve import TOKEN_AGREEMENT

WORKER = str(Path(__file__).resolve().parent / "_torch_tp_worker.py")
TIMEOUT = 300

REF_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[2])
    import numpy as np
    import jax
    from jax.sharding import AxisType, NamedSharding
    from repro.core import get_policy
    from repro.dist import partition as PT
    from repro.models import registry as R
    from repro.serve import Engine
    import _torch_tp_worker as W

    policy = get_policy(W.POLICY)
    cfg = R.get_config(W.ARCH).reduced()
    params = R.init(cfg, jax.random.PRNGKey(0), policy.param_dtype)
    saved = {}
    for shape in ((2, 1), (2, 2)):
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        named = lambda tree: jax.tree_util.tree_map(                     # noqa: E731
            lambda s: NamedSharding(mesh, s), tree,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        p = jax.device_put(params, named(PT.param_specs(params, cfg, mesh)))
        for chunk in (1, 4):
            eng = Engine(p, cfg, policy, n_slots=W.DP_SLOTS, max_len=W.MAX_LEN, mesh=mesh,
                         paged=True, page_size=W.DP_PAGE, n_pages=W.DP_PAGES,
                         prefill_chunk=chunk, fused_decode=False)
            for prompt, gen in W.dp_requests(cfg.vocab):
                eng.submit(prompt, gen)
            for c in eng.run():
                saved[f"{shape[0]}x{shape[1]}_{chunk}_{c.rid}"] = np.asarray(c.tokens)
            saved[f"{shape[0]}x{shape[1]}_{chunk}_rows"] = np.asarray(eng.pool.n_rows)
    np.savez(sys.argv[1] + "/ref.npz", **saved)
""")

LAUNCH = ["-m", "repro_torch.launch.serve", "--arch", "qwen2.5-3b", "--reduced", "--device",
          "cpu", "--paged", "--requests", "8", "--max-len", "48"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess, the port's 2- and 4-rank launches and
    the launcher on 2 ranks and in one process, all at once."""
    out = tmp_path_factory.mktemp("dp_paged")
    flags = ("--xla_force_host_platform_device_count=4 --xla_allow_excess_precision=false "
             "--xla_cpu_multi_thread_eigen=false")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(out), str(Path(WORKER).parent)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                           env=rank_env(XLA_FLAGS=flags, JAX_PLATFORMS="cpu"), cwd=ROOT)
    launcher = [subprocess.Popen([sys.executable, *pre, *LAUNCH, *post], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True, env=rank_env(), cwd=ROOT)
                for pre, post in ((["-m", "repro_torch.launch.dist_launch", "-n", "2", "--",
                                    sys.executable], ["--data-parallel", "2"]), ([], []))]
    env = rank_env(JAX_PLATFORMS="cpu")
    procs = [ref, *launcher]
    try:
        launches = [start_ranks(WORKER, ["dp_paged_quad", str(out)], 4, out / "quad_logs",
                                TIMEOUT, env),
                    start_ranks(WORKER, ["dp_paged", str(out)], 2, out / "pair_logs", TIMEOUT,
                                env)]
        procs += [x[0] for x in launches]
        for launch in launches:
            wait_ranks(launch)
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in (ref, *launcher)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip((ref, *launcher), logs):
        assert p.returncode == 0, log[-4000:]
    pair = [torch.load(out / f"rank{r}_dp_paged.pt", weights_only=False) for r in range(2)]
    quad = [torch.load(out / f"rank{r}_dp_paged_quad.pt", weights_only=False) for r in range(4)]
    return dict(np.load(out / "ref.npz")), pair, quad, logs[1:]


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[r], b[r]) for r in a)


def _one(pair) -> dict:
    """The one-process runs, split between the two ranks."""
    return {**pair[0]["one"], **pair[1]["one"]}


def _gathered(parts: list, key: str, upto: int) -> torch.Tensor:
    """Leaf ``key``'s rows ``[0, upto)`` of the ranks' pools, in data order."""
    dim = 1 if key.startswith("layers.") else 0
    return torch.cat([p["pages"][key] for p in parts], dim=dim).narrow(dim, 0, upto)


def _rows_equal(parts: list, whole: dict, n_pages: int) -> bool:
    """The data ranks' owned rows of every paged leaf, gathered, equal the
    whole pool's rows ``[0, n_pages)``."""
    assert whole["pages"].keys() == parts[0]["pages"].keys() and whole["pages"]
    return all(torch.equal(_gathered(parts, k, n_pages), _gathered([whole], k, n_pages))
               for k in whole["pages"])


# -- partition and the exchange's plan (no ranks) -------------------------

def test_page_rows_and_the_lifted_refusal():
    """Rows split into contiguous equal shares, the null row on the last
    data rank; ``serve_refusal`` serves a paged pool on (2, 1) and (2, 2)
    and still refuses a channel width the model axis does not divide."""
    mesh = Mesh(("data", "model"), (2, 2))
    assert [PT.page_rows(14, mesh, d) for d in range(2)] == [(0, 7), (7, 14)]
    assert PT.page_rows(14, None) == (0, 14)
    assert PT.page_rows(13, Mesh(("data", "model"), (1, 2))) == (0, 13)
    with pytest.raises(ValueError, match="do not split"):
        PT.page_rows(13, mesh)
    cfg = R.get_config("qwen2.5-3b").reduced()
    for sizes in ((2, 1), (2, 2)):
        assert PT.serve_refusal(cfg, Mesh(("data", "model"), sizes)) is None
    narrow = dataclasses.replace(cfg, d_ff=cfg.d_ff + 1)
    assert "item 2" in PT.serve_refusal(narrow, mesh)


def _plan(index: int, table, *, reset=(), copies=(), positions=None, lanes=((0, 2), (2, 4)),
          copy_width=None):
    ex = PG.PageExchange(Mesh(("data", "model"), (2, 1)), 8, 4, list(lanes), index=index)
    table = np.asarray(table, np.int32)
    page_reset = np.zeros((8,), bool)
    page_reset[list(reset)] = True
    if positions is None:
        positions = np.full((table.shape[0], 1), -1, np.int32)
    return ex.plan(table, page_reset, list(copies), np.asarray(positions, np.int32),
                   copy_width=copy_width)


def test_exchange_plan_on_hand_made_tables():
    """8 rows on 2 data ranks (rank 0 owns 0-3, rank 1 owns 4-7, the null
    row 7), lanes 0-1 on rank 0 and 2-3 on rank 1. Each row a rank's lanes
    name and another rank owns is sent once; a recycled row is sent by
    nobody; a copy-on-write destination reads its source; the owner of a
    destination whose source lies elsewhere receives the source row; the
    cells a lane writes into another rank's row go to that rank, a write
    aimed at the null row nowhere."""
    table = [[0, 5, 7], [5, 6, 7],     # rank 0's lanes: rows 5, 6 are rank 1's
             [1, 4, 7], [2, 7, 7]]     # rank 1's lanes: rows 1, 2 are rank 0's
    # row 2 is recycled this step; lane 1 copies row 3 into its row 6
    # and writes position 5 (row 6, cell 1); lane 2 writes row 1 (cell 1),
    # lane 3 the recycled row 2 (cell 0); lane 0's position 9 is unmapped
    step = dict(reset=(2,), copies=[(6, 3)], positions=[[9], [5], [1], [0]])
    p0, p1 = _plan(0, table, **step), _plan(1, table, **step)
    # rank 0's working rows: 0 (its own), 5 (from rank 1), 6 (a copy of its
    # own row 3, read locally), then the null row
    assert p0.work.tolist() == [0, 5, 6]
    assert p0.table.tolist() == [[0, 1, 3], [1, 2, 3]]
    assert p0.local_at.tolist() == [0, 2] and p0.local_from.tolist() == [0, 3]
    assert p0.recv_at[1] == [1] and p0.recv_rows == [0, 1]
    # rank 0 sends rank 1 row 1 (named by lane 2) and row 3 (the source of
    # the copy into rank 1's row 6), never the recycled row 2
    assert p0.send_rows[1] == [1, 3] and p1.recv_rows == [2, 0] and p1.send_rows[0] == [1]
    assert p1.work.tolist() == [1, 2, 4] and p1.local_at.tolist() == [2]
    assert p1.recv_at[0] == [0]                   # row 2 (working row 1) starts empty
    assert p1.copy_in[0] == ([2], [1])            # its row 6 <- rank 0's second row
    # the pair crosses ranks: neither rank's local copy lists hold it
    assert p0.copy_dst.size == 0 and p1.copy_dst.size == 0
    # a pair of rank 0's own rows goes to its local lists (rows 2 <- 0), at
    # the step's static width: padded with the same pair again, or with the
    # local row count (4: copies nothing) when there is none
    own = _plan(0, table, copies=[(2, 0)], copy_width=3)
    assert own.copy_dst.tolist() == [2, 2, 2] and own.copy_src.tolist() == [0, 0, 0]
    assert _plan(1, table, copies=[(2, 0)], copy_width=3).copy_dst.tolist() == [4, 4, 4]
    assert p0.out_at[1] == [2] and p0.out_off[1] == [1]
    assert p1.in_row[0] == [2] and p1.in_off[0] == [1]
    assert p1.out_at[0] == [0, 1] and p1.out_off[0] == [1, 0]
    assert p0.in_row[1] == [1, 2] and p0.in_off[1] == [1, 0]
    assert p0.pull and p0.push and (p0.sent_rows, p0.sent_cells) == (2, 1)
    assert p0.cell_row.size == 0 and p1.cell_row.size == 0
    # every lane on both ranks (slots the data size does not divide): rows
    # still move, written cells never cross (each owner computes every lane)
    both = _plan(0, table, lanes=((0, 4), (0, 4)), **step)
    assert both.work.tolist() == [0, 1, 2, 4, 5, 6] and both.send_rows[1] == [0, 1, 3]
    assert not both.push and both.cell_row.tolist() == [1, 2]
    # nothing foreign named, nothing written: no collective at all
    idle = _plan(0, [[0, 7, 7], [1, 7, 7], [4, 7, 7], [5, 7, 7]])
    assert not idle.pull and not idle.push


# -- the ranks ------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 4])
def test_2x1_tokens_equal_the_reference(runs, chunk):
    ref, pair, _, _ = runs
    want = {r: ref[f"2x1_{chunk}_{r}"] for r in range(6)}
    for res in pair:
        assert _equal(res[f"dp_ref_{chunk}"]["tokens"], want)
        assert res[f"dp_ref_{chunk}"]["n_rows"] == int(ref[f"2x1_{chunk}_rows"]) == 14


@pytest.mark.parametrize("chunk", [1, 4])
def test_2x2_tokens_agree_with_the_reference(runs, chunk):
    ref, _, quad, _ = runs
    want = {r: ref[f"2x2_{chunk}_{r}"] for r in range(6)}
    for res in quad:
        got = res[f"ref_{chunk}"]["tokens"]
        same = sum(int((got[r] == want[r]).sum()) for r in want)
        total = sum(want[r].size for r in want)
        assert total == 42 and same >= TOKEN_AGREEMENT * total, (same, total)


@pytest.mark.parametrize("case", ["ref_1", "ref_4", "forced_1", "forced_4", "slots_3",
                                  "mixtral-8x22b", "recurrentgemma-2b"])
def test_2x1_equals_one_process_bitwise(runs, case):
    """Tokens, steps, preemptions, prefix hits and skipped tokens, and the
    owned rows of every paged leaf gathered in data order."""
    _, pair, _, _ = runs
    one = _one(pair)[case]
    for res in pair:
        got = res[f"dp_{case}"]
        assert _equal(got["tokens"], one["tokens"]) and got["stats"] == one["stats"]
    assert _rows_equal([res[f"dp_{case}"] for res in pair], one, one["n_rows"] - 1)


@pytest.mark.parametrize("chunk", [1, 4])
def test_2x2_equals_1x2_bitwise(runs, chunk):
    _, pair, quad, _ = runs
    for m in range(2):
        whole = pair[m][f"tp_ref_{chunk}"]
        parts = sorted((q for q in quad if q["coords"]["model"] == m),
                       key=lambda q: q["coords"]["data"])
        assert [p["coords"]["data"] for p in parts] == [0, 1]
        for p in parts:
            assert _equal(p[f"ref_{chunk}"]["tokens"], whole["tokens"])
            assert p[f"ref_{chunk}"]["stats"] == whole["stats"]
        assert _rows_equal([p[f"ref_{chunk}"] for p in parts], whole, whole["n_rows"] - 1)


@pytest.mark.parametrize("chunk", [1, 4])
def test_forced_stream_crosses_ranks(runs, chunk):
    _, pair, _, _ = runs
    got = pair[0][f"dp_forced_{chunk}"]
    assert got["cross"] == pair[1][f"dp_forced_{chunk}"]["cross"]
    assert all(n >= 1 for n in got["cross"].values()), got["cross"]
    steps, preemptions, hits, reused = got["stats"]
    assert preemptions >= 1 and hits >= 1 and reused >= 1


def test_slots_the_data_size_does_not_divide(runs):
    """3 slots on 2 data ranks: every rank computes every lane (no token
    gather, no written cell crosses), and the rows still shard and move."""
    _, pair, _, _ = runs
    for res in pair:
        got = res["dp_slots_3"]
        assert got["slots"] == (0, 3)
        assert got["rows"] == [(0, 7), (7, 14)][res["coords"]["data"]]
        assert got["exchange"]["cells_sent"] == 0 and got["exchange"]["rows_sent"] > 0


@pytest.mark.parametrize("case", ["ref_1", "forced_4", "recurrentgemma-2b"])
def test_pool_bytes_and_exchange_counts(runs, case):
    """Each rank's page leaves are 1/2 of one process's pool padded to the
    sharded row count; the exchange made its plans' collectives and
    handed them its plans' bytes (rows sent times the row's bytes, plus
    the cells written into other ranks' rows)."""
    _, pair, _, _ = runs
    one = _one(pair)[case]
    for res in pair:
        got = res[f"dp_{case}"]
        assert 2 * got["page_nbytes"] == got["global_page_nbytes"]
        assert got["global_page_nbytes"] * one["n_rows"] == one["page_nbytes"] * got["n_rows"]
        ex = got["exchange"]
        assert ex["calls"] == ex["planned_calls"] and 0 < ex["calls"] <= 2 * ex["steps"]
        assert ex["bytes"] == ex["planned_bytes"] > 0


def test_launcher_serves_paged_on_a_data_axis(runs):
    *_, (ranks, one) = runs
    tokens = lambda log: re.findall(r"rid=\d+ .*tokens=\[[^\]]*\]", log)   # noqa: E731
    assert len(tokens(one)) == 4 and tokens(ranks) == tokens(one)
    assert len(re.findall(r"\[serve\] rank \d pages: rows", ranks)) == 2
    assert "collectives and" in ranks
