"""Serving launcher: continuous-batching engine over a synthetic stream
(port of ``repro.launch.serve``, the flags of the ported features).

Drives :class:`repro_torch.serve.engine.Engine` with open-loop Poisson
arrivals (exponential inter-arrival gaps measured in engine iterations)
and mixed prompt/generation lengths, then prints throughput and slot
statistics. Runs on CUDA unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --policy bf16_standard --max-len 256 --fused-decode

``--arch`` takes every decoder-only architecture of the registry, qwen2-vl
included (text tokens: standard RoPE, as the reference's launcher serves
it); the engine refuses whisper-base, which decodes in lock-step
(``registry.make_cache(batch=...)``). Mamba and the RG-LRU hybrid decode
one token per step (no ``--prefill-chunk``, no prefix cache):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --reduced \\
        --device cpu

Paged KV pool + chunked prefill + prefix cache (the prefix cache is on by
default with ``--paged``; ``--no-prefix-cache`` turns it off):

    PYTHONPATH=src python -m repro_torch.launch.serve --paged --page-size 16 \\
        --prefill-chunk 32 --fused-decode
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced \\
        --device cpu --paged --page-size 16 --n-pages 24 --prefill-chunk 8

Sampled decoding for every request (temperature, then top-k, then top-p;
each token keyed by the sample seed, the request id and its position, so
runs and preemption recomputes reproduce their tokens):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced \\
        --device cpu --temperature 0.8 --top-k 50 --top-p 0.95 --sample-seed 1

On a ``(data, model)`` mesh of processes (``--data-parallel D
--model-parallel M`` under ``repro_torch.launch.dist_launch -n D*M``; no
mesh without ``--data-parallel``, as the reference's launcher): the
weights are drawn whole from ``--seed`` and each rank keeps its shards
(``partition.param_specs``), the slots split over the data ranks and the
kv heads over the model ranks. A model axis above 1 serves every
decoder-only family (qwen2.5, yi, mistral-nemo, command-r, qwen2-vl's
text; the MoE families, each expert's FFN width split; falcon-mamba,
``d_inner`` split; recurrentgemma, the RG-LRU channels split) and runs its
step eagerly, head counts it does not divide included (recurrentgemma's
one kv head and, on 4 ranks, its 10 query heads padded to 12; qwen2.5's 2
kv heads on 4); channel widths the axis does not divide are ROADMAP A12
(whisper decodes in lock-step on the axis through
``registry.make_cache(batch=, mesh=)``). ``--paged`` with a data axis
above 1 shards the page rows over the data ranks and moves the rows each
rank's lanes read through the page exchange (``dist/pages.py``); each
rank prints its pool MiB, its rows and the exchange's collectives and
bytes per step. Several ranks share one card with ``--dist-backend gloo``:

    PYTHONPATH=src python -m repro_torch.launch.dist_launch -n 2 -- \\
        python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced --device cpu \\
        --data-parallel 1 --model-parallel 2 --fused-decode
    python -m repro_torch.launch.dist_launch -n 4 -- python -m repro_torch.launch.serve \\
        --data-parallel 2 --model-parallel 2 --dist-backend gloo --fused-decode
    PYTHONPATH=src python -m repro_torch.launch.dist_launch -n 2 -- \\
        python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced --device cpu \\
        --paged --data-parallel 2
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.policy import get_policy
from repro_torch.dist import fsdp as F
from repro_torch.dist import multihost as MH
from repro_torch.dist import partition as PT
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import registry as R
from repro_torch.serve.engine import Completion, Engine
from repro_torch.serve.sampling import validate_sampling
from repro_torch.tree import tree_leaves


def synthetic_stream(rng: np.random.Generator, n_requests: int, *,
                     rate: float, prompt_lens: tuple[int, int],
                     gen_lens: tuple[int, int], vocab: int):
    """(arrival_step, prompt, max_new) triples with Poisson arrivals.

    ``rate`` is requests per engine iteration; prompt/generation lengths
    are drawn uniformly from their (lo, hi) ranges — the mixed-length
    traffic that makes static batching pay for its stragglers.
    """
    t = 0.0
    out = []
    for _ in range(n_requests):
        t += rng.exponential(1.0 / max(rate, 1e-9))
        s0 = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        gen = int(rng.integers(gen_lens[0], gen_lens[1] + 1))
        prompt = rng.integers(0, vocab, size=s0).astype(np.int32)
        out.append((int(t), prompt, gen))
    return out


@dataclasses.dataclass
class StreamResult:
    completions: list[Completion]
    arrivals: dict[int, int]       # rid → arrival step
    calls: int                     # engine.step() calls (= serve-step calls)
    seconds: float                 # host wall time, ending in a device sync


def serve_stream(engine: Engine, stream, sampling=None) -> StreamResult:
    """Feed ``stream`` to ``engine`` open-loop until drained. An engine
    iteration with nothing to do (a gap between arrivals) advances the
    step clock without calling the serve step. ``sampling(i)`` gives the
    ``submit`` keywords (temperature, top_k, top_p, seed) of the stream's
    request ``i``; without it every request is greedy."""
    t0 = time.perf_counter()
    completions, arrivals, queued, calls = [], {}, 0, 0
    while queued < len(stream) or engine.has_work():
        while queued < len(stream) and stream[queued][0] <= engine.stats.steps:
            arrive, prompt, gen = stream[queued]
            kw = sampling(queued) if sampling is not None else {}
            arrivals[engine.submit(prompt, gen, **kw)] = arrive
            queued += 1
        if not engine.has_work():      # open-loop gap: idle until next arrival
            engine.stats.steps += 1
            engine.stats.slot_steps += engine.pool.n_slots
            continue
        completions.extend(engine.step())
        calls += 1
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return StreamResult(completions, arrivals, calls, time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="bf16_sr")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=1.0,
                    help="Poisson arrival rate, requests per engine step")
    ap.add_argument("--prompt-lens", type=int, nargs=2, default=(4, 12))
    ap.add_argument("--gen-lens", type=int, nargs=2, default=(4, 48))
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the request stream")
    ap.add_argument("--fused-decode", action="store_true",
                    help="the serve step through the hand-written kernels: "
                         "decode attention via the CUDA kernel (parked lanes "
                         "skipped) and, on CUDA, the dense products via qmatmul, "
                         "RMSNorm's mean via row_mean_sq and a prefill chunk's "
                         "attention via the decode kernel, so chunked prefill "
                         "gives the unchunked tokens")
    ap.add_argument("--paged", action="store_true",
                    help="back full-context attention layers with the paged KV "
                         "pool (token-granular allocation via a per-lane block "
                         "table); token parity with the contiguous pool")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (with --paged)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="pool pages (default slots*ceil(max_len/page): byte "
                         "parity with the contiguous pool; lower it to "
                         "oversubscribe lanes per byte)")
    ap.add_argument("--prefill-chunk", type=int, default=1,
                    help="prompt tokens admitted per engine iteration (>1 = "
                         "chunked prefill, interleaved with decode)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for every request (0 = greedy, "
                         "the bitwise-parity path)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k largest logits (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="base sampling seed; each token's key is mixed from "
                         "(seed, rid, position), so runs and preemption "
                         "recomputes are reproducible")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable prompt-prefix page sharing (with --paged it "
                         "is on by default for attention-only full-context "
                         "stacks)")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="the mesh's data axis (0: no mesh); the slots split over it")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the mesh's model axis: tensor-parallel weights and kv heads")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the process group's backend (default: NCCL on CUDA, gloo on "
                         "the CPU; gloo for several ranks sharing one card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    try:
        validate_sampling(args.temperature, args.top_k, args.top_p)
    except ValueError as e:
        ap.error(str(e))

    device = resolve_device(args.device)
    policy = get_policy(args.policy)
    cfg = R.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = None
    if args.data_parallel:
        MH.initialize(device=device, backend=args.dist_backend)
        mesh = make_local_mesh(args.data_parallel, args.model_parallel)
    try:
        _serve(args, cfg, policy, device, mesh, ap)
    finally:
        MH.shutdown()


def _serve(args, cfg, policy, device, mesh, ap):
    params = R.init(cfg, args.seed, policy.param_dtype, device=device)
    if mesh is not None:
        params = F.shard_state(params, PT.param_specs(params, cfg, mesh), mesh)
        if device.type == "cuda":      # ranks may share the card: free the whole tree
            torch.cuda.empty_cache()
    engine = Engine(params, cfg, policy, n_slots=args.slots,
                    max_len=args.max_len, eos_id=args.eos_id,
                    fused_decode=args.fused_decode, paged=args.paged,
                    page_size=args.page_size, n_pages=args.n_pages,
                    prefill_chunk=args.prefill_chunk,
                    prefix_cache=False if args.no_prefix_cache else None,
                    device=device, mesh=mesh)

    rng = np.random.default_rng(args.seed)
    # every request must fit the pool: clamp generation lengths to what the
    # longest prompt leaves room for, and reject impossible flag combos
    hi = min(args.gen_lens[1], args.max_len - args.prompt_lens[1])
    if hi < 1:
        ap.error(f"--max-len {args.max_len} leaves no room to generate "
                 f"after a {args.prompt_lens[1]}-token prompt; raise "
                 f"--max-len or lower --prompt-lens")
    stream = synthetic_stream(rng, args.requests, rate=args.rate,
                              prompt_lens=tuple(args.prompt_lens),
                              gen_lens=(min(args.gen_lens[0], hi), hi),
                              vocab=cfg.vocab)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    knobs = dict(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                 seed=args.sample_seed)
    layout = (f"paged page={args.page_size} pages={engine.pool.n_pages}"
              if args.paged else "contiguous")
    if mesh is not None:
        weight = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        mode = ("eager steps (model group)" if engine.axis else
                "eager steps (page exchange)" if engine.pages else "graphs on CUDA")
        print(f"[serve] rank {MH.process_index()} of mesh {mesh.shape}: slots "
              f"{engine.pool.slots[0]}..{engine.pool.slots[1] - 1}, weights "
              f"{weight / 2**20:.1f} MiB, KV {engine.pool.nbytes() / 2**20:.1f} MiB; "
              f"{mode}",
              flush=True)
    if not MH.is_primary():
        serve_stream(engine, stream, lambda i: knobs)
        _print_exchange(engine)
        return
    print(f"[serve] {cfg.name} policy={policy.name} slots={args.slots} "
          f"max_len={args.max_len} kv_dtype={engine.pool.dtype} {layout} "
          f"pool={engine.pool.nbytes() / 2**20:.1f} MiB chunk={args.prefill_chunk} "
          f"fused_decode={args.fused_decode} device={where}")
    if args.temperature > 0:
        print(f"[serve] sampling: temperature={args.temperature} top_k={args.top_k} "
              f"top_p={args.top_p} seed={args.sample_seed}")
    res = serve_stream(engine, stream, lambda i: knobs)
    st = engine.stats
    print(f"[serve] {st.finished}/{args.requests} finished in {st.steps} "
          f"steps, {res.calls} serve-step calls ({res.seconds:.2f}s on {where})")
    print(f"[serve] {st.tokens_generated} tokens generated → "
          f"{st.tokens_generated / res.seconds:.1f} tok/s on {where}; KV "
          f"utilization {st.utilization:.1%} (live tokens / pool capacity); "
          f"lane occupancy {st.lane_occupancy:.1%} (prefill share "
          f"{st.prefill_slot_steps / max(st.active_slot_steps, 1):.1%})")
    if args.paged:
        print(f"[serve] pages: {engine.pool.n_pages} total, "
              f"{st.kv_pages_live} live at drain; {st.preemptions} preemptions")
        if engine.prefix_cache:
            print(f"[serve] prefix cache: {st.prefix_hits} hits, "
                  f"{st.prefix_tokens_reused} prefill tokens skipped; "
                  f"{engine.pool.n_cached_pages} pages indexed at drain")
    if res.completions:
        lat = np.asarray([c.finished_step - c.admitted_step for c in res.completions])
        tf = np.asarray([c.first_token_step - res.arrivals[c.rid]
                         for c in res.completions])
        print(f"[serve] latency (engine steps): p50={np.percentile(lat, 50):.0f} "
              f"p95={np.percentile(lat, 95):.0f} max={lat.max()}; "
              f"TTFT p50={np.percentile(tf, 50):.0f} "
              f"p99={np.percentile(tf, 99):.0f}")
    for c in res.completions[:4]:
        print(f"  rid={c.rid} {c.finish_reason:6s} prompt={c.prompt.size:3d} "
              f"gen={c.tokens.size:3d} tokens={c.tokens[:8].tolist()}…")
    _print_exchange(engine)


def _print_exchange(engine: Engine) -> None:
    """A paged pool on a data axis: this rank's pool, its page rows and
    the page exchange's collectives and bytes per step."""
    if engine.pages is None:
        return
    st, pool = engine.pages.stats, engine.pool
    steps = max(st.steps, 1)
    print(f"[serve] rank {MH.process_index()} pages: rows {pool.rows[0]}..{pool.rows[1] - 1} of "
          f"{pool.n_rows}, pool {pool.nbytes() / 2**20:.2f} MiB (page leaves "
          f"{pool.page_nbytes() / 2**20:.2f} of {pool.global_page_nbytes() / 2**20:.2f}); "
          f"exchange {st.calls / steps:.2f} collectives and {st.bytes / steps:.0f} bytes per "
          f"step over {st.steps} steps ({st.rows_sent} rows, {st.cells_sent} cells sent), "
          f"working buffers peak {st.work_peak_bytes / 2**20:.2f} MiB", flush=True)


if __name__ == "__main__":
    main()
