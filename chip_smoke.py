#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing its lines (a failed check exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the four CUDA kernels (decode attention, ``sr_cast``,
   ``fused_adamw``, ``fused_sgd``), built from this checkout with one
   ``nvcc`` per source at once; nvcc time, registers and spills;
3. kernel: the decode kernel against its plain PyTorch version at the
   serving path's shapes (B=8 lanes, 16/2 heads, D=128, bf16, Sc 256 and
   2048): mixed depths, two parked lanes (exact zeros), window 64 +
   softcap 30; its time beside its bound, the plain version's time and
   ``scaled_dot_product_attention``'s (a yardstick the port never calls);
4. serve (main path of serving): full-width qwen2.5-3b (36 layers, random
   weights from a seed) served by the continuous-batching engine with the
   fused decode kernel — 12 requests from the synthetic stream; every
   request must finish, the kernel must have launched 36 times per
   serve-step call, and the tokens must equal the port's ``generate``
   (same kernel, batched to the engine's 8 rows) bit for bit; then a
   profile of steady-state serve steps;
5. update kernels: ``sr_cast`` (with ±inf, NaN and near-max lanes),
   ``fused_adamw`` and ``fused_sgd`` (nearest or SR × Kahan off or on)
   against their plain versions on one int32 bits tensor, at a ragged
   n = 1,000,003 and at the embedding leaf's 151936×2048 elements: every
   output ``torch.equal``; device time at the embedding size beside the
   bytes bound and the plain version's time (no single PyTorch call
   computes these updates, so there is no library time);
6. train (main path of training): full-width qwen2.5-3b trained through
   the launcher's own functions, ``--policy bf16_sr_kahan --fused-update
   --batch 2 --seq 2048``, 8 steps at lr 3e-3: every loss finite, the
   last below step 0's, ``fused_adamw`` launched once per parameter leaf
   per step; ms per step, tokens per second, the optimizer's ms per step
   (CUDA events) beside its bound, peak device memory; then one more step
   under the profiler (device time, idle share, top kernels);
7. update parity (main path of the non-fused optimizer and of fused
   SGD): from the trained state and one fresh gradient, one step of
   ``adamw`` against ``fused_adamw_optimizer`` and of ``sgd`` against
   ``fused_sgd_optimizer`` with the same per-leaf bits, leaf by leaf:
   params, moments and Kahan buffers bitwise equal on every leaf, and
   ``sr_cast`` launched by the non-fused path; then whether the card's
   embedding backward (``index_put_`` with accumulation, bf16) equals the
   CPU's bf16 scatter-add.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, it exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# kernel vs plain version on the f32 output: both sum in f32 in different
# orders, and an f32-ulp difference can flip the bf16 rounding of one p —
# a bf16-ulp-level difference, far below this bound
ATOL = RTOL = 1e-2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12    # H100 SXM data sheet, dense bf16
B, HQ, HKV, D = 8, 16, 2, 128
MAIN_SC = 256               # the engine's max_len below
KERNELS = ("decode_attention", "sr_cast", "fused_adamw", "fused_sgd")
EMBED_N = 151936 * 2048     # the embedding leaf of qwen2.5-3b
# bytes per element each update kernel must move in its main-path variant
# (SR + Kahan): every bf16 input read once, bits read once, outputs written
UPDATE_BYTES = {"sr_cast": 4 + 4 + 2,                       # x f32, bits; out bf16
                "fused_adamw": 5 * 2 + 4 + 4 * 2,           # w m v g c, bits; w m v c
                "fused_sgd": 4 * 2 + 4 + 3 * 2}             # w m g c, bits; w m c
TRAIN_ARGV = ["--arch", "qwen2.5-3b", "--policy", "bf16_sr_kahan", "--fused-update",
              "--batch", "2", "--seq", "2048", "--steps", "8", "--lr", "3e-3",
              "--seed", "0", "--device", "cuda"]


def fail(msg: str):
    print(f"[smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def time_ms(fns, calls: int = 64) -> float:
    """Device time per call: ``calls`` calls cycling over ``fns`` (one per
    input copy, so the working set exceeds the 50 MB L2 as it does between
    a layer's uses on the serving path), captured in a CUDA graph so host
    overhead is not measured, replayed and timed with CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def host_us(fn, calls: int = 200) -> float:
    """Host time per call to enqueue ``fn`` (Python, checks, launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def phase_card() -> str:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load_all(KERNELS)
    print(f"[build] {len(KERNELS)} kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f}s wall (one nvcc per source, in parallel)")
    for name in KERNELS:
        info = _build.builds[name]
        print(f"[build] {name}: nvcc {info.seconds:.2f}s -> {info.path.name}")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build]   {line.strip()}")


def _inputs(Sc: int, seed: int, *, parked=(), window=None, softcap=None):
    """Decode inputs on the card: lane depths mixed over the cache; cells
    0..depth hold positions, the rest are empty (−1)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    q = torch.randn((B, 1, HQ, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Sc, HKV, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Sc, HKV, D), generator=g, device=dev).to(torch.bfloat16)
    depth = torch.linspace(Sc // 8, Sc - 1, B, device=dev).to(torch.int32)
    cells = torch.arange(Sc, device=dev, dtype=torch.int32)[None, :]
    k_pos = torch.where(cells <= depth[:, None], cells, -1).to(torch.int32).contiguous()
    q_pos = depth.clone()
    for lane in parked:
        q_pos[lane] = -1
    return dict(q=q, k=k, v=v, k_pos=k_pos, q_pos=q_pos, window=window, softcap=softcap)


def _bound_ms(x) -> tuple[float, str]:
    """Least time for this input: bytes of q, k_pos, q_pos and the K/V rows
    of unmasked cells of active lanes read once plus out written, against
    HBM; 4·D flops per (query head, unmasked cell) against bf16 peak."""
    kp, qp = x["k_pos"], x["q_pos"][:, None]
    ok = (kp >= 0) & (kp <= qp) & (qp >= 0)
    if x["window"] is not None:
        ok &= qp - kp < x["window"]
    n_cells = int(ok.sum())
    n_active = int((x["q_pos"] >= 0).sum())
    Sc = kp.shape[1]
    nbytes = (n_active * HQ * D * 2 + n_active * Sc * 4 + B * 4
              + n_cells * HKV * D * 2 * 2 + B * HQ * D * 4)
    flops = n_cells * HQ * 4 * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA

    def call(fn, x):
        return fn(x["q"], x["k"], x["v"], x["k_pos"], x["q_pos"], window=x["window"],
                  softcap=x["softcap"], p_dtype=torch.bfloat16)

    max_err, row = 0.0, None
    for Sc in (MAIN_SC, 2048):
        cases = {"mixed": _inputs(Sc, 0),
                 "parked": _inputs(Sc, 1, parked=(1, 5)),
                 "window+softcap": _inputs(Sc, 2, window=64, softcap=30.0)}
        for name, x in cases.items():
            got = call(DA.fused_decode_attention, x)
            want = call(DA.decode_attention_ref, x)
            torch.cuda.synchronize()
            check(got.dtype == torch.float32 and got.shape == (B, 1, HQ, D),
                  f"kernel output {got.dtype} {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"Sc={Sc} {name}: non-finite output")
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            check(torch.allclose(got, want, atol=ATOL, rtol=RTOL),
                  f"Sc={Sc} {name}: kernel vs plain max |err| {err}")
            for lane in range(B):
                if int(x["q_pos"][lane]) < 0:
                    check(bool((got[lane] == 0).all()),
                          f"Sc={Sc} parked lane {lane} is not exactly zero")
            print(f"[kernel] Sc={Sc} {name}: max |kernel - plain| {err:.3e} "
                  f"(atol=rtol={ATOL})")
        # timing: the mixed-depth case, copies rotated past the L2
        x = cases["mixed"]
        kv_bytes = 2 * x["k"].numel() * x["k"].element_size()
        copies = [x] + [{n: t.clone() if hasattr(t, "clone") else t for n, t in x.items()}
                        for _ in range(-(-64 * 2**20 // kv_bytes) - 1)]
        ms = time_ms([lambda c=c: call(DA.fused_decode_attention, c) for c in copies])
        plain_ms = time_ms([lambda c=c: call(DA.decode_attention_ref, c) for c in copies])

        def sdpa(c):
            allowed = ((c["k_pos"] >= 0) & (c["k_pos"] <= c["q_pos"][:, None]))[:, None, None, :]
            qt, kt, vt = c["q"].transpose(1, 2), c["k"].transpose(1, 2), c["v"].transpose(1, 2)
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                          enable_gqa=True)
        library_ms = time_ms([sdpa(c) for c in copies])
        enqueue_us = host_us(lambda: call(DA.fused_decode_attention, x))
        bound_ms, bound_by = _bound_ms(x)
        print(f"[kernel] Sc={Sc} mixed depths on {card}: kernel {ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {library_ms:.4f} ms (device time, "
              f"{len(copies)} input copies rotated); host enqueue {enqueue_us:.1f} us "
              f"per kernel call")
        if Sc == MAIN_SC:
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms}
    row["max_abs_err"] = max_err
    return row


def phase_main_path(card: str) -> int:
    import numpy as np
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_stream, synthetic_stream
    from repro_torch.models import registry as R
    from repro_torch.serve.decode import generate
    from repro_torch.serve.engine import Engine

    policy = get_policy("bf16_standard")
    cfg = R.get_config("qwen2.5-3b")
    n_slots, max_len = 8, MAIN_SC
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = R.init(cfg, 0, policy.param_dtype, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[main] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params ({policy.name}) initialised on the card "
          f"in {time.perf_counter() - t0:.2f}s; peak device memory during init "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    def engine():
        return Engine(params, cfg, policy, n_slots=n_slots, max_len=max_len,
                      fused_decode=True, device="cuda")

    warm = engine()                      # cuBLAS handles, kernel library load
    warm.submit(np.arange(4, dtype=np.int32), 2)
    warm.run()
    del warm

    stream = synthetic_stream(np.random.default_rng(0), 12, rate=1.0,
                              prompt_lens=(16, 64), gen_lens=(16, 48),
                              vocab=cfg.vocab)
    eng = engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    DA.LAUNCHES = 0
    res = serve_stream(eng, stream)
    launches = DA.LAUNCHES
    st = eng.stats
    check(st.finished == len(stream) == len(res.completions),
          f"{st.finished}/{len(stream)} requests finished")
    check(launches == cfg.n_layers * res.calls,
          f"kernel launches {launches} != {cfg.n_layers} x {res.calls} serve-step calls")
    check(all(c.tokens.size == gen for c, (_, _, gen) in zip(
        sorted(res.completions, key=lambda c: c.rid), stream)),
          "a request stopped short of its max_new_tokens")
    print(f"[main] on {card}: {len(stream)} requests, {st.steps} engine steps, "
          f"{res.calls} serve-step calls, {st.tokens_generated} tokens in "
          f"{res.seconds:.3f}s -> {st.tokens_generated / res.seconds:.1f} tok/s, "
          f"{1e3 * res.seconds / res.calls:.2f} ms per serve step, "
          f"{launches} kernel launches ({launches // res.calls} per step)")

    # the reference: lock-step generate through the same kernel, each batch
    # padded with dummy prompts to the engine's row count (cuBLAS picks its
    # GEMM by the row count, so rows agree bitwise only at equal counts)
    groups = {}
    for c in res.completions:
        groups.setdefault((c.prompt.size, c.tokens.size), []).append(c)
    with dispatch.fused_decode():
        for (s0, gen), cs in groups.items():
            rows = [c.prompt for c in cs]
            rows += [np.zeros(s0, np.int32)] * (n_slots - len(rows))
            ref = generate(params, cfg, policy, np.stack(rows), max_new_tokens=gen,
                           cache_len=max_len, device="cuda").cpu().numpy()
            for i, c in enumerate(cs):
                check(np.array_equal(ref[i, s0:], c.tokens),
                      f"rid {c.rid}: engine {c.tokens.tolist()} != generate "
                      f"{ref[i, s0:].tolist()}")
    toks = np.concatenate([c.tokens for c in res.completions])
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token out of vocab")
    print(f"[main] engine tokens == generate tokens for all {len(res.completions)} "
          f"requests ({len(groups)} reference batches of {n_slots} rows)")
    print(f"[main] peak device memory while serving and checking "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    phase_profile(eng, cfg, card)
    return launches


def phase_profile(eng, cfg, card: str, steps: int = 3):
    """Where a serve step's time goes: 8 lanes decoding in steady state,
    host wall time per step against the device time the profiler records
    for its kernels, kernel launches per step and the top kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    for _ in range(eng.pool.n_slots):
        eng.submit(rng.integers(0, cfg.vocab, size=32).astype(np.int32), 64)
    for _ in range(40):                   # past the prompts: every lane decodes
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in avgs if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in avgs if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                                      "cudaLaunchKernelExC")) / steps
    print(f"[profile] on {card}: {host_ms:.2f} ms host wall per serve step, "
          f"{device_ms:.2f} ms device kernel time per step (device idle "
          f"{max(0.0, 1 - device_ms / host_ms):.1%}), {launches:.0f} kernel launches per step")
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        print(f"[profile]   {dev_us(e) / 1e3 / steps:7.3f} ms/step  {e.count / steps:6.0f} "
              f"calls/step  {e.key[:90]}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:5]:
        print(f"[profile]   host {e.self_cpu_time_total / 1e3 / steps:7.3f} ms/step  "
              f"{e.count / steps:6.0f} calls/step  {e.key[:90]}")


def event_ms(fn, reps: int = 5) -> float:
    """Device time per call of ``fn`` by CUDA events over ``reps`` eager
    calls after one warm-up (inputs far larger than the 50 MB L2)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _equal(got, want) -> bool:
    """torch.equal on every lane, NaN lanes compared as NaN on both sides."""
    import torch
    nan = torch.isnan(want.float())
    return (torch.equal(torch.isnan(got.float()), nan)
            and torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16)))


def _update_inputs(n: int, seed: int) -> dict:
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(scale):
        return (torch.randn(n, generator=g, device="cuda") * scale).to(torch.bfloat16)
    return dict(w=r(1.0), m=r(0.1), v=r(0.1).abs(), g=r(1.0), c=r(2.0 ** -9),
                bits=torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device="cuda",
                                   dtype=torch.int32))


def phase_update_kernels(card: str) -> dict:
    """Each update kernel ≡ its plain version (torch.equal, every variant,
    two sizes); device time at the embedding leaf's size."""
    import torch
    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.kernels import fused_sgd as FS
    from repro_torch.kernels import sr_cast as SC

    hp_adam = dict(lr=1e-3, b1=0.8984375, b2=0.99609375, eps=1e-8, wd=0.01,
                   c1=0.8984375, c2=0.99609375)
    hp_sgd = dict(lr=0.1, momentum=0.9, wd=1e-4)
    variants = [(False, False), (True, False), (False, True), (True, True)]
    rows = {}
    for n in (1_000_003, EMBED_N):
        x = _update_inputs(n, n % 1000)
        # sr_cast: f32 input with ±inf, NaN and lanes near the top of the range
        xs = torch.randn(n, device="cuda") * 7
        xs[:6] = torch.tensor([float("inf"), float("-inf"), float("nan"), 3.3961e38,
                               -3.3961e38, 3.3895e38])
        ok = _equal(SC.sr_cast(xs, x["bits"]), SC.sr_cast_ref(xs, x["bits"]))
        check(ok, f"sr_cast n={n}: kernel != plain")
        print(f"[update] sr_cast n={n}: kernel == plain (torch.equal; inf/NaN/near-max lanes)")
        for stochastic, kahan in variants:
            tag = f"{'SR' if stochastic else 'nearest'}{'+Kahan' if kahan else ''}"
            bits = x["bits"] if stochastic else None
            want = FA.fused_adamw_ref(x["w"], x["m"], x["v"], x["g"],
                                      c=x["c"] if kahan else None, bits=bits,
                                      stochastic=stochastic, **hp_adam)
            got = [t.clone() for t in (x["w"], x["m"], x["v"], x["c"])]
            FA.fused_adamw(got[0], got[1], got[2], x["g"], c=got[3] if kahan else None,
                           bits=bits, stochastic=stochastic, **hp_adam)
            for name, a, b in zip("wmvc", got, want):
                if b is not None:
                    check(torch.equal(a, b), f"fused_adamw {tag} n={n}: {name} kernel != plain")
            del want, got
            want = FS.fused_sgd_ref(x["w"], x["m"], x["g"], c=x["c"] if kahan else None,
                                    bits=bits, stochastic=stochastic, **hp_sgd)
            got = [t.clone() for t in (x["w"], x["m"], x["c"])]
            FS.fused_sgd(got[0], got[1], x["g"], c=got[2] if kahan else None, bits=bits,
                         stochastic=stochastic, **hp_sgd)
            for name, a, b in zip("wmc", got, want):
                if b is not None:
                    check(torch.equal(a, b), f"fused_sgd {tag} n={n}: {name} kernel != plain")
            del want, got
            print(f"[update] fused_adamw, fused_sgd {tag} n={n}: kernel == plain on every "
                  f"output (torch.equal)")
        if n != EMBED_N:
            continue
        # timing at the embedding leaf, SR + Kahan (the main path's variant)
        w, m, v, c = (x[k].clone() for k in "wmvc")
        calls = {
            "sr_cast": (lambda: SC.sr_cast(xs, x["bits"]),
                        lambda: SC.sr_cast_ref(xs, x["bits"])),
            "fused_adamw": (lambda: FA.fused_adamw(w, m, v, x["g"], c=c, bits=x["bits"],
                                                   **hp_adam),
                            lambda: FA.fused_adamw_ref(x["w"], x["m"], x["v"], x["g"],
                                                       c=x["c"], bits=x["bits"], **hp_adam)),
            "fused_sgd": (lambda: FS.fused_sgd(w, m, x["g"], c=c, bits=x["bits"], **hp_sgd),
                          lambda: FS.fused_sgd_ref(x["w"], x["m"], x["g"], c=x["c"],
                                                   bits=x["bits"], **hp_sgd)),
        }
        for name, (kernel, plain) in calls.items():
            ms = event_ms(kernel)
            plain_ms = event_ms(plain, reps=2)
            bound_ms = n * UPDATE_BYTES[name] / HBM_BYTES_PER_S * 1e3
            rows[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
            print(f"[update] {name} n={n} SR+Kahan on {card}: kernel {ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({UPDATE_BYTES[name]} B/element over 3.35 TB/s; "
                  f"{bound_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, library: none")
        del x, xs, w, m, v, c
        torch.cuda.empty_cache()
    return rows


def phase_train(card: str):
    """Full-width training through the launcher's functions."""
    import numpy as np
    import torch
    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.kernels import fused_sgd as FS
    from repro_torch.kernels import sr_cast as SC
    from repro_torch.core.policy import get_policy
    from repro_torch.launch import train as LT
    from repro_torch.tree import tree_leaves

    args = LT.parse_args(TRAIN_ARGV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt_events = []
    opt = LT.make_optimizer(args, get_policy(args.policy))

    def timed_update(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = opt.update(*a, **kw)
        end.record()
        opt_events.append((start, end))
        return out

    run = LT.build(args, optimizer=dataclasses.replace(opt, update=timed_update))
    torch.cuda.synchronize()
    n_leaves = len(tree_leaves(run.state.params))
    n_params = sum(t.numel() for t in tree_leaves(run.state.params))
    print(f"[train] {run.cfg.name}: {run.cfg.n_layers} layers, {n_params / 1e9:.3f} B params "
          f"in {n_leaves} leaves, {run.optimizer.name}, state built on the card in "
          f"{time.perf_counter() - t0:.2f}s")
    step_s = []
    step_fn = run.step_fn

    def timed_step(state, batch, seed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(state, batch, seed)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    run = dataclasses.replace(run, step_fn=timed_step)
    FA.LAUNCHES = SC.LAUNCHES = FS.LAUNCHES = 0
    state, info = LT.train(args, run, log=lambda line: print(f"[train] {line}"))
    launches = FA.LAUNCHES
    check(SC.LAUNCHES == 0 and FS.LAUNCHES == 0, "the fused path launched sr_cast or fused_sgd")
    losses = [row["loss"] for row in info["history"]]
    check(len(losses) == args.steps and all(np.isfinite(losses)), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(launches == n_leaves * args.steps,
          f"fused_adamw launched {launches} times, expected {n_leaves} leaves x {args.steps}")
    opt_ms = [s.elapsed_time(e) for s, e in opt_events]
    steady = step_s[2:]
    ms_step = 1e3 * sum(steady) / len(steady)
    tokens = args.batch * args.seq
    bound_opt = n_params * UPDATE_BYTES["fused_adamw"] / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] losses {[round(x, 4) for x in losses]}")
    print(f"[train] on {card}: step times {[round(1e3 * x, 1) for x in step_s]} ms; "
          f"steady (steps 2-7) {ms_step:.1f} ms/step, {tokens / ms_step * 1e3:.0f} tokens/s; "
          f"optimizer update {sum(opt_ms[2:]) / len(opt_ms[2:]):.2f} ms/step (CUDA events, "
          f"bits drawn inside) against a bound of {bound_opt:.2f} ms "
          f"({UPDATE_BYTES['fused_adamw']} B x {n_params} elements over 3.35 TB/s); "
          f"fused_adamw launched {launches} times ({n_leaves} per step); peak device memory "
          f"{peak:.2f} GiB")
    return run, state, launches


def phase_train_profile(run, state, card: str):
    """Where a training step's time goes: one more step under
    ``torch.profiler`` — host wall time against device kernel time, and
    the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = next(run.batches(state.step))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = run.step_fn(state, batch, 0)
        float(metrics["loss"])
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in avgs if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    print(f"[profile-train] on {card}: one step {host_ms:.1f} ms host wall under the "
          f"profiler, {device_ms:.1f} ms device kernel time (device idle "
          f"{max(0.0, 1 - device_ms / host_ms):.1%}), {n_kernels} kernels")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        print(f"[profile-train]   {dev_us(e) / 1e3:8.2f} ms  {e.count:6d} calls  {e.key[:90]}")
    return state


def phase_parity(run, state, card: str) -> dict:
    """Non-fused ≡ fused AdamW and SGD at full width, leaf by leaf."""
    import torch
    from repro_torch.core.qarith import QArith
    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.kernels import fused_sgd as FS
    from repro_torch.kernels import sr_cast as SC
    from repro_torch.models import registry as R
    from repro_torch.optim import (AdamWState, SGDState, StepKey, adamw,
                                   fused_adamw_optimizer, fused_sgd_optimizer, sgd)
    from repro_torch.train.train_state import softmax_xent
    from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

    policy = run.policy
    params, opt_state = state.params, state.opt_state
    batch = next(run.batches(state.step))
    leaves = [w.detach().requires_grad_(True) for w in tree_leaves(params)]
    logits = R.forward_logits(QArith(policy), tree_unflatten(params, leaves), run.cfg, batch)
    loss = softmax_xent(logits, batch["labels"])
    del logits
    grads = list(torch.autograd.grad(loss, leaves))
    del leaves
    print(f"[parity] fresh gradient at step {state.step}: loss {float(loss.detach()):.4f}")
    pairs = {"adamw": (adamw(policy, b2=0.997, weight_decay=0.01),
                       fused_adamw_optimizer(policy, b2=0.997, weight_decay=0.01)),
             "sgd": (sgd(policy, momentum=0.9, weight_decay=1e-4),
                     fused_sgd_optimizer(policy, momentum=0.9, weight_decay=1e-4))}
    key = StepKey(0, state.step)
    lr = 1e-3
    paths = tree_paths(params)
    ms, vs, cs = (tree_leaves(t) for t in (opt_state.m, opt_state.v, opt_state.kahan_c))

    def one(t):
        return {"w": t}

    FA.LAUNCHES = SC.LAUNCHES = FS.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i, (path, w) in enumerate(zip(paths, tree_leaves(params))):
            g, grads[i] = grads[i], None              # each gradient freed after its leaf
            # SGD first, on two copies (the AdamW first moment as momentum)
            plain, fused = pairs["sgd"]
            copies = [[t.clone() for t in (w, ms[i], cs[i])] for _ in range(2)]
            outs = []
            for opt, (cw, cm, cc) in zip((plain, fused), copies):
                p, s = opt.update(one(g), SGDState(one(cm), one(cc)), one(cw), step=state.step,
                                  key=key, lr=lr)
                outs.append((p["w"], s.momentum["w"], s.kahan_c["w"]))
            for name, a, b in zip(("w", "momentum", "c"), *outs):
                check(torch.equal(a, b), f"sgd vs fused_sgd: {path} {name} differs")
            del copies, outs
            # AdamW: the fused kernel on copies, the plain optimizer in place
            plain, fused = pairs["adamw"]
            cw, cm, cv, cc = (t.clone() for t in (w, ms[i], vs[i], cs[i]))
            pf, sf = fused.update(one(g), AdamWState(one(cm), one(cv), opt_state.c1,
                                                     opt_state.c2, one(cc)),
                                  one(cw), step=state.step, key=key, lr=lr)
            pp, sp = plain.update(one(g), AdamWState(one(ms[i]), one(vs[i]), opt_state.c1,
                                                     opt_state.c2, one(cs[i])),
                                  one(w), step=state.step, key=key, lr=lr)
            for name, a, b in (("w", pp["w"], pf["w"]), ("m", sp.m["w"], sf.m["w"]),
                               ("v", sp.v["w"], sf.v["w"]),
                               ("c", sp.kahan_c["w"], sf.kahan_c["w"])):
                check(torch.equal(a, b), f"adamw vs fused_adamw: {path} {name} differs")
            del cw, cm, cv, cc, pf, sf, pp, sp, g
    torch.cuda.synchronize()
    n = len(paths)
    launches = {"sr_cast": SC.LAUNCHES, "fused_sgd": FS.LAUNCHES, "fused_adamw": FA.LAUNCHES}
    check(launches == {"sr_cast": 2 * n, "fused_sgd": n, "fused_adamw": n},
          f"parity launches {launches}, expected sr_cast {2 * n} (non-fused adamw and "
          f"sgd, one per leaf each), fused_sgd {n}, fused_adamw {n}")
    print(f"[parity] {policy.name}, lr {lr}, one step from the trained state on {card}: adamw "
          f"== fused_adamw and sgd == fused_sgd (momentum 0.9, wd 1e-4) on w, moments and "
          f"Kahan c of all {n} leaves (torch.equal, full width, leaf by leaf) in "
          f"{time.perf_counter() - t0:.1f}s; launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del grads
    # the card's embedding backward: bf16 scatter-add with accumulation
    toks = batch["tokens"].reshape(-1).long()
    rows = torch.randn((toks.numel(), run.cfg.d_model), device="cuda").to(torch.bfloat16)
    table = (run.cfg.vocab, run.cfg.d_model)
    on_card = torch.zeros(table, dtype=torch.bfloat16, device="cuda").index_put_(
        (toks,), rows, accumulate=True)
    on_cpu = torch.zeros(table, dtype=torch.bfloat16).index_put_(
        (toks.cpu(),), rows.cpu(), accumulate=True)
    exact = torch.zeros(table, dtype=torch.float32, device="cuda").index_put_(
        (toks,), rows.float(), accumulate=True)
    diff = (on_card.cpu().float() - on_cpu.float()).abs().max()
    print(f"[parity] embedding backward on the card vs the CPU's bf16 scatter-add over "
          f"{toks.numel()} tokens ({int(toks.unique().numel())} distinct): equal="
          f"{torch.equal(on_card.cpu(), on_cpu)}, max |diff| {float(diff):.4g}; card vs "
          f"f32 sum rounded once: equal={torch.equal(on_card, exact.to(torch.bfloat16))}")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main():
    # fewer, larger cached blocks: the phases allocate at very different sizes
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script checks the port on a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import repro_torch from {ROOT / 'src'}: {e}")
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    rows = {"decode_attention": phase_kernel(card)}
    launches = {"decode_attention": phase_main_path(card)}
    torch.cuda.empty_cache()
    rows.update(phase_update_kernels(card))
    run, state, launches["fused_adamw"] = phase_train(card)
    state = phase_train_profile(run, state, card)
    parity = phase_parity(run, state, card)
    launches["sr_cast"], launches["fused_sgd"] = parity["sr_cast"], parity["fused_sgd"]
    print(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f}s on {card}")
    sources = {
        "decode_attention": "src/repro/kernels/decode_attention.py:42",
        "sr_cast": "src/repro/kernels/sr_cast.py:26",
        "fused_adamw": "src/repro/kernels/fused_adamw.py:36",
        "fused_sgd": "src/repro/kernels/fused_sgd.py:18",
    }
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": sources[name], "launches": launches[name], **rows[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
