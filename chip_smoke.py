#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing its lines (a failed check exits non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA decode-attention kernel, built from this checkout;
3. kernel: the kernel against its plain PyTorch version at the serving
   path's shapes (B=8 lanes, 16/2 heads, D=128, bf16, Sc 256 and 2048):
   mixed depths, two parked lanes (exact zeros), window 64 + softcap 30;
   its time beside its bound, the plain version's time and
   ``scaled_dot_product_attention``'s (a yardstick the port never calls);
4. main path: full-width qwen2.5-3b (36 layers, random weights from a
   seed) served by the continuous-batching engine with the fused decode
   kernel — 12 requests from the synthetic stream; every request must
   finish, the kernel must have launched 36 times per serve-step call,
   and the tokens must equal the port's ``generate`` (same kernel, batched
   to the engine's 8 rows) bit for bit; then a profile of steady-state
   serve steps (host time, device time, launches, top kernels).

Then one JSON line with the kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
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
    _build.load("decode_attention")
    info = _build.builds["decode_attention"]
    print(f"[build] decode_attention: nvcc {info.seconds:.2f}s, load "
          f"{time.perf_counter() - t0:.2f}s total -> {info.path.name}")
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


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main():
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
    row = phase_kernel(card)
    launches = phase_main_path(card)
    print(f"[smoke] all phases passed in {time.perf_counter() - t0:.1f}s on {card}")
    print(json.dumps({"kernels": [{
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:42",
        "launches": launches, **row}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
