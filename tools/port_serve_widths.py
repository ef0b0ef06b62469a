#!/usr/bin/env python3
"""Serve-step time by token width of the PyTorch port on one GPU.

    python3 tools/port_serve_widths.py [--src PATH]

Serves full-width qwen2.5-3b (random weights from seed 0, ``bf16_standard``,
fused decode) on the streams of ``chip_smoke.py``: the contiguous engine
(8 slots, max_len 256, 12 requests) and the paged engine (8 slots, max_len
1024, 64 pages of 16, prefix cache, 16 requests), each with
``prefill_chunk`` 1 and 32, and prints per run the tok/s, the ms per serve
step and, per token width, the mean host wall of a replayed step (the call
ends in the read of its tokens, a sync; each width's eager first step and
capture left out). ``--src`` imports ``repro_torch`` from another tree's
``src`` (an unpacked parent commit, to compare two trees in one run);
this tree's ``chip_smoke.py`` supplies the streams and the step timer.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to run")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times the port on a GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np

    import chip_smoke as CS
    from repro_torch.launch.serve import serve_stream, synthetic_stream
    from repro_torch.serve.engine import Engine

    import repro_torch
    print(f"[widths] repro_torch from {Path(repro_torch.__file__).parent} on "
          f"{torch.cuda.get_device_name(0)}")
    params, cfg, policy = CS.serve_model()
    streams = {
        "contiguous": (dict(max_len=CS.MAIN_SC),
                       synthetic_stream(np.random.default_rng(0), 12, rate=1.0,
                                        prompt_lens=(16, 64), gen_lens=(16, 48),
                                        vocab=cfg.vocab)),
        "paged": (dict(max_len=CS.PAGED_MAX_LEN, paged=True, page_size=CS.PAGE,
                       n_pages=CS.PAGED_N_PAGES), CS.paged_stream(cfg.vocab)),
    }
    for name, (kw, stream) in streams.items():
        warm = Engine(params, cfg, policy, n_slots=8, fused_decode=True, device="cuda", **kw)
        warm.submit(np.arange(4, dtype=np.int32), 2)
        warm.run()
        del warm
        for chunk in (1, CS.CHUNK):
            eng = Engine(params, cfg, policy, n_slots=8, fused_decode=True, device="cuda",
                         prefill_chunk=chunk, **kw)
            times = CS.step_times(eng)
            t0 = time.perf_counter()
            res = serve_stream(eng, stream)
            wall = time.perf_counter() - t0
            st = eng.stats
            print(f"[widths] {name}, chunk {chunk}: {st.steps} engine steps, {res.calls} "
                  f"serve-step calls, {st.tokens_generated} tokens in {wall:.3f}s -> "
                  f"{st.tokens_generated / wall:.1f} tok/s, {1e3 * wall / res.calls:.2f} ms "
                  f"per serve step; {CS.width_ms(times)}")
            del eng
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
