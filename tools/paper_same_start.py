#!/usr/bin/env python3
"""The port's paper harnesses from the reference's start, on the CPU.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python3 tools/paper_same_start.py

The port's sections start from their own draws (weights from a
``torch.Generator``, LM tokens from numpy uniforms), so their rows differ
from the reference's by the start. This script separates the start from
the arithmetic: it runs Fig 2's three least-squares runs
(``repro_torch.benchmarks.bench_theory.train``) on the reference's X, y
and 6000 sample indices; ``repro_torch.benchmarks.common.train_dlrm``
(Table 4's settings) from the reference's seed-0 DLRM weights, converted,
and ``train_tiny_lm`` at Fig 12's settings from the reference's seed-0
LM weights and token batches; then the port's own DLRM start for seeds
0–3 under fp32. Both packages are imported, so it runs where the JAX
reference does; the rows it prints are accuracy figures, not times.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data.synthetic import lm_batches as j_lm_batches
from repro.models import registry as JR
from repro.models.dlrm import DLRM_KAGGLE_SMALL as J_CFG
from repro.models.dlrm import dlrm_init as j_dlrm_init
from repro.models.lstsq import make_dataset as j_make_dataset
from repro_torch.benchmarks import bench_theory
from repro_torch.benchmarks import common as C
from repro_torch.convert import from_jax_dlrm_params, from_jax_params
from repro_torch.models.dlrm import DLRM_KAGGLE_SMALL, dlrm_init


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def fig2_from_reference_data():
    """Fig 2 on the reference's dataset and sample indices (its
    ``_run``: ``make_dataset(PRNGKey(0), n=512, d=10)``, sample i drawn
    with ``randint(fold_in(PRNGKey(1), i), (), 0, n)``)."""
    X, y, _ = j_make_dataset(jax.random.PRNGKey(0), n=512, d=10)
    n, steps = X.shape[0], 6000
    idx = jax.vmap(lambda i: jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(1), i),
                                                (), 0, n))(jnp.arange(steps))
    X, y, idx = (torch.from_numpy(np.array(a)) for a in (X, y, idx))
    mse = {m: bench_theory.train(X, y, idx.long(), m) for m in ("exact", "updates", "fwdbwd")}
    print(f"fig2 from the reference's X, y and sample indices: mse exact={mse['exact']:.4e} "
          f"updates={mse['updates']:.4e} ({mse['updates'] / mse['exact']:.1f}x) "
          f"fwdbwd={mse['fwdbwd']:.4e} ({mse['fwdbwd'] / mse['exact']:.4f}x)", flush=True)


def main():
    fig2_from_reference_data()
    dlrm = _np_tree(j_dlrm_init(jax.random.PRNGKey(0), J_CFG))
    for pol in ("fp32", "bf16_standard", "bf16_kahan"):
        _, auc, _, _ = C.train_dlrm(pol, steps=400, device="cpu",
                                    init_params=from_jax_dlrm_params(dlrm, device="cpu"))
        print(f"table4_dlrm_{pol} from the reference's weights: auc={auc:.4f}", flush=True)
    for seed in range(4):
        init = dlrm_init(torch.Generator().manual_seed(seed), DLRM_KAGGLE_SMALL)
        _, auc, _, _ = C.train_dlrm("fp32", steps=400, device="cpu", init_params=init)
        print(f"table4_dlrm_fp32 from the port's seed-{seed} weights: auc={auc:.4f}", flush=True)

    cfg = JR.get_config("qwen2.5-3b").reduced()
    tokens = [{k: np.asarray(v) for k, v in b.items()}
              for _, b in zip(range(250), j_lm_batches(cfg.vocab, 8, 32, seed=0))]

    def reference_batches(vocab, batch, seq, *, seed, device):
        for b in tokens:
            yield {k: torch.from_numpy(v.copy()).to(device) for k, v in b.items()}

    C.lm_batches = reference_batches
    lm = _np_tree(JR.init(cfg, jax.random.PRNGKey(0), jnp.float32))
    for pol in ("bf16_sr", "fp16_sr", "bf16_kahan", "fp16_kahan"):
        _, final, _ = C.train_tiny_lm(pol, steps=250, init_scale=0.05, lr=1e-2, device="cpu",
                                      init_params=from_jax_params(lm, device="cpu"))
        print(f"fig12_lm_{pol} from the reference's weights and tokens: "
              f"final_loss={final:.4f}", flush=True)


if __name__ == "__main__":
    main()
