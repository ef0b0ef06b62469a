#!/usr/bin/env python3
"""The port's paper LM harness from the reference's start, on the CPU.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python3 tools/paper_same_start.py

The port's sections draw Fig 2's data and indices, the DLRM weights and
the LM tokens as the reference does (``repro_torch.core.jrandom``), but
the LM weights from a ``torch.Generator``, so its LM rows differ from the
reference's by the start. This script separates the start from the
arithmetic: it runs ``train_tiny_lm`` at Fig 12's settings from the
reference's seed-0 LM weights, converted (``tools/port_paper_seeds.py``
prints the DLRM and Fig 2 rows of the port's own start). Both packages
are imported, so it runs where the JAX reference does; the rows it
prints are accuracy figures, not times.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import registry as JR
from repro_torch.benchmarks import common as C
from repro_torch.convert import from_jax_params


def main():
    cfg = JR.get_config("qwen2.5-3b").reduced()
    lm = jax.tree_util.tree_map(np.asarray, JR.init(cfg, jax.random.PRNGKey(0), jnp.float32))
    for pol in ("bf16_sr", "fp16_sr", "bf16_kahan", "fp16_kahan"):
        _, final, _ = C.train_tiny_lm(pol, steps=250, init_scale=0.05, lr=1e-2, device="cpu",
                                      init_params=from_jax_params(lm, device="cpu"))
        print(f"fig12_lm_{pol} from the reference's weights: final_loss={final:.4f}",
              flush=True)


if __name__ == "__main__":
    main()
