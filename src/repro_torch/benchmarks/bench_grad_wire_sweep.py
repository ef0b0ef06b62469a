"""Gradient-wire format × model sweep: payload bytes per step against the
converged loss (port of ``benchmarks/bench_grad_wire_sweep.py``, its
training rows).

Trains the two paper workloads — the reduced LM and the DLRM click model
— once per wire format (fp32, bf16, bf14, bf12, e4m3) plus one per-leaf
keep cell (``bf12_keep``: embeddings, norms, biases and leaves under 2048
elements ride fp32, the bulk matmul leaves bf12), each through the
one-replica wire of ``make_transport(wire=, wire_policy=)`` (no mesh: the
SR quantization with error feedback, no collective), and prints one row
per cell:

* ``payload_bytes_per_step`` — the format's payload, Σ n_elem ·
  ``fmt.bits``/8 (``CompressedWire.payload_bytes``), not the carrier's;
* ``carrier`` — the dtype(s) the payload rides;
* ``ratio_vs_fp32`` — the fp32 payload over this one (bf12 32/12 ≈ 2.67;
  asserted ≥ 2.6);
* ``final_loss`` and ``tol`` — the mean loss of the last 10 steps, and
  the bound within which the keep cell must recover the fp32 loss
  (asserted in the full run).

The reference's ``grad_wire_sweep_hlo_<fmt>`` rows read XLA's lowered
module for the collective bytes of a 2-pod step; their rows here name
ROADMAP A6, which ports that tooling. ``smoke=True`` runs the LM's fp32,
bf12 and keep cells for 8 steps.
"""
from __future__ import annotations

import time

import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import _sync, dlrm_loss, row
from repro_torch.core.formats import wire_carrier_dtype
from repro_torch.core import jrandom
from repro_torch.core.policy import get_policy
from repro_torch.core.qarith import QArith
from repro_torch.data.synthetic import dlrm_batches, lm_batches
from repro_torch.dist import transport as TR
from repro_torch.models import registry as R
from repro_torch.models.dlrm import DLRM_KAGGLE_SMALL, dlrm_init
from repro_torch.optim import StepKey, adamw, constant, sgd
from repro_torch.optim.base import init_params_for_policy
from repro_torch.optim.grad_compress import WireKey
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import make_train_state
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# (label, wire format name, keep policy spec or None)
CELLS = [
    ("fp32", "fp32", None),
    ("bf16", "bf16", None),
    ("bf14", "bf14", None),
    ("bf12", "bf12", None),
    ("e4m3", "e4m3", None),
    ("bf12_keep", "bf12", "default"),
]

# |final_loss - fp32 final_loss| bound for the keep-policy cell
TOL = {"lm": 0.15, "dlrm": 0.03}
HLO_WIRES = ("fp32", "bf16", "bf12", "e4m3")


def _make_transport(wire: str, policy_spec: str | None):
    wp = TR.WirePolicy.parse(policy_spec) if policy_spec is not None else None
    return TR.make_transport(wire=wire, wire_policy=wp)


def _payload(tr, params) -> tuple[int, str]:
    """(payload bytes per wire reduce, carrier label) for a transport."""
    n_f32 = sum(leaf.numel() for leaf in tree_leaves(params)) * 4
    if not hasattr(tr, "payload_bytes"):
        return n_f32, "f32"
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}
    carriers = sorted({names[wire_carrier_dtype(f)] for f in tr.leaf_formats(params)})
    return tr.payload_bytes(params), "+".join(carriers)


def _lm_params(seed: int, dev):
    """The reduced LM's f32 weights, drawn on the CPU (the same on every
    device)."""
    cfg = R.get_config("qwen2.5-3b").reduced()
    return cfg, tree_map(lambda w: w.to(dev), R.init(cfg, seed, torch.float32, device="cpu"))


def _train_lm(tr, steps: int, dev, seed: int = 0) -> tuple[float, float]:
    """The reduced-LM cell through the transport; (final_loss, us/step)."""
    policy = get_policy("bf16_sr")
    cfg, params = _lm_params(seed, dev)
    params = init_params_for_policy(params, policy)
    opt = adamw(policy, b2=0.997)
    state = make_train_state(params, opt, transport=tr)
    step = make_train_step(cfg, policy, opt, constant(3e-3), attn_chunk=8, transport=tr)
    losses = []
    _sync()
    t0 = time.perf_counter()
    for i, b in enumerate(lm_batches(cfg.vocab, 8, 32, seed=seed, device=dev)):
        if i >= steps:
            break
        state, m = step(state, b, seed)
        losses.append(float(m["loss"]))
    us = (time.perf_counter() - t0) / max(len(losses), 1) * 1e6
    return sum(losses[-10:]) / min(len(losses), 10), us


def _train_dlrm(tr, steps: int, dev, seed: int = 0) -> tuple[float, float]:
    """The DLRM cell: SGD with the wire's reduce between the backward and
    the update (the harness of ``common.train_dlrm`` has no transport);
    (final logloss, us/step)."""
    policy = get_policy("bf16_sr")
    qa = QArith(policy)
    params = init_params_for_policy(
        dlrm_init(jrandom.PRNGKey(seed), DLRM_KAGGLE_SMALL, device=dev), policy)
    opt = sgd(policy, momentum=0.0)
    opt_state = opt.init(params)
    residuals = tr.init_residuals(params)
    losses = []
    _sync()
    t0 = time.perf_counter()
    for i, batch in enumerate(dlrm_batches(DLRM_KAGGLE_SMALL, 128, seed=seed + 1,
                                           device=dev)):
        if i >= steps:
            break
        leaves = [w.detach().requires_grad_(True) for w in tree_leaves(params)]
        with torch.enable_grad():
            loss = dlrm_loss(qa, tree_unflatten(params, leaves), batch)
            grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
        del leaves
        grads, residuals = tr.reduce(grads, residuals, WireKey(7, i))
        params, opt_state = opt.update(grads, opt_state, params, step=i,
                                       key=StepKey(seed, i), lr=0.1)
        losses.append(float(loss.detach()))
    us = (time.perf_counter() - t0) / max(len(losses), 1) * 1e6
    return sum(losses[-10:]) / min(len(losses), 10), us


def run(*, smoke: bool = False, device=None) -> dict:
    dev = resolve_device(device)
    models = {"lm": (_train_lm, 8 if smoke else 120),
              "dlrm": (_train_dlrm, 20 if smoke else 200)}
    cells = [c for c in CELLS if c[0] in ("fp32", "bf12_keep", "bf12")] if smoke else CELLS
    if smoke:
        models.pop("dlrm")
    out = {}
    for model, (train, steps) in models.items():
        base_payload = fp32_loss = None
        # params for the payload's accounting only (each cell draws its own)
        probe = (_lm_params(0, "cpu")[1] if model == "lm"
                 else dlrm_init(jrandom.PRNGKey(0), DLRM_KAGGLE_SMALL, device="cpu"))
        for label, wire, pol in cells:
            tr = _make_transport(wire, pol)
            payload, carrier = _payload(tr, probe)
            if label == "fp32":
                base_payload = payload
            ratio = (base_payload or payload) / payload
            loss, us = train(tr, steps, dev)
            if label == "fp32":
                fp32_loss = loss
            tol = TOL[model]
            row(f"grad_wire_sweep_{model}_{label}", us,
                f"payload_bytes_per_step={payload} carrier={carrier} "
                f"ratio_vs_fp32={ratio:.3f} final_loss={loss:.4f} tol={tol}")
            out[f"{model}_{label}"] = {"payload_bytes_per_step": payload, "carrier": carrier,
                                       "ratio_vs_fp32": ratio, "final_loss": loss, "us": us}
            if label == "bf12" and base_payload is not None:
                if ratio < 2.6:
                    raise AssertionError(f"bf12 payload saves only {ratio:.2f}x vs fp32 "
                                         f"on {model}")
            if label == "bf12_keep" and fp32_loss is not None and not smoke:
                if abs(loss - fp32_loss) > tol:
                    raise AssertionError(f"{model} keep-policy loss {loss:.4f} outside "
                                         f"±{tol} of fp32 {fp32_loss:.4f}")
    if not smoke:
        for wire in HLO_WIRES:
            # the reference reads XLA's lowered module here
            row(f"grad_wire_sweep_hlo_{wire}", 0.0, "not_ported=ROADMAP_A6")
    return out
