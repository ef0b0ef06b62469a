"""The paper's experiments on the port (counterpart of the reference's
top-level ``benchmarks`` package): one module per table or figure, each
``run(*, device=None)`` printing the reference's CSV rows and returning
its numbers; ``python -m repro_torch.benchmarks.run`` runs them."""
