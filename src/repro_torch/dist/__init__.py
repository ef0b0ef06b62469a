"""Distributed training on ``torch.distributed`` (port of ``repro.dist``):
the process lifecycle (``multihost``), mesh axes, placement and the rows
of a rank (``partition``), fully-sharded data parallelism (``fsdp``), and
the gradient transports (``transport``), and the model axis as the model
code sees it (``axes``: tensor-parallel serving and training)."""
