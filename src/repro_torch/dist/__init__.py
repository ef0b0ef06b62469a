"""Distributed training on ``torch.distributed`` (port of ``repro.dist``,
its data-parallel layer): the process lifecycle (``multihost``), mesh
axes and the rows of a rank (``partition``), and the gradient transports
(``transport``). FSDP is ROADMAP A9, the model axis A10."""
