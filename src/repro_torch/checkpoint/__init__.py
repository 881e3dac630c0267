# Fault-tolerance substrate: asynchronous, atomic, keep-k checkpointing of
# (parameters, optimizer state, data cursor) with exact-resume semantics;
# counterpart of repro/checkpoint/. The on-disk layout is the reference's.

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
