"""Multi-process scale-out: distributed load generation over a local
socket protocol.

Counterpart of ``repro/dist``. One Python process tops out at a host
dispatch ceiling before the card does: one interpreter can issue only so
many requests a second. This package spreads the load over N client
*processes*, each replaying a seeded per-process sub-schedule
(``SeedSequence.spawn`` off the plan's seed, so the merged arrival stream is
still Poisson at the target QPS and the same for one seed), each building
its workload through its own engine on the plan's device and the shared
``--cache-dir`` (a warm run restores every process's tune winner at zero
trials, and every process loads the kernel library its launcher built),
and streaming per-request completion stamps back to the launcher for
merged percentile and goodput accounting. On one card the N processes hold
N CUDA contexts, time-sliced by the device.

- :mod:`repro_torch.dist.proto`: the wire format, length-prefixed JSON
  messages (Hello / Assign / Ready / Start / Stamp / Done / Error) over a
  local TCP socket.
- :mod:`repro_torch.dist.client_proc`: the ``python -m
  repro_torch.dist.client_proc`` entry point one client process runs.
- :mod:`repro_torch.dist.launcher`: spawns and supervises the clients from
  the engine process, synchronizes the start epoch, and merges the
  completion streams into one :class:`~repro_torch.serve.latency.LatencyStats`
  with per-process QPS.

Selected by ``ServeSpec.client_procs`` (CLI ``--client-procs N``); the
engine's serve stage routes to :func:`repro_torch.dist.launcher.run_distributed`
when it is nonzero.
"""
