"""One distributed load-generation client: ``python -m repro_torch.dist.client_proc``.

Counterpart of ``repro/dist/client_proc.py``. Spawned by
:mod:`repro_torch.dist.launcher`, one per ``ServeSpec.client_procs``. The
client connects back to the launcher, receives its :class:`Assign`, and
builds the assigned workload through its *own* engine on ``Assign.device``
against the shared ``--cache-dir``: build, place, tune (a tuning plan
restores the winner its launcher's engine stored there, at zero trials)
and the first call, which loads the kernel library the launcher built.
It then derives its sub-schedule (``open_loop_lane_schedules`` with
``n_lanes=n_procs``, indexed by ``proc_id``: the same
``SeedSequence.spawn`` split the threaded client uses a lane, so the
merged stream is Poisson at the target QPS and the same for one seed),
waits for the shared start epoch, replays the sub-schedule with the
in-process open-loop runner (completions stamped when the call's CUDA
event has fired), and streams epoch-relative stamps back.

A client whose device cannot be reached (``cuda`` and no card) sends
:class:`Error` and exits nonzero: it never runs on another device. Its
:class:`Done` carries the tune sidecar's counters, its trials, whether the
kernel library it loaded was already built on disk, and its kernel launch
counters over the replay.
"""

from __future__ import annotations

import argparse
import functools
import os
import socket
import sys
import time
import traceback

from repro_torch.dist.proto import (
    Assign,
    Done,
    Error,
    Hello,
    Ready,
    Stamp,
    Start,
    recv_msg,
    send_msg,
)

# Stamp rows a frame: large enough to amortize framing, small enough that
# one frame never approaches MAX_FRAME_BYTES.
_STAMP_BATCH = 512


def _read_launches() -> dict[str, int]:
    """Every kernel wrapper's launch counter, by C entry point."""
    from repro_torch.kernels import (
        avgpool,
        bitonic_sort,
        flash_attention,
        lrn,
        mandelbrot,
        matmul,
        prefix_scan,
        softmax,
        srad_stencil,
    )

    mods = (matmul, softmax, lrn, avgpool, bitonic_sort, prefix_scan, srad_stencil,
            flash_attention, mandelbrot)
    return {k: v for mod in mods for k, v in mod.launches.items()}


def _run_assignment(sock: socket.socket, a: Assign) -> None:
    """Build -> tune -> first call -> sync -> replay -> stream."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.plan import ExecutionPlan, ServeSpec
    from repro_torch.core.registry import get_benchmark
    from repro_torch.kernels import _build
    from repro_torch.serve.lanes import run_open_loop
    from repro_torch.serve.loadgen import open_loop_lane_schedules

    serve = ServeSpec(**{**a.serve, "client_procs": 0})  # this process IS one client
    spec = get_benchmark(a.benchmark)
    plan = ExecutionPlan(
        names=(a.benchmark,),
        preset=a.preset,
        overrides={a.benchmark: a.overrides} if a.overrides else None,
        include_backward=False,
        seed=a.seed,
        impl=a.impl,
        tune=a.tune,
        device=a.device,
        serve=serve,
    )
    if plan.devices != a.devices or plan.placement.mode != a.placement:
        raise ValueError(f"assigned {a.devices} devices, {a.placement!r}; a client "
                         "runs on one device, replicate")
    engine_mod._prepare_device(plan)  # PlanError when the device is not there
    engine = engine_mod.Engine(cache_dir=a.cache_dir)
    workload, args = engine._stage_build(spec, plan, a.preset)
    args = engine._stage_place(workload, args, plan)
    impl, _ = engine._resolve_impl(workload, plan, False)
    tuned, trials, _, _ = engine._stage_tune(
        spec, workload, args, plan, a.preset, False, plan.placement, impl
    )
    entry = engine._stage_compile(
        spec, workload, args, plan, a.preset, False, plan.placement, impl, tuned
    )
    call = functools.partial(entry.executable, *args)
    engine_mod._synchronize(a.device)

    # This process's slice of the merged Poisson stream: every process
    # derives the same n_procs-way split from the shared seed.
    sub = open_loop_lane_schedules(
        qps=serve.qps,
        duration_s=serve.duration_s,
        n_lanes=a.n_procs,
        seed=a.seed,
        warmup=a.warmup,
    )[a.proc_id]

    send_msg(sock, Ready(proc_id=a.proc_id, requests=len(sub)))
    start = recv_msg(sock)
    if not isinstance(start, Start):
        raise RuntimeError(f"expected Start, got {type(start).__name__}")
    # Shared origin: sleep until the wall-clock epoch, then pair a
    # perf_counter reading with a wall reading so stamps rebase onto
    # "seconds since epoch", one axis across all processes.
    delay = start.epoch - time.time()
    if delay > 0:
        time.sleep(delay)
    launches0 = _read_launches()
    pc_ref = time.perf_counter()
    wall_ref = time.time()
    completions = run_open_loop(call, sub, n_lanes=serve.lanes, concurrency=serve.concurrency)
    launches1 = _read_launches()
    shift = (wall_ref - start.epoch) - pc_ref

    rows = [
        [c.index, c.lane, c.t_submit + shift, c.t_done + shift, c.warmup]
        for c in completions
    ]
    for i in range(0, len(rows), _STAMP_BATCH):
        send_msg(sock, Stamp(proc_id=a.proc_id, completions=rows[i: i + _STAMP_BATCH]))
    counters = dict(engine.disk_cache.counter_dict()) if engine.disk_cache is not None else {}
    counters["tune_trials"] = int(trials or 0)
    loaded = _build.loaded_info()
    if loaded is not None:
        counters["library_cached"] = int(loaded["cached"])
    send_msg(
        sock,
        Done(
            proc_id=a.proc_id,
            requests=len(rows),
            truncated=sub.truncated,
            cache_counters=counters,
            launches={k: n - launches0[k] for k, n in launches1.items() if n != launches0[k]},
        ),
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--proc-id", type=int, required=True)
    args = ap.parse_args(argv)

    sock = socket.create_connection((args.host, args.port), timeout=60)
    # The client blocks in recv for Start while the launcher waits for
    # every process to build: no timeout a call once connected (the
    # launcher's deadlines bound the run and it closes the socket).
    sock.settimeout(None)
    try:
        send_msg(sock, Hello(proc_id=args.proc_id, pid=os.getpid()))
        assign = recv_msg(sock)
        if not isinstance(assign, Assign):
            raise RuntimeError(f"expected Assign, got {type(assign).__name__}")
        try:
            _run_assignment(sock, assign)
        except Exception as e:  # noqa: BLE001 — report, then die loudly
            traceback.print_exc()
            msg = " ".join(f"{type(e).__name__}: {e}".split())[:500]
            send_msg(sock, Error(proc_id=args.proc_id, message=msg))
            return 1
        return 0
    finally:
        sock.close()


if __name__ == "__main__":
    sys.exit(main())
