"""Spawn, synchronize and supervise N load-generation client processes;
merge their completion streams into one set of serving statistics.

Counterpart of ``repro/dist/launcher.py``. The launcher runs inside the
engine process (the serve stage routes here when ``ServeSpec.client_procs
> 0``). It listens on a loopback TCP port bound to 0 and starts ``python -m
repro_torch.dist.client_proc`` once a process with :mod:`subprocess` (a
fresh interpreter, never a fork: this process holds a CUDA context),
assigns each its workload, seed, process index and device, waits for every
client to finish building (``Ready``), broadcasts one shared wall-clock
start epoch, then collects the epoch-relative completion stamps each
client streams back.

On the card the launcher loads the kernel library once before it spawns,
so N clients load the library it built instead of starting N ``nvcc``
builds at once. The N processes share the one card, each with its own
CUDA context; without MPS, kernels of two contexts are time-sliced, never
run at the same time.

Merged accounting: stamps from process p, local lane l are relabeled to
global lane ``p * lanes + l``, so the merged stream's percentiles are those
of one client running ``n * lanes`` lanes (``stats_from_completions`` over
the concatenation, the identity ``tests/test_torch_dist.py`` pins), while
``proc_qps`` groups the same stamps by process. Each client's counters
arrive in its ``Done`` and are kept a process (``client_dones``) and summed
(``client_cache_counters``, printed on stderr as ``# dist-cache[N procs]:``
beside the engine's ``# hlocache:`` line).

A client's ``Error``, a nonzero exit or a missed deadline (``ready_timeout_s``
for connecting and building, ``done_timeout_s`` past the serving duration
for the replay) fails the row with the client's message and the tail of its
stderr. No row is served from fewer processes than it names.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

from repro_torch.dist.proto import (
    Assign,
    ConnectionClosed,
    Done,
    Error,
    Hello,
    Ready,
    Stamp,
    Start,
    recv_msg,
    send_msg,
)
from repro_torch.serve.lanes import Completion
from repro_torch.serve.latency import (
    LatencyStats,
    lane_qps_from_completions,
    stats_from_completions,
)

__all__ = ["DistLatencyStats", "run_distributed"]

# How long a client may take to connect and build before the run is
# declared wedged, and how long past the serving duration its replay may
# run. Generous: a cold client imports torch, creates a CUDA context and
# makes its inputs; tests pass seconds.
READY_TIMEOUT_S = 600.0
DONE_TIMEOUT_S = 600.0
# Seconds between the Start broadcast and the shared epoch: long enough
# for every client to receive the frame and wake its sleep loop.
_START_LEAD_S = 0.3
# How often the launcher, waiting for connections, checks whether a client
# already exited.
_POLL_S = 0.25


@dataclasses.dataclass(frozen=True)
class DistLatencyStats(LatencyStats):
    """Merged serving statistics of a distributed run: a plain
    :class:`LatencyStats` over the concatenated completion stream, plus
    the per-process accounting."""

    client_procs: int = 0
    proc_qps: tuple[float, ...] | None = None  # achieved QPS a process
    # The clients' cache counters summed (tune_hits/stores/fallbacks,
    # tune_trials, library_cached): a warm run reads tune_trials == 0 and
    # library_cached == client_procs.
    client_cache_counters: dict | None = None
    # Each client's Done, by process index (requests sent, launches).
    client_dones: tuple[Done, ...] | None = None

    def derived(self) -> str:
        parts = [super().derived(), f"client_procs={self.client_procs}"]
        if self.proc_qps is not None:
            qps = ",".join(f"{q:.1f}" for q in self.proc_qps)
            parts.append(f"proc_qps={qps}")
        return ";".join(parts)


class _StreamCollector:
    """Lock-guarded accumulator the per-client reader threads feed: one
    reader a client socket appends stamp rows and records its terminal
    Done or Error; the launcher reads everything back after joining them."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rows: dict[int, list] = {}
        self._done: dict[int, Done] = {}
        self._errors: list[str] = []

    def add_rows(self, proc_id: int, rows: list) -> None:
        with self._lock:
            self._rows.setdefault(proc_id, []).extend(rows)

    def mark_done(self, done: Done) -> None:
        with self._lock:
            self._done[done.proc_id] = done

    def add_error(self, message: str) -> None:
        with self._lock:
            self._errors.append(message)

    def snapshot(self) -> tuple[dict[int, list], dict[int, Done], list[str]]:
        with self._lock:
            return (
                {p: list(rows) for p, rows in self._rows.items()},
                dict(self._done),
                list(self._errors),
            )


def _read_client(sock: socket.socket, proc_id: int, out: _StreamCollector) -> None:
    """Reader-thread body: drain one client until Done, Error or EOF."""
    try:
        while True:
            msg = recv_msg(sock)
            if isinstance(msg, Stamp):
                out.add_rows(msg.proc_id, msg.completions)
            elif isinstance(msg, Done):
                out.mark_done(msg)
                return
            elif isinstance(msg, Error):
                out.add_error(f"proc {msg.proc_id}: {msg.message}")
                return
            else:
                out.add_error(f"proc {proc_id}: unexpected {type(msg).__name__} frame")
                return
    except (ConnectionClosed, OSError, ValueError) as e:
        out.add_error(f"proc {proc_id}: stream died: {e}")


def _src_pythonpath() -> str:
    """PYTHONPATH entry that makes ``import repro_torch`` work in a child."""
    import repro_torch

    src_dir = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    existing = os.environ.get("PYTHONPATH")
    return src_dir if not existing else f"{src_dir}{os.pathsep}{existing}"


def _stderr_tail(path: str, limit: int = 2000) -> str:
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            return f.read()[-limit:]
    except OSError:
        return "<stderr unavailable>"


def _sum_counters(dones: dict[int, Done]) -> dict | None:
    total: dict[str, int] = {}
    seen = False
    for done in dones.values():
        if done.cache_counters is None:
            continue
        seen = True
        for k, v in done.cache_counters.items():
            total[k] = total.get(k, 0) + int(v)
    return total if seen else None


def _client_failed(procs, stderr_paths, proc_id: int, what: str) -> RuntimeError:
    return RuntimeError(
        f"client {proc_id} {what}\n--- client stderr ---\n{_stderr_tail(stderr_paths[proc_id])}"
    )


def _accept_all(listener, procs, stderr_paths, n: int, deadline: float) -> dict:
    """Accept and greet n clients by ``deadline``; fail as soon as one of
    them exits before it connected."""
    conns: dict[int, socket.socket] = {}
    listener.settimeout(_POLL_S)
    while len(conns) < n:
        try:
            conn, _addr = listener.accept()
        except socket.timeout:
            for proc_id, p in enumerate(procs):
                code = p.poll()
                if code is not None and proc_id not in conns:
                    raise _client_failed(procs, stderr_paths, proc_id,
                                         f"exited with code {code} before connecting")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"{n - len(conns)} of {n} clients did not connect in time") from None
            continue
        conn.settimeout(max(deadline - time.monotonic(), _POLL_S))
        hello = recv_msg(conn)
        if not isinstance(hello, Hello):
            conn.close()
            raise RuntimeError(f"expected Hello, got {type(hello).__name__}")
        if hello.proc_id in conns:
            conn.close()
            raise RuntimeError(f"duplicate proc_id {hello.proc_id}")
        conns[hello.proc_id] = conn
    return conns


def run_distributed(
    *,
    benchmark: str,
    preset: int,
    overrides: dict,
    serve,
    seed: int,
    device: str = "cuda",
    impl: str = "torch",
    tune: bool = False,
    cache_dir: str | None = None,
    ready_timeout_s: float = READY_TIMEOUT_S,
    done_timeout_s: float = DONE_TIMEOUT_S,
) -> DistLatencyStats:
    """One distributed open-loop serving run of ``benchmark`` on ``device``.

    Blocks until every client process finishes, or fails; raises
    ``RuntimeError`` naming the first failure (the engine's fault isolation
    turns it into an error record).
    """
    n = int(serve.client_procs)
    if n < 1:
        raise ValueError(f"run_distributed needs client_procs >= 1, got {n}")
    serve_fields = {f.name: getattr(serve, f.name) for f in dataclasses.fields(type(serve))}
    serve_fields["client_procs"] = 0
    # Merged warm-up prefix: every process fills its own pipeline, so the
    # single-process fill count scales by the process count.
    warmup = max(serve.concurrency, serve.lanes, 2) * n
    if device == "cuda" and impl == "kernel":
        from repro_torch.kernels import _build

        _build.library()  # one build, here, before N clients load it

    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    procs: list[subprocess.Popen] = []
    conns: dict[int, socket.socket] = {}
    stderr_paths: list[str] = []
    collector = _StreamCollector()
    try:
        listener.bind(("127.0.0.1", 0))
        listener.listen(n)
        port = listener.getsockname()[1]
        env = dict(os.environ)
        env["PYTHONPATH"] = _src_pythonpath()
        for proc_id in range(n):
            errfile = tempfile.NamedTemporaryFile(
                mode="w", suffix=f".dist{proc_id}.err", delete=False
            )
            stderr_paths.append(errfile.name)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.dist.client_proc",
                 "--port", str(port), "--proc-id", str(proc_id)],
                env=env, stdin=subprocess.DEVNULL, stdout=errfile, stderr=errfile,
            ))
            errfile.close()

        conns = _accept_all(listener, procs, stderr_paths, n,
                            time.monotonic() + ready_timeout_s)
        for proc_id, conn in conns.items():
            send_msg(conn, Assign(
                benchmark=benchmark, preset=preset, overrides=dict(overrides),
                serve=serve_fields, seed=seed, proc_id=proc_id, n_procs=n,
                warmup=warmup, devices=1, placement="replicate", impl=impl,
                cache_dir=cache_dir, device=device, tune=tune,
            ))

        # Barrier: every client has built before any load starts. A client
        # that fails building sends Error (or closes, or misses the
        # deadline); the run stops with its stderr tail.
        for proc_id, conn in conns.items():
            try:
                msg = recv_msg(conn)
            except socket.timeout:
                raise _client_failed(procs, stderr_paths, proc_id,
                                     f"was not ready within {ready_timeout_s:g} s") from None
            except (ConnectionClosed, OSError) as e:
                raise _client_failed(procs, stderr_paths, proc_id,
                                     f"closed before Ready: {e}") from None
            if isinstance(msg, Error):
                raise _client_failed(procs, stderr_paths, proc_id,
                                     f"failed before Ready: {msg.message}")
            if not isinstance(msg, Ready):
                raise RuntimeError(f"client {proc_id}: expected Ready, got {type(msg).__name__}")

        epoch = time.time() + _START_LEAD_S
        for conn in conns.values():
            conn.settimeout(serve.duration_s + done_timeout_s)
            send_msg(conn, Start(epoch=epoch))

        readers = [
            threading.Thread(target=_read_client, args=(conn, proc_id, collector),
                             name=f"dist-reader-{proc_id}", daemon=True)
            for proc_id, conn in conns.items()
        ]
        for t in readers:
            t.start()
        end = time.monotonic() + serve.duration_s + done_timeout_s + _START_LEAD_S
        for t in readers:
            t.join(timeout=max(end - time.monotonic(), 0.0))
            if t.is_alive():
                raise RuntimeError(
                    f"distributed run wedged: {t.name} still reading "
                    f"{done_timeout_s:g} s past the serving duration")
        for proc_id, p in enumerate(procs):
            try:
                code = p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                code = p.wait()
            if code != 0:
                collector.add_error(
                    f"proc {proc_id}: exit code {code}\n--- client stderr ---\n"
                    f"{_stderr_tail(stderr_paths[proc_id])}")
    finally:
        for conn in conns.values():
            try:
                conn.close()
            except OSError:
                pass
        listener.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for path in stderr_paths:
            try:
                os.remove(path)
            except OSError:
                pass

    rows_by_proc, dones, errors = collector.snapshot()
    if errors:
        raise RuntimeError("; ".join(errors))
    missing = sorted(set(range(n)) - set(dones))
    if missing:
        raise RuntimeError(f"clients never reported Done: {missing}")

    # Relabel (proc, local lane) -> global lane so the merged stream is
    # statistically one client running n * lanes lanes.
    merged = [
        Completion(
            index=int(index),
            lane=proc_id * serve.lanes + int(lane),
            t_submit=float(t_submit),
            t_done=float(t_done),
            warmup=bool(warm),
        )
        for proc_id, rows in sorted(rows_by_proc.items())
        for index, lane, t_submit, t_done, warm in rows
    ]
    merged.sort(key=lambda c: c.t_done)
    base = stats_from_completions(
        merged,
        offered_qps=serve.qps,
        slo_us=serve.slo_us,
        truncated=any(d.truncated for d in dones.values()),
        n_lanes=n * serve.lanes,
    )
    by_proc = [dataclasses.replace(c, lane=c.lane // serve.lanes) for c in merged]
    proc_qps = lane_qps_from_completions(by_proc, n_lanes=n)
    client_counters = _sum_counters(dones)
    if client_counters is not None:
        # Like the engine's "# hlocache:" line: always say what the clients'
        # caches did, so "the warm run tuned and built nothing anywhere" is
        # readable from stderr alone.
        line = " ".join(f"{k}={v}" for k, v in sorted(client_counters.items()))
        print(f"# dist-cache[{n} procs]: {line}", file=sys.stderr)
    return DistLatencyStats(
        **{f.name: getattr(base, f.name) for f in dataclasses.fields(LatencyStats)},
        client_procs=n,
        proc_qps=proc_qps,
        client_cache_counters=client_counters,
        client_dones=tuple(dones[p] for p in range(n)),
    )
