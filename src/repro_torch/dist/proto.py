"""Wire protocol for distributed load generation: length-prefixed JSON
messages over a local TCP socket.

The port's own copy of ``repro/dist/proto.py``: the same framing, tags and
``MESSAGE_TYPES`` literal, stdlib only. Three fields are the port's:
``Assign.device`` (``"cuda"`` or ``"cpu"``: the plan names its device, and
a client never falls back to another), ``Assign.tune`` (the plan's tune
flag: a client restores the winner its launcher's engine stored in the
shared cache directory), and ``Done.launches`` (the client's kernel launch
counters over its replay, so the launcher can show each client ran the
kernel).

Each frame is a 4-byte big-endian length followed by that many bytes of
UTF-8 JSON. The JSON object carries a ``"type"`` tag naming the message
class; the remaining keys are the dataclass fields. Every message type
registered in :data:`MESSAGE_TYPES` round-trips ``decode(encode(msg)) ==
msg`` — enforced statically by the ``dist-proto`` rule of
``python -m repro_torch.check`` (every dataclass here must be registered,
with no duplicate tags) and at runtime by ``tests/test_torch_dist.py``.

Conversation (launcher = server side, client_proc = client side)::

    client                          launcher
      Hello(proc_id) ------------------>
      <------------------------- Assign(workload + serve knobs + seed)
      Ready(proc_id) ------------------>   (after build, tune and first call)
      <------------------------- Start(epoch)   (shared wall-clock start)
      Stamp(completions) -------------->   (batched, epoch-relative)
      Done(summary + counters) -------->

Timestamps in ``Stamp`` rows are *seconds since the shared epoch*: each
client pairs a ``time.time()`` reading with a ``time.perf_counter()``
reading at its local origin and rebases its perf_counter stamps, so
stamps from different processes land on one comparable axis (same
machine, same wall clock) and the launcher can compute merged windows.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import struct
from typing import Any

__all__ = [
    "ProtocolError",
    "ConnectionClosed",
    "Hello",
    "Assign",
    "Ready",
    "Start",
    "Stamp",
    "Done",
    "Error",
    "MESSAGE_TYPES",
    "encode",
    "decode",
    "send_msg",
    "recv_msg",
]

PROTOCOL_VERSION = 1

_HEADER = struct.Struct(">I")
# Stamp batches are the largest frames (a few hundred rows each); anything
# near this bound is a corrupt header, not a real message.
MAX_FRAME_BYTES = 16 * 1024 * 1024


class ProtocolError(ValueError):
    """A frame or message that cannot be decoded as this protocol."""


class ConnectionClosed(ConnectionError):
    """The peer closed the socket mid-conversation."""


@dataclasses.dataclass(frozen=True)
class Hello:
    """Client → launcher: first message on a fresh connection."""

    proc_id: int
    pid: int
    protocol: int = PROTOCOL_VERSION


@dataclasses.dataclass(frozen=True)
class Assign:
    """Launcher → client: everything one client process needs to rebuild
    the workload and derive its own sub-schedule. ``serve`` is the
    ServeSpec field dict (``client_procs`` forced to 0 so the client runs
    the in-process path); ``overrides`` the flat param-override dict;
    ``device`` where the client runs (a client that cannot reach it sends
    Error); ``tune`` whether the row's plan tunes its kernel."""

    benchmark: str
    preset: int
    overrides: dict
    serve: dict
    seed: int
    proc_id: int
    n_procs: int
    warmup: int
    devices: int
    placement: str
    impl: str
    cache_dir: str | None = None
    device: str = "cuda"
    tune: bool = False


@dataclasses.dataclass(frozen=True)
class Ready:
    """Client → launcher: build + compile finished; waiting for Start."""

    proc_id: int
    requests: int  # length of this process's sub-schedule


@dataclasses.dataclass(frozen=True)
class Start:
    """Launcher → client: begin replay at the shared wall-clock epoch
    (``time.time()`` seconds; clients sleep until it passes)."""

    epoch: float


@dataclasses.dataclass(frozen=True)
class Stamp:
    """Client → launcher: a batch of completion rows, each
    ``[index, lane, t_submit, t_done, warmup]`` with epoch-relative
    stamps (seconds since Start.epoch)."""

    proc_id: int
    completions: list


@dataclasses.dataclass(frozen=True)
class Done:
    """Client → launcher: replay finished; per-process summary plus the
    client's counters: ``cache_counters`` the tune sidecar's
    (``tune_hits``/``tune_stores``/``tune_fallbacks``), its own
    ``tune_trials``, and ``library_cached`` (1 when the kernel library it
    loaded was already built on disk, absent when it loaded none), so the
    launcher can show a warm run tuned and built nothing in *every*
    process; ``launches`` the kernel launch counters over the replay
    (warm-up requests included)."""

    proc_id: int
    requests: int
    truncated: bool
    cache_counters: dict | None = None
    launches: dict | None = None


@dataclasses.dataclass(frozen=True)
class Error:
    """Client → launcher: the client failed; ``message`` is the one-line
    reason (full traceback stays on the client's stderr)."""

    proc_id: int
    message: str


# Tag -> message class. A dict *literal* on purpose: the dist-proto check
# rule reads it statically to verify every dataclass above is registered
# exactly once (an unregistered message type would encode but never
# decode).
MESSAGE_TYPES = {
    "hello": Hello,
    "assign": Assign,
    "ready": Ready,
    "start": Start,
    "stamp": Stamp,
    "done": Done,
    "error": Error,
}

_TYPE_TAGS = {cls: tag for tag, cls in MESSAGE_TYPES.items()}


def encode(msg: Any) -> bytes:
    """One message → one wire frame (header + JSON body)."""
    tag = _TYPE_TAGS.get(type(msg))
    if tag is None:
        raise ProtocolError(f"unregistered message type: {type(msg).__name__}")
    body = dict(dataclasses.asdict(msg))
    body["type"] = tag
    payload = json.dumps(body, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame too large: {len(payload)} bytes")
    return _HEADER.pack(len(payload)) + payload


def decode(frame: bytes) -> Any:
    """One frame body (JSON bytes, header already stripped) → message."""
    try:
        body = json.loads(frame.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"undecodable frame: {e}") from e
    if not isinstance(body, dict):
        raise ProtocolError(f"frame is not an object: {body!r}")
    tag = body.pop("type", None)
    cls = MESSAGE_TYPES.get(tag)
    if cls is None:
        raise ProtocolError(f"unknown message type {tag!r}")
    known = {f.name for f in dataclasses.fields(cls)}
    try:
        return cls(**{k: v for k, v in body.items() if k in known})
    except TypeError as e:  # missing required field
        raise ProtocolError(f"bad {tag!r} message: {e}") from e


def send_msg(sock: socket.socket, msg: Any) -> None:
    """Write one message to a connected socket."""
    sock.sendall(encode(msg))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining:
        chunk = sock.recv(remaining)
        if not chunk:
            raise ConnectionClosed(
                f"peer closed with {remaining}/{n} bytes outstanding"
            )
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> Any:
    """Read one message from a connected socket (blocking)."""
    (length,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if length > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame header claims {length} bytes")
    return decode(_recv_exact(sock, length))
