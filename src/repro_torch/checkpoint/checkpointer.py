"""Async, atomic, keep-k checkpointing, in the reference's on-disk layout.

Counterpart of ``repro/checkpoint/checkpointer.py``; a checkpoint either
package writes, the other reads:

- **Per-leaf files**: every leaf of the payload (nested dicts, lists,
  tuples and dataclasses such as ``AdamWState``) is one raw-bytes file,
  ``leaf_<i>.bin``, with its dtype and shape in ``manifest.json`` under its
  path (keys joined by ``/``; dict keys sorted, as JAX flattens them).
  Python scalars are stored in the manifest as ``{"value": ...}``.
  bfloat16 round-trips through torch's own 16-bit views of the bytes; the
  reference needs ``ml_dtypes`` for that, the port does not.
- **Atomicity**: writes land in ``<dir>/.tmp.<step>`` and are
  ``os.replace``d into ``step_<N>`` after the manifest is fsynced, so a
  crash mid-save never corrupts the latest complete checkpoint.
- **Async**: ``save`` copies every tensor and array to a host snapshot
  (blocking only on that copy), then a daemon thread writes the files;
  ``wait()`` joins it, and the next ``save`` or a ``restore`` waits first.
- **Keep-k**: old steps are pruned after a successful save, never before.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

__all__ = ["Checkpointer"]

_SEP = "/"
# torch dtype -> the name numpy (and the reference's manifest) gives it.
_NAMES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
}
_TORCH = {name: dt for dt, name in _NAMES.items()}


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order: dict keys sorted, list
    and tuple items by index, dataclass fields in declaration order."""
    def join(key) -> str:
        return f"{prefix}{_SEP}{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], join(k))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in _flatten(x, join(i))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in _flatten(getattr(tree, f.name), join(f.name))]
    return [(prefix, tree)]


def _unflatten(tree, leaves: dict):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    def walk(node, prefix):
        def join(key) -> str:
            return f"{prefix}{_SEP}{key}" if prefix else str(key)

        if isinstance(node, dict):
            return {k: walk(node[k], join(k)) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x, join(i)) for i, x in enumerate(node))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name), join(f.name))
                for f in dataclasses.fields(node)})
        return leaves[prefix]

    return walk(tree, "")


def _host(leaf):
    """A leaf as what the writer stores: (dtype name, bytes, shape) for a
    tensor or array, the value itself for a Python scalar. Tensors and arrays
    are copied whatever their device, so the writer thread never reads
    memory that the next step updates in place."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        name = _NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, t.numpy(), list(leaf.shape)
    if isinstance(leaf, (np.ndarray, np.generic)):
        arr = np.array(leaf, copy=True, order="C")
        return str(arr.dtype), arr, list(arr.shape)
    return leaf


def _read(path: str, dtype: str, shape: list[int]) -> torch.Tensor:
    """The tensor in ``path``, raw bytes of ``dtype``, on the CPU."""
    with open(path, "rb") as f:
        raw = f.read()
    if dtype == "bfloat16":
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.int16).copy()).view(torch.bfloat16)
    elif dtype in _TORCH:
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype)).copy())
    else:
        raise TypeError(f"{path}: cannot restore dtype {dtype!r}")
    return t.reshape(shape)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.write_s: list[float] = []  # each save's file writing, seconds
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, payload: Any, *, blocking: bool = False) -> None:
        """Snapshot ``payload`` at ``step``: its tensors copied to the host
        now, the files written on a thread (here, with ``blocking``)."""
        self.wait()
        host_items = [(k, _host(v)) for k, v in _flatten(payload)]

        def _write():
            t0 = time.perf_counter()
            tmp = os.path.join(self.directory, f".tmp.{step}")
            final = os.path.join(self.directory, f"step_{step:010d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": {}}
            for i, (key, val) in enumerate(host_items):
                if isinstance(val, tuple):
                    dtype, arr, shape = val
                    fname = f"leaf_{i:05d}.bin"
                    with open(os.path.join(tmp, fname), "wb") as f:
                        # The buffer itself, as bytes: no copy under the GIL.
                        f.write(arr.reshape(-1).view(np.uint8).data)
                    manifest["leaves"][key] = {"file": fname, "dtype": dtype, "shape": shape}
                else:
                    manifest["leaves"][key] = {"value": val}
            mpath = os.path.join(tmp, "manifest.json")
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._prune()
            self.write_s.append(time.perf_counter() - t0)

        if blocking:
            _write()
        else:
            def _run():
                try:
                    _write()
                except Exception as e:  # raised again by wait()
                    self._error = e

            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the pending save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.directory, name, "manifest.json")
            ):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: int | None = None) -> tuple[int, Any]:
        """Restore into the structure of ``template``, each leaf's shape
        checked. -> (step, payload): a tensor leaf of the template becomes a
        tensor of the checkpoint's dtype on the template leaf's device, a
        numpy leaf a numpy array, a scalar the stored value."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for key, tmpl in _flatten(template):
            if key not in manifest["leaves"]:
                raise KeyError(f"checkpoint {d} missing leaf {key!r}")
            meta = manifest["leaves"][key]
            if "value" in meta:
                leaves[key] = meta["value"]
                continue
            t = _read(os.path.join(d, meta["file"]), meta["dtype"], meta["shape"])
            if hasattr(tmpl, "shape") and tuple(tmpl.shape) != tuple(t.shape):
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {tuple(t.shape)} != template "
                    f"{tuple(tmpl.shape)}"
                )
            if isinstance(tmpl, torch.Tensor):
                leaves[key] = t.to(tmpl.device)
            elif meta["dtype"] == "bfloat16":
                leaves[key] = t  # numpy has no bfloat16 without ml_dtypes
            else:
                leaves[key] = t.numpy()
        return step, _unflatten(template, leaves)
