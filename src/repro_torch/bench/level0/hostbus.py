"""Level 0: BusSpeedDownload / BusSpeedReadback — the host bus (PCIe).

Counterpart of ``repro/bench/level0/hostbus.py``: 1 KiB to 64 MiB
transfers in pageable host memory, each direction one row. The transfer
itself is the benchmark, so both are ``no_jit`` workloads: the engine
leaves their inputs on the host, but for the positions
``meta["device_args"]`` names, which it commits once before timing.

- **Download** copies a pageable host tensor into a device buffer made
  once by the place stage (``dst.copy_(src)``). On the card the timer's
  event pair brackets that one copy on the current stream: CUDA
  stages the pageable bytes through its pinned buffers and DMAs them, and
  ``copy_`` returns only when the copy is done, so the pair spans the
  whole transfer, host staging included.
- **Readback** copies a committed device tensor into a new pageable host
  tensor (``.cpu()``, as the reference's ``np.asarray`` makes a new host
  array). The event pair brackets the allocation and the synchronous
  copy.

On the CPU (``--device cpu``) both are host memory copies timed by the
host clock. Pinned-memory rows are not part of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.presets import geometric_presets
from repro_torch.core.registry import BenchmarkSpec, Workload, register


def _host_array(nbytes: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(nbytes // 4, dtype=np.float32))


def _make_download(nbytes: int) -> Workload:
    def make_inputs(seed: int):
        src = _host_array(nbytes, seed)
        return (src, torch.zeros_like(src))  # the destination, committed

    def fn(src, dst):
        return dst.copy_(src)

    def validate(out, args):
        src, _ = args
        assert torch.equal(out.cpu(), src), "the downloaded bytes differ"

    return Workload(
        name=f"busspeeddownload.n{nbytes}",
        fn=fn,
        make_inputs=make_inputs,
        bytes_moved=float(nbytes),
        validate=validate,
        batch_dims=None,
        meta={"no_jit": True, "device_args": (1,)},
    )


def _make_readback(nbytes: int) -> Workload:
    def make_inputs(seed: int):
        return (_host_array(nbytes, seed),)  # committed to the device

    def fn(dev):
        return dev.cpu()

    def validate(out, args):
        (dev,) = args
        assert out.device.type == "cpu" and torch.equal(out, dev.cpu())

    return Workload(
        name=f"busspeedreadback.n{nbytes}",
        fn=fn,
        make_inputs=make_inputs,
        bytes_moved=float(nbytes),
        validate=validate,
        batch_dims=None,
        meta={"no_jit": True, "device_args": (0,)},
    )


_PRESETS = geometric_presets(
    {"nbytes": 1 << 10}, scale_keys={"nbytes": 16.0}, round_to=4
)  # 1 KiB .. 64 MiB

register(
    BenchmarkSpec(
        name="busspeeddownload",
        level=0,
        dwarf=None,
        domain=None,
        cuda_feature=None,
        gpu_feature="pageable host-to-device copy (copy_)",
        presets=_PRESETS,
        build=lambda nbytes: _make_download(nbytes),
    )
)

register(
    BenchmarkSpec(
        name="busspeedreadback",
        level=0,
        dwarf=None,
        domain=None,
        cuda_feature=None,
        gpu_feature="device-to-pageable-host copy (.cpu())",
        presets=_PRESETS,
        build=lambda nbytes: _make_readback(nbytes),
    )
)
