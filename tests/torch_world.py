"""Start a ``torch.distributed`` world of N ranks on the CPU for a test.

One fresh interpreter a rank (so the ranks import torch and the port, never
JAX), joined over gloo through a ``file://`` rendezvous in the test's
``tmp_path``: no port is fixed, so pytest-xdist workers cannot collide.
Each world has a deadline of its own; past it every rank is killed and the
test fails with what the ranks printed.

The script runs after a prelude that has joined the group and bound
``RANK``, ``WORLD`` and ``OUT`` (a directory the ranks share with the test,
for results); it leaves the group at the end.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
import time
import uuid
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PRELUDE = """\
import os
import torch
import torch.distributed as dist

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=os.environ["TORCH_WORLD_INIT"],
                        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
RANK, WORLD, OUT = dist.get_rank(), dist.get_world_size(), os.environ["TORCH_WORLD_OUT"]
"""
_EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""


class World:
    """A started world: :meth:`wait` collects it."""

    def __init__(self, script: str, n: int, tmp_path: Path) -> None:
        tag = uuid.uuid4().hex[:8]
        self.n = n
        self.out = tmp_path / f"world-{n}-{tag}"
        self.out.mkdir()
        env = dict(
            os.environ,
            PYTHONPATH=str(SRC),
            WORLD_SIZE=str(n),
            TORCH_WORLD_INIT=f"file://{tmp_path / f'rendezvous-{tag}'}",
            TORCH_WORLD_OUT=str(self.out),
            OMP_NUM_THREADS="1",
        )
        code = _PRELUDE + textwrap.dedent(script) + _EPILOGUE
        self.procs = [
            subprocess.Popen([sys.executable, "-c", code], env=dict(env, RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)
        ]
        self.started = time.monotonic()

    def wait(self, timeout: float = 120.0) -> list[str]:
        """Each rank's stdout. Fails the test on a nonzero exit or past
        ``timeout`` seconds from the start."""
        n, procs = self.n, self.procs
        deadline = self.started + timeout
        results = []
        try:
            for p in procs:
                results.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0)))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            tails = [err[-2000:] for _, err in results]
            for p in procs[len(results):]:
                tails.append(p.communicate()[1][-2000:])
            raise AssertionError(f"a world of {n} ranks passed its {timeout} s deadline:\n"
                                 + "\n".join(tails)) from None
        for r, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
            assert p.returncode == 0, f"rank {r} of {n} exited {p.returncode}:\n{stdout}\n{stderr}"
        return [stdout for stdout, _ in results]


def start_world(script: str, n: int, tmp_path: Path) -> World:
    """Start ``script`` on ``n`` ranks and return at once (the test works
    meanwhile); ``.wait(timeout)`` collects it."""
    return World(script, n, tmp_path)


def run_world(script: str, n: int, tmp_path: Path, timeout: float = 120.0) -> list[str]:
    """Run ``script`` on ``n`` ranks; -> each rank's stdout. Fails the test
    on a nonzero exit or past ``timeout`` seconds."""
    return start_world(script, n, tmp_path).wait(timeout)
