"""The port's static checker (``repro_torch.check``) against the
reference's (``repro.check``).

Each of the reference's rule fixtures (``tests/test_check.py``) is written
once in the reference's terms and translated into the port's: paths under
``src/repro_torch/``, ``KERNEL_OPS`` and ``kernel=`` for ``PALLAS_OPS`` and
``pallas_kernel=``, the tune sidecar's ``_tune_path`` for the disk cache's
``_path``, torch for jax. Both checkers run on their tree and must flag the
same rules on the same lines, each with the port's wording. Then the
port's own cases: the kernel-build module in the lock rule's scope, the
schema fingerprint at its own path, the CLI, and the live tree, which
``python -m repro_torch.check`` must pass with exit 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.check import all_checkers as j_all_checkers
from repro.check import run_checks as j_run_checks
from repro_torch.check import all_checkers, run_checks
from repro_torch.check.__main__ import main
from repro_torch.check.schema import update_fingerprint

REPO_ROOT = Path(__file__).resolve().parents[1]

# reference term -> port term; each keeps line numbers.
_TRANSLATION = (
    ("src/repro/", "src/repro_torch/"),
    ("from repro.kernels", "from repro_torch.kernels"),
    ("PALLAS_OPS", "KERNEL_OPS"),
    ("pallas_kernel", "kernel"),
    ("def _path(", "def _tune_path("),
    ("import jax", "import torch"),
)


def _port(text: str) -> str:
    for old, new in _TRANSLATION:
        text = text.replace(old, new)
    return text


def write_tree(root: Path, files: dict[str, str]) -> Path:
    for rel, content in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(content))
    return root


def messages(findings) -> str:
    return "\n".join(f.message for f in findings)


WORKLOAD = {
    "src/repro/kernels/ops.py": """\
        from repro.kernels import badkern as _bad_mod

        PALLAS_OPS = {"badkern": _bad_mod}
    """,
    "src/repro/kernels/badkern.py": """\
        def tune_space():
            return ({"block": 0},)
    """,
    "src/repro/bench/level0/foo.py": """\
        def register():
            return Workload(name="foo", pallas_kernel="nope")
    """,
}
GOOD_KERNEL = {"src/repro/kernels/badkern.py": "def tune_space():\n    return ({},)\n"}
CACHEKEY = {
    "src/repro/core/plan.py": """\
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class Placement:
            devices: int
            mode: str
    """,
    "src/repro/core/engine.py": """\
        class Engine:
            def _cache_key(self, spec, preset, placement, impl):
                return (spec, preset, placement.devices)

            def _bucket_key(self, spec, preset, placement):
                return (spec, preset, placement.devices, placement.mode)

            def load(self, spec):
                return self.disk_cache.load_tuned((spec, "adhoc"), None)
    """,
    "src/repro/core/hlocache.py": """\
        import hashlib

        class HloDiskCache:
            def _path(self, key):
                return hashlib.sha256(repr(key[0]).encode()).hexdigest()
    """,
}
CACHEKEY_OK = {
    "src/repro/core/engine.py": """\
        class Engine:
            def _cache_key(self, spec, preset, placement, impl, tuned_params=None):
                return (spec, preset, placement.devices, placement.mode, impl,
                        tuple(sorted((tuned_params or {}).items())))

            def _bucket_key(self, spec, preset, placement, impl, width):
                base = (spec, preset, placement.devices, placement.mode, impl, ())
                return base if width == 1 else base + ("vmap", width)

            def tune(self, spec, preset, placement, impl):
                base_key = self._cache_key(spec, preset, placement, impl)

                def load():
                    # Closure capture of the bound key is a legal binding.
                    return self.disk_cache.load_tuned(base_key, None)

                return load()
    """,
    "src/repro/core/hlocache.py": """\
        import hashlib

        class HloDiskCache:
            def _path(self, key):
                return hashlib.sha256(repr(key).encode()).hexdigest()
    """,
}
STAGES = {
    "src/repro/core/engine.py": """\
        class Engine:
            def run_one(self, spec):
                entry = self._stage_measure(spec)
                return entry
    """,
    "src/repro/core/harness.py": """\
        def time_fn(fn, tracer):
            tracer.counters.inc("samples", 1)
            if tracer.enabled:
                tracer.counters.inc("guarded", 1)
            return fn()
    """,
    "src/repro/serve/lanes.py": """\
        class DispatchLane:
            def submit(self, out, tracer):
                tracer.event("submit", t_start=0.0, t_end=1.0)
                return out
    """,
}
STAGES_OK = {
    "src/repro/core/engine.py": """\
        class Engine:
            def run_one(self, spec):
                timings = {}
                with self._timed_stage("measure", timings, bench=spec):
                    entry = self._stage_measure(spec)
                return entry

            def _stage_tune(self, spec):
                # Nested stage calls run inside the caller's span.
                return self._stage_compile(spec)
    """,
    "src/repro/core/harness.py": "def time_fn(fn):\n    return fn()\n",
}
SINK_UNLOCKED = """\
    import threading

    class Sink:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []

        def add(self, item):
            self._items.append(item)

        def harvest(self):
            with self._lock:
                out = list(self._items)
                self._items.clear()
            return out
"""
SINK_LOCKED = textwrap.dedent(SINK_UNLOCKED).replace(
    "        self._items.append(item)",
    "        with self._lock:\n            self._items.append(item)",
)
TALLY = """\
    class Tally:
        def __init__(self):
            self.counts = {}

        def bump(self, k):
            self.counts[k] = self.counts.get(k, 0) + 1
"""
PROTO_UNREGISTERED = """\
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Hello:
        proc_id: int

    @dataclasses.dataclass(frozen=True)
    class Rogue:
        payload: str

    MESSAGE_TYPES = {"hello": Hello}
"""
PROTO_COMPUTED = """\
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Hello:
        proc_id: int

    MESSAGE_TYPES = dict(hello=Hello)
"""
PROTO_OK = """\
    import dataclasses
    import json
    import struct

    _HEADER = struct.Struct(">I")

    @dataclasses.dataclass(frozen=True)
    class Hello:
        proc_id: int
        note: str | None = None

    MESSAGE_TYPES = {"hello": Hello}
    _TAGS = {cls: tag for tag, cls in MESSAGE_TYPES.items()}

    def encode(msg):
        body = dict(dataclasses.asdict(msg), type=_TAGS[type(msg)])
        payload = json.dumps(body).encode()
        return _HEADER.pack(len(payload)) + payload

    def decode(frame):
        body = json.loads(frame.decode())
        return MESSAGE_TYPES[body.pop("type")](**body)
"""


def _suppressed(comment: str, preceding: bool = False) -> dict:
    line = "        self._items.append(item)"
    new = (f"        {comment}\n{line}" if preceding else f"{line}  {comment}")
    return {"src/repro/serve/sink.py": textwrap.dedent(SINK_UNLOCKED).replace(line, new)}


# case -> (files, rule, the port's message fragments; [] = check-clean)
CASES = {
    "workload_fires": (WORKLOAD, "workload-contract",
                       ["positive int literals", "batch_dims", "'nope' is not a key of "
                        "kernels.ops.KERNEL_OPS"]),
    "workload_through_helper": (
        {**WORKLOAD, "src/repro/bench/level0/foo.py": """\
            def register():
                # Not a Workload() call: the kernel rides a construction helper.
                return make_workload(name="foo", batch_dims=None, pallas_kernel="bogus")
        """}, "workload-contract", ["'bogus' is not a key"]),
    "workload_conditional_test": (
        {**WORKLOAD, **GOOD_KERNEL, "src/repro/bench/level0/foo.py": """\
            def register(impl):
                return Workload(
                    name="foo",
                    batch_dims=(0,),
                    # "other" sits in the test position, not a kernel name.
                    pallas_kernel="badkern" if impl == "other" else None,
                )
        """}, "workload-contract", []),
    "workload_optout_known_kernel": (
        {**WORKLOAD, **GOOD_KERNEL, "src/repro/bench/level0/foo.py": """\
            def register():
                return Workload(name="foo", batch_dims=None, pallas_kernel="badkern")
        """}, "workload-contract", []),
    "workload_computed_tune_space": (
        {**WORKLOAD, "src/repro/kernels/badkern.py": """\
            TILES = ({"block": 128},)

            def tune_space():
                return tuple(dict(t) for t in TILES)
        """, "src/repro/bench/level0/foo.py": "X = 1\n"},
        "workload-contract", ["must return a literal tuple/list of dicts"]),
    "cachekey_fires": (CACHEKEY, "cache-key",
                       ["'impl' never reaches the key", "omits Placement.mode",
                        "axis joined only one of them", "not built ad hoc",
                        "HloDiskCache._tune_path must not subscript the key"]),
    "cachekey_bound_keys": ({**CACHEKEY, **CACHEKEY_OK}, "cache-key", []),
    "stages_fire": (STAGES, "stage-discipline",
                    ["_stage_measure() called outside a _timed_stage span",
                     "without an `if tracer.enabled:` guard"]),
    "stages_timed": (STAGES_OK, "stage-discipline", []),
    "concurrency_serve": ({"src/repro/serve/sink.py": SINK_UNLOCKED}, "concurrency",
                          ["outside `with self._lock:`"]),
    "concurrency_dist": ({"src/repro/dist/sink.py": SINK_UNLOCKED}, "concurrency",
                         ["outside `with self._lock:`"]),
    "concurrency_locked_and_lockfree": (
        {"src/repro/serve/sink.py": SINK_LOCKED, "src/repro/serve/tally.py": TALLY},
        "concurrency", []),
    "proto_unregistered": ({"src/repro/dist/proto.py": PROTO_UNREGISTERED}, "dist-proto",
                           ["would encode but never decode"]),
    "proto_computed_registry": ({"src/repro/dist/proto.py": PROTO_COMPUTED}, "dist-proto",
                                ["dict literal"]),
    "proto_non_stdlib_import": (
        {"src/repro/dist/proto.py": PROTO_UNREGISTERED.replace(
            "import dataclasses", "import dataclasses\n    import jax")},
        "dist-proto", ["pure-stdlib"]),
    "proto_round_trips": ({"src/repro/dist/proto.py": PROTO_OK}, "dist-proto", []),
    "suppression_one_rule": (_suppressed("# repro-check: ignore[concurrency]"),
                             "concurrency", []),
    "suppression_preceding_star": (_suppressed("# repro-check: ignore[*]", preceding=True),
                                   "concurrency", []),
    "suppression_other_rule": (_suppressed("# repro-check: ignore[cache-key]"),
                               "concurrency", ["outside `with self._lock:`"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_port_flags_what_the_reference_flags(tmp_path, case):
    files, rule, fragments = CASES[case]
    jroot = write_tree(tmp_path / "reference", files)
    troot = write_tree(tmp_path / "port", {_port(k): _port(v) for k, v in files.items()})
    want = j_run_checks(jroot, rules=[rule])
    got = run_checks(troot, rules=[rule])
    assert [(f.rule, f.file, f.line) for f in got] == [
        (f.rule, _port(f.file), f.line) for f in want]
    for fragment in fragments:
        assert fragment in messages(got)
    assert bool(got) == bool(fragments)
    assert main(["--root", str(troot), "--rules", rule]) == (1 if fragments else 0)
    # Each checker reads its own package alone.
    assert run_checks(jroot) == [] and j_run_checks(troot) == []


def test_the_lock_rule_covers_the_kernel_build_module(tmp_path):
    root = write_tree(tmp_path, {
        "src/repro_torch/kernels/_build.py": SINK_UNLOCKED,
        "src/repro_torch/kernels/other.py": SINK_UNLOCKED,  # out of the rule's scope
    })
    findings = run_checks(root, rules=["concurrency"])
    assert [(f.file, f.line) for f in findings] == [("src/repro_torch/kernels/_build.py", 9)]


RESULTS_V3 = """\
    SCHEMA_VERSION = 3

    class BenchmarkRecord:
        name: str
        us_per_call: float

    class RunMetadata:
        backend: str
        counters: dict | None = None

    def csv_header():
        return "name,us_per_call"
"""
RESULTS = "src/repro_torch/core/results.py"


def test_schema_drift_missing_fingerprint_fires(tmp_path):
    root = write_tree(tmp_path, {RESULTS: RESULTS_V3})
    findings = run_checks(root, rules=["schema-drift"])
    assert "fingerprint is missing" in messages(findings)
    assert "python -m repro_torch.check --update-schema-fingerprint" in messages(findings)
    assert main(["--root", str(root), "--rules", "schema-drift"]) == 1


@pytest.mark.parametrize("change,fragment", [
    (("us_per_call: float", "us_per_call: float\n    extra: int"),
     "without a SCHEMA_VERSION bump"),
    (("backend: str", "backend: str\n    device_name: str | None = None"),
     "without a SCHEMA_VERSION bump"),
    (("SCHEMA_VERSION = 3", "SCHEMA_VERSION = 4"), "regenerate"),
])
def test_schema_drift_against_the_ports_own_fingerprint(tmp_path, change, fragment):
    root = write_tree(tmp_path, {RESULTS: RESULTS_V3})
    update_fingerprint(root)
    assert (root / "src/repro_torch/check/schema_fingerprint.json").exists()
    assert run_checks(root, rules=["schema-drift"]) == []
    (root / RESULTS).write_text(textwrap.dedent(RESULTS_V3).replace(*change))
    assert fragment in messages(run_checks(root, rules=["schema-drift"]))
    update_fingerprint(root)
    assert run_checks(root, rules=["schema-drift"]) == []


def test_schema_drift_csv_header_must_name_record_fields(tmp_path):
    root = write_tree(tmp_path, {RESULTS: textwrap.dedent(RESULTS_V3).replace(
        '"name,us_per_call"', '"name,bogus_column"')})
    update_fingerprint(root)
    assert "'bogus_column'" in messages(run_checks(root, rules=["schema-drift"]))


def test_cli_json_output(tmp_path, capsys):
    root = write_tree(tmp_path, {"src/repro_torch/serve/sink.py": SINK_UNLOCKED})
    assert main(["--root", str(root), "--json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["count"] == len(payload["findings"]) == 1
    finding = payload["findings"][0]
    assert (finding["rule"], finding["file"], finding["severity"]) == (
        "concurrency", "src/repro_torch/serve/sink.py", "error")


def test_cli_unknown_rule_exits_2_and_empty_tree_is_green(tmp_path, capsys):
    assert main(["--root", str(tmp_path), "--rules", "no-such-rule"]) == 2
    assert "unknown rule" in capsys.readouterr().err
    assert main(["--root", str(tmp_path)]) == 0
    assert "repro_torch.check: 0 findings" in capsys.readouterr().out


def test_cli_update_fingerprint_roundtrip(tmp_path, capsys):
    root = write_tree(tmp_path, {RESULTS: RESULTS_V3})
    assert main(["--root", str(root), "--update-schema-fingerprint"]) == 0
    capsys.readouterr()
    committed = json.loads((root / "src/repro_torch/check/schema_fingerprint.json").read_text())
    assert committed["schema_version"] == 3
    assert committed["record_fields"] == ["name", "us_per_call"]
    assert committed["metadata_fields"] == ["backend", "counters"]
    assert committed["csv_header"] == "name,us_per_call"


def test_every_rule_of_the_reference_is_registered():
    assert [c.rule for c in all_checkers()] == [c.rule for c in j_all_checkers()] == [
        "cache-key", "concurrency", "dist-proto", "schema-drift", "stage-discipline",
        "workload-contract"]


def test_live_repo_is_check_clean():
    findings = run_checks(REPO_ROOT)
    assert findings == [], "\n" + "\n".join(f.format() for f in findings)


def test_python_m_repro_torch_check_exits_0_on_the_repo():
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.check"], env=env,
                         capture_output=True, text=True, timeout=120, cwd=str(REPO_ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("repro_torch.check: 0 findings")


def test_live_repo_fingerprint_is_current_and_the_ports_own():
    from repro_torch.check.core import Context
    from repro_torch.check.schema import FINGERPRINT_FILE, compute_schema

    committed = json.loads((REPO_ROOT / FINGERPRINT_FILE).read_text())
    assert committed == compute_schema(Context(REPO_ROOT))
    assert FINGERPRINT_FILE == "src/repro_torch/check/schema_fingerprint.json"
    assert "counters" in committed["metadata_fields"]
    assert "torch_version" in committed["metadata_fields"]
