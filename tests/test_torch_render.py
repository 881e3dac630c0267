"""The tables tool (``repro_torch/tools/render_experiments.py``) against the
reference's (``tools/render_experiments.py``, loaded by path, its ``DRY`` and
``OUT`` set on the module object): both render the same synthetic dry-run
records in a ``tmp_path``, and the tables match row for row except where the
port says the card's own: a cell's seconds are ``trace_s`` (the reference's
column ``compile_s``; the records here carry both, equal), a device holds 80
GiB (the reference's 16), the roofline table's ratio is over the traced FLOPs
(the reference's "HLO"), and each dominant term's lever names the card's
tensor cores, HBM3 and NVLink.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.tools import render_experiments as port

ROOT = Path(__file__).resolve().parents[1]

# (arch, shape, mesh, variant) -> (args + temp GiB, dominant, trace seconds)
CELLS = {
    ("granite-3-8b", "train_4k", "single", "baseline"): (72.9, "memory", 21.46),
    ("granite-3-8b", "train_4k", "multi", "baseline"): (40.2, "memory", 20.04),
    ("granite-3-8b", "prefill_32k", "single", "baseline"): (12.0, "compute", 4.1),
    ("qwen1.5-0.5b", "train_4k", "single", "baseline"): (186.6, "collective", 14.23),
    ("mixtral-8x22b", "decode_32k", "single", "baseline"): (16.0, "collective", 3.0),
    ("mixtral-8x22b", "decode_32k", "multi", "baseline"): (8.0, "collective", 2.5),
    ("jamba-1.5-large-398b", "train_4k", "single", "baseline"): (418.98, "compute", 99.99),
    ("granite-3-8b", "train_4k", "single", "zero"): (60.0, "memory", 22.0),
    ("qwen1.5-0.5b", "train_4k", "single", "seqshard"): (150.5, "collective", 15.0),
}
SKIPS = {("hubert-xlarge", "decode_32k", "single", "baseline"): "encoder-only: no decode",
         ("granite-3-8b", "long_500k", "single", "baseline"): "pure full-attention arch"}
HINTS = {"compute": "tensor-core", "memory": "HBM3", "collective": "NVLink"}


def _record(arch, shape, mesh, variant, gib, dominant, seconds, i) -> dict:
    terms = {"compute": 1.0 + i, "memory": 0.5 + i / 7, "collective": 0.25 + i / 3}
    terms[dominant] = 10.0 + i
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "variant": variant,
        "compile_s": seconds, "trace_s": seconds,
        "memory": {"argument_size_in_bytes": 0.25 * gib * 2**30,
                   "temp_size_in_bytes": 0.75 * gib * 2**30},
        "collectives": {"all-gather": {"count": 10 + i, "bytes": 3e9 * (i + 1)},
                        "all-reduce": {"count": 20, "bytes": 2.5e9},
                        "reduce-scatter": {"count": 5, "bytes": 1e8 * i},
                        "all-to-all": {"count": 1, "bytes": 1e6}},
        "roofline": {"compute_s": terms["compute"], "memory_s": terms["memory"],
                     "collective_s": terms["collective"], "dominant": dominant,
                     "roofline_fraction": 0.123 + i / 100},
        "useful_compute_ratio": 0.5 + i / 10,
    }


@pytest.fixture
def dry(tmp_path) -> Path:
    d = tmp_path / "dryrun"
    d.mkdir()
    for i, ((arch, shape, mesh, variant), (gib, dom, s)) in enumerate(CELLS.items()):
        rec = _record(arch, shape, mesh, variant, gib, dom, s, i)
        (d / f"{arch}__{shape}__{mesh}__{variant}.json").write_text(json.dumps(rec))
    for (arch, shape, mesh, variant), why in SKIPS.items():
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "variant": variant, "skip": why}
        (d / f"{arch}__{shape}__{mesh}__{variant}.json").write_text(json.dumps(rec))
    return d


@pytest.fixture
def reference(dry, tmp_path):
    spec = importlib.util.spec_from_file_location("reference_render_experiments",
                                                  ROOT / "tools" / "render_experiments.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DRY, mod.OUT = str(dry), str(tmp_path / "reference_tables")
    return mod


def _cells(line: str) -> list[str]:
    return [c.strip() for c in line.strip("|").split("|")]


def test_dryrun_table_matches_the_references_row_for_row(reference, dry):
    want, got = reference.render_dryrun().splitlines(), port.render_dryrun(str(dry)).splitlines()
    assert len(got) == len(want) == 2 + 7  # header, rule, 5 traced baselines, 2 skips
    assert got[0] == (want[0].replace("compile", "trace").replace("fits 16 GiB", "fits 80 GiB"))
    assert got[1] == want[1]
    for g, w in zip(got[2:], want[2:], strict=True):
        gc, wc = _cells(g), _cells(w)
        assert gc[:5] + gc[6:] == wc[:5] + wc[6:]
        if "skip" in w:
            continue
        gib = float(gc[4].split()[0])
        assert gc[5] == ("✅" if gib <= 80 else f"❌ ({gib / 80:.1f}×)")
        assert wc[5] == ("✅" if gib <= 16 else f"❌ ({gib / 16:.1f}×)")
    # A cell within 80 GiB but past 16 fits on the card alone.
    assert any("72.9 GiB | ✅" in line for line in got)
    assert any("72.9 GiB | ❌ (4.6×)" in line for line in want)


def test_roofline_table_matches_the_references_row_for_row(reference, dry):
    want = reference.render_roofline().splitlines()
    got = port.render_roofline(str(dry)).splitlines()
    assert got[0] == want[0].replace("6·N·D / HLO", "6·N·D / traced")
    assert len(got) == len(want) == 2 + 7
    assert got[1] == want[1]
    for g, w in zip(got[2:], want[2:], strict=True):
        gc, wc = _cells(g), _cells(w)
        assert gc[:-1] == wc[:-1]
        if "skip" in w:
            assert gc[-1] == wc[-1]
            continue
        dominant = gc[5].strip("*")
        assert HINTS[dominant] in gc[-1]
        assert not any(word in gc[-1] for word in ("MXU", "ICI", "TPU"))


def test_variants_table_equals_the_references(reference, dry):
    got = port.render_variants(str(dry))
    assert got == reference.render_variants()
    assert len(got.splitlines()) == 2 + 2  # zero and seqshard against their baselines


def test_main_writes_the_three_tables_where_asked(reference, dry, tmp_path, capsys):
    out = tmp_path / "tables"
    assert port.main(["--device", "cpu"], dry=str(dry), out=str(out)) == 0
    assert sorted(os.listdir(out)) == ["dryrun.md", "roofline.md", "variants.md"]
    assert (out / "variants.md").read_text() == reference.render_variants() + "\n"
    printed = capsys.readouterr().out.splitlines()
    assert [line.split(" (")[0].rsplit("/", 1)[1] for line in printed] == [
        "dryrun.md", "roofline.md", "variants.md"]
    # The defaults: the port's own directories, never the reference's.
    assert Path(port.DRY).resolve() == ROOT / "artifacts" / "dryrun_torch"
    assert Path(port.OUT).resolve() == ROOT / "artifacts" / "tables_torch"


def test_the_tool_imports_neither_torch_nor_numpy():
    """Stdlib only, as the reference's: it renders where torch is absent."""
    script = textwrap.dedent("""
        import sys
        import repro_torch.tools.render_experiments
        heavy = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "numpy"))
        sys.exit(1 if heavy else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
