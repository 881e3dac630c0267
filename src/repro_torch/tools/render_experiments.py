"""Render the dry run's tables from its records.

Counterpart of ``tools/render_experiments.py``: the same three tables
(``dryrun``, ``roofline``, ``variants``) from the records that ``python -m
repro_torch.launch.dryrun`` writes to ``artifacts/dryrun_torch/``, into
``artifacts/tables_torch/`` (the reference's go to ``artifacts/tables/``).
Where the reference's differ:

- a device's capacity is the H100's 80 GB, counted as 80 GiB (``HBM_GIB``,
  the tables' unit, in which PERF.md counts the cells that fit), where the
  reference has a TPU v5e's 16 GiB;
- a cell's seconds are ``trace_s``, the dry run's trace of the step on the
  meta device (its records write ``compile_s: 0.0``: PyTorch compiles
  nothing), where the reference prints XLA's ``compile_s``;
- the next lever of each dominant term names the card's tensor cores, its
  HBM3 and NVLink or the network between hosts.

Stdlib only, as the reference's; ``--device`` is every port CLI's, and a
``cuda`` run (the default) without a card exits 2.

Usage: PYTHONPATH=src python -m repro_torch.tools.render_experiments [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
DRY = os.path.join(ROOT, "artifacts", "dryrun_torch")
OUT = os.path.join(ROOT, "artifacts", "tables_torch")

HBM_GIB = 80.0

ARCH_ORDER = [
    "granite-3-8b", "qwen1.5-0.5b", "granite-8b", "deepseek-7b", "xlstm-350m",
    "mixtral-8x22b", "dbrx-132b", "hubert-xlarge", "jamba-1.5-large-398b",
    "qwen2-vl-2b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str, variant: str, dry: str = DRY) -> dict[tuple[str, str], dict]:
    out = {}
    for p in glob.glob(os.path.join(dry, f"*__{mesh}__{variant}.json")):
        with open(p) as f:
            c = json.load(f)
        out[(c["arch"], c["shape"])] = c
    return out


def _mem_gib(c: dict) -> float:
    m = c.get("memory", {})
    # The rank's arguments and the step's peak beyond them: its live footprint.
    return (m.get("argument_size_in_bytes", 0) + m.get("temp_size_in_bytes", 0)) / 2**30


def _coll_summary(c: dict) -> str:
    hist = c.get("collectives", {})
    parts = [
        f"{k}:{int(v['count'])}×/{v['bytes'] / 1e9:.1f}GB"
        for k, v in sorted(hist.items(), key=lambda kv: -kv[1]["bytes"])
    ]
    return " ".join(parts[:3]) if parts else "-"


def _trace_s(c: dict) -> float:
    return round(c["trace_s"], 2)


def render_dryrun(dry: str = DRY) -> str:
    single = load("single", "baseline", dry)
    multi = load("multi", "baseline", dry)
    lines = [
        f"| arch | shape | 16×16 trace | 2×16×16 trace | mem/dev (args+temp) | fits {HBM_GIB:.0f} GiB | top collectives (per step, per device) |",
        "|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            cs, cm = single.get((a, s)), multi.get((a, s))
            if cs is None:
                continue
            if "skip" in cs:
                lines.append(f"| {a} | {s} | — | — | — | — | *skip: {cs['skip']}* |")
                continue
            gib = _mem_gib(cs)
            fits = "✅" if gib <= HBM_GIB else f"❌ ({gib / HBM_GIB:.1f}×)"
            mc = f"{_trace_s(cm)}s ✓" if cm and "skip" not in cm else "—"
            lines.append(
                f"| {a} | {s} | {_trace_s(cs)}s ✓ | {mc} | {gib:.1f} GiB | {fits} | {_coll_summary(cs)} |"
            )
    return "\n".join(lines)


_MOVE_HINT = {
    "compute": "already tensor-core-bound; gains need better matmul shapes/fusion",
    "memory": "cut HBM3 traffic: avoid f32 score materialization (chunked/online attention, bf16 scores), tighter remat",
    "collective": "cut NVLink and inter-host network bytes: re-shard (replicate small weights / EP where divisible), reduce dispatch traffic, overlap",
}


def render_roofline(dry: str = DRY) -> str:
    single = load("single", "baseline", dry)
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | roofline fraction | 6·N·D / traced | next lever |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            c = single.get((a, s))
            if c is None:
                continue
            if "skip" in c:
                lines.append(f"| {a} | {s} | — | — | — | — | — | — | *skip: {c['skip']}* |")
                continue
            r = c["roofline"]
            lines.append(
                f"| {a} | {s} | {r['compute_s']:.3g} | {r['memory_s']:.3g} | "
                f"{r['collective_s']:.3g} | **{r['dominant']}** | "
                f"{r['roofline_fraction']:.3f} | {c['useful_compute_ratio']:.2f} | "
                f"{_MOVE_HINT[r['dominant']]} |"
            )
    return "\n".join(lines)


def render_variants(dry: str = DRY) -> str:
    """All non-baseline variants vs their baselines."""
    base = load("single", "baseline", dry)
    rows = []
    for p in sorted(glob.glob(os.path.join(dry, "*__single__*.json"))):
        with open(p) as f:
            c = json.load(f)
        if c.get("variant", "baseline") == "baseline" or "skip" in c:
            continue
        b = base.get((c["arch"], c["shape"]))
        if b is None or "skip" in b:
            continue
        rb, rv = b["roofline"], c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['variant']} | "
            f"{rb['compute_s']:.3g}→{rv['compute_s']:.3g} | "
            f"{rb['memory_s']:.3g}→{rv['memory_s']:.3g} | "
            f"{rb['collective_s']:.3g}→{rv['collective_s']:.3g} | "
            f"{rb['roofline_fraction']:.3f}→{rv['roofline_fraction']:.3f} | "
            f"{_mem_gib(b):.1f}→{_mem_gib(c):.1f} GiB |"
        )
    return "\n".join(
        [
            "| arch | shape | variant | compute_s | memory_s | collective_s | fraction | mem/dev |",
            "|---|---|---|---|---|---|---|---|",
        ]
        + rows
    )


def _cuda_available() -> bool:
    try:
        import torch
    except ImportError:
        return False
    return torch.cuda.is_available()


def main(argv=None, *, dry: str = DRY, out: str = OUT) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not _cuda_available():
        print("render_experiments: --device cuda, but no CUDA card is available (ask for "
              "--device cpu)", file=sys.stderr)
        return 2
    os.makedirs(out, exist_ok=True)
    for name, text in (
        ("dryrun", render_dryrun(dry)),
        ("roofline", render_roofline(dry)),
        ("variants", render_variants(dry)),
    ):
        with open(os.path.join(out, name + ".md"), "w") as f:
            f.write(text + "\n")
        print(f"wrote {os.path.relpath(os.path.join(out, name + '.md'), ROOT)} "
              f"({len(text.splitlines())} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
