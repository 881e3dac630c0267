"""The port's examples (``repro_torch/examples/``), each in a fresh
interpreter: with ``--device cpu`` at its smoke size each exits 0 and prints
the reference's lines (``examples/*.py``); without it, on a host with no
card, each exits 2 and measures nothing on the CPU.

The runs start together and the tests read their output. ``train_lm`` runs
its default 5m model for 3 steps, then ``--resume --steps 5``: the resumed
run restarts at step 3, and its printed parameter count is the reference's
``ArchConfig.param_counts()``. ``serve_lm``'s default prompt is 32 tokens
where the reference's is 24: its mixtral smoke config dispatches MoE tokens
in groups of 64, and 4 × 24 does not divide into them (the reference's
example fails its own assertion at its defaults).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.models.config import ArchConfig as RefArchConfig
from repro_torch.examples import train_lm
from repro_torch.models.config import ArchConfig

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
EXAMPLES = ("quickstart", "serve_lm", "run_suite", "feature_analysis", "train_lm")
SUITE_NAMES = ("gemm_bf16_nn", "softmax", "srad", "where", "sort")
DEADLINE = 150
NUM = r"[0-9][0-9,]*(\.[0-9]+)?"


def _start(args, cwd: Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-m", *args], env=env, cwd=str(cwd),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(p: subprocess.Popen) -> tuple[int, str, str]:
    try:
        out, err = p.communicate(timeout=DEADLINE)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        raise AssertionError(f"{p.args} passed its {DEADLINE} s deadline:\n{out}\n{err}")
    return p.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (exit code, stdout, stderr) of every run; ``tmp`` their
    directory."""
    tmp = tmp_path_factory.mktemp("examples")
    ckpt = str(tmp / "ckpt")
    cpu = {
        "quickstart": ["repro_torch.examples.quickstart"],
        "serve_lm": ["repro_torch.examples.serve_lm"],
        "run_suite": ["repro_torch.examples.run_suite", "--names", *SUITE_NAMES, "--preset",
                      "0", "--iters", "2", "--report", str(tmp / "report.json"), "--jsonl",
                      str(tmp / "suite.jsonl")],
        "feature_analysis": ["repro_torch.examples.feature_analysis"],
        "train_lm": ["repro_torch.examples.train_lm", "--steps", "3", "--ckpt", ckpt],
    }
    started = {name: _start([*args, "--device", "cpu"], tmp) for name, args in cpu.items()}
    if not torch.cuda.is_available():
        for name in EXAMPLES:
            started[f"{name}/cuda"] = _start([f"repro_torch.examples.{name}"], tmp)
        started["render/cuda"] = _start(["repro_torch.tools.render_experiments"], tmp)
    results = {name: _finish(p) for name, p in started.items()}
    # The resumed run needs the first run's checkpoint.
    results["train_lm/resume"] = _finish(_start(
        ["repro_torch.examples.train_lm", "--steps", "5", "--resume", "--ckpt", ckpt,
         "--device", "cpu"], tmp))
    results["tmp"] = tmp
    return results


def _ok(runs, name) -> list[str]:
    rc, out, err = runs[name]
    assert rc == 0, f"{name} exited {rc}:\n{out}\n{err[-3000:]}"
    return out.splitlines()


def _matches(lines: list[str], patterns: list[str]) -> None:
    """Each pattern matches a line, in order."""
    it = iter(lines)
    for pat in patterns:
        assert any(re.fullmatch(pat, line) for line in it), f"no line {pat!r} in order:\n" + \
            "\n".join(lines)


def test_quickstart_prints_the_references_lines(runs):
    lines = _ok(runs, "quickstart")
    rows = [rf"  {re.escape(n)}\S* +{NUM} us  compute\|#* *\| memory\|#* *\|"
            for n in ("gemm.bf16.nn", "softmax.", "srad.", "where.")]
    _matches(lines, ["=== 1. Mirovia suite slice \\(preset 0\\) ===", *rows,
                     "=== 2. Train a small qwen-family LM ===",
                     rf"  loss {NUM} -> {NUM} in {NUM}s",
                     r"=== 3. Serve it \(batched greedy decode\) ===",
                     rf"  {NUM} tok/s over 4 requests", r"  sample output tokens: \[[0-9, ]+\]"])
    first, final = re.search(rf"  loss ({NUM}) -> ({NUM}) in", "\n".join(lines)).group(1, 3)
    assert float(final) < float(first)  # the loss goes down


def test_serve_lm_prints_the_references_lines(runs):
    lines = _ok(runs, "serve_lm")
    # 8 requests in 2 rounds of 4: 32-token prompts, 23 decode steps each.
    _matches(lines, [rf"\[serve_lm\] mixtral-8x22b: 8 requests \| 256 prefill \+ 184 decode "
                     rf"tokens \| {NUM}s \| {NUM} tok/s",
                     *(rf"  request {i}: \[[0-9, ]+\]\.\.\." for i in range(3))])


def test_run_suite_prints_the_table_and_writes_its_reports(runs):
    lines = _ok(runs, "run_suite")
    tmp = runs["tmp"]
    _matches(lines, [r"benchmark +us/call  compute +memory +dominant",
                     *(rf"{re.escape(n)}\S* +{NUM}  \|#* *\| \|#* *\| \w+"
                       for n in ("gemm.bf16.nn", "sort.", "softmax.", "srad.", "where.")),
                     rf"6 rows \(0 errors\); backend=cpu devices=1/1 builds=6 cache_hits=0; "
                     rf"report: {re.escape(str(tmp / 'report.json'))} jsonl: "
                     rf"{re.escape(str(tmp / 'suite.jsonl'))}",
                     r"name,us_per_call,devices,placement,derived"])
    records = [json.loads(line) for line in (tmp / "suite.jsonl").read_text().splitlines()]
    assert sum(r.get("kind") == "record" for r in records) == 6
    assert (tmp / "report.json").exists()


def test_feature_analysis_prints_the_four_studies(runs):
    lines = _ok(runs, "feature_analysis")
    titles = ["HyperQ → batched occupancy (Pathfinder)",
              "Unified Memory → staging vs prefetch (BFS)",
              "Cooperative Groups → fused stencil (SRAD)",
              "Dynamic Parallelism → adaptive tiles (Mandelbrot)"]
    rows = {"HyperQ": [f"feat_hyperq.n{n}" for n in (1, 2, 4, 8, 16, 32)],
            "Unified": [f"feat_um.bfs.n{n}" for n in (1024, 8192, 32768)],
            "Cooperative": [f"feat_cg.srad.{n}x{n}" for n in (128, 256, 512, 1024)],
            "Dynamic": [f"feat_dp.mandelbrot.{n}px" for n in (128, 256, 512)]}
    patterns = []
    for title in titles:
        patterns.append(f"=== {re.escape(title)} ===")
        patterns += [rf"  {re.escape(n)} +{NUM} us   \S+=\S+" for n in rows[title.split()[0]]]
    _matches(lines, patterns)


def test_train_lm_counts_the_references_parameters_and_resumes(runs):
    first = _ok(runs, "train_lm")
    resumed = _ok(runs, "train_lm/resume")
    L, d, h, kv, ff, v = train_lm.SIZES["5m"]
    kw = dict(name="train-lm-5m", family="dense", n_layers=L, d_model=d, n_heads=h,
              n_kv_heads=kv, head_dim=d // h, d_ff=ff, vocab=v, dtype="float32")
    n = RefArchConfig(**kw).param_counts()["total"]
    assert ArchConfig(**kw).param_counts()["total"] == n
    ckpt = re.escape(str(runs["tmp"] / "ckpt"))
    _matches(first, [rf"\[train_lm\] train-lm-5m: ~{n / 1e6:.1f}M params",
                     rf"\[train_lm\] step    0 loss {NUM} {NUM} tok/s",
                     rf"\[train_lm\] 6,144 tokens in {NUM}s \({NUM} tok/s\); final loss {NUM}; "
                     rf"checkpoint at {ckpt}"])
    # Steps 3 and 4: the cursor of the first run's last checkpoint.
    _matches(resumed, [rf"\[train_lm\] train-lm-5m: ~{n / 1e6:.1f}M params",
                       r"\[train_lm\] resumed at step 3",
                       rf"\[train_lm\] 4,096 tokens in {NUM}s \({NUM} tok/s\); final loss {NUM}; "
                       rf"checkpoint at {ckpt}"])
    assert sorted(os.listdir(runs["tmp"] / "ckpt")) == ["step_0000000003", "step_0000000005"]


@pytest.mark.parametrize("name", [*EXAMPLES, "render"])
def test_without_a_card_a_cuda_run_exits_2_and_runs_nothing(runs, name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for hosts without one")
    rc, out, err = runs[f"{name}/cuda"]
    assert rc == 2, out + err
    assert "cuda" in err.lower()
    assert out == ""  # no row, step or table on the CPU
