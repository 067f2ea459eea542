"""BENCHMARK.json against the harness's files, the result line's form,
the refusal without a card, a cell added by files alone, and the
benchmark's isolation from JAX and the JAX package."""

from __future__ import annotations

import ast
import glob
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_util import tiny_cell
from benchmark import run

ROOT = run.ROOT
BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def test_benchmark_json_matches_the_files(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"][1] == "benchmark/run.py"
    cells = {w["name"]: w for w in spec["workloads"]}
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as f:
            cfg = json.load(f)
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert cfg["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    for name, w in cells.items():
        assert NAME.match(name) and len(w["why"]) <= 200 and w["chips"] == 1
        cell = run.load_cell(name)
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"], 1)
    readers = {r.NAME: r for r in run.readers()}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        r = readers[m["name"]]
        assert r.UNIT == m["unit"] and r.TRACE == (m["name"] not in e2e)
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
    # each cell reports setup_s, another end-to-end metric, a per-layer one,
    # and the end-to-end metric that each of its per-layer metrics moves
    reported = {m["name"]: set(m.get("workloads", cells)) for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m["workloads"]) <= reported[m["moves"]]
    for name in cells:
        own = {n for n, where in reported.items() if name in where}
        assert "setup_s" in own and len(own) >= 2
        assert any(name in m["workloads"] for m in spec["per_layer"])
    assert set(readers) == e2e | {m["name"] for m in spec["per_layer"]}
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def _line_ok(result: dict, names: set):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) <= names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(result))


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(spec, trace):
    result, _ = run.run_cell(tiny_cell("lucene-mixed"), 51, 1.0, trace, "cpu")
    kinds = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in spec[kinds]}
    _line_ok(result, names)
    assert result["correct"] is True and result["failed"] == 0
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        for key in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][key]) <= 10
    else:
        assert {"qps", "p95_ms", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("trace", [False, True])
def test_line_leaves_out_the_metrics_of_other_cells(spec, trace):
    """A cell's line holds the metrics BENCHMARK.json lists for it: the
    host-paced cell reports neither qps nor p95_ms end to end, and its
    traced line the host-paced readings in place of the others'."""
    result, _ = run.run_cell(tiny_cell("nq-questions"), 53, 1.0, trace, "cpu")
    kinds = "per_layer" if trace else "end_to_end"
    own = {m["name"] for m in spec[kinds] if "nq-questions" in m.get("workloads", ["nq-questions"])}
    _line_ok(result, own)
    if trace:
        # the host's readings (the card's find nothing to read on the CPU)
        assert {"qps.host_paced", "p95_ms.host_paced", "engine.parse_ms.host_paced",
                "engine.dispatch_ms.host_paced"} <= set(result["metrics"])
        assert "engine.dispatch_ms" not in result["metrics"]
    else:
        assert set(result["metrics"]) == {"setup_s"}  # no peak on the CPU


def test_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "lucene-mixed", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0 and proc.stdout == ""


def test_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and benchmark/ exits non-zero
    and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "lucene-mixed", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_cell_added_by_files_alone(tmp_path, monkeypatch):
    """A new configuration, traffic mix, cell and per-layer metric, each a
    new file, found by name with no file of the harness edited."""
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: open(p, "rb").read() for p in glob.glob(str(copy / "**" / "*"), recursive=True)
              if os.path.isfile(p)}
    cfg = json.load(open(copy / "configs" / "luceneutil-wikimedium10m.1of8.json"))
    cfg.update(n_docs=2500, vocab_size=20000, body_words=60)
    (copy / "configs" / "tiny-wiki.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "lucene-terms.json").write_text(json.dumps({
        "df_classes": {"High": [0.01, 1.0], "Med": [0.001, 0.01]},
        "classes": [{"name": "HighTerm", "share": 1, "keywords": ["High"]},
                    {"name": "OrHighMed", "share": 1, "keywords": ["High", "Med"]}]}))
    cell = json.load(open(copy / "workloads" / "lucene-mixed.json"))
    cell.update(config="tiny-wiki", traffic="lucene-terms", warm_blocks=1)
    (copy / "workloads" / "tiny-terms.json").write_text(json.dumps(cell))
    (copy / "metrics" / "window.batches.py").write_text(
        'UNIT = "batches"\nTRACE = False\n\n\ndef read(run):\n    return len(run.batches)\n')
    for p, data in before.items():
        assert open(p, "rb").read() == data
    monkeypatch.setattr(run, "HERE", str(copy))
    result, _ = run.run_cell(run.load_cell("tiny-terms"), 61, 1.0, False, "cpu")
    assert result["correct"] is True
    assert result["metrics"]["window.batches"]["value"] >= 1
    assert result["metrics"]["window.batches"]["unit"] == "batches"
    assert "qps" in result["metrics"]


def test_a_bm25_shard_added_by_files_alone(tmp_path, monkeypatch):
    """A configuration that names BM25's ranker and its reference, and a
    cell over it, each a new file: the harness loads the cell and builds
    both from it, with no file of the harness edited."""
    from benchmark import collection, reference_bm25
    from spaghettisearch_tpu_torch.models.bm25 import BM25Ranker

    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: open(p, "rb").read() for p in glob.glob(str(copy / "**" / "*"), recursive=True)
              if os.path.isfile(p)}
    cfg = json.load(open(copy / "configs" / "luceneutil-wikimedium10m.1of8.json"))
    cfg.update(n_docs=500, vocab_size=5000, body_words=30,
               ranker="spaghettisearch_tpu_torch.models.bm25:BM25Ranker",
               reference="benchmark.reference_bm25:Reference")
    (copy / "configs" / "tiny-wiki-bm25.json").write_text(json.dumps(cfg))
    cell = json.load(open(copy / "workloads" / "lucene-mixed.json"))
    cell.update(config="tiny-wiki-bm25")
    (copy / "workloads" / "tiny-bm25.json").write_text(json.dumps(cell))
    for p, data in before.items():
        assert open(p, "rb").read() == data
    monkeypatch.setattr(run, "HERE", str(copy))
    cfg = run.load_cell("tiny-bm25")["config_data"]
    assert type(run._ranker(cfg["ranker"])) is BM25Ranker
    coll = collection.generate(cfg, 62, "cpu", snapshot=False)
    assert type(run.make_reference(cfg, coll, "cpu")) is reference_bm25.Reference


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_sources_import_neither_jax_nor_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "spaghettisearch_tpu", "bench", "chip_smoke", "experiments"}
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        for mod in _imports(path):
            assert mod.split(".")[0] not in banned, (path, mod)
    # the reference and the comparison import nothing of the port
    for name in ("reference.py", "reference_bm25.py", "compare.py"):
        tops = {m.split(".")[0] for m in _imports(os.path.join(BENCH, name))}
        assert tops <= {"__future__", "re", "numpy", "torch", "benchmark"}, (name, tops)


def test_a_run_loads_no_jax_module():
    """In a fresh process: a whole tiny run, then no module whose top-level
    name is jax, jaxlib, flax or spaghettisearch_tpu (whole names: the
    port's spaghettisearch_tpu_torch begins with the last)."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from bench_util import tiny_cell\n"
        "from benchmark import run\n"
        "res, _ = run.run_cell(tiny_cell('nq-questions'), 71, 1.0, True, 'cpu')\n"
        "assert res['correct']\n"
        "assert 'spaghettisearch_tpu_torch' in sys.modules\n"
        "print('FOUND', run.banned_modules())\n"
    ) % (ROOT, os.path.join(BENCH, "tests"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout
