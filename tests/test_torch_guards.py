"""Guards around the PyTorch port: it imports with jax, jaxlib, lxml,
aiohttp and the JAX package itself blocked (a GPU host has none of the
first four, and the port stands alone); its copies of the JAX package's host modules cannot
drift from their originals; its CLI and chip_smoke.py refuse
to run without CUDA instead of falling back; its kernel wrappers refuse
inputs they do not take."""

from __future__ import annotations

import ast
import glob
import inspect
import os
import pkgutil
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

import spaghettisearch_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    class _Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "lxml", "aiohttp", "spaghettisearch_tpu",
                                      "tests", "bench", "oracle", "corpus", "test_sharded_build"):
                raise ImportError(f"blocked: {name}")
            return None
    sys.meta_path.insert(0, _Block())
""")


def _port_modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages(
            spaghettisearch_tpu_torch.__path__, "spaghettisearch_tpu_torch."
        )
    )


#: scripts beside the package that import only the port: chip_smoke.py and
#: every experiments/torch_*.py (the probes, soaks and profilers ported to
#: the card, their shared set-up, the A/B and profile tools)
_SCRIPTS = ("chip_smoke.py", *sorted(
    os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "experiments", "torch_*.py"))
))

#: top-level names the port and chip_smoke.py never import: the JAX stack,
#: the JAX package, and the repo's bench.py and test modules (tests/ is on
#: sys.path in the JAX package's tests)
_FORBIDDEN = ("jax", "jaxlib", "lxml", "aiohttp", "spaghettisearch_tpu",
              "tests", "bench", "oracle", "corpus", "test_sharded_build")


def test_port_imports_without_jax_or_lxml():
    assert {"experiments/torch_kernel_ab.py", "experiments/torch_profile.py",
            "experiments/torch_sparse_probe.py"} <= set(_SCRIPTS) and len(_SCRIPTS) >= 28
    mods = _port_modules()
    assert "spaghettisearch_tpu_torch.retrieval.engine" in mods and len(mods) > 25
    assert {"spaghettisearch_tpu_torch.parallel.mesh", "spaghettisearch_tpu_torch.parallel.sharded",
            "spaghettisearch_tpu_torch.retrieval.sharded_engine"} <= set(mods)
    code = _BLOCKER + textwrap.dedent(f"""
        import importlib.util, os
        try:
            import spaghettisearch_tpu
        except ImportError:
            pass
        else:
            raise AssertionError("the blocker let the JAX package through")
        for m in {mods!r}:
            importlib.import_module(m)
        for name in {_SCRIPTS!r}:
            spec = importlib.util.spec_from_file_location(
                os.path.basename(name)[:-3], os.path.join({REPO!r}, name))
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules if m.split(".")[0] in {_FORBIDDEN!r}]
        assert not bad, bad
        print("clean")
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr[-3000:]


def test_bench_and_oracle_run_without_jax(tmp_path):
    """The port's bench builds its corpus and runs its oracle parity (which
    imports oracle.py at call time) with jax, lxml, aiohttp, the JAX
    package, bench.py and the test modules blocked."""
    code = _BLOCKER + textwrap.dedent(f"""
        import torch
        torch.set_num_threads(1)
        from spaghettisearch_tpu_torch import bench
        bench.BENCH_DIR = {str(tmp_path)!r}
        bench.build_bench_corpus(bench.corpus_root(80), n_pages=80, device="cpu", quiet=True)
        res = bench.bench_parity(80, 8, "cpu")
        assert res["value"] == 1.0 and res["queries"] == 8, res
        bad = [m for m in sys.modules if m.split(".")[0] in {_FORBIDDEN!r}]
        assert not bad, bad
        tests_dir = {os.path.join(REPO, "tests")!r}
        assert not [m for m in sys.modules.values()
                    if (getattr(m, "__file__", None) or "").startswith(tests_dir)]
        print("clean")
    """)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr[-3000:]


def test_crawl_cli_builds_a_store_without_jax_lxml_aiohttp(tmp_path):
    """`python -m spaghettisearch_tpu_torch.cli.crawl --device cpu` with
    jax, jaxlib, lxml, aiohttp and the JAX package blocked crawls a local
    site into a store and a snapshot."""
    from spaghettisearch_tpu_torch.corpus import render_pages
    from spaghettisearch_tpu_torch.crawl.localsite import LocalSite

    pages = render_pages(n_pages=40, n_vocab=400, seed=1)
    pages["/"] = "".join(f'<a href="/p{i}">p</a>' for i in range(40)).encode()
    with LocalSite(pages) as site:
        argv = ["crawl", "--startURL", site.base + "/", "--numPages", "41", "--skipODP",
                "--device", "cpu", "--db", str(tmp_path / "db"),
                "--saveSnapshot", str(tmp_path / "snap")]
        code = _BLOCKER + textwrap.dedent(f"""
            import runpy
            sys.argv = {argv!r}
            runpy.run_module("spaghettisearch_tpu_torch.cli.crawl", run_name="__main__")
            bad = [m for m in sys.modules if m.split(".")[0] in {_FORBIDDEN!r}]
            assert not bad, bad
        """)
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": REPO},
        )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "(indexed 41, errors 0)" in out.stdout
    assert os.path.isdir(tmp_path / "snap")


def _sources() -> list[str]:
    root = os.path.dirname(spaghettisearch_tpu_torch.__file__)
    paths = [os.path.join(REPO, name) for name in _SCRIPTS]
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, fn) for fn in files if fn.endswith(".py")]
    return sorted(paths)


def test_port_source_never_imports_jax():
    """No absolute import of jax, jaxlib, lxml, aiohttp or the JAX package,
    at module level or inside a function."""
    for path in _sources():
        tree = ast.parse(open(path, encoding="utf-8").read())
        for node in ast.walk(tree):
            names = (
                [a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                else []
            )
            for n in names:
                assert n.split(".")[0] not in _FORBIDDEN, (path, n)


#: the port's Tracer: the original's span aggregator, whose spans and ranges
#: are also torch.profiler ranges while a profiler records, plus counters
_TRACER_ORIG = '''@dataclass
class Tracer:
    """Thread-safe span aggregator."""

    stats: dict[str, SpanStats] = field(default_factory=lambda: defaultdict(SpanStats))
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.stats[name].add(dt)

    def report(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "count": s.count,
                    "total_s": round(s.total_s, 6),
                    "mean_ms": round(1e3 * s.total_s / max(s.count, 1), 3),
                    "max_ms": round(1e3 * s.max_s, 3),
                }
                for name, s in sorted(self.stats.items())
            }

    def reset(self) -> None:
        with self._lock:
            self.stats.clear()
'''
_TRACER_PORT = '''#: what Tracer.range returns while no profiler records (shared, reusable)
_NO_RANGE = contextlib.nullcontext()


@dataclass
class Tracer:
    """Thread-safe span aggregator and counters. While a torch.profiler
    records, every span and range is also a range on the profiler's host
    timeline, on the clock of its device activities, so the device work a
    block launched can be credited to it."""

    stats: dict[str, SpanStats] = field(default_factory=lambda: defaultdict(SpanStats))
    counters: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    _lock: threading.Lock = field(default_factory=threading.Lock)

    @staticmethod
    def range(name: str):
        """A profiler range around a block while a profiler records, else a
        no-op; nothing is aggregated (for device stages, whose host time is
        an asynchronous launch). The range has the scope of an operator,
        not of a user annotation, so the profiler makes no copy of it on
        the device's timeline: the device timeline holds only the work."""
        if _autograd_profiler._is_profiler_enabled:
            return _RecordFunctionFast(name)
        return _NO_RANGE

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with self.range(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.stats[name].add(dt)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def report(self) -> dict[str, dict[str, float]]:
        """Spans (count, total_s, mean_ms, max_ms), then counters (count)."""
        with self._lock:
            out = {
                name: {
                    "count": s.count,
                    "total_s": round(s.total_s, 6),
                    "mean_ms": round(1e3 * s.total_s / max(s.count, 1), 3),
                    "max_ms": round(1e3 * s.max_s, 3),
                }
                for name, s in sorted(self.stats.items())
            }
            out.update((name, {"count": c}) for name, c in sorted(self.counters.items()))
            return out

    def reset(self) -> None:
        with self._lock:
            self.stats.clear()
            self.counters.clear()
'''

#: host modules carried over verbatim: only import lines may differ, plus
#: the listed substitutions (original, copy): comment wording that names the
#: original's own workspace, the body of the device-trace hook
#: (jax.profiler in the original, torch.profiler in the port), and the
#: port's Tracer
COPIES = {
    "config.py": (),
    "store/__init__.py": (),
    "store/docinfo.py": (),
    "store/kv.py": (),
    "store/native_kv.py": (),
    "store/tables.py": (  # the docs pack's torn-tail repair (store/durable_kv.py)
        ("                    parts = line.split()\n",
         "                    if not line.endswith(\"\\n\"):\n"
         "                        continue  # torn tail: its writer died mid-line\n"
         "                    parts = line.split()\n"),
        ('            self._iw = open(self.idx_path, "a", encoding="utf-8")\n',
         "            cut_torn_line(self.idx_path)  # never glue a line onto a torn one\n"
         '            self._iw = open(self.idx_path, "a", encoding="utf-8")\n'),
    ),
    "text/laundry.py": (),
    "text/porter2.py": (),
    "text/stopwords.py": (),
    "utils/__init__.py": (),
    "utils/hashing.py": (),
    "utils/rwlock.py": (),
    "utils/timing.py": (
        ("hook into\njax.profiler for", "hook into\ntorch.profiler for"),
        ('    """Capture a jax.profiler device trace around a block."""\n'
         '    import jax\n\n'
         '    jax.profiler.start_trace(logdir)\n    try:\n        yield\n'
         '    finally:\n        jax.profiler.stop_trace()\n',
         '    """Capture a torch.profiler trace around a block (host activity, and\n'
         '    the CUDA kernels when CUDA is present); writes a Chrome trace file into\n'
         '    `logdir` when the block exits."""\n'
         '    import os\n\n'
         '    import torch\n'
         '    from torch.profiler import ProfilerActivity, profile\n\n'
         '    activities = [ProfilerActivity.CPU]\n'
         '    if torch.cuda.is_available():\n'
         '        activities.append(ProfilerActivity.CUDA)\n'
         '    os.makedirs(logdir, exist_ok=True)\n'
         '    with profile(activities=activities) as prof:\n'
         '        yield\n'
         '    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))\n'),
        ("from dataclasses import dataclass, field\n",
         "from dataclasses import dataclass, field\n\n"
         "from torch._C._profiler import _RecordFunctionFast\n"
         "from torch.autograd import profiler as _autograd_profiler\n"),
        (_TRACER_ORIG, _TRACER_PORT),
    ),
    "index/snapshot.py": (),
    "index/persist.py": (),
    "index/indexer.py": (),
    "text/page.py": (),
    "cli/debug_db.py": (),
    "evaluation.py": (),
    "crawl/__init__.py": (),
    "crawl/frontier.py": (("own_fetcher = AiohttpFetcher()", "own_fetcher = UrllibFetcher()"),),
    "ops/weighting.py": (("crawl driver still", "crawl command still"),),
    "retrieval/summary.py": (),
    "retrieval/native_summary.py": (),
    "retrieval/native_hydrate.py": (),
    "retrieval/hydration_sidecar.py": ((
        "BadgerDB (/root/reference/retrieval/", "BadgerDB (reference retrieval/",
    ),),
    "retrieval/topics.py": (),
    "serve/batcher.py": (("FINDINGS sessions 5-6", "FINDINGS s5-6"),),
    "serve/fastloop.py": (),
    "serve/server.py": (),
    "serve/static/index.html": (),
    "oracle.py": (),
}
#: copies whose original lives outside the JAX package
ORIGINS = {"oracle.py": "tests/oracle.py"}


def _is_import(line: str) -> bool:
    s = line.lstrip()
    return s.startswith("import ") or (s.startswith("from ") and " import " in s)


def _strip_imports(src: str) -> list[str]:
    return [line for line in src.splitlines() if not _is_import(line)]


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_matches_original(rel):
    orig_path = ORIGINS.get(rel, os.path.join("spaghettisearch_tpu", rel))
    orig = open(os.path.join(REPO, orig_path), encoding="utf-8").read()
    copy = open(os.path.join(REPO, "spaghettisearch_tpu_torch", rel), encoding="utf-8").read()
    for a, b in COPIES[rel]:
        assert copy.count(b) == 1
        copy = copy.replace(b, a)
    assert _strip_imports(copy) == _strip_imports(orig)


def _ast_defs(path: str) -> dict[str, str]:
    """Top-level functions and assignments of a source file, each dumped
    without its import statements (those may differ between copies)."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            node.body = [n for n in node.body if not isinstance(n, (ast.Import, ast.ImportFrom))]
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node)
    return out


#: (module, names): functions and constants of the JAX package's module that
#: the port's module of the same path carries unchanged (the rest of each
#: port module is its own: the DOM walks, the fetcher, the tensor code)
PORTED_DEFS = {
    "text/htmlparse.py": ("_URL_WS", "_SKIP_TEXT_PARENTS", "_META_NAMES", "_SUMMARY_PRUNE",
                          "clean_url", "_base_authority", "resolve_href", "tokenize_page",
                          "extract_summary_text"),
    "crawl/odp.py": ("TopicData", "crawl_topic", "parse_odp"),
    "crawl/fetch.py": ("HEADERS", "FetchResult", "parse_last_modified", "DictFetcher"),
    "ops/pagerank.py": ("DEFAULT_MAX_ITERS", "topic_personalization", "_load_graph"),
}


@pytest.mark.parametrize("rel", sorted(PORTED_DEFS))
def test_ported_defs_match_original(rel):
    orig = _ast_defs(os.path.join(REPO, "spaghettisearch_tpu", rel))
    copy = _ast_defs(os.path.join(REPO, "spaghettisearch_tpu_torch", rel))
    for name in PORTED_DEFS[rel]:
        assert copy[name] == orig[name], name


_SUMMARY_PAGES = {
    "sections": b"""<html><head><title> T </title><meta name="keywords" content="k1, k2">
<script>skip()</script></head><body><nav><a href="/n">nav</a></nav><p>body text
<a href="/x">anchor</a> tail</p><noscript>ns</noscript></body></html>""",
    "fragment": b"one <b>two</b> <a href='rel/x'>three</a> four",
    "charset": b'<meta charset="utf-8"><title>caf\xc3\xa9</title><p>na\xc3\xafve <i>r\xc3\xa9sum\xc3\xa9</i></p>',
    "latin1": b"<p>caf\xc3\xa9 &amp; cr\xe8me<!-- c --> tail<br>after</p>",
}


@pytest.mark.parametrize("name", sorted(_SUMMARY_PAGES))
def test_summary_and_tokenizer_match_original(name):
    """The port's summary extractor and tokenizer (on its own DOM, no lxml)
    give the JAX package's output on fixed pages."""
    from spaghettisearch_tpu.text import htmlparse as jhp
    from spaghettisearch_tpu_torch.text import htmlparse as thp

    raw = _SUMMARY_PAGES[name]
    assert thp.extract_summary_text(raw) == jhp.extract_summary_text(raw)
    base = "http://site.local/a/b.html"
    assert thp.tokenize_page(raw, base, True).__dict__ == jhp.tokenize_page(raw, base, True).__dict__


def _func_src(obj) -> str:
    """A function's code without its docstring (comments stripped by ast)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    fn = tree.body[0]
    body = fn.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        fn.body = body[1:]
    return ast.dump(fn)


def test_ported_host_code_matches_original():
    """The engine's host-only half (hydration, prewarm, sidecar, wordlist,
    row filling) and the device index's numpy layout code are copies."""
    from spaghettisearch_tpu.retrieval import device_index as jdi
    from spaghettisearch_tpu.retrieval import engine as jeng
    from spaghettisearch_tpu_torch.retrieval import device_index as tdi
    from spaghettisearch_tpu_torch.retrieval import engine as teng

    for name in (
        "query", "query_batch", "prewarm_hydration", "_prewarm_streaming",
        "_hyd_sidecar_key", "_load_hyd_sidecar", "_save_hyd_sidecar", "_doc_record",
        "_topic_pagerank", "_keep", "hydrate_row", "hydrate_row_json",
        "prewarm_wordlist", "wordlist", "_fill_keyword_rows", "_hot_map",
        "class_batching_pays", "commit_refresh", "refresh", "_phrase_weights",
    ):
        assert _func_src(getattr(teng.QueryEngine, name)) == _func_src(
            getattr(jeng.QueryEngine, name)
        ), name
    assert teng.QueryEngine.PREWARM_BUDGET_BYTES == jeng.QueryEngine.PREWARM_BUDGET_BYTES
    assert inspect.getsource(teng._MultiRankHandle) == inspect.getsource(jeng._MultiRankHandle)
    for name in ("_p_level", "_pow2", "_e_levels", "_cap_levels"):
        assert _func_src(getattr(teng, name)) == _func_src(getattr(jeng, name)), name
    for name in ("_doc_sort_pays", "_doc_sort_perm", "_round_up", "_build_hot_cache",
                 "_build_posT", "build_posT_raw"):
        assert _func_src(getattr(tdi, name)) == _func_src(getattr(jdi, name)), name
    from spaghettisearch_tpu.models import bm25 as jbm25
    from spaghettisearch_tpu_torch.models import bm25 as tbm25

    assert _func_src(tbm25.bm25_posting_weights) == _func_src(jbm25.bm25_posting_weights)
    for name in ("DOC_BLOCK", "DOC_TERM_CAP", "DOC_SORT_MIN_DOCS", "DOC_SORT_TC",
                 "POS_MAT_BUDGET_BYTES", "POS_T_BUDGET_BYTES", "POS_T_C_MAX",
                 "POS_T_INT16", "HOT_W_BUDGET_BYTES", "HOT_H_MAX", "HOT_MAX_DPAD",
                 "FWD_DEV_MAX_DPAD"):
        assert getattr(tdi, name) == getattr(jdi, name), name
    for name in ("WARM_B_MAX", "B_SMALL", "B_BIG", "B_PHRASE", "Q_BASE", "Q_CATCHALL",
                 "P_LEVELS", "SEGREGATE_MIN_DOCS", "MATCHER_BP", "E_BASE"):
        assert getattr(teng, name) == getattr(jeng, name), name


def test_parse_query_matches_jax():
    from spaghettisearch_tpu.retrieval.engine import parse_query as jparse
    from spaghettisearch_tpu_torch.retrieval.engine import parse_query

    for q in ('"quantum physics" galaxy', "Running runners ran", '"a" "b c" d', ""):
        assert parse_query(q).__dict__ == jparse(q).__dict__


@pytest.mark.parametrize("argv,msg", [
    (["--device", "cuda"], "CUDA is not available"),
    # --ranker bm25 is served: it gets past the options to the device check
    pytest.param(["--ranker", "bm25"], "CUDA is not available", id="argv1-bm25"),
    # --meshShards is served: without CUDA it stops at the same device check
    pytest.param(["--meshShards", "2"], "CUDA is not available", id="argv2-meshShards"),
    (["--platform", "cpu"], "platform"),
])
def test_server_cli_refuses(argv, msg, monkeypatch):
    from spaghettisearch_tpu_torch.cli import server as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["--db", "/nonexistent-db"] + argv)
    assert msg in str(e.value)


def test_server_cli_serves_bm25(tmp_path, monkeypatch):
    """--ranker bm25 builds the engine on BM25Ranker and hands it to the
    server (stubbed here, so nothing listens)."""
    from corpus import build_corpus_db
    from spaghettisearch_tpu_torch.cli import server as cli
    from spaghettisearch_tpu_torch.models.bm25 import BM25Ranker

    build_corpus_db(n_pages=12, seed=7, root=str(tmp_path / "db")).close()
    served = []

    class Server:
        def __init__(self, engine, **kwargs):
            served.append(engine)

        def serve(self, port):
            served.append(port)

    monkeypatch.setattr(cli, "SearchServer", Server)
    cli.main(["--db", str(tmp_path / "db"), "--device", "cpu", "--ranker", "bm25",
              "--port", "0"])
    engine, port = served
    assert isinstance(engine.model, BM25Ranker) and port == 0
    assert engine.query('"gradient"') == engine.query_batch(['"gradient"'])[0]
    engine.db.close()


@pytest.mark.parametrize("cli_name", ["crawl", "debug_retrieval"])
def test_offline_clis_refuse_without_cuda(cli_name, monkeypatch):
    """The crawl and debug CLIs default to --device cuda and refuse to
    start without it (no fallback to the CPU)."""
    import importlib

    cli = importlib.import_module(f"spaghettisearch_tpu_torch.cli.{cli_name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["--db", "/nonexistent-db"])
    assert "CUDA is not available" in str(e.value)


def test_update_pagerank_refuses_without_cuda(monkeypatch):
    from spaghettisearch_tpu_torch.ops.pagerank import update_pagerank
    from spaghettisearch_tpu_torch.store.tables import Database

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = Database()
    db.doc_children.set("a", ["b"])
    db.topic_meta.set("Sci", {"numPages": 2.0, "wordCount": 1.0})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        update_pagerank(db)
    assert len(db.doc_rank) == 0


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for cwd in (REPO, str(tmp_path)):
        script = os.path.join(cwd, "chip_smoke.py")
        if cwd != REPO:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        out = subprocess.run(
            [sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.parametrize("which", ["soak", "soak_sharded", "chip_smoke"])
def test_soak_append_snippets_run_without_jax(which, tmp_path):
    """The code strings run in append subprocesses (the soaks' and
    chip_smoke.py's refresh phase) import nothing of jax, lxml, aiohttp or
    the JAX package: each runs under the import blocker and appends to a
    fresh store."""
    import importlib
    import importlib.util

    root = str(tmp_path / "db")
    if which == "chip_smoke":
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_snippet", os.path.join(REPO, "chip_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        snippet = mod.REFRESH_SNIPPET.format(here=REPO, root=root, seed=0, n=mod.REFRESH_PAGES,
                                             base="http://refresh0.local",
                                             marker=mod.REFRESH_MARKERS[0])
        want_docs = mod.REFRESH_PAGES
    else:
        mod = importlib.import_module(f"spaghettisearch_tpu_torch.cli.{which}")
        fields = {"repo": REPO, "root": root, "seed": 1000, "base": 1000, "count": 64,
                  "start": 0}
        snippet = mod.APPEND_SNIPPET.format(**fields)
        want_docs = 10 if which == "soak" else 64
    for node in ast.walk(ast.parse(snippet)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
            assert all(n.split(".")[0] not in _FORBIDDEN for n in names), (which, names)
    code = _BLOCKER + snippet + textwrap.dedent(f"""
        bad = [m for m in sys.modules if m.split(".")[0] in {_FORBIDDEN!r}]
        assert not bad, bad
        from spaghettisearch_tpu_torch.store.tables import Database
        print("docs", len(Database({root!r}).doc_info))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split("docs")[-1]) >= want_docs


def test_wrappers_raise_on_other_devices():
    from spaghettisearch_tpu_torch.ops.kernels import (
        fused, fused_topk, membership, mixed, phrase_delta,
    )

    meta = torch.empty((8, 4), dtype=torch.int32, device="meta")
    t = torch.empty((8, 512), dtype=torch.int32, device="meta")
    w = torch.empty((8, 512), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        membership.forward_scores_2sec(t, w, t, w, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        membership.forward_scores(t, w, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fused.fused_final_scores(t, w, t, w, w[0], w[0], w[:1], meta,
                                 w[:, 0].clone(), w[:, :1].clone())
    with pytest.raises(ValueError, match="unsupported device"):
        mixed.mixed_scores_2sec(t, w, t, w, w, w, meta, meta[:, 0], meta, w[:, :4], meta[:, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_topk.fused_topk(t, w, t, w, w[0], w[0], meta, w[:, 0].clone())
    with pytest.raises(ValueError, match="unsupported device"):
        phrase_delta.phrase_delta(t, w, t, w, w, w, meta, w[:, :4], meta[:, 0])
