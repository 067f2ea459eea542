"""Guards around the PyTorch port: it imports with jax, jaxlib, lxml and the
JAX package itself blocked (a GPU host has neither jax nor lxml, and the
port stands alone); its copies of the JAX package's host modules cannot
drift from their originals; its CLI and chip_smoke.py refuse
to run without CUDA instead of falling back; its kernel wrappers refuse
inputs they do not take."""

from __future__ import annotations

import ast
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
            if name.split(".")[0] in ("jax", "jaxlib", "lxml", "spaghettisearch_tpu"):
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


#: top-level names the port and chip_smoke.py never import
_FORBIDDEN = ("jax", "jaxlib", "lxml", "spaghettisearch_tpu")


def test_port_imports_without_jax_or_lxml():
    mods = _port_modules()
    assert "spaghettisearch_tpu_torch.retrieval.engine" in mods and len(mods) > 25
    code = _BLOCKER + textwrap.dedent(f"""
        import importlib.util
        try:
            import spaghettisearch_tpu
        except ImportError:
            pass
        else:
            raise AssertionError("the blocker let the JAX package through")
        for m in {mods!r}:
            importlib.import_module(m)
        spec = importlib.util.spec_from_file_location("chip_smoke", {os.path.join(REPO, "chip_smoke.py")!r})
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


def _sources() -> list[str]:
    root = os.path.dirname(spaghettisearch_tpu_torch.__file__)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, fn) for fn in files if fn.endswith(".py")]
    return sorted(paths)


def test_port_source_never_imports_jax():
    """No absolute import of jax, jaxlib, lxml or the JAX package, at module
    level or inside a function (lxml's one call-time import aside)."""
    for path in _sources():
        tree = ast.parse(open(path, encoding="utf-8").read())
        for node in ast.walk(tree):
            names = (
                [a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                else []
            )
            for n in names:
                if path.endswith(os.path.join("text", "htmlparse.py")) and n == "lxml":
                    continue
                assert n.split(".")[0] not in _FORBIDDEN, (path, n)


#: host modules carried over verbatim: only import lines may differ, plus
#: the listed substitutions (original, copy): comment wording that names the
#: original's own workspace, and the jax.profiler hook, which has no
#: counterpart in the port
COPIES = {
    "config.py": (),
    "store/__init__.py": (),
    "store/docinfo.py": (),
    "store/kv.py": (),
    "store/native_kv.py": (),
    "store/tables.py": (),
    "text/laundry.py": (),
    "text/porter2.py": (),
    "text/stopwords.py": (),
    "utils/__init__.py": (),
    "utils/hashing.py": (),
    "utils/rwlock.py": (),
    "utils/timing.py": ((
        '\n\n@contextlib.contextmanager\ndef device_trace(logdir: str):\n'
        '    """Capture a jax.profiler device trace around a block."""\n'
        '    import jax\n\n'
        '    jax.profiler.start_trace(logdir)\n    try:\n        yield\n'
        '    finally:\n        jax.profiler.stop_trace()\n',
        '\n# Device traces come from torch.profiler (experiments/torch_profile.py);\n'
        '# the jax.profiler hook has no counterpart in this package.\n',
    ),),
    "index/snapshot.py": (),
    "index/persist.py": (),
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
}


def _is_import(line: str) -> bool:
    s = line.lstrip()
    return s.startswith("import ") or (s.startswith("from ") and " import " in s)


def _strip_imports(src: str) -> list[str]:
    return [line for line in src.splitlines() if not _is_import(line)]


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_matches_original(rel):
    orig = open(os.path.join(REPO, "spaghettisearch_tpu", rel), encoding="utf-8").read()
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
        if isinstance(node, ast.FunctionDef):
            node.body = [n for n in node.body if not isinstance(n, (ast.Import, ast.ImportFrom))]
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node)
    return out


def test_summary_extractor_matches_original():
    """text/htmlparse.py carries the original's extract_summary_text and
    what it calls; lxml is imported inside _parse_dom instead of at module
    level."""
    orig = _ast_defs(os.path.join(REPO, "spaghettisearch_tpu", "text", "htmlparse.py"))
    copy = _ast_defs(os.path.join(REPO, "spaghettisearch_tpu_torch", "text", "htmlparse.py"))
    assert set(copy) == {"_SKIP_TEXT_PARENTS", "_SUMMARY_PRUNE", "_parse_dom",
                         "extract_summary_text"}
    for name, src in copy.items():
        assert src == orig[name], name


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
        "class_batching_pays", "commit_refresh", "_phrase_weights",
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
    (["--meshShards", "2"], "meshShards"),
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


def test_wrappers_raise_on_other_devices():
    from spaghettisearch_tpu_torch.ops.kernels import fused, membership, mixed

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
