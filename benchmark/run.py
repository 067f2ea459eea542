"""The port's benchmark: one cell, one seed, one process.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (workloads/<cell>.json) names a configuration (configs/) and a
traffic mix (traffic/). The run draws the configuration's shard and the
mix's query stream from the seed, builds the port's QueryEngine on the
card over the shard's snapshot, warms it with the stream's first
WARM_BLOCKS blocks, and then, for `--seconds`, drives it as the server's
batcher does: the stream's texts in arrival order, BATCH at a time, each
batch parsed (`parse_query`) and dispatched (`QueryEngine.rank_async`)
before the batch ahead of it is fetched (`.finish()`), IN_FLIGHT batches
on the way. The window's stream is drawn by a child process
(traffic.Feed) as the loop takes it, so it lasts as long as the window
and the loop's host work is the port's alone. No HTTP, batcher or
hydration: the cell measures the engine.

After the window a sample of the answered queries, drawn from the seed,
is held against the configuration's plain reference on the card, once the
port's state is freed; `correct` is that comparison (compare.py) against
the cell's limits. A configuration names its reference by `reference`
(module:Class of this package; reference.py's blend when absent).

The last line of standard output is the result's JSON object: with
`--trace 0` the end-to-end metrics, with `--trace 1` the per-layer ones
(a torch.profiler trace of the window) and a breakdown.
Every metric is a reader in metrics/, found by its file name; a reader
that finds nothing to read returns None and is left out, and so is a
metric that BENCHMARK.json lists for other cells only.

The run refuses to start without a CUDA card (no fallback to the CPU).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import glob  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from dataclasses import dataclass  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that must not be loaded (the JAX package and JAX)
BANNED = ("jax", "jaxlib", "flax", "spaghettisearch_tpu")
#: rows a batch (the server's max_batch), batches in flight (the batcher's
#: fetch stage), rows of each answer, warm-up blocks of the stream (one
#: block is 1,024 queries: 8 batches; 32 blocks, 2-3 s on the card, bring
#: the parse's word cache and the card's clocks to where the window keeps
#: them; a cell may ask for fewer by `warm_blocks`, as the tests' tiny
#: cells do), answers held against the reference
BATCH, IN_FLIGHT, TOPK, WARM_BLOCKS, CHECK_QUERIES = 128, 2, 50, 32, 512
#: the reference of a configuration without a `reference` key
DEFAULT_REFERENCE = "benchmark.reference:Reference"


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(ROOT, "build", "benchmark")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv_compute")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell with its configuration and traffic mix."""
    cell = load_json("workloads", name)
    cell["name"] = name
    cell["config_data"] = load_json("configs", cell["config"])
    cell["traffic_data"] = load_json("traffic", cell["traffic"])
    reference_spec(cell["config_data"])
    return cell


def reference_spec(cfg: dict) -> str:
    """The configuration's `reference`, a module:Class spec. Only this
    package supplies one: the program never brings its own yardstick."""
    spec = cfg.get("reference", DEFAULT_REFERENCE)
    mod, _, cls = spec.partition(":") if isinstance(spec, str) else ("", "", "")
    if mod.split(".", 1)[0] != "benchmark" or not cls:
        raise ValueError("configuration key 'reference' must name a class of the "
                         f"benchmark package as module:Class, not {spec!r}")
    return spec


def _load(spec: str):
    mod, _, cls = spec.partition(":")
    return getattr(importlib.import_module(mod), cls)


def make_reference(cfg: dict, coll, device, **kw):
    """The configuration's plain reference over the shard's raw tokens;
    `kw` adds the control's `dtype`."""
    from benchmark import traffic

    return _load(reference_spec(cfg))(
        coll.title.tok, coll.body.tok, coll.words(), traffic.stopwords(), device, **kw)


def reader(name: str):
    """The metric reader metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.NAME = name
    return mod


def readers() -> list:
    """Every metric reader in metrics/, by file name."""
    return [reader(os.path.basename(p)[:-3])
            for p in sorted(glob.glob(os.path.join(HERE, "metrics", "*.py")))]


def elsewhere(cell_name: str) -> set[str]:
    """Metrics that BENCHMARK.json, beside this folder, lists for other
    cells only (by their `workloads`): a run of this cell leaves them out
    of its line. Without the file, none."""
    try:
        with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json"), encoding="utf-8") as f:
            spec = json.load(f)
    except OSError:
        return set()
    return {m["name"] for m in spec["end_to_end"] + spec["per_layer"]
            if cell_name not in m.get("workloads", [cell_name])}


def banned_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in BANNED)


@dataclass
class Batch:
    i0: int  # first query's index in the window's stream
    n: int
    t_take: float  # texts taken from the stream (before parse_query)
    t_parsed: float  # parse_query returned
    t_dispatched: float  # rank_async returned
    t_done: float = 0.0  # finish() returned the rows
    scores: object = None
    ids: object = None
    has_phrase: bool = False


@dataclass
class Run:
    """What the metric readers read."""

    cell: dict
    coll: object
    kw: list  # keyword ranks per window query
    ph: list  # phrase ranks per window query
    batches: list
    window_s: float
    setup_s: float
    index_build_s: float
    index_bytes: int
    peak_bytes: int | None
    events: object = None  # devtrace.Events of a --trace 1 run


def drive(eng, source, deadline=None, fault=None, traced=False, parse=None):
    """The closed loop: batches of the source's texts (a traffic.Cursor) in
    order, IN_FLIGHT on the way, until the source or the deadline runs
    out. -> list[Batch]."""
    import torch

    span = torch.profiler.record_function if traced else (lambda _n: contextlib.nullcontext())
    clock = time.perf_counter
    out, pending = [], deque()

    def finish(item):
        batch, handle = item
        with span("bench.finish"):
            scores, ids = handle.finish()
        batch.t_done = clock()
        batch.scores, batch.ids = scores, ids
        out.append(batch)

    pos = 0
    while deadline is None or clock() < deadline:
        chunk = source.take(pos, BATCH)
        if not chunk:
            break
        t_take = clock()
        with span("bench.parse"):
            parsed = [parse(t) for t in chunk]
        t_parsed = clock()
        with span("bench.rank_async"):
            handle = eng.rank_async(parsed, topk=TOPK)
        batch = Batch(pos, len(chunk), t_take, t_parsed, clock(),
                      has_phrase=any(p.phrase_hashes for p in parsed))
        if fault is not None:
            handle = fault(len(out) + len(pending), handle)
        pending.append((batch, handle))
        pos += len(chunk)
        # a part of the stream's next block is drawn while the card works
        # through the batches on the way
        with span("bench.stream"):
            source.prefetch(pos)
        if len(pending) >= IN_FLIGHT:
            finish(pending.popleft())
    while pending:
        finish(pending.popleft())
    return out


def _ranker(spec: str):
    return _load(spec)()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_process: float | None = None, fault=None, n_check: int | None = None,
             window_blocks: int | None = None):
    """One run of a cell -> (result dict, checks dict). `fault` wraps each
    dispatched handle (the tests' broken timed path); `window_blocks` ends
    the window's stream after that many blocks (the tests' fixed work)."""
    import numpy as np
    import torch

    from benchmark import collection, compare, devtrace, traffic
    from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query
    from spaghettisearch_tpu_torch.store.tables import Database

    t0 = time.perf_counter() if t_process is None else t_process
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, mix = cell["config_data"], cell["traffic_data"]
    clock = time.perf_counter
    steps = {"imports": clock() - t0}
    t = clock()
    coll = collection.generate(cfg, seed, dev, content_seed=cell["content_seed"])
    steps["generate"] = clock() - t
    t = clock()
    flow = traffic.Traffic(mix, coll, seed, content_seed=cell["content_seed"])
    warm = int(cell.get("warm_blocks", WARM_BLOCKS))
    # the window's stream is drawn by a child process, so that the window's
    # host loop carries the port's work alone. It is forked before the
    # index, the engine and the warm-up, so that what the window writes
    # was made after the fork, or first written in the warm-up, and costs
    # no copy of a page the two processes share; the objects made so far
    # are frozen, out of the collector's way
    gc.collect()
    gc.freeze()
    source = traffic.Feed(flow, warm, window_blocks)
    steps["traffic"] = clock() - t
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    t = clock()
    index = DeviceIndex.from_snapshot(coll.snapshot, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    index_build_s = steps["index"] = clock() - t
    t = clock()
    eng = QueryEngine(db=Database(None), snapshot=coll.snapshot, index=index, device=dev,
                      model=_ranker(cfg["ranker"]))
    drive(eng, traffic.Cursor(flow, 0, warm), parse=parse_query, fault=fault)
    if cuda:
        torch.cuda.synchronize(dev)
    steps["engine_and_warmup"] = clock() - t
    print("setup seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in steps.items()),
          file=sys.stderr)
    print("shard: " + json.dumps({
        **coll.stats, "d_pad": index.n_docs_padded,
        "title_T": int(index.title.fwd.ftT.shape[0]), "body_T": int(index.body.fwd.ftT.shape[0]),
        "title_pos_c": index.title.pos_c, "body_pos_c": index.body.pos_c,
        "hot_terms": 0 if index.hot_body_w is None else int(index.hot_body_w.shape[0]),
        "doc_sorted": index.doc_perm is not None,
    }), file=sys.stderr)

    prof = None
    try:
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.start()
        setup_s = time.perf_counter() - t0
        start = time.perf_counter()
        with (torch.profiler.record_function(devtrace.WINDOW) if trace
              else contextlib.nullcontext()):
            batches = drive(eng, source, deadline=start + seconds, fault=fault,
                            traced=trace, parse=parse_query)
    finally:
        source.close()
        gc.unfreeze()
    window_s = batches[-1].t_done - start
    events = None
    if prof is not None:
        prof.stop()
        events = devtrace.from_profiler(prof)
        del prof
    answered = sum(x.n for x in batches)
    steps_ms = np.diff([x.t_take for x in batches]) * 1e3
    if steps_ms.size:
        print(f"window: {len(batches)} batches, loop step median {np.median(steps_ms):.2f} ms, "
              f"longest {steps_ms.max():.2f} ms", file=sys.stderr)
    stream = source.stream
    texts = stream.texts

    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else None
    index_bytes = int(index.device_bytes())
    del eng, index, flow
    coll.snapshot = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: a sample of the answered queries against the reference
    failed = sum(
        x.n - (len(x.ids) if x.ids is not None and np.shape(x.ids)[1:] == (TOPK,)
               else 0)
        for x in batches
    )
    rng = np.random.default_rng([int(seed), 0xC4])
    n_check = CHECK_QUERIES if n_check is None else n_check
    picks = np.sort(rng.choice(answered, size=min(n_check, answered), replace=False))
    rows = _answers(batches)
    ref = make_reference(cfg, coll, dev)
    t = clock()
    readings = []
    for q in picks.tolist():
        scores, ids = rows[q]
        readings.append(compare.gaps(scores, ids, ref.scores(texts[q])))
    del ref
    print(f"check seconds: {clock() - t:.2f} for {len(picks)} answers", file=sys.stderr)
    worst = compare.worst(readings)
    limits = cell["limits"]
    checks = {n: {"value": worst[n], "limit": float(limits[n])} for n in compare.NUMBERS}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    run = Run(cell=cell, coll=coll, kw=stream.kw, ph=stream.ph,
              batches=batches, window_s=window_s, setup_s=setup_s,
              index_build_s=index_build_s, index_bytes=index_bytes, peak_bytes=peak,
              events=events)
    metrics = {}
    skip = elsewhere(cell["name"])
    for r in readers():
        if bool(getattr(r, "TRACE", True)) != bool(trace) or r.NAME in skip:
            continue
        value = r.read(run)
        if value is not None:
            metrics[r.NAME] = {"value": float(value), "unit": r.UNIT}
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    result = {
        "correct": bool(correct),
        "attempted": int(answered),
        "failed": int(failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
                   "memory_peak_bytes": peak},
    }
    if events is not None:
        result["device"]["busy_s"] = devtrace.busy_ns(events) / 1e9
        result["device"]["window_s"] = devtrace.window_ns(events) / 1e9
        result["breakdown"] = {"device_ops": devtrace.device_ops(events),
                               "idle_gaps": devtrace.idle_gaps(events)}
    result["checks"] = checks
    return result, checks


def _answers(batches) -> dict:
    """Window query index -> (scores, ids) of its answer."""
    out = {}
    for x in batches:
        for j in range(x.n):
            out[x.i0 + j] = (x.scores[j], x.ids[j])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs()
    # the checkout's root, not this folder, heads the path: the port and
    # this package import from there, and no file here shadows a module
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    cell = load_cell(args.workload)
    import torch

    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"the cell needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              t_process=T_PROCESS)
    found = banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for n, c in checks.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
