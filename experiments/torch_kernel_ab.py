#!/usr/bin/env python3
"""Time the kernels of one checkout of the PyTorch port on one GPU.

    python3 experiments/torch_kernel_ab.py --tree DIR --db build/ab_corpus [--write]

Imports spaghettisearch_tpu_torch from DIR (a checkout of any commit of
the port), opens the seeded 100k-page benchmark corpus at --db through that
checkout's store (with --write it first writes it there), builds the
device index as the engine does, and measures on the card:
  - K1 at B=128 (Q=4, hot split, doc-sorted bound, counts as the engine
    emits them), K2 at B=128 (Q=4, P=16) and at B=16 (Q=4, P=4, the
    serving shape), K3 at B=128 (body section, counts on, Q=4: the
    custom-blend route's call), K4 at B=128 (Q=4, topics off), one
    custom-blend rank at B=128 (BlendedRanker._custom_forward: two K3
    calls, phrase fold, finalize, top-k), K5 at B=256 (Q=4, k_pad=16,
    chip_smoke.py phase 4's batch) and K6 on the B=128, P=16 mixed batch's
    first 16 rows and on all 128 (flag off, and on at bp=128): the call,
    by CUDA events over 50 calls back to back (check.time_ms), and each
    kernel it launches alone, by torch.profiler (device time per call of
    every kernel in the trace, by name: the probe-table build, the sweep,
    K5's merge; `kernel_device_ms` sums them);
  - each result against its plain version (check.compare, compare_section,
    compare_final; the custom rank's top-50 scores against the rank with
    K3's plain version);
  - with --serve, --bursts bursts (default 1) of 320 POST /query from 8
    clients through the checkout's HTTP front end (req/s, latency p50/p99,
    launches, batches per burst).
Prints one JSON line. To compare two commits, run it in one chip call for
both, in turns (parent, change, change, parent), on the same --db; with
--outputs FILE the first run saves every case's outputs and the later ones
report whether theirs are bit-identical (a kernel refactor that must not
change a result). With --occupancy it also prints, per kernel the cases
launched, the nvcc/ptxas lines of its build (registers, spills, static
shared memory), its launch shape and dynamic shared memory (from the
profiler's trace), and its resident blocks per SM
(cuOccupancyMaxActiveBlocksPerMultiprocessor on the library's own cubin,
loaded through libcuda).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose port is measured")
    ap.add_argument("--db", required=True, help="corpus directory")
    ap.add_argument("--write", action="store_true", help="write the corpus first")
    ap.add_argument("--label", default="")
    ap.add_argument("--serve", action="store_true", help="also time a serving burst")
    ap.add_argument("--bursts", type=int, default=1, help="measured serving bursts")
    ap.add_argument("--outputs", default="", help="save each case's outputs here, or, when "
                    "the file exists, compare them with the saved ones bit for bit")
    ap.add_argument("--occupancy", action="store_true",
                    help="also report each kernel's build lines, launch shape and occupancy")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    from spaghettisearch_tpu_torch import corpus
    from spaghettisearch_tpu_torch.index.snapshot import build_snapshot
    from spaghettisearch_tpu_torch.models.blended import BlendedRanker
    from spaghettisearch_tpu_torch.ops.kernels import check, membership
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    if args.write:
        import shutil

        shutil.rmtree(args.db, ignore_errors=True)
        db = corpus.write_corpus(args.db, n_pages=100_000, seed=0)
    else:
        db = corpus.Database(args.db)
    snap = build_snapshot(db)
    idx = QueryEngine(db, snapshot=snap, device="cuda").index
    setup_s = time.perf_counter() - t0
    df = snap.body.df(range(snap.n_words)).astype("float64")
    emit = idx.has_zero_weight
    tmax = idx.body.tmax_blocks is not None
    kbatch = check.to_device(check.keyword_batch(idx, 128, 4, seed=4, df=df), "cuda")
    cbatch = check.to_device(check.keyword_batch(idx, 128, 4, seed=4, df=df, split=False), "cuda")
    m128 = check.to_device(check.mixed_batch(idx, 128, 4, 16, seed=1, df=df, snap=snap), "cuda")
    m16 = check.to_device(check.mixed_batch(idx, 16, 4, 4, seed=2, df=df, snap=snap), "cuda")
    k4_in = check.fused_inputs(idx, cbatch, 1, seed=1)
    k5_in = check.k5_inputs(idx, check.to_device(
        check.keyword_batch(idx, 256, 4, seed=256, df=df, split=False), "cuda"))
    qlen = cbatch["qn"].clamp(min=1).to(torch.float32)
    tp0 = torch.zeros((128, idx.n_categories), device="cuda")
    title_only = BlendedRanker(w_pagerank=0.0, w_title=1.0, w_body=0.0)

    def custom_rank(plain=False):
        saved = membership.forward_scores
        if plain:
            membership.forward_scores = lambda ftT, fwT, tq, qn=None, *, emit_counts=True: (
                membership.plain_section_scores(ftT, fwT, tq))
        try:
            return title_only._custom_forward(idx, cbatch["term_ids"], qlen, tp0, 50,
                                              qn=cbatch["qn"])
        finally:
            membership.forward_scores = saved

    cases = {  # name -> (run(plain=False), compare(got, want))
        "K1 B=128": (lambda plain=False: check.run_k1(idx, kbatch, emit, tmax, plain=plain),
                     check.compare),
        "K2 B=128": (lambda plain=False: check.run_k2(idx, m128, emit, plain=plain),
                     check.compare),
        "K2 B=16": (lambda plain=False: check.run_k2(idx, m16, emit, plain=plain),
                    check.compare),
        "K3 body B=128": (lambda plain=False: check.run_k3(idx, cbatch, True, "body",
                                                           plain=plain),
                          check.compare_section),
        "K4 B=128 C=1": (lambda plain=False: check.run_k4(idx, cbatch, k4_in, plain=plain),
                         check.compare_final),
        "custom rank B=128": (custom_rank,
                              lambda got, want: check.compare_final(got[0], want[0])),
        "K5 B=256": (lambda plain=False: check.run_k5(k5_in, plain=plain), check.compare_topk),
        "K6 bp=16": (lambda plain=False: check.run_k6(idx, m128, False, 16, plain=plain),
                     check.compare_delta),
        "K6 bp=128": (lambda plain=False: check.run_k6(idx, m128, False, plain=plain),
                      check.compare_delta),
        "K6 bp=128 flag": (lambda plain=False: check.run_k6(idx, m128, True, plain=plain),
                           check.compare_delta),
    }
    out = {"label": args.label, "device": smi, "setup_s": setup_s, "cases": {}}
    saved = torch.load(args.outputs) if args.outputs and os.path.exists(args.outputs) else None
    outputs = {}
    cubins = Cubins() if args.occupancy else None
    for name, (run, compare) in cases.items():
        got = run()
        outputs[name] = [x.cpu() for x in got if isinstance(x, torch.Tensor)]
        rep = compare(got, run(plain=True))
        ms = check.time_ms(run, iters=50, warmup=5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
        per_kernel = {}
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                key = short_name(e.key)
                per_kernel[key] = per_kernel.get(key, 0.0) + e.self_device_time_total / 1e3 / 20
        out["cases"][name] = {
            "wrapper_ms": ms, "kernel_device_ms": sum(per_kernel.values()),
            "kernels_device_ms": per_kernel,
            "table_build_device_ms": per_kernel.get("ss::probe::build_tables_kernel", 0.0),
            "ok": rep["ok"], "max_abs_err": rep["max_abs_err"],
        }
        if cubins is not None:
            out["cases"][name]["occupancy"] = cubins.report(trace_shapes(prof))
        if saved is not None and name in saved:
            out["cases"][name]["bit_identical"] = len(saved[name]) == len(outputs[name]) and all(
                torch.equal(a, b) for a, b in zip(saved[name], outputs[name]))
    if args.outputs and saved is None:
        torch.save(outputs, args.outputs)
    if args.serve:
        out["serving"] = serve(db, snap, idx, args.bursts)
    print(json.dumps(out), flush=True)
    return 0


def short_name(name: str) -> str:
    """A kernel's demangled name without its return type and parameters,
    template arguments as __cxa_demangle prints them
    (ss::phrase_delta_kernel<true, 8>; cu++filt writes (bool)1, (int)8)."""
    name = name.removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    name = name.replace("(bool)1", "true").replace("(bool)0", "false")
    return re.sub(r"\((?:int|unsigned int)\)(\d+)", r"\1", name)


def trace_shapes(prof) -> dict:
    """{kernel: (block threads, total shared memory bytes, grid)} of the
    kernels in a torch.profiler run, from its exported trace's args."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    shapes = {}
    for e in events:
        a = e.get("args", {})
        if e.get("cat") == "kernel" and "block" in a and e["name"].find("ss::") >= 0:
            shapes[short_name(e["name"])] = (
                int(a["block"][0]) * int(a["block"][1]) * int(a["block"][2]),
                int(a.get("shared memory", 0)), a.get("grid"))
    return shapes


class Cubins:
    """The kernels of the tree's built libraries, loaded from each
    library's own cubin (cuobjdump -xelf), loaded through libcuda, by
    short_name (the first library that holds a name wins: the probe-table
    build is the same code in each)."""

    def __init__(self) -> None:
        import ctypes
        import glob
        import tempfile

        import torch

        from spaghettisearch_tpu_torch.ops.kernels import (
            _build, fused, fused_topk, membership, mixed, phrase_delta,
        )

        self.cu = cu = ctypes.CDLL("libcuda.so.1")
        torch.zeros(1, device="cuda")  # the primary context, current on this thread
        bin_dir = os.path.dirname(_build.nvcc_path())
        self.funcs = {}
        for mod in (membership, mixed, fused, fused_topk, phrase_delta):
            built = mod.library()
            with tempfile.TemporaryDirectory() as tmp:
                subprocess.run([os.path.join(bin_dir, "cuobjdump"), "-xelf", "all", built.path],
                               cwd=tmp, check=True, capture_output=True)
                cubins = glob.glob(os.path.join(tmp, "*.cubin"))
                if len(cubins) != 1:
                    raise RuntimeError(f"{built.path}: {len(cubins)} cubins")
                with open(cubins[0], "rb") as f:
                    image = f.read()
            module = ctypes.c_void_p()
            err = cu.cuModuleLoadData(ctypes.byref(module), image)
            if err:
                raise RuntimeError(f"cuModuleLoadData: CUresult {err}")
            n = ctypes.c_uint()
            cu.cuModuleGetFunctionCount(ctypes.byref(n), module)
            handles = (ctypes.c_void_p * n.value)()
            cu.cuModuleEnumerateFunctions(handles, n.value, module)
            for fn in handles:
                raw = ctypes.c_char_p()
                cu.cuFuncGetName(ctypes.byref(raw), ctypes.c_void_p(fn))
                mangled = raw.value.decode()
                pretty = subprocess.run([os.path.join(bin_dir, "cu++filt"), mangled],
                                        capture_output=True, text=True, check=True).stdout
                self.funcs.setdefault(short_name(pretty.strip()),
                                      (mod.__name__.rsplit(".", 1)[-1], fn, mangled, built.log))

    def report(self, shapes: dict) -> dict:
        """Per kernel of `shapes`: the ptxas lines of its build, registers,
        static shared memory, local (spill) bytes, its launch (block,
        grid, dynamic shared memory) and its resident blocks per SM at that
        launch (cuOccupancyMaxActiveBlocksPerMultiprocessor)."""
        import ctypes

        cu = self.cu
        out = {}
        for key, (block, smem_total, grid) in shapes.items():
            if key not in self.funcs:
                out[key] = {"found": False}
                continue
            lib, fn, mangled, log = self.funcs[key]
            fn = ctypes.c_void_p(fn)

            def attr(a: int) -> int:
                v = ctypes.c_int()
                cu.cuFuncGetAttribute(ctypes.byref(v), a, fn)
                return v.value

            static = attr(1)  # CU_FUNC_ATTRIBUTE_SHARED_SIZE_BYTES
            dyn = max(0, smem_total - static)
            cu.cuFuncSetAttribute(fn, 8, 232448 - static)  # MAX_DYNAMIC_SHARED_SIZE_BYTES
            blocks = ctypes.c_int()
            err = cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
                ctypes.byref(blocks), fn, block, ctypes.c_size_t(dyn))
            lines, keep = [], False
            for line in log.splitlines():  # ptxas: "Compiling entry function '<mangled>'"
                if "Compiling entry function" in line:
                    keep = f"'{mangled}'" in line
                if keep and re.search(r"registers|spill|smem|Compiling entry", line):
                    lines.append(line.strip())
            out[key] = {
                "library": lib, "registers": attr(4), "static_smem": static,
                "local_bytes": attr(3), "block": block, "grid": grid, "dynamic_smem": dyn,
                "blocks_per_sm": None if err else blocks.value,
                "warps_per_sm": None if err else blocks.value * block // 32, "ptxas": lines,
            }
        return out


def serve(db, snap, idx, bursts: int = 1, n: int = 320, clients: int = 8) -> list[dict]:
    """`bursts` bursts of n POST /query (the benchmark mix) from `clients`
    threads through the checkout's SearchServer (micro-batching on), after
    warmup and a 64-request warm burst, sent by chip_smoke.send_jobs (every
    response 200, client errors raised): per burst, req/s, latency p50/p99
    (host clock), K1 and K2 launches, and the batcher's batch count."""
    import importlib.util

    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.ops.kernels import membership, mixed
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine
    from spaghettisearch_tpu_torch.serve.server import SearchServer

    # this checkout's chip_smoke.py, whatever --tree put first on sys.path
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    engine = QueryEngine(db, snapshot=snap, index=idx, device="cuda")
    engine.warmup()
    engine.prewarm_hydration()
    server = SearchServer(engine, batching=True)
    host, port = server.start_background(port=0)
    base = f"http://{host}:{port}"
    queries = bench_queries(snap, n + 64, seed=1, phrase_every=4, db=db)
    runs = []
    try:
        smoke.send_jobs(base, [("post", q) for q in queries[n:]], clients)
        for _ in range(bursts):
            membership.reset_launches()
            mixed.reset_launches()
            b0 = server.batcher.stats.batches
            results, wall = smoke.send_jobs(base, [("post", q) for q in queries[:n]], clients)
            runs.append({
                **smoke.latency_stats(results, n, wall), "k1_launches": membership.LAUNCHES,
                "k2_launches": mixed.LAUNCHES, "batches": server.batcher.stats.batches - b0,
            })
    finally:
        server.shutdown()
    return runs


if __name__ == "__main__":
    raise SystemExit(main())
