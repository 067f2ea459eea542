#!/usr/bin/env python3
"""The crawl-built 1M and 2M tiers of the port's bench, each in one run:
the corpus built first (several processes, corpus.write_corpus), then the
tier's modes, each a process of its own, each held to its bar.

    python3 experiments/torch_tiers.py 1m [--out DIR] [--budget S]
    python3 experiments/torch_tiers.py 2m [--out DIR] [--budget S]

1m: the 1,000,000-page corpus; scale2m --pages 1000000 (residency, K1 and
    K2 per call beside their bounds), parity1m (256 queries against the
    oracle, its queries over the host's cores), serve1m and serve1m
    --routeMix (512 connections); then STEPS: the roofline (the card's
    stream peak and the 1M mixed program, alone), the crash soak
    (torch_crash_recovery.py --phase all at 1M on a copy of the store,
    started when the disk holds the copy and the budget leaves CRASH_S;
    the holds of chip_smoke.py phase 18) and beside it the shard-scale
    probe (8 and 4 shards, projected from this call's serve1m result);
    then, while the budget lasts, the ten probes whose originals default
    to the 1M corpus (phrase-delta, eight corpus probes, kw_gap), two at
    a time, the split probe first. --probes A,B: the build and those
    steps and probes only (shard_scale_probe brings serve1m before it).
2m: the 2,000,000-page corpus; parity2m (128 queries), sparse2m (16
    queries), then scale2m if the budget leaves SCALE2M_S for it; each
    mode a process of its own.

Holds: parity recall@10 1.0, every top-50 divergence tie-explained,
score_max_rel_err <= 1e-6, K2 launched; serve every answer 200, no
protocol error, the server's segregation line "active"; scale2m at 2M the
fused lane live, int16 planes within POS_T_BUDGET_BYTES, no hot cache, the
forward arrays on the host; sparse2m no planes, the matcher ran, every
divergence tie-explained; each probe's own exactness check; the crash
soak's committed pages intact, killed mid-/refresh, the stale sidecar
rebuilt, the restarted server's answers equal to the kernel and plain
paths. Prints the
card (nvidia-smi name and power limit), the host (MemTotal, cores, free
disk), each step's seconds (the build's per step, from its BUILT.json),
and as its last line one JSON object with every result; writes each
step's output and results.json under --out (default
chiprun_out/tiers_{tier}). No mode runs past --budget + GRACE_S seconds
(3,500 by default, inside a 60-minute call). Exits 1 when a hold fails. --device cpu with
--pages runs the same steps on a small corpus (the CPU test)."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

PROBES = ("split_probe", "phrase_delta_probe", "probe1m_decomp", "mixed_tbound_probe",
          "phrase_tmax_probe", "post16_probe", "mixed256_probe", "probe1m", "segregate_probe",
          "kw_gap_probe")
#: the 1M steps that take more than a page count: the shard-scale probe
#: (fed this call's serve1m result), the roofline (the stream peak and the
#: 1M mixed program, alone on the card) and the crash soak (a copy of the
#: store, at its original's 1M)
STEPS = ("roofline", "crash_recovery", "shard_scale_probe")
#: the crash soak's queries to its restarted server (chip_smoke.py phase 18's)
CRASH_QUERIES = 64
#: disk the crash soak's copy needs beyond the store and snapshot it copies
#: (the appended pages, the rebuilt hydration sidecar, the logs)
CRASH_DISK_MARGIN = 4 << 30
#: seconds of the budget the crash soak needs at 1M (two servers of the 1M
#: index, each writing its hydration sidecar, and two digests of the store)
CRASH_S = 1500.0
RTOL = 1e-6
#: seconds a step may run past the budget (the last mode's, results.json's)
GRACE_S = 200.0
#: seconds scale2m needs at 2M (its device index build and timed batches),
#: and a pair of probes at 1M
SCALE2M_S = 600.0
PROBE_S = 300.0


def _smi() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return None


def _mem_available() -> int:
    with open("/proc/meminfo", encoding="ascii") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


class Run:
    def __init__(self, out: str, device: str, budget_s: float) -> None:
        self.out, self.device = out, device
        self.t0 = time.monotonic()
        self.budget_s = budget_s
        self.results: dict = {}
        self.failed: list[str] = []

    def left(self) -> float:
        return self.budget_s - (time.monotonic() - self.t0)

    def cap(self, timeout_s: float) -> float:
        """A step's timeout, cut so that it ends by the budget + GRACE_S."""
        return min(timeout_s, max(self.left() + GRACE_S, 1.0))

    def start(self, name: str, cmd: list[str]):
        log = open(os.path.join(self.out, f"{name}.err"), "wb")
        out = open(os.path.join(self.out, f"{name}.out"), "wb")
        print(f"# {name}: {' '.join(cmd)}", flush=True)
        proc = subprocess.Popen(cmd, stdout=out, stderr=log, cwd=REPO)
        return name, proc, time.monotonic(), (out, log)

    def finish(self, job, timeout_s: float) -> dict | None:
        name, proc, t0, files = job
        try:
            rc = proc.wait(timeout=max(timeout_s, 1.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
            rc = f"killed after {timeout_s:.0f}s"
        for f in files:
            f.close()
        secs = round(time.monotonic() - t0, 1)
        with open(os.path.join(self.out, f"{name}.out"), encoding="utf-8",
                  errors="replace") as f:
            lines = [ln for ln in f.read().splitlines() if ln.startswith("{")]
        res = None
        if lines:
            try:
                res = json.loads(lines[-1])
            except ValueError:
                res = None
        self.results[name] = {"rc": rc, "seconds": secs, "result": res}
        print(f"# {name}: rc {rc} in {secs}s: {json.dumps(res)}", flush=True)
        if rc != 0 or res is None:
            self.failed.append(f"{name}: rc {rc}")
            return None
        return res

    def run(self, name: str, cmd: list[str], timeout_s: float) -> dict | None:
        return self.finish(self.start(name, cmd), timeout_s)

    def build(self, cmd: list[str], marker: str, timeout_s: float) -> dict | None:
        """A step that prints no JSON: its marker file is its result."""
        name, proc, t0, files = self.start("build", cmd)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = f"killed after {timeout_s:.0f}s ({proc.wait()})"
        for f in files:
            f.close()
        secs = round(time.monotonic() - t0, 1)
        res = None
        if rc == 0 and os.path.exists(marker):
            with open(marker, encoding="utf-8") as f:
                res = json.load(f)
        self.results[name] = {"rc": rc, "seconds": secs, "marker": res}
        print(f"# build: rc {rc} in {secs}s: {json.dumps(res)}", flush=True)
        if res is None:
            self.failed.append(f"build: rc {rc}")
        return res

    def hold(self, name: str, ok: bool, what: str) -> None:
        print(f"# hold {name}: {what}: {'ok' if ok else 'FAILED'}", flush=True)
        self.results.setdefault("holds", []).append({"step": name, "what": what, "ok": bool(ok)})
        if not ok:
            self.failed.append(f"{name}: {what}")


def _bench(mode: str, device: str, *flags: str) -> list[str]:
    return [sys.executable, "-m", "spaghettisearch_tpu_torch.bench", "--mode", mode,
            "--device", device, *flags]


def _hold_parity(run: Run, name: str, r: dict | None, on_card: bool) -> None:
    if r is None:
        return
    run.hold(name, r["value"] == 1.0, f"recall@10 {r['value']} == 1.0")
    run.hold(name, r["divergences_tie_explained"] == r["order_divergences_at_50"],
             f"{r['divergences_tie_explained']} of {r['order_divergences_at_50']} top-50 "
             "divergences tie-explained")
    run.hold(name, r["score_max_rel_err"] <= RTOL,
             f"score_max_rel_err {r['score_max_rel_err']} <= {RTOL}")
    if on_card:
        run.hold(name, r["launches"]["K2"] > 0, f"K2 launched {r['launches']['K2']} times")


def _hold_serve(run: Run, name: str, r: dict | None) -> None:
    if r is None:
        return
    run.hold(name, r["non_200"] == 0 and r["requests"] > 0,
             f"{r['requests']} answers, {r['non_200']} not 200")
    run.hold(name, r["protocol_errors"] == 0, f"protocol_errors {r['protocol_errors']}")
    run.hold(name, r["segregation"] == "active", f"segregation line {r['segregation']!r}")


def _probes(run: Run, todo: list[str], n_pages: int, device: str, store_bytes: int) -> None:
    """The probes at n_pages while the budget leaves PROBE_S for them, two
    at a time when the host holds two more copies of the store; each held
    to its own check."""
    pair = _mem_available() > 3 * store_bytes
    while todo and run.left() > PROBE_S:
        jobs = [run.start(p, [sys.executable, os.path.join(HERE, f"torch_{p}.py"),
                              str(n_pages), "--device", device])
                for p in todo[: 2 if pair else 1]]
        todo = todo[len(jobs):]
        for job in jobs:
            res = run.finish(job, run.cap(1800))
            if res is not None:
                run.hold(job[0], res.get("ok") is True, "its exactness check")
    run.results["probes_not_run"] = todo
    run.results["probes_two_at_a_time"] = pair


def _hold_crash(run: Run, r: dict | None) -> None:
    """The crash soak's own holds (torch_crash_recovery.holds), as
    chip_smoke.py phase 18 holds them."""
    if r is None:
        return
    import torch_crash_recovery

    for ok, what in torch_crash_recovery.holds(r["crash_recovery"]):
        run.hold("crash_recovery", ok, what)


def _start_crash(run: Run, n_pages: int, device: str, root: str):
    """Start the crash soak on a copy of the corpus when the disk holds the
    copy. -> its job, or None (the reason recorded, a failed hold)."""
    need = _dir_bytes(os.path.join(root, "store")) + _dir_bytes(os.path.join(root, "snapshot")) \
        + CRASH_DISK_MARGIN
    work = os.path.join(REPO, "build", "crash", f"corpus{n_pages // 1000}k")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.dirname(work), exist_ok=True)
    free = shutil.disk_usage(os.path.dirname(work)).free
    run.results["crash_disk"] = {"need_bytes": need, "free_bytes": free}
    print(f"# crash_recovery: the copy needs {need} B, {free} B free", flush=True)
    if free < need:
        run.hold("crash_recovery", False, f"disk for the copy: {free} B free < {need} B")
        return None
    if run.left() < CRASH_S:
        run.results["crash_recovery"] = {"not_run": f"{run.left():.0f}s of the budget left, "
                                                    f"under CRASH_S {CRASH_S:.0f}"}
        print(f"# crash_recovery: not run ({run.results['crash_recovery']['not_run']})",
              flush=True)
        return None
    return run.start("crash_recovery", [
        sys.executable, os.path.join(HERE, "torch_crash_recovery.py"), "--phase", "all",
        "--pages", str(n_pages), "--device", device, "--work", work,
        "--checkQueries", str(CRASH_QUERIES)])


def _steps(run: Run, todo: list[str], n_pages: int, device: str, serve1m: dict | None,
           store_bytes: int, root: str) -> None:
    """STEPS and PROBES named in `todo` at n_pages: the roofline alone,
    then the crash soak started and, beside it, the shard-scale probe and
    the probes (_probes); each held to its own check."""
    if "roofline" in todo:
        if run.left() > PROBE_S:
            res = run.run("roofline", [sys.executable, os.path.join(HERE, "torch_roofline.py"),
                                       "--skip-headline", "--pages1m", str(n_pages),
                                       "--device", device], run.cap(1800))
            if res is not None:
                run.hold("roofline", res.get("ok") is True, "its exactness check")
        else:
            run.results["roofline"] = {"not_run": f"{run.left():.0f}s of the budget left"}
    crash = _start_crash(run, n_pages, device, root) if "crash_recovery" in todo else None
    if "shard_scale_probe" in todo:
        if serve1m is None:
            run.hold("shard_scale_probe", False, "a serve1m result to project from")
        else:
            path = os.path.join(run.out, "serve1m_result.json")
            with open(path, "w", encoding="utf-8") as f:
                json.dump(serve1m, f)
            res = run.run("shard_scale_probe", [
                sys.executable, os.path.join(HERE, "torch_shard_scale_probe.py"), str(n_pages),
                "--device", device, "--serve1m", path], run.cap(1800))
            if res is not None:
                run.hold("shard_scale_probe", res.get("ok") is True, "its exactness check")
    _probes(run, [p for p in todo if p in PROBES], n_pages, device, store_bytes)
    if crash is not None:
        _hold_crash(run, run.finish(crash, run.cap(3600)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tier", choices=("1m", "2m"))
    ap.add_argument("--out", help="output directory (default chiprun_out/tiers_{tier})")
    ap.add_argument("--budget", type=float, default=3300.0,
                    help="seconds after which no probe and no scale2m starts; every step ends by "
                         "--budget + GRACE_S")
    ap.add_argument("--probes", help="1m: run only these probes (comma-separated) after the "
                                     "build, none of the modes")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pages", type=int, help="the corpus size (default: the tier's)")
    ap.add_argument("--queries", type=int, help="parity query count (default: the mode's)")
    args = ap.parse_args(argv)

    import torch

    from spaghettisearch_tpu_torch.bench import CORPUS_VERSION, corpus_root, host_resources

    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("torch_tiers: CUDA is not available (pass --device cpu)", file=sys.stderr)
        return 2
    n_pages = args.pages or (1_000_000 if args.tier == "1m" else 2_000_000)
    out = args.out or os.path.join(REPO, "chiprun_out", f"tiers_{args.tier}")
    os.makedirs(out, exist_ok=True)
    run = Run(out, args.device, args.budget)
    smi = _smi()
    root = corpus_root(n_pages)
    host = host_resources(os.path.dirname(root))
    print(f"# card: {smi}", flush=True)
    print(f"# host: {json.dumps(host)}", flush=True)
    run.results.update(tier=args.tier, pages=n_pages, nvidia_smi=smi, host=host,
                       corpus_version=CORPUS_VERSION)

    # the build: a fresh corpus, in a process of its own, as the bench builds it
    shutil.rmtree(root, ignore_errors=True)
    built = run.build([sys.executable, "-m", "spaghettisearch_tpu_torch.bench", "--device",
                       args.device, "--build-corpus", str(n_pages), "30000", root],
                      os.path.join(root, "BUILT.json"), run.cap(3600))
    if built is None:
        print(json.dumps({**run.results, "ok": False, "failed": run.failed}))
        return 1
    store_bytes = _dir_bytes(os.path.join(root, "store"))
    run.results["build"]["store_bytes"] = store_bytes
    run.results["build"]["snapshot_bytes"] = _dir_bytes(os.path.join(root, "snapshot"))
    run.results["build"]["mem_available_after"] = _mem_available()
    print(f"# build: store {store_bytes} B on disk; steps {json.dumps(built.get('steps'))}",
          flush=True)

    pages = ["--pages", str(n_pages)]
    queries = ["--queries", str(args.queries)] if args.queries else []
    if args.tier == "1m" and args.probes:
        todo = args.probes.split(",")
        unknown = set(todo) - set(PROBES) - set(STEPS)
        if unknown:
            raise SystemExit(f"--probes: {sorted(unknown)} not in {STEPS + PROBES}")
        serve1m = None
        if "shard_scale_probe" in todo:  # its host stages come from this call's serve1m
            serve1m = run.run("serve1m", _bench("serve1m", args.device, *pages), run.cap(1800))
            _hold_serve(run, "serve1m", serve1m)
        _steps(run, todo, n_pages, args.device, serve1m, store_bytes, root)
    elif args.tier == "1m":
        res = run.run("scale_1m", _bench("scale2m", args.device, *pages), run.cap(1800))
        if res is not None and on_card:
            run.hold("scale_1m", res["fused_lane_live"], "fused lane live")
        _hold_parity(run, "parity1m",
                     run.run("parity1m", _bench("parity1m", args.device, *pages, *queries),
                             run.cap(2400)),
                     on_card)
        served = {}
        for name, flags in (("serve1m", ()), ("serve1m_routes", ("--routeMix",))):
            served[name] = run.run(name, _bench("serve1m", args.device, *pages, *flags),
                                   run.cap(1800))
            _hold_serve(run, name, served[name])
        _steps(run, [*STEPS, *PROBES], n_pages, args.device, served["serve1m"], store_bytes,
               root)
    else:
        _hold_parity(run, "parity2m",
                     run.run("parity2m", _bench("parity2m", args.device, *pages, *queries),
                             run.cap(3000)),
                     on_card)
        res = run.run("sparse2m", _bench("sparse2m", args.device, *pages), run.cap(2400))
        if res is not None:
            run.hold("sparse2m", not res["pos_dense"], "no position planes")
            run.hold("sparse2m", res["matcher_calls"] > 0, f"matcher calls {res['matcher_calls']}")
            run.hold("sparse2m", res["divergences_tie_explained"] == res["order_divergences_at_50"],
                     f"{res['divergences_tie_explained']} of {res['order_divergences_at_50']} "
                     "divergences tie-explained")
        if run.left() < SCALE2M_S:
            run.results["scale2m"] = {"not_run": f"{run.left():.0f}s of the budget left, "
                                                 f"under SCALE2M_S {SCALE2M_S:.0f}"}
            print(f"# scale2m: not run ({run.results['scale2m']['not_run']})", flush=True)
        else:
            res = run.run("scale2m", _bench("scale2m", args.device, *pages), run.cap(2400))
            if res is not None:
                run.hold("scale2m", res["fused_lane_live"], "fused lane live")
                run.hold("scale2m", all(d == "torch.int16" for d in res["posT_dtype"].values())
                         and sum(res["posT_bytes"].values()) <= 2 * res["posT_budget_bytes"]
                         and max(res["posT_bytes"].values()) <= res["posT_budget_bytes"],
                         f"int16 planes {res['posT_bytes']} within {res['posT_budget_bytes']} "
                         "each")
                if on_card:
                    run.hold("scale2m", not res["hot_cache"] and res["hot_body_w_none"],
                             "no hot-term cache")
                    run.hold("scale2m", all(res["fwd_on_host"].values()),
                             f"ft/fw/fj on the host {res['fwd_on_host']}")
    run.results["seconds"] = round(time.monotonic() - run.t0, 1)
    run.results["failed"] = run.failed
    run.results["ok"] = not run.failed
    with open(os.path.join(out, "results.json"), "w", encoding="utf-8") as f:
        json.dump(run.results, f, indent=1)
    print(f"# card: {smi}")
    print(json.dumps(run.results))
    return 0 if run.results["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
