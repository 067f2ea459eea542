"""Every metric reader and the trace reduction on synthetic runs and
profiler events."""

from __future__ import annotations

import numpy as np
import pytest

from bench_util import tiny_cell
from benchmark import collection, devtrace, roofline, run, traffic

MS = 1_000_000  # ns


def _readers():
    return {r.NAME: r for r in run.readers()}


def _batches(n=10, period=0.01, latency=0.02, dispatch=0.004, phrase=False):
    return [run.Batch(i0=128 * i, n=128, t_take=i * period, t_parsed=i * period + 0.001,
                      t_dispatched=i * period + dispatch, t_done=i * period + latency,
                      has_phrase=phrase) for i in range(n)]


def _run(batches, events=None, coll=None, kw=None, ph=None):
    return run.Run(cell={}, coll=coll, kw=kw or [], ph=ph or [], batches=batches,
                   window_s=batches[-1].t_done, setup_s=12.5, index_build_s=4.25,
                   index_bytes=3 * 2**30, peak_bytes=5 * 2**30, events=events)


def test_end_to_end_readers():
    r = _readers()
    b = _batches()
    b[9].t_done = b[9].t_take + 0.5  # one slow batch: the top 10% of queries
    x = _run(b)
    assert r["qps"].read(x) == pytest.approx(1280 / b[-1].t_done)
    lat = np.array([0.02] * 9 * 128 + [0.5] * 128)
    assert r["p95_ms"].read(x) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert r["peak_mem_gib"].read(x) == 5.0
    assert r["setup_s"].read(x) == 12.5
    assert r["engine.dispatch_ms"].read(x) == pytest.approx(4.0)
    assert r["engine.parse_ms"].read(x) == pytest.approx(1.0)
    assert r["index.device_gib"].read(x) == 3.0
    assert r["index.build_s"].read(x) == 4.25
    for name, mod in r.items():
        assert mod.UNIT and isinstance(mod.TRACE, bool), name
    assert {n for n, m in r.items() if not m.TRACE} == {"qps", "p95_ms", "peak_mem_gib", "setup_s"}


def _events():
    ev = devtrace.Events()
    ev.host = [("bench.window", 0, 100 * MS), ("bench.parse", 10 * MS, 20 * MS),
               ("bench.rank_async", 20 * MS, 30 * MS), ("bench.finish", 60 * MS, 95 * MS)]
    ev.device = [
        ("void ss::membership2_kernel<false>(int const*, float const*)", 30 * MS, 40 * MS),
        ("cutlass::Kernel2<cutlass_80_simt_sgemm>", 35 * MS, 50 * MS),
        ("Memcpy DtoH (Device -> Pinned)", 70 * MS, 72 * MS),
        ("ss::mixed_kernel<false>", 72 * MS, 80 * MS),
        ("ss::membership2_kernel<false>", 90 * MS, 110 * MS),  # clipped at the window's end
        ("ss::membership2_kernel<false>", 120 * MS, 130 * MS),  # outside it
    ]
    return ev


def test_trace_reduction():
    ev = _events()
    assert devtrace.window_ns(ev) == 100 * MS
    # union: [30, 50] + [70, 80] + [90, 100]
    assert devtrace.busy_ns(ev) == 40 * MS
    assert devtrace.gaps(ev) == [(0, 30 * MS), (50 * MS, 70 * MS), (80 * MS, 90 * MS)]
    assert devtrace.idle_gaps(ev) == [["bench.parse", 0.03], ["bench.finish", 0.02],
                                      ["bench.finish", 0.01]]
    assert devtrace.kernel(ev, "membership2_kernel") == (2, 0.02)
    assert devtrace.kernel(ev, "mixed_kernel") == (1, 0.008)
    ops = dict((k, v) for k, v in devtrace.device_ops(ev))
    assert ops["ss::membership2_kernel<false>"] == pytest.approx(0.02)
    assert ops["cutlass::Kernel2<cutlass_80_simt_sgemm>"] == pytest.approx(0.015)


def test_device_readers():
    r = _readers()
    x = _run(_batches(n=4), _events())
    assert r["device.idle_pct"].read(x) == pytest.approx(60.0)
    assert r["device.ms_per_batch"].read(x) == pytest.approx((10 + 15 + 2 + 8 + 10) / 4)
    assert r["device.idle_pct"].read(_run(_batches(n=4))) is None


def test_kernel_roofline_readers():
    cell = tiny_cell("nq-questions")
    coll = collection.generate(cell["config_data"], 14, "cpu", snapshot=False)
    s = traffic.make_stream(cell["traffic_data"], coll, 256, 14)
    b = _batches(n=2)
    ev = devtrace.Events(host=[("bench.window", 0, 100 * MS)], device=[
        ("ss::membership2_kernel<false>", 10 * MS, 11 * MS),
        ("ss::membership2_kernel<false>", 20 * MS, 22 * MS)])
    x = _run(b, ev, coll, s.kw, s.ph)
    hot = roofline.hot_ranks(coll)
    bound = sum(roofline.membership_bound_s(coll, *roofline.batch_rows(
        s.kw[i: i + 128], s.ph[i: i + 128], hot), 128)[0] for i in (0, 128))
    r = _readers()
    assert r["k1.roofline_pct"].read(x) == pytest.approx(100 * bound / 0.003)
    assert r["k2.roofline_pct"].read(x) is None  # K2 did not run
    ev.device.append(("ss::membership2_kernel<false>", 30 * MS, 31 * MS))
    assert r["k1.roofline_pct"].read(x) is None  # launches no longer pair with batches
