"""The stage split (stages.py) on synthetic profiler events and on a CPU
run of a tiny cell, the readers of the port's spans and token cache, and
on the card the share of device time credited to named stages."""

from __future__ import annotations

import pytest

from bench_util import CELLS, tiny_cell
from benchmark import devtrace, run, stages

MS = 1_000_000  # ns
MAIN = 1  # the harness's thread


def _stages():
    """One batch: the harness's ranges, the engine's, the scoring stages
    nested in the launch, and the device work each launched."""
    ev = stages.Stages()
    ev.host = [("bench.window", 0, 100 * MS), ("bench.parse", 0, 10 * MS),
               ("bench.rank_async", 10 * MS, 40 * MS), ("bench.finish", 60 * MS, 95 * MS)]
    ev.program = [
        ("engine.pack", MAIN, 11 * MS, 14 * MS),
        ("engine.upload", MAIN, 14 * MS, 30 * MS),
        ("engine.launch", MAIN, 30 * MS, 39 * MS),
        ("scoring.kernel", MAIN, 30 * MS, 31 * MS),
        ("scoring.hot", MAIN, 31 * MS, 32 * MS),
        ("scoring.finalize", MAIN, 32 * MS, 36 * MS),
        ("scoring.sqd", MAIN, 34 * MS, 35 * MS),
        ("scoring.topk", MAIN, 36 * MS, 38 * MS),
    ]
    # host operations (correlation -> thread, start) the device work links to
    ev.ops = {1: (MAIN, 15 * MS), 2: (MAIN, 30 * MS), 3: (MAIN, 31 * MS), 4: (MAIN, 33 * MS),
              5: (MAIN, 34 * MS), 6: (MAIN, 37 * MS), 7: (MAIN, int(38.5 * MS)), 8: (MAIN, 5 * MS)}
    ev.runtime = {108: int(36.5 * MS)}
    ev.device = [
        ("Memcpy HtoD (Pageable -> Device)", 20 * MS, 21 * MS),  # 1: the upload
        ("ss::membership2_kernel<false>", 40 * MS, 42 * MS),  # 2: K1, a ctypes launch
        ("sm80_xmma_gemm_f32f32", 42 * MS, 45 * MS),  # 3: the hot matmul
        ("vectorized_elementwise_kernel<CUDAFunctor_add>", 45 * MS, 52 * MS),  # 4: finalize
        ("cutlass::Kernel2<sgemm>", 52 * MS, 53 * MS),  # 5: the topic GEMM
        ("radixSortKVInPlace", 53 * MS, 55 * MS),  # 6: top-k
        ("Memcpy DtoH (Device -> Pinned)", 55 * MS, 56 * MS),  # 7: the result copy
        ("vectorized_elementwise_kernel<fill>", 1 * MS, 2 * MS),  # 8: outside any range
        ("unrolled_elementwise_kernel<copy>", 56 * MS, 57 * MS),  # via its runtime call
        ("void mystery_kernel", 58 * MS, 59 * MS),  # no link at all
    ]
    ev.links = [(1, 101), (2, 102), (3, 103), (4, 104), (5, 105), (6, 106), (7, 107),
                (8, 109), (0, 108), (0, 110)]
    return ev


def test_device_work_is_credited_to_the_innermost_range_holding_its_launch():
    ev = _stages()
    assert stages.stage_of(ev) == [
        "engine.upload", "scoring.kernel", "scoring.hot", "scoring.finalize", "scoring.sqd",
        "scoring.topk", "engine.launch", stages.UNATTRIBUTED, "scoring.topk",
        stages.UNATTRIBUTED,
    ]
    # a launch on another thread does not take this thread's ranges
    ev.ops[4] = (MAIN + 1, 33 * MS)
    assert stages.stage_of(ev)[3] == stages.UNATTRIBUTED


def test_device_stages_sum_to_the_window_device_time():
    ev = _stages()
    split = stages.device_stages(ev)
    total = sum(e - s for _, s, e in devtrace.in_window(ev)) / 1e9
    assert sum(split.values()) == pytest.approx(total)
    assert split["scoring.finalize"] == pytest.approx(0.007)
    assert split["scoring.topk"] == pytest.approx(0.003)
    assert split[stages.UNATTRIBUTED] == pytest.approx(0.002)
    assert list(split)[0] == "scoring.finalize"  # largest first
    ops = stages.stage_ops(ev)
    assert ops["scoring.hot"] == [["sm80_xmma_gemm_f32f32", pytest.approx(0.003)]]
    summary = stages.summary(ev, ms_per_batch=20.0)
    assert summary["device.finalize_ms"] == pytest.approx(20.0 * 8 / 20)
    assert summary["device.hot_ms"] == pytest.approx(20.0 * 3 / 20)
    assert summary["device.topk_ms"] == pytest.approx(20.0 * 3 / 20)
    assert summary["device.kernel_ms"] == pytest.approx(20.0 * 2 / 20)
    assert summary["unattributed_pct"] == pytest.approx(10.0)
    assert summary["engine_upload_ms"] == pytest.approx(16.0)
    assert summary["engine_pack_ms"] == pytest.approx(3.0)


def test_idle_gap_inside_rank_async_takes_the_programs_range():
    ev = _stages()
    ev.device = [("k", 12 * MS, 13 * MS), ("k", 35 * MS, 36 * MS), ("k", 41 * MS, 100 * MS)]
    ev.links = [(0, 0)] * 3
    gaps = stages.program_gaps(ev)
    # 13-35 ms: its middle (24 ms) is in engine.upload, inside bench.rank_async
    assert gaps[0] == ["engine.upload", pytest.approx(0.022)]
    assert ["bench.parse", pytest.approx(0.012)] in gaps
    # devtrace, which knows only the harness's ranges, names the same gap so
    assert devtrace.idle_gaps(ev)[0] == ["bench.rank_async", pytest.approx(0.022)]
    assert stages.host_ranges(ev).innermost(37 * MS) == "scoring.topk"
    ev.host.append(("gc.gen2", 20 * MS, 28 * MS))  # a collection inside the upload
    assert stages.program_gaps(ev)[0] == ["gc.gen2", pytest.approx(0.022)]
    assert stages.summary(ev, 1.0)["gc_pauses"] == 1
    assert stages.host_ranges(ev).innermost(50 * MS) is None


class _Event:
    """A kineto event as from_profiler reads it."""

    def __init__(self, name, kind, start, end, device=False, tid=MAIN, corr=0, linked=0):
        from torch.autograd import DeviceType

        self._v = (name, kind, start, end, DeviceType.CUDA if device else DeviceType.CPU,
                   tid, corr, linked)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def is_user_annotation(self):
        return self._v[1] in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def device_type(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]

    def linked_correlation_id(self):
        return self._v[7]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_device_annotations_are_no_work():
    events = [
        _Event("bench.window", "user_annotation", 0, 100 * MS, corr=1),
        _Event("bench.window", "gpu_user_annotation", 0, 100 * MS, device=True),
        _Event("bench.rank_async", "user_annotation", 10 * MS, 20 * MS, corr=2),
        _Event("bench.rank_async", "gpu_user_annotation", 30 * MS, 90 * MS, device=True),
        _Event("engine.launch", "cpu_op", 12 * MS, 19 * MS, corr=3),
        _Event("scoring.finalize", "cpu_op", 13 * MS, 18 * MS, corr=4),
        _Event("aten::add", "cpu_op", 14 * MS, 15 * MS, corr=5),
        _Event("cudaLaunchKernel", "cuda_runtime", int(14.5 * MS), 15 * MS, tid=4242, corr=77),
        _Event("some.user.range", "gpu_user_annotation", 30 * MS, 90 * MS, device=True),
        _Event("add_kernel", "kernel", 30 * MS, 40 * MS, device=True, corr=77, linked=5),
        _Event("Memcpy DtoH", "gpu_memcpy", 40 * MS, 41 * MS, device=True, corr=78),
    ]
    ev = stages.from_profiler(_Prof(events))
    assert [n for n, *_ in ev.device] == ["add_kernel", "Memcpy DtoH"]
    assert [n for n, *_ in ev.host] == ["bench.window", "bench.rank_async"]
    assert [n for n, *_ in ev.program] == ["engine.launch", "scoring.finalize"]
    assert ev.runtime == {77: int(14.5 * MS)}
    assert stages.stage_of(ev) == ["scoring.finalize", stages.UNATTRIBUTED]
    # an older profiler's events, without the activity type and the flag:
    # annotations known by the harness's and the program's names
    older = [e for e in events if e.name() != "some.user.range"]
    for e in older:
        e.activity_type = e.is_user_annotation = None
    assert stages.from_profiler(_Prof(older)) == ev
    # device.ms_per_batch and device.idle_pct read the kernels and the copy alone
    readers = {r.NAME: r for r in run.readers()}
    batches = [run.Batch(i0=0, n=128, t_take=0.0, t_parsed=0.0, t_dispatched=0.0)]
    x = run.Run(cell={}, coll=None, kw=[], ph=[], batches=batches, window_s=0.1, setup_s=1.0,
                index_build_s=1.0, index_bytes=0, peak_bytes=None, events=ev)
    assert readers["device.ms_per_batch"].read(x) == pytest.approx(11.0)
    assert readers["device.idle_pct"].read(x) == pytest.approx(89.0)


def test_stage_split_of_a_tiny_cell_on_the_cpu():
    """A CPU run records the program's ranges on the trace's clock (there is
    no device work to credit) and the readers of the port's spans and token
    cache read them."""
    from spaghettisearch_tpu_torch.utils.timing import TRACER

    TRACER.reset()
    result, _, ev = stages.stage_run(tiny_cell("lucene-mixed"), 51, 1.0, "cpu")
    assert result["correct"]
    names = {n for n, *_ in ev.program}
    assert {"engine.pack", "engine.upload", "engine.launch", "scoring.kernel",
            "scoring.finalize", "scoring.sqd", "scoring.topk"} <= names
    w = ev.window()
    launches = [(s, e) for n, _, s, e in ev.program
                if n == "engine.launch" and s >= w[0] and e <= w[1]]
    assert launches and stages.span_ms(ev, "engine.upload", len(launches)) > 0
    for name in ("engine.upload_ms", "engine.pack_ms", "engine.parse_miss_pct"):
        assert result["metrics"][name]["value"] > 0, name
    assert result["breakdown"]["device_stages"] == {}
    assert {"index.sort", "index.title", "index.body"} <= set(result["setup_spans"])
    assert result["spans"]["engine.lane.fused"]["count"] == result["spans"]["engine.launch"]["count"]
    untraced, _, none = stages.stage_run(tiny_cell("nq-questions"), 52, 1.0, "cpu", trace=False)
    assert none is None and "breakdown" not in untraced and untraced["correct"]
    assert untraced["spans"]["engine.upload"]["count"] >= 8


def test_span_readers():
    from spaghettisearch_tpu_torch.text.laundry import _clean_token
    from spaghettisearch_tpu_torch.utils.timing import TRACER

    readers = {r.NAME: r for r in run.readers()}
    TRACER.reset()
    assert readers["engine.upload_ms"].read(None) is None  # a program without the spans
    assert readers["engine.pack_ms"].read(None) is None
    for name, seconds in (("engine.upload", 0.004), ("engine.upload", 0.002),
                          ("engine.pack", 0.001), ("engine.launch", 0.0),
                          ("engine.launch", 0.0)):
        with TRACER._lock:
            TRACER.stats[name].add(seconds)
    assert readers["engine.upload_ms"].read(None) == pytest.approx(3.0)
    assert readers["engine.pack_ms"].read(None) == pytest.approx(0.5)
    TRACER.reset()
    _clean_token.cache_clear()
    for raw in ("Running", "running", "Running", "Running"):
        _clean_token(raw)
    assert readers["engine.parse_miss_pct"].read(None) == pytest.approx(50.0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_device_time_is_credited_to_named_stages_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result, checks, ev = stages.stage_run(tiny_cell(name), 41, 1.0, "cuda")
    assert result["correct"], checks
    split = result["breakdown"]["device_stages"]
    total = sum(split.values())
    assert total > 0
    assert total == pytest.approx(sum(e - s for _, s, e in devtrace.in_window(ev)) / 1e9)
    assert split.get(stages.UNATTRIBUTED, 0.0) < 0.02 * total, split
    assert result["stages"]["device.finalize_ms"] > 0 and result["stages"]["device.topk_ms"] > 0


def test_gc_marker_makes_collections_ranges_of_the_trace():
    import gc

    from torch.profiler import ProfilerActivity, profile

    mark = stages.gc_marker()
    gc.callbacks.append(mark)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            gc.collect()
    finally:
        gc.callbacks.remove(mark)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "gc.gen2" in names
