"""Host milliseconds per batch of the engine's packing: the port's TRACER
span engine.pack (bucket rows, term ids, phrase ids, topic probs, the
row sort and its inverse), summed over the run and divided by the batches
the engine launched (span engine.launch: the warm-up's with the
window's)."""

UNIT = "ms"
TRACE = True


def read(run):
    from spaghettisearch_tpu_torch.utils.timing import TRACER

    spans = TRACER.report()
    pack, launch = spans.get("engine.pack"), spans.get("engine.launch")
    if not pack or not launch or not launch["count"]:
        return None
    return 1e3 * pack["total_s"] / launch["count"]
