"""Host milliseconds per batch of the engine's uploads: the port's TRACER
span engine.upload, every host-to-device copy of a batch (pageable, so
each waits until the card has taken it, behind the work already queued),
summed over the run and divided by the batches the engine launched (span
engine.launch: the warm-up's with the window's)."""

UNIT = "ms"
TRACE = True


def read(run):
    from spaghettisearch_tpu_torch.utils.timing import TRACER

    spans = TRACER.report()
    upload, launch = spans.get("engine.upload"), spans.get("engine.launch")
    if not upload or not launch or not launch["count"]:
        return None
    return 1e3 * upload["total_s"] / launch["count"]
