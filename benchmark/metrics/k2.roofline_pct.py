"""K2 (csrc/mixed.cu mixed_kernel, the fused mixed lane): its least time
on the window's batches that hold a phrase (roofline.membership_bound_s,
phrase terms asked in both sections, plus the position planes its chain
check needs, roofline.PhrasePlanes) over its device time, in %."""

from benchmark import roofline

UNIT = "%"
TRACE = True


def read(run):
    return roofline.kernel_roofline_pct(run, "mixed_kernel", phrase_lane=True)
