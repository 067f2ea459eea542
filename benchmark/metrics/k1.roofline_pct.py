"""K1 (csrc/membership.cu membership2_kernel, the keyword lane): its
least time on the window's keyword batches (roofline.membership_bound_s)
over its device time, in %."""

from benchmark import roofline

UNIT = "%"
TRACE = True


def read(run):
    return roofline.kernel_roofline_pct(run, "membership2_kernel", phrase_lane=False)
