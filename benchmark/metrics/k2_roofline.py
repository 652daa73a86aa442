"""K2's share of its roofline: the least time of its calls over their
device time in the trace. K2 is ``fused_rhs_kernel`` (csrc/fused_rhs.cu);
its work is that of relu((A h) W + b) at the cell's shapes
(``benchmark.roofline.k2``)."""

import re

from benchmark import roofline
from benchmark import trace as trace_lib

LAYER = "operator kernels (kernels/fused_rhs, kernels/coo_spmv)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_steps_per_s.graphed"

KERNEL = re.compile(r"\bfused_rhs_kernel<")


def read(rec):
    tr, w = rec["trace"], rec["work"]
    if tr is None or w["operator"] != "dense":
        return None
    secs, calls = trace_lib.kernel_time(tr, KERNEL)
    if calls == 0 or secs <= 0:
        return None
    least = calls * roofline.k2(w["n"], w["state_width"]).least_s()
    return 100.0 * least / secs
