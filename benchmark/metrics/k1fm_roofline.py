"""K1-fm's share of its roofline, forward and over Aᵀ alike: the least time
of its calls over the device time of its two kernels (the pack,
``pack_rows_kernel``, and the gather, ``csr_rows_T_kernel``, in
csrc/coo_spmv_T.cu; a call is one of each) in the trace. Its work is the
product over the CSR operator at the solve's (d_sub, n) state
(``benchmark.roofline.k1fm``)."""

import re

from benchmark import roofline
from benchmark import trace as trace_lib

LAYER = "operator kernels (kernels/fused_rhs, kernels/coo_spmv)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_steps_per_s.hostloop"

PACK = re.compile(r"\bpack_rows_kernel<")
GATHER = re.compile(r"\bcsr_rows_T_kernel<")


def read(rec):
    tr, w = rec["trace"], rec["work"]
    if tr is None or w["operator"] != "csr":
        return None
    pack_s, packs = trace_lib.kernel_time(tr, PACK)
    gather_s, calls = trace_lib.kernel_time(tr, GATHER)
    if calls == 0 or packs != calls:
        return None
    least = calls * roofline.k1fm(w["n"], w["nnz"], w["state_width"]).least_s()
    return 100.0 * least / (pack_s + gather_s)
