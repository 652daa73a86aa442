"""Gather-floor accounting for the scale path's train step, as
``ndcn_tpu/train/roofline.py``.

The floor is built from the measured SpMV at the run's exact shape, not
from a bytes-over-bandwidth estimate: the feature-major SpMV is a gather,
and what bounds a gather is measured, not known. One differentiable dopri5
train step makes ``nfe`` forward RHS evaluations, each one forward
``spmv_T``, and its backward pushes each evaluation's cotangent through Aᵀ
once (the transpose CSR). Hence

    gather_floor_s = nfe * (spmv_fwd_s + spmv_t_s)

and ``pct_of_gather_floor`` = floor / measured step time. Callers pass the
budget probe's initial-state nfe, so the floor is that state's; a later
step may make more evaluations. The card's times come from CUDA events over
10 chained data-dependent calls, the JAX package's discipline (the next
call's input is the previous call's output), so no call can be skipped or
overlapped; a CPU operator raises, since this measures the card.
"""

from __future__ import annotations

import statistics

import torch

from ndcn_tpu_torch.kernels.coo_spmv import spmv_T, sublane_pad

CHAIN = 10


def measure_spmv(op, d: int, kernel_precision: str = "split2",
                 reps: int = 5, warm: int = 2) -> dict:
    """Time ``spmv_T`` over A and over Aᵀ at ``op``'s shape and width ``d``
    (in the precision the caller has set, see ``coo_spmv.gather_precision``)
    and return the record's roofline fields. ``slots`` is nnz: CSR has no
    pad slots."""
    if op.device.type != "cuda":
        raise RuntimeError("measure_spmv times the SpMV on the card; the "
                           "operator lies on the CPU")
    d_sub = sublane_pad(d)
    gen = torch.Generator(device=op.device).manual_seed(7)
    x = torch.zeros((d_sub, op.n), device=op.device)
    x[:d] = torch.rand((d, op.n), device=op.device, generator=gen)

    def chain(a):
        acc = x
        for _ in range(CHAIN):
            acc = spmv_T(a, acc) * 1e-3 + x
        return acc

    def per_call_s(a):
        with torch.no_grad():
            for _ in range(warm):
                chain(a)
            times = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                chain(a)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3 / CHAIN)
        return statistics.median(times)

    fwd_s = per_call_s(op)
    t_s = per_call_s(op.transpose())
    slots = int(op.cols.shape[0])
    g_item = 2 if kernel_precision == "bf16" else 4
    return {
        "spmv_fwd_ms": round(fwd_s * 1e3, 3),
        "spmv_t_ms": round(t_s * 1e3, 3),
        "slots": slots,
        "slot_rate_m_per_s": round(slots / fwd_s / 1e6, 1),
        "gather_gb_per_spmv": round(slots * d_sub * g_item / 1e9, 3),
    }


def gather_floor_s(nfe: int, spmv: dict) -> float:
    """The step's SpMV floor in seconds: ``nfe`` forward products plus one
    transpose product per evaluation's cotangent."""
    return nfe * (spmv["spmv_fwd_ms"] + spmv["spmv_t_ms"]) / 1e3
