"""How K1-w's time depends on its form: what ``kernels.coo_mutual.
mutual_plan``'s crossover width rests on.

At each width d in (1, 2, 3, 4, 6, 8, 12, 20), on the 200k-node adjacency
of the scale driver (``build_sparse_graph(200_000, 10, seed=0)``) and on the
20k-node hub graph of ``chip_smoke.py`` [3] (a 19.6k-edge row; its absolute
values, as [14]) and its transpose, and at d in (1, 2) on the 50k and 1M
adjacencies (the mutualistic ground truth's sizes), the forward and the
backward are timed under the warp form and, where it is built for d, the
edge form (with carries where the CSR has long rows, as the plan has it:
``carries`` per side; the warp form by setting ``EDGE_MAX_WIDTH`` to 0),
each is held within 1e-5 · max|y| of the plain version, and
``coo_mutual.EDGE_LAUNCHES`` shows that the form asked for ran:

    python -m ndcn_tpu_torch.tools.tune_mutual_plan

Times are ms per call of ten calls queued behind a spin kernel (the card's
part, without the wrapper's host work), the median of five runs; beside
them each kernel's mean duration in a torch.profiler trace of ten forward
and ten backward calls (``kernels_us``: name, microseconds a launch). One
JSON line on stdout; one line per case on stderr.
"""

from __future__ import annotations

import contextlib
import json
import sys

import numpy as np
import scipy.sparse as sp
import torch

from ndcn_tpu_torch.graph.generators import build_sparse_graph
from ndcn_tpu_torch.graph.sparse import from_scipy_coo
from ndcn_tpu_torch.kernels import coo_mutual
from ndcn_tpu_torch.tools import log, require_cuda
from ndcn_tpu_torch.tools.tune_fused_plan import device_ms

WIDTHS = (1, 2, 3, 4, 6, 8, 12, 20)
COEF = (5.0, 0.1, 0.9)


def hub_graph() -> sp.csr_matrix:
    """``chip_smoke.py`` [3]'s hub graph, absolute values."""
    rng = np.random.RandomState(3)
    n, m = 20_000, 200_000
    rows = np.concatenate([rng.zipf(1.5, m) % n, np.full(5_000, 7)])
    cols = np.concatenate([rng.randint(0, n, m),
                           rng.choice(n, 5_000, replace=False)])
    a = sp.coo_matrix((rng.randn(rows.size).astype(np.float32),
                       (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return abs(a)


@contextlib.contextmanager
def only_form(form: str):
    """``mutual_plan`` as it is for "edges"; for "rows", with the edge form
    off (``EDGE_MAX_WIDTH`` 0)."""
    saved = coo_mutual.EDGE_MAX_WIDTH
    if form == "rows":
        coo_mutual.EDGE_MAX_WIDTH = 0
    try:
        yield
    finally:
        coo_mutual.EDGE_MAX_WIDTH = saved


def forms(d: int):
    """The warp form, and the edge form where it is built for d."""
    yield "rows"
    if d <= coo_mutual.EDGE_MAX_WIDTH:
        yield "edges"


def kernel_times(fn, calls: int = 10) -> dict:
    """Mean device microseconds a launch of each kernel that ``calls`` calls
    of ``fn`` run, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0 and ev.count:
            out[ev.key[:56]] = round(us / ev.count, 3)
    return out


def max_rel(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y - ref).abs().max() / ref.abs().max())


def sweep(label: str, a: sp.csr_matrix, dev: torch.device,
          widths=WIDTHS) -> list:
    op = from_scipy_coo(a, device=dev)
    nnz = int(op.cols.shape[0])
    out = []
    for d in widths:
        rs = np.random.RandomState(d)
        x = torch.as_tensor((rs.rand(op.n, d) * 3 + 0.2).astype(np.float32),
                            device=dev)
        g = torch.as_tensor(rs.randn(op.n, d).astype(np.float32), device=dev)
        ref = coo_mutual.mutual_forward_plain(op, x, *COEF)
        dref = coo_mutual.mutual_backward_plain(op, x, g, *COEF)
        chosen = coo_mutual.mutual_plan(d, nnz)
        for form in forms(d):
            with only_form(form):
                before = coo_mutual.EDGE_LAUNCHES
                y = coo_mutual.mutual_forward(op, x, *COEF)
                dx = coo_mutual.mutual_backward(op, x, g, *COEF)
                ran = ("edges" if coo_mutual.EDGE_LAUNCHES == before + 3
                       else "rows")
                errs = (max_rel(y, ref), max_rel(dx, dref))
                if max(errs) > 1e-5 or ran != form:
                    raise RuntimeError(f"K1-w {label} d={d} {form}: ran "
                                       f"{ran}, {errs}")
                row = dict(graph=label, n=op.n, nnz=nnz, d=d, form=form,
                           carries=[bool(o.split.long_rows.shape[0])
                                    for o in (op, op.transpose())],
                           chosen=form == chosen.form,
                           rel_err=max(errs),
                           fwd_ms=device_ms(lambda: coo_mutual.mutual_forward(
                               op, x, *COEF)),
                           bwd_ms=device_ms(
                               lambda: coo_mutual.mutual_backward(
                                   op, x, g, *COEF)),
                           fwd_kernels_us=kernel_times(
                               lambda: coo_mutual.mutual_forward(
                                   op, x, *COEF)),
                           bwd_kernels_us=kernel_times(
                               lambda: coo_mutual.mutual_backward(
                                   op, x, g, *COEF)))
            log(json.dumps(row))
            out.append(row)
    return out


def main(argv=None) -> dict:
    dev = require_cuda()
    hub = hub_graph()
    rows = (sweep("200k", build_sparse_graph(200_000, 10, seed=0), dev)
            + sweep("hub", hub, dev)
            + sweep("hub_transposed", hub.T.tocsr(), dev)
            + sweep("50k", build_sparse_graph(50_000, 10, seed=0), dev,
                    (1, 2))
            + sweep("1m", build_sparse_graph(1_000_000, 10, seed=0), dev,
                    (1, 2)))
    best = {}
    for r in rows:
        key = f"{r['graph']}_d{r['d']}"
        total = r["fwd_ms"] + r["bwd_ms"]
        if key not in best or total < best[key][0]:
            best[key] = (total, r["form"])
    result = {"card": torch.cuda.get_device_name(0),
              "edge_max_width": coo_mutual.EDGE_MAX_WIDTH, "cases": rows,
              "fastest": {k: dict(form=f, fwd_bwd_ms=t)
                          for k, (t, f) in best.items()}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
