"""Where the card's adams attempts part from the CPU's.

    python -m ndcn_tpu_torch.tools.trace_adams_attempts

runs the forward solve of ``chip_smoke.py`` [21] a's adams step (the heat
driver's grid400 data: T 5, tick 100, irregular, seed 0; ``--replicas 4``,
the replicas seeded 0-3; dense, ``fused="auto"``: K2's batched form on the
card, its plain version on the CPU) once on the card and once on the CPU,
float32 both, and records every attempt of the masked VCABM machine
(``ode.vcabm.solve_vcabm_batched``): each replica's order, accept flag and
next order, and the controller's numbers that decide them (the error ratio
the step is accepted on, and the ratios of the orders below and above that
the order test weighs against it). For each replica it prints the first
attempt whose accept flag or next order parts between the two devices, with
those numbers on both. The attempts are observed by wrapping the machine's
own functions for this process only; the solve is not changed.

One JSON line on stdout; the parting attempts on stderr.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ndcn_tpu_torch.graph.generators import (build_network,
                                             grid_block_initial_value)
from ndcn_tpu_torch.graph.operators import normalized_laplacian
from ndcn_tpu_torch.graph.sparse import as_operator
from ndcn_tpu_torch.kernels.platform import pin_fp32
from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
from ndcn_tpu_torch.ode import vcabm
from ndcn_tpu_torch.parallel.sweep import stack_models
from ndcn_tpu_torch.tools import log, require_cuda
from ndcn_tpu_torch.train.sampling import sample_times

REPLICAS = 4


def _values(t: torch.Tensor) -> list:
    return [float(v) for v in t.detach().reshape(-1).cpu()]


class _Recorder:
    """Wraps the machine's attempt and the controller's reductions in
    ``ode.vcabm`` while entered, and keeps one record an attempt."""

    NAMES = ("_masked_attempt", "accept_and_max_ratio", "_tmin_rows",
             "tmax_rows")

    def __init__(self):
        self.attempts = []

    def __enter__(self):
        self.saved = {n: getattr(vcabm, n) for n in self.NAMES}
        attempt, accept, tmin, tmax = (self.saved[n] for n in self.NAMES)
        rec = self.attempts

        def masked_attempt(func, st, *args, **kwargs):
            rec.append({"order": _values(st.order), "lower_orders": []})
            out = attempt(func, st, *args, **kwargs)
            rec[-1].update(accept=_values(out[1]),
                           order_next=_values(out[0].order))
            return out

        def accept_and_max_ratio(*args, **kwargs):
            flag, ratio = accept(*args, **kwargs)
            rec[-1]["error_ratio"] = _values(ratio)
            return flag, ratio

        def tmin_rows(*args, **kwargs):
            out = tmin(*args, **kwargs)
            rec[-1]["lower_orders"].append(_values(out))
            return out

        def tmax_rows(*args, **kwargs):
            out = tmax(*args, **kwargs)
            rec[-1]["higher_order"] = _values(out)
            return out

        for name, fn in zip(self.NAMES, (masked_attempt, accept_and_max_ratio,
                                         tmin_rows, tmax_rows)):
            setattr(vcabm, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(vcabm, name, fn)


def _replica(record: dict, r: int) -> dict:
    """Replica r's numbers of one attempt record."""
    return {k: ([w[r] for w in v] if k == "lower_orders" else v[r])
            for k, v in record.items()}


def main(argv=None) -> dict:
    dev = require_cuda()
    pin_fp32()
    adj = build_network("grid", 400)
    lap = normalized_laplacian(adj)
    hs = sample_times(5.0, 100, "irregular", seed=0)
    x0 = torch.as_tensor(grid_block_initial_value(20).astype(np.float32))
    t = hs.t[hs.id_train]

    def attempts(device):
        model = stack_models([init_ndcn(torch.Generator().manual_seed(s), 1,
                                        20, 1)
                              for s in range(REPLICAS)]).to(device)
        with _Recorder() as rec:
            _, stats = ndcn_forward(model, as_operator(lap, device=device), t,
                                    x0.to(device), method="adams",
                                    fused="auto", max_steps=256, rtol=0.01,
                                    atol=0.001)
        return rec.attempts, list(stats.nfe)

    card, nfe_card = attempts(dev)
    cpu, nfe_cpu = attempts(torch.device("cpu"))
    results = {"device": torch.cuda.get_device_name(dev),
               "nfe_card": nfe_card, "nfe_cpu": nfe_cpu, "parting": {}}
    for r in range(REPLICAS):
        first = next((i for i, (a, b) in enumerate(zip(card, cpu))
                      if a["accept"][r] != b["accept"][r]
                      or a["order_next"][r] != b["order_next"][r]), None)
        part = {"attempt": first}
        if first is not None:
            part.update(card=_replica(card[first], r),
                        cpu=_replica(cpu[first], r))
        results["parting"][r] = part
        log(f"replica {r}: first parting attempt {json.dumps(part)}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
