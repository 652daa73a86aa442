"""The sparse microbenchmarks on the card, as the JAX package's ``tools/``,
and probes and sweeps of the port's own kernels:

- ``microbench_sparse``: the SpMV building blocks, the sliced-tile reduce
  (P1a) and the row gather (P1b);
- ``probe_inkernel_gather``: the row gather (P2) against PyTorch's gathers;
- ``bench_wide_gather``: K1-fm (narrow) against K5 (wide), split2 and bf16;
- ``tune_fused_plan``: K2 and K4 (and with ``k3``, K3) under every launch
  plan they are built for (what ``kernels.fused_rhs.panel_plan``'s and
  ``kernels.bsr_spmm.bsr_spmm_plan``'s rules rest on);
- ``tune_wide_plan``: K1's wide form under each lane-column count and row
  order, and K3's batched form under each replica group (what
  ``kernels.coo_spmv.gather_plan``'s and ``kernels.bsr_spmm.
  bsr_batched_plan``'s rules rest on);
- ``trace_adams_attempts``: the first attempt where the card's masked
  VCABM machine parts from the CPU's on ``chip_smoke.py`` [21] a's adams
  step, and the controller's numbers there;
- ``probe_mma_accumulate``: the tensor core's truncating fp32 accumulate
  against the fused kernels' chunk-wise fold;
- ``compare_builds``: K1-K4 from two checkouts on the same inputs, bit
  for bit;
- ``tune_mutual_plan``: K1-w in both forms by width (what
  ``kernels.coo_mutual.mutual_plan``'s crossover rests on);
- ``time_checkouts``: K1-w, K5 and the 1M step's three solves in several
  checkouts, one process each (parent against change in one call);
- ``microbench_sharded_spmv``: K1 on the whole operator against the
  row-sharded product on a one-rank NCCL group (the mesh path);
- ``serve_artifact``: a serving artifact (``serve.export_ndcn``) served in
  a process that imports none of the model code: latency, launches and
  host reads per request.

Each runs as ``python -m ndcn_tpu_torch.tools.<name> [args]``, prints one
line per measurement on stderr and JSON on stdout, and raises without a
CUDA device. ``chain_time`` is their timing discipline.

The scale-record tools, as the JAX repository's root ``tools/``, run on
the card unless given ``--platform cpu`` (and refuse to without one):

- ``profile_scale_step``: the scale driver's train step split by level
  (SpMV, RHS, inference solve, differentiable solve, gradient, step);
- ``bench_scale``: the scale driver's ``--estimate`` and a measured run in
  one record under ``results_torch/``;
- ``check_scale_records``: each committed ``results_torch/`` scale record's
  argv run again, failing 10 % under its steps/s;
- ``record_showcase``: the README's cora recipe through the dgnn driver,
  its accuracy as a record;
- ``analyze_mesh_tax``: the ``--mesh`` train step against the unsharded
  one in variants, with a profiler histogram of each.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Callable, Optional, Tuple

import torch

K = 30  # chained calls per timed run


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the microbenchmarks measure the card and no CUDA "
                           "device is visible")
    return torch.device("cuda", 0)


def card() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (the first card's), or
    None where no CUDA device is visible or ``nvidia-smi`` is missing."""
    if not torch.cuda.is_available():
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def chain_time(step: Callable[[torch.Tensor], torch.Tensor],
               init: torch.Tensor, k: int = K,
               reps: int = 3) -> Tuple[float, torch.Tensor]:
    """Seconds per call of ``step``, over ``k`` data-dependent calls (each
    call's input is the previous call's output) between two CUDA events;
    the best of ``reps`` runs, after one warm run. Returns (seconds, the
    last output)."""
    with torch.no_grad():
        def run():
            y = init
            for _ in range(k):
                y = step(y)
            return y

        out = run()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    return best / k, out
