"""Serve a serving artifact (``serve.export_ndcn``) in a process of its own,
as a deployment would: the process imports torch and
``ndcn_tpu_torch.kernels`` (the kernels' operators) and nothing of the
port's models, solvers, graphs or serving module.

    python -m ndcn_tpu_torch.tools.serve_artifact ARTIFACT X0.npy \\
        [ARTIFACT X0.npy ...] [--requests 10] [--answers DIR]

Loads each artifact onto the card in turn, answers one request (the first
launch loads the kernels' library, building it from the repository's
sources if it is not built), then ``--requests`` more, each timed on the
host clock to ``torch.cuda.synchronize()``. Of one request it counts the
kernels' launches (``kernels.launch_counts``) and the host's reads of the
device in the program's call (``host_reads``: the synchronizing operations
that ``torch.cuda.set_sync_debug_mode`` reports). Prints one JSON line an
artifact on stdout; ``--answers`` keeps each first request's output.
Raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ndcn_tpu_torch import kernels
from ndcn_tpu_torch.tools import log, require_cuda

# what the loading process must not import
MODEL_CODE = ("jax", "ndcn_tpu", "ndcn_tpu_torch.models", "ndcn_tpu_torch.ode",
              "ndcn_tpu_torch.graph", "ndcn_tpu_torch.serve")


@contextlib.contextmanager
def host_reads():
    """Count the host's reads of the device in the block: the list it
    yields holds their number once the block ends."""
    count = []
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield count
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    count.append(sum("synchronizing" in str(w.message) for w in seen))


def serve(path: str, x0_path: str, requests: int,
          answer: Optional[str], dev: torch.device) -> dict:
    """Load one artifact and serve it: its record (see the module
    docstring)."""
    extra = {"ndcn_device": ""}
    t0 = time.perf_counter()
    program = torch.export.load(path, extra_files=extra).module()
    load_s = time.perf_counter() - t0
    x0 = torch.as_tensor(np.load(x0_path), dtype=torch.float32, device=dev)

    def request():
        t0 = time.perf_counter()
        with torch.no_grad():
            out, ok = program(x0)
        torch.cuda.synchronize()
        return out, bool(ok), (time.perf_counter() - t0) * 1e3

    out, ok, first_ms = request()
    if answer:
        np.save(answer, out.cpu().numpy())
    kernels.reset_launch_counts()
    with torch.no_grad(), host_reads() as reads:
        program(x0)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    latencies = [request()[2] for _ in range(requests)]
    return dict(artifact=os.path.basename(path),
                bytes=os.path.getsize(path), exported_on=extra["ndcn_device"],
                served_on=torch.cuda.get_device_name(dev), load_s=load_s,
                first_request_ms=first_ms, success=ok, shape=list(out.shape),
                latency_ms=latencies, median_ms=statistics.median(latencies),
                launch_counts=launches, host_reads=reads[0],
                model_code_imported=[m for m in MODEL_CODE
                                     if m in sys.modules])


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("pairs", nargs="+", metavar="ARTIFACT X0",
                   help="artifacts, each followed by its request's input "
                        "(a .npy file)")
    p.add_argument("--requests", type=int, default=10)
    p.add_argument("--answers", default=None, metavar="DIR",
                   help="save each artifact's first output here, as "
                        "<artifact name>.npy")
    args = p.parse_args(argv)
    if len(args.pairs) % 2:
        p.error("give each artifact its request's input")
    dev = require_cuda()
    recs = []
    for path, x0_path in zip(args.pairs[::2], args.pairs[1::2]):
        answer = (os.path.join(args.answers, os.path.splitext(
            os.path.basename(path))[0] + ".npy") if args.answers else None)
        rec = serve(path, x0_path, args.requests, answer, dev)
        log(f"{rec['artifact']}: median {rec['median_ms']:.3f} ms, "
            f"{rec['host_reads']} host reads, launches "
            f"{rec['launch_counts']}")
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
