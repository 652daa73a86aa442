"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>
    python3 -m benchmark.run --list

The run builds its inputs from the seed, sets up the cell's train step,
measures it for ``--seconds`` (``benchmark.harness``), checks it against
the plain reference and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer ones with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
number compared beside its limit, which also end standard error.

It measures the card only: without CUDA, or with fewer cards than the cell
asks for, it exits 2 and prints no result. It exits 3, with no result, if
JAX or the JAX package was imported. The kernel library of the port is
cached in the checkout's ``build/kernels/``; every other cache is kept
under ``build/bench_cache/`` there.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "ndcn_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device=None, root: Path = ROOT, t_start: float = T_START):
    """One run; returns (exit code, the result dict or None). ``device``
    other than CUDA is for the tests, which run the cell on the CPU."""
    import torch

    from benchmark import check, harness, spec

    cell = spec.cell(name, root)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            log(f"{name} needs {cell.chips} CUDA device(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                " visible: no result")
            return 2, None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    readers = {m["name"]: spec.metric_reader(m["name"], m, root)
               for m in (cell.per_layer if trace else cell.end_to_end)}

    log(f"set-up imports and the card {time.time() - t_start:.3f} s")
    s = harness.build(cell, seed, device, log)
    setup_s = time.time() - t_start
    log(f"{name} seed {seed}: set-up {setup_s:.3f} s, max_steps "
        f"{s.program.max_steps}, first losses {s.first.losses}")
    win = harness.window(s, cell.traffic, seconds)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    log(f"window {win.seconds:.3f} s: {win.steps} steps, {win.failed} "
        f"failed, cycles of {' '.join(f'{c:.4f}' for c in win.cycle_s)} s")
    counts = traced = None
    if trace:
        counts = harness.counts(s, cell.traffic)
        traced = harness.traced(s, cell.traffic, root)
    rec = dict(traffic=cell.traffic, setup_s=setup_s, window=win,
               peak_bytes=peak,
               capture_s=s.session.capture_s, max_steps=s.program.max_steps,
               work=s.program.work(), counts=counts, trace=traced)
    inp, first = s.inp, s.first
    harness.free(s)
    del s
    harness.collect(device)
    ref_steps, ref_rec = harness.reference_steps(cell.config, inp, device)
    values = check.numbers(first, ref_steps, ref_rec.first_raw_grad)
    correct = check.judge(values, cell.limits)

    metrics = {}
    for m_name, mod in readers.items():
        v = mod.read(rec)
        if v is not None:
            metrics[m_name] = {"value": v, "unit": mod.UNIT}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": win.steps + win.failed,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if trace and traced is not None:
        from benchmark import trace as trace_lib

        busy = trace_lib.busy_s(traced)
        if busy > 0:
            dev["busy_s"], dev["window_s"] = busy, traced.window_s
        result["breakdown"] = trace_lib.breakdown(traced)
    if on_card:
        from ndcn_tpu_torch.tools import card

        dev["card"] = card()
    log(f"first steps: nfe {first.nfe} (reference {ref_steps.nfe}), losses "
        f"{first.losses} (reference {ref_steps.losses})")
    result["check"] = {
        k: {"value": values[k] if math.isfinite(values[k]) else None,
            "limit": cell.limits[k]} for k in check.NAMES}
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {bad}; the benchmark measures the "
            f"port alone: no result")
        return 3, None
    for k in check.NAMES:
        log(f"check {k} {values[k]!r} limit {cell.limits[k]!r}")
    return 0, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark.run")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true",
                    help="print every cell and what it resolves to")
    args = ap.parse_args(argv)
    if args.list:
        from benchmark import spec

        for row in spec.listing():
            print(json.dumps(row))
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        ap.error("--workload, --seed and --seconds are required")
    code, result = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace))
    if result is not None:
        print(json.dumps(result, allow_nan=True), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
