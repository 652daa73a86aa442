"""The readings the correctness limits are set from, at a cell's own size.

    python3 -m benchmark.calibrate --workload <name> --seeds <n> ... \\
        [--control-seeds <n> ...] [--fault-seeds <n> ...]

For each ``--seeds`` seed: the run's set-up (``harness.build``: the
program's first three steps through the window's own call) against the
reference, as ``benchmark.run`` compares them. For each
``--control-seeds`` seed: the control, the reference computed in TF32 put
in the program's place. For each ``--fault-seeds`` seed: the half-batch
fault, the reference whose loss takes the first half of the nodes, put in
the program's place. One JSON line each; no window runs. ``benchmark.run``
never runs this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import check, harness, inputs, spec


def _line(kind: str, seed: int, values: dict, **extra) -> None:
    print(json.dumps({"kind": kind, "seed": seed, **values, **extra}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--window", type=float, default=0.0,
                    help="also measure each program seed's rate for this "
                         "many seconds, and read one cycle's counts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate measures on the card; no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)            # the card's context, first
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats(device)
        s = harness.build(cell, seed, device)
        inp, first, ms = s.inp, s.first, s.program.max_steps
        extra = {}
        if args.window:
            win = harness.window(s, cell.traffic, args.window)
            cyc = harness.counts(s, cell.traffic)
            extra = dict(steps_per_s=win.steps / win.seconds,
                         peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
                         cycle_nfe=sum(c[0] for c in cyc) / len(cyc),
                         cycle_attempts_max=max(c[1] + c[2] for c in cyc))
        harness.free(s)
        del s
        harness.collect(device)
        ref_steps, rec = harness.reference_steps(cell.config, inp, device)
        _line("program", seed, check.numbers(first, ref_steps,
                                             rec.first_raw_grad),
              max_steps=ms, nfe=first.nfe, ref_nfe=ref_steps.nfe,
              seconds=time.time() - t0, **extra)
        del inp, first, ref_steps, rec
        harness.collect(device)
    for kinds, seeds in (("control", args.control_seeds),
                         ("half_batch", args.fault_seeds)):
        for seed in seeds:
            inp = inputs.make(cell.config, seed, device)
            ref_steps, rec = harness.reference_steps(cell.config, inp, device)
            if kinds == "control":
                other, orec = harness.reference_steps(cell.config, inp,
                                                      device, mode="tf32")
            else:
                other, orec = harness.reference_steps(
                    cell.config, inp, device, loss_rows=inp.n // 2)
            _line(kinds, seed, check.numbers(other, ref_steps,
                                             rec.first_raw_grad),
                  nfe=other.nfe, ref_nfe=ref_steps.nfe)
            del inp, ref_steps, rec, other, orec
            harness.collect(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
