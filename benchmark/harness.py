"""One run of one cell: set-up, the measured window, the traced span and
the comparison with the reference.

Set-up builds the inputs, the program and ONE train step object
(``benchmark.session``), drives its first three steps through the window's
own call, one step a call (the comparison's steps), and the rest of one
cycle, then restores the cycle's start. If that cycle exhausts the step
budget, set-up regrows it once and starts again.

The window repeats the cycle: at each cycle's start the parameters and
Adam's state are restored in place; each ``steps_per_read`` steps end in
one host read of the loss; the window closes at the first cycle's end
after ``seconds``. A read whose loss is not finite (the solve ran out of
its budget) counts its steps as failed, regrows the budget and rolls back
to the cycle's start, the last snapshot, as the drivers roll back to
theirs. ``train_steps_per_s`` is every completed step over the window's
whole time, reads, restores and rollbacks included.

The traced run (``--trace 1``) then drives one cycle a step a call,
reading each solve's counts (NFE, attempts), and profiles
``trace_steps`` steps from a cycle's start (``torch.profiler``, a Chrome
trace under the checkout's ``build/``, read and deleted).

The reference runs after the window, once the peak is read and the
program's state is freed.
"""

from __future__ import annotations

import gc
import math
import os
import time
from typing import List, NamedTuple, Optional

import torch

from benchmark import check, inputs, spec
from benchmark import trace as trace_lib
from benchmark.program import Program
from benchmark.reference import ndcn as ref
from benchmark.reference.products import Products


class SetUp(NamedTuple):
    inp: inputs.Inputs
    program: Program
    session: object
    start: List[torch.Tensor]
    first: check.Steps


class Window(NamedTuple):
    steps: int
    failed: int
    seconds: float
    cycle_s: List[float]        # each cycle's seconds, by the host clock


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cell: spec.Cell, seed: int, device: torch.device,
          log=None) -> SetUp:
    """The set-up; ``log`` takes each phase's seconds, by the host clock."""
    config, traffic = cell.config, cell.traffic
    session_cls = spec.dispatch(traffic)
    clock = [time.perf_counter()]

    def phase(name):
        sync(device)
        now = time.perf_counter()
        if log is not None:
            log(f"set-up {name} {now - clock[0]:.3f} s")
        clock[0] = now

    inp = inputs.make(config, seed, device)
    phase("inputs")
    program = Program(config, inp, device, scan=session_cls.scan)
    want = config["solver"]["solve_layout"]
    if program.solve_layout != want:
        raise SystemExit(f"the program resolves layout "
                         f"{config['solver']['layout']!r} to "
                         f"{program.solve_layout!r}; the configuration states "
                         f"{want!r}")
    phase("program")
    program.probe_budget()
    phase("probe")
    session = session_cls(program)
    start = session.snapshot()
    phase("step")
    first = first_cycle(session, start, traffic)
    session.restore(start)
    phase("first cycle")
    return SetUp(inp, program, session, start, first)


def _intervals(done: int, total: int, per_read: int):
    """The read sizes from ``done`` to ``total`` steps, aligned to reads."""
    while done < total:
        k = min(per_read - done % per_read, total - done)
        yield k
        done += k


def first_cycle(session, start, traffic) -> check.Steps:
    """The comparison's three steps, one a call, and the rest of a cycle;
    the budget regrown once if the cycle exhausts it."""
    beta1 = session.program.config["train"]["betas"][0]
    for attempt in range(2):
        losses, nfe, m1 = [], [], None
        for i in range(3):
            loss, _ = session.run(1)
            losses.append(loss)
            nfe.append(session.last_stats()[0])
            if i == 0:
                m1 = session.first_moments()
        end = {n: p.detach().clone() for n, p in zip(session.names,
                                                      session.params)}
        ok = all(math.isfinite(v) for v in losses)
        for k in _intervals(3, traffic["cycle_steps"],
                            traffic["steps_per_read"]):
            if not ok:
                break
            ok = math.isfinite(session.run(k)[0])
        if ok:
            return check.Steps(
                losses, {n: m / (1.0 - beta1) for n, m in m1.items()},
                dict(zip(session.names, start)), end, nfe)
        if attempt == 0:
            session.regrow()
            session.restore(start)
    raise SystemExit("the set-up cycle exhausted the step budget twice "
                     f"(max_steps {session.program.max_steps})")


def window(s: SetUp, traffic: dict, seconds: float) -> Window:
    sess, device = s.session, s.program.device
    cycle, per_read = traffic["cycle_steps"], traffic["steps_per_read"]
    steps = failed = 0
    cycle_s = []
    sync(device)
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        sess.restore(s.start)
        at = 0
        while at < cycle:
            k = min(per_read, cycle - at)
            loss, _ = sess.run(k)
            if math.isfinite(loss):
                steps += k
                at += k
            else:
                failed += k
                sess.regrow()
                sess.restore(s.start)
                at = 0
        cycle_s.append(time.perf_counter() - c0)
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return Window(steps, failed, time.perf_counter() - t0, cycle_s)


def counts(s: SetUp, traffic: dict) -> list:
    """(nfe, accepted, rejected, success) of every step of one cycle."""
    s.session.restore(s.start)
    out = []
    for _ in range(traffic["cycle_steps"]):
        s.session.run(1)
        out.append(s.session.last_stats())
    return out


def traced(s: SetUp, traffic: dict, root) -> Optional[trace_lib.Trace]:
    """``trace_steps`` steps from a cycle's start under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    device = s.program.device
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    s.session.restore(s.start)
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(trace_lib.WINDOW):
            for k in _intervals(0, traffic["trace_steps"],
                                traffic["steps_per_read"]):
                with record_function("bench.read"):
                    s.session.run(k)
            sync(device)
    out_dir = root / "build" / "bench_trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    try:
        return trace_lib.window(trace_lib.load(str(path)))
    finally:
        os.remove(path)


def reference_steps(config: dict, inp: inputs.Inputs, device: torch.device,
                    mode: str = "float64", loss_rows: Optional[int] = None):
    """The reference's three steps (``reference.ndcn.train_steps``) from
    the inputs alone: (check.Steps, its record)."""
    prod = Products(mode)
    lap = ref.normalized_laplacian(inp.adjacency, device,
                                   dense=config["graph"]["format"] == "dense")
    op = prod.operator(lap)
    del lap
    tdtype = torch.float64 if mode == "float64" else torch.float32
    t = torch.as_tensor(inp.t_train, device=device).to(tdtype)
    solver, tr = config["solver"], config["train"]
    rec = ref.train_steps(
        prod, inp.weights, op, inp.x0, inp.target, t, rtol=solver["rtol"],
        atol=solver["atol"], lr=tr["lr"], weight_decay=tr["weight_decay"],
        betas=tuple(tr["betas"]), eps=tr["eps"], steps=3,
        norm_count=inp.n * spec.state_width(config), loss_rows=loss_rows)
    return check.Steps(rec.losses, rec.first_grad, inp.weights,
                       rec.params, [st.nfe for st in rec.stats]), rec


def free(s: SetUp) -> None:
    """Release the program's graph; the caller then drops ``s`` and calls
    ``collect``."""
    s.session.release()


def collect(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
