"""The port's spans (``utils.timing.span``) under ``torch.profiler`` on the
CPU: where each opens and what it holds in one NDCN train step (host loop,
both layouts) and in an eager ``TrainChunk``; how many of each a step and a
solve open; the off path (no profiler) opening nothing; and a profiled
step computing what an unprofiled one computes, bit for bit."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ndcn_tpu_torch.graph import generators, operators, sparse
from ndcn_tpu_torch.graph.sparse import as_operator
from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
from ndcn_tpu_torch.train.chunk import TrainChunk
from ndcn_tpu_torch.train.losses import l1_loss
from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam
from ndcn_tpu_torch.utils import timing

N, T = 25, 6
# each span and the span it opens in (None: outermost)
PARENT = {"train.step": None, "train.forward": "train.step",
          "train.backward": "train.step", "train.optimizer": "train.step",
          "model.encode": "train.forward", "model.decode": "train.forward",
          "ode.solve": "train.forward", "ode.attempt": "ode.solve",
          "ode.sync": "ode.attempt", "ode.observe": "ode.solve"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(fmt: str):
    """A 5 × 5 grid's normalized Laplacian (dense or COO), x0 and a target."""
    adj = generators.build_network("grid", N)
    lap = (operators.normalized_laplacian(adj) if fmt == "dense" else
           operators.normalized_laplacian_sparse(adj))
    op = as_operator(lap, sparse=fmt != "dense", format=fmt)
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.uniform(0, 5, (N, 1)), dtype=torch.float32)
    target = torch.tensor(rng.uniform(0, 5, (T, N, 1)), dtype=torch.float32)
    return op, x0, target


class _Step:
    """``make_sgd_step`` over the NDCN train objective; ``stats`` keeps each
    call's ``SolveStats``."""

    def __init__(self, fmt="dense", layout="nd", scan=False, max_steps=64):
        op, x0, target = _problem(fmt)
        self.model = init_ndcn(torch.Generator().manual_seed(0), 1, 8, 1)
        self.opt = torch_adam(self.model.parameters(), 0.01, 1e-3,
                              capturable=scan)
        t = torch.linspace(0.0, 1.0, T)
        self.stats = []

        def loss_fn():
            out, stats = ndcn_forward(self.model, op, t, x0, rtol=0.01,
                                      atol=0.001, method="dopri5",
                                      max_steps=max_steps, layout=layout,
                                      scan=scan)
            self.stats.append(stats)
            loss = l1_loss(out, target)
            return loss, loss / target.mean()

        self.step = make_sgd_step(self.opt, loss_fn)


def _spans(prof):
    """The port's spans the profiler recorded, in order of their start."""
    evs = [e for e in prof.events() if e.name in PARENT]
    return sorted(evs, key=lambda e: e.time_range.start)


def _enclosing(ev):
    """The nearest span of the port that holds ``ev``, or None."""
    p = ev.cpu_parent
    while p is not None and p.name not in PARENT:
        p = p.cpu_parent
    return None if p is None else p.name


def _names(evs):
    return [e.name for e in evs]


@pytest.mark.parametrize("fmt,layout", [("dense", "nd"),
                                        ("coo", "feature_major")])
def test_a_host_loop_step_opens_the_spans_nested(fmt, layout, monkeypatch):
    # the feature-major solve (heat1m's) needs an operator that serves the
    # SpMV kernels: the CPU tests' seam, as in test_torch_scale.py
    monkeypatch.setattr(sparse, "use_tiled_kernel", lambda op: True)
    s = _Step(fmt, layout)
    s.step()                                        # outside the profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.step()
    evs = _spans(prof)
    assert set(_names(evs)) == set(PARENT)
    for e in evs:
        assert _enclosing(e) == PARENT[e.name], e.name
    top = [e.name for e in evs if _enclosing(e) in (None, "train.step")]
    assert top == ["train.step", "train.forward", "train.backward",
                   "train.optimizer"]
    fwd = [e.name for e in evs if _enclosing(e) == "train.forward"]
    assert fwd == ["model.encode", "ode.solve", "model.decode"]


def test_a_solve_opens_an_attempt_span_an_attempt_and_a_sync_a_read():
    s = _Step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            s.step()
    names = _names(_spans(prof))
    stats = s.stats
    assert len(stats) == 2
    assert names.count("ode.solve") == 2
    assert names.count("ode.attempt") == sum(st.n_accepted + st.n_rejected
                                             for st in stats)
    assert names.count("ode.sync") == sum(st.host_syncs for st in stats)
    for name in ("train.step", "train.backward", "train.optimizer",
                 "train.forward", "model.encode", "model.decode"):
        assert names.count(name) == 2, name


def test_a_host_loop_solve_opens_an_observe_span_a_read_step(monkeypatch):
    # y0's readout, then one read a step that passed observations: at most
    # one an accepted step, and fewer than one an observation
    monkeypatch.setattr(sparse, "use_tiled_kernel", lambda op: True)
    s = _Step("coo", "feature_major")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.step()
    names = _names(_spans(prof))
    (stats,) = s.stats
    assert 2 <= names.count("ode.observe") <= stats.n_accepted + 1
    assert names.count("ode.observe") < T


def test_an_eager_chunk_opens_a_step_span_a_step_and_one_read_span():
    k, budget = 2, 8
    s = _Step(scan=True, max_steps=budget)
    chunk = TrainChunk(s.step, list(s.model.parameters()), s.opt)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chunk(k)
    evs = _spans(prof) + [e for e in prof.events()
                          if e.name.startswith("train.chunk.")]
    names = _names(evs)
    assert names.count("train.step") == k
    assert names.count("train.chunk.read") == 1
    assert names.count("train.chunk.replay") == 0   # no graph on the CPU
    # the bounded solve: every one of its attempts, and no read
    assert names.count("ode.attempt") == k * budget
    assert all(bool(st.success) for st in s.stats)
    assert names.count("ode.sync") == 0


def test_span_off_is_the_shared_null_context_and_calls_no_torch(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a torch operation ran with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    a, b = timing.span("train.step"), timing.span("ode.attempt")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a, b:
        pass
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        on = timing.span("train.step")
        assert isinstance(on, torch.autograd.profiler.record_function)


def test_a_profiled_step_computes_the_unprofiled_step_bit_for_bit():
    plain, traced = _Step(), _Step()
    losses = [plain.step() for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU]):
        traced_losses = [traced.step() for _ in range(2)]
    for (l1, r1), (l2, r2) in zip(losses, traced_losses):
        assert torch.equal(l1, l2) and torch.equal(r1, r2)
    for p, q in zip(plain.model.parameters(), traced.model.parameters()):
        assert torch.equal(p, q)
