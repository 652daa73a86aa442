"""The plain reference (``benchmark/reference``) against the port on the
CPU at tiny sizes: the three train steps the benchmark compares, through
the benchmark's own set-up, on each path its cells take (the graphed
step's bounded solve with K2's plain version, the host loop on COO in the
(n, d) layout and, with the seam the port's tests use, in the feature-major
layout whose norms count the zero rows), with equal NFE."""

import math

import pytest
import torch

from benchmark import check, harness, inputs, spec
from benchmark.reference import dopri5
from benchmark.reference import ndcn as ref
from benchmark.reference.products import Products, to_tf32


def _config(kind: str, layout: str = "nd", problem: int = 0) -> dict:
    common = {
        "problem_seed": problem,
        "model": {"kind": "ndcn", "input_size": 1, "hidden_size": 20,
                  "output_size": 1},
        "train": {"lr": 0.01, "weight_decay": 1e-3, "betas": [0.9, 0.999],
                  "eps": 1e-8},
        "kernel_precision": "split2", "tf32": False,
        "emission_precision": "f32", "residual_precision": "f32",
    }
    if kind == "grid":
        return {**common,
                "graph": {"kind": "grid8", "side": 8, "operator": "norm_lap",
                          "format": "dense", "fused": True},
                "physics": {"operator": "lap"},
                "solver": {"method": "dopri5", "rtol": 0.01, "atol": 0.001,
                           "T": 5.0, "time_tick": 20, "layout": "auto",
                           "solve_layout": "nd"},
                "budget": {"probe_times": "all", "floor": 8,
                           "headroom": 2.5, "slack": 4, "quantum": 4}}
    return {**common,
            "graph": {"kind": "random", "n": 1500, "avg_degree": 10,
                      "operator": "norm_lap", "format": "coo"},
            "physics": {"operator": "norm_lap", "x0_uniform": [0.0, 25.0]},
            "solver": {"method": "dopri5", "rtol": 0.01, "atol": 0.001,
                       "T": 5.0, "time_tick": 20,
                       "layout": "auto" if layout == "nd" else layout,
                       "solve_layout": layout},
            "budget": {"probe_times": "train", "floor": 8, "headroom": 1.5,
                       "slack": 2, "quantum": 4}}


def _cell(config, dispatch):
    traffic = {"dispatch": dispatch, "steps_per_read": 3, "cycle_steps": 4,
               "trace_steps": 3}
    return spec.Cell("t", 1, config, traffic, {}, [], [])


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("kind,dispatch,layout,seed", [
    ("grid", "graphed", "nd", 1),
    ("grid", "graphed", "nd", 2 ** 31 + 17),
    ("random", "host_loop", "nd", 3),
    ("random", "host_loop", "feature_major", 4),
])
def test_reference_follows_the_port(kind, dispatch, layout, seed,
                                    monkeypatch):
    if layout == "feature_major":
        from ndcn_tpu_torch.graph import sparse as graph_sparse

        monkeypatch.setattr(graph_sparse, "use_tiled_kernel", lambda op: True)
    config = _config(kind, layout, problem=seed % 7)
    cpu = torch.device("cpu")
    s = harness.build(_cell(config, dispatch), seed, cpu)
    ref_steps, rec = harness.reference_steps(config, s.inp, cpu)
    values = check.numbers(s.first, ref_steps, rec.first_raw_grad)
    # the first step's loss and gradient to float32's reach; at this size a
    # gradient element near zero, which Adam turns into a step of about lr
    # whose sign the rounding decides (check.py), moves the later steps'
    # losses and the change by more
    assert abs(s.first.losses[0] - ref_steps.losses[0]) \
        < 1e-6 * abs(ref_steps.losses[0])
    assert values["loss_gap"] < 1e-4
    assert values["grad_gap"] < 1e-3
    assert values["change_gap"] < 2e-2
    assert all(st.success for st in rec.stats)
    assert s.first.nfe == ref_steps.nfe


def test_feature_major_norms_count_the_zero_rows(monkeypatch):
    """With the (n, d) norm count the reference parts from the feature-major
    port by far more than with the padded count."""
    from ndcn_tpu_torch.graph import sparse as graph_sparse

    monkeypatch.setattr(graph_sparse, "use_tiled_kernel", lambda op: True)
    config = _config("random", "feature_major")
    cpu = torch.device("cpu")
    s = harness.build(_cell(config, "host_loop"), 5, cpu)
    padded, rec = harness.reference_steps(config, s.inp, cpu)
    nd_config = {**config, "solver": {**config["solver"],
                                      "solve_layout": "nd"}}
    unpadded, rec2 = harness.reference_steps(nd_config, s.inp, cpu)
    good = check.numbers(s.first, padded, rec.first_raw_grad)
    bad = check.numbers(s.first, unpadded, rec2.first_raw_grad)
    assert good["loss_gap"] < 1e-5 < bad["loss_gap"]


def test_dopri5_on_a_linear_system():
    """y' = -y from 1: the solve against exp(-t), and its gradient in the
    rate against the exact one within the tolerance's reach."""
    k = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    t = torch.linspace(0, 2, 5, dtype=torch.float64)
    sol, stats = dopri5.odeint(lambda _t, y: -k * y,
                               torch.ones(3, dtype=torch.float64), t,
                               rtol=1e-8, atol=1e-10)
    out = torch.stack(sol)[:, 0]
    assert stats.success and stats.nfe == 2 + 6 * (stats.n_accepted
                                                   + stats.n_rejected)
    assert torch.allclose(out, torch.exp(-t), rtol=1e-6)
    (g,) = torch.autograd.grad(out[-1], k)
    assert float(g) == pytest.approx(-2 * math.exp(-2), rel=1e-4)


def test_tf32_rounding_and_products():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      float("inf")])
    # ties go to even: 1 + 2^-11 -> 1, 1 + 3·2^-11 -> 1 + 2^-9
    assert to_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, float("inf")]
    a = torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
    prod = Products("tf32")
    assert torch.equal(prod.mm(a, a), to_tf32(a) @ to_tf32(a))
    assert not torch.equal(prod.mm(a, a), a @ a)
    sp_a = a.to_sparse_csr()
    dense_op = Products("float32").operator(a)
    sparse_op = Products("float32").operator(sp_a)
    x = torch.randn(8, 3, generator=torch.Generator().manual_seed(1))
    assert torch.allclose(dense_op(x), sparse_op(x), atol=1e-6)


@pytest.mark.parametrize("kind", ["grid", "random"])
def test_inputs_are_the_seeds_relabelling_of_one_problem(kind):
    """The same seed, the same inputs; another seed, the same problem with
    its nodes and hidden units relabelled: the same degrees, x0 values,
    times, weights and trajectory values, the same loss of the model."""
    config = _config(kind)
    cpu = torch.device("cpu")
    a = inputs.make(config, 2 ** 33 + 1, cpu)
    b = inputs.make(config, 2 ** 33 + 1, cpu)
    c = inputs.make(config, 2 ** 33 + 2, cpu)
    assert torch.equal(a.target, b.target) and torch.equal(a.x0, b.x0)
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
    assert not torch.equal(a.x0, c.x0)
    assert torch.equal(a.x0.flatten().sort().values,
                       c.x0.flatten().sort().values)
    assert torch.allclose(a.target.sort(dim=1).values,
                          c.target.sort(dim=1).values, rtol=1e-6, atol=1e-5)
    for k in a.weights:
        assert torch.equal(a.weights[k].flatten().sort().values,
                           c.weights[k].flatten().sort().values)
    assert (a.t_train == c.t_train).all()
    adj_a, adj_c = (torch.as_tensor(x.toarray() if hasattr(x, "toarray")
                                    else x) for x in (a.adjacency,
                                                      c.adjacency))
    assert torch.equal(adj_a, adj_a.T) and float(adj_a.diagonal().sum()) == 0
    assert torch.equal(adj_a.sum(1).sort().values, adj_c.sum(1).sort().values)
    prod = Products("float64")
    losses = []
    for inp in (a, c):
        lap = ref.normalized_laplacian(inp.adjacency, cpu, dense=True)
        t = torch.as_tensor(inp.t_train, dtype=torch.float64)
        out, stats = ref.forward(prod, {k: v.double() for k, v in
                                        inp.weights.items()},
                                 prod.operator(lap), inp.x0.double(), t,
                                 0.01, 0.001)
        losses.append((float(torch.mean(torch.abs(out - inp.target))),
                       stats.nfe))
    assert losses[0][1] == losses[1][1]
    assert losses[0][0] == pytest.approx(losses[1][0], rel=1e-9)
