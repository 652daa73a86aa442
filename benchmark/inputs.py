"""The inputs of a run, made from ``--seed`` by the benchmark's own code and
handed alike to the program and to the reference: the graph's adjacency,
x0, the observation times, the heat trajectory the model is trained to,
and the initial weights.

Every seed gets the same work in another order. The problem (the graph,
x0, the times and the weights) is drawn once from the configuration's
``problem_seed``; the run's seed draws a relabelling of the nodes and one
of the hidden units, and the inputs are the problem so relabelled: the
adjacency P A Pᵀ, x0 and the trajectory P x, the encoder's rows, the
control layer's rows and columns and the decoder's columns permuted
alike. The model computes the same function of the relabelled graph, so
every seed's solves take the same steps, and its train step the same
time and memory; what the seed moves is where each node and unit lies in
memory, and with it the order of every sum. (Drawn anew from each seed,
the problem changes the work: two seeds' 1M-node steps peaked at 18.7 and
15.9 GB, their solves taking more or fewer attempts.)

Each stream comes from ``numpy.random.SeedSequence``, so the same seed
gives the same inputs and any seed up to 2**64 works. What is large is
drawn in bulk on the run's device (a ``torch.Generator`` there).

- ``grid8``: the side × side grid, each cell joined to its 8 neighbours,
  and the three-block initial condition (25, 20, 17) of the NDCN heat
  script (calvin-zcx/ndcn ``heat_dynamics.py``).
- ``random``: ``build_sparse_graph``'s logic from the JAX package's
  ``examples/large_graph.py``: n · degree / 2 uniform node pairs, self
  loops dropped, symmetrized, duplicates merged, unit weights; x0 ~ U(0, 25).
- the times: NDCN's irregular sampling (its ``heat_dynamics.py``): 1.2 ·
  tick points drawn from a 10× oversampled grid on [0, T], t[0] = 0; of the
  first tick, a random fifth are held out for interpolation and the rest
  are the training observations.
- the heat trajectory: x' = -L x from x0, L the configuration's physics
  operator, by classical RK4 in float64 with steps of at most 0.1 / λ, λ a
  bound on L's spectrum (2 · the largest degree for D - A, 2 for the
  normalized Laplacian), landing on every observation time.
- the weights: ``nn.Linear``'s U(±1/sqrt(fan_in)) for every weight and bias.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from benchmark.reference.ndcn import LEAVES, normalized_laplacian


class Inputs(NamedTuple):
    adjacency: object          # numpy (n, n) float32 or scipy CSR
    n: int
    x0: torch.Tensor           # (n, 1) float32 on the device
    t_train: np.ndarray        # (T,) float32, t[0] = 0
    t_full: np.ndarray         # every observation time of the grid
    target: torch.Tensor       # (T, n, 1) float32 on the device
    weights: Dict[str, torch.Tensor]


def streams(seed: int, count: int = 4):
    """``count`` independent 64-bit seeds from one run seed."""
    if seed < 0:
        raise ValueError(f"--seed takes a whole number >= 0, got {seed}")
    children = np.random.SeedSequence(seed).spawn(count)
    return [int(c.generate_state(1, np.uint64)[0]) for c in children]


def grid8_adjacency(side: int) -> np.ndarray:
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    xs, ys = xs.ravel(), ys.ravel()
    a = np.zeros((side * side, side * side), dtype=np.float32)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nx, ny = xs + dx, ys + dy
            ok = (nx >= 0) & (nx < side) & (ny >= 0) & (ny < side)
            a[xs[ok] * side + ys[ok], nx[ok] * side + ny[ok]] = 1.0
    return a


def grid_blocks(side: int) -> np.ndarray:
    x0 = np.zeros((side, side), dtype=np.float32)
    x0[int(0.05 * side):int(0.25 * side), int(0.05 * side):int(0.25 * side)] = 25.0
    x0[int(0.45 * side):int(0.75 * side), int(0.45 * side):int(0.75 * side)] = 20.0
    x0[int(0.05 * side):int(0.25 * side), int(0.35 * side):int(0.65 * side)] = 17.0
    return x0.reshape(-1, 1)


def random_graph(n: int, degree: int, gen: torch.Generator,
                 label: torch.Tensor) -> sp.csr_matrix:
    """The symmetric random graph, drawn and merged on ``gen``'s device,
    node i labelled ``label[i]``."""
    m = n * degree // 2
    dev = gen.device
    rows = torch.randint(0, n, (m,), generator=gen, device=dev)
    cols = torch.randint(0, n, (m,), generator=gen, device=dev)
    keep = rows != cols
    rows, cols = label[rows[keep]], label[cols[keep]]
    key = torch.unique(torch.cat([rows * n + cols, cols * n + rows]))
    r, c = key // n, key % n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
    return sp.csr_matrix((np.ones(key.numel(), np.float32),
                          c.cpu().numpy().astype(np.int32),
                          indptr.cpu().numpy()), shape=(n, n))


def time_grid(total: float, tick: int, rng: np.random.Generator):
    """(every time, the training indices) of the irregular sampling."""
    dense = np.linspace(0.0, total, tick * 10)
    t = np.sort(rng.permutation(dense)[: int(tick * 1.2)]).astype(np.float32)
    t[0] = 0.0
    held = np.sort(rng.permutation(np.arange(1, tick))[: int(tick * 0.2)])
    train = np.array(sorted(set(range(tick)) - set(held.tolist())))
    return t, train


def physics_operator(kind: str, adjacency, device: torch.device):
    """(x -> L x in float64, the spectral bound λ) for x' = -L x."""
    if kind == "lap":
        a = torch.as_tensor(np.asarray(adjacency), dtype=torch.float64,
                            device=device)
        lap = torch.diag(a.sum(1)) - a
        return (lambda x: lap @ x), 2.0 * float(a.sum(1).max())
    if kind == "norm_lap":
        lap = normalized_laplacian(adjacency, device,
                                   dense=not sp.issparse(adjacency))
        return (lambda x: lap @ x), 2.0
    raise ValueError(f"unknown physics operator {kind!r}")


def heat_trajectory(apply_l, bound: float, x0: torch.Tensor,
                    t: np.ndarray) -> torch.Tensor:
    """x(t_i) of x' = -L x, (len(t), n, 1) float32 (see the module)."""
    h_max = 0.1 / bound
    x = x0.to(torch.float64)
    out = [x]

    def rhs(y):
        return -apply_l(y)

    for a, b in zip(t[:-1].astype(np.float64), t[1:].astype(np.float64)):
        steps = max(1, int(np.ceil((b - a) / h_max)))
        h = (b - a) / steps
        for _ in range(steps):
            k1 = rhs(x)
            k2 = rhs(x + 0.5 * h * k1)
            k3 = rhs(x + 0.5 * h * k2)
            k4 = rhs(x + h * k3)
            x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        out.append(x)
    return torch.stack(out).to(torch.float32)


def initial_weights(model: dict, gen: torch.Generator,
                    units: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every leaf of ``reference.ndcn.LEAVES`` at ``model``'s widths, from
    one draw on ``gen``'s device, hidden unit j the draw's ``units[j]``."""
    i, h, o = model["input_size"], model["hidden_size"], model["output_size"]
    shapes = {"enc1.weight": (h, i), "enc1.bias": (h,), "enc2.weight": (h, h),
              "enc2.bias": (h,), "wt.weight": (h, h), "wt.bias": (h,),
              "dec.weight": (o, h), "dec.bias": (o,)}
    fan_in = {"enc1": i, "enc2": h, "wt": h, "dec": h}
    sizes = [int(np.prod(shapes[k])) for k in LEAVES]
    u = torch.rand(sum(sizes), generator=gen, device=gen.device)
    out, at = {}, 0
    for k, size in zip(LEAVES, sizes):
        bound = fan_in[k.split(".")[0]] ** -0.5
        out[k] = ((2.0 * u[at:at + size] - 1.0) * bound).reshape(shapes[k])
        at += size
    for k in ("enc1", "enc2", "wt"):        # their outputs are hidden units
        out[f"{k}.weight"] = out[f"{k}.weight"][units]
        out[f"{k}.bias"] = out[f"{k}.bias"][units]
    for k in ("enc2", "wt", "dec"):         # their inputs are hidden units
        out[f"{k}.weight"] = out[f"{k}.weight"][:, units].contiguous()
    return out


def make(config: dict, seed: int, device: torch.device) -> Inputs:
    """The inputs of ``config`` at ``seed`` on ``device`` (the module)."""
    s_graph, s_time, s_x0, s_weights = streams(config["problem_seed"])
    graph, solver = config["graph"], config["solver"]

    def gen(s):
        return torch.Generator(device=device).manual_seed(s)

    relabel = gen(streams(seed, 1)[0])
    n = graph["side"] ** 2 if graph["kind"] == "grid8" else graph["n"]
    node = torch.randperm(n, generator=relabel, device=device)  # new -> old
    units = torch.randperm(config["model"]["hidden_size"], generator=relabel,
                           device=device)
    if graph["kind"] == "grid8":
        side, at = graph["side"], node.cpu().numpy()
        adjacency = grid8_adjacency(side)[np.ix_(at, at)]
        x0 = torch.as_tensor(grid_blocks(side)[at], device=device)
    elif graph["kind"] == "random":
        label = torch.empty_like(node)
        label[node] = torch.arange(n, device=device)           # old -> new
        adjacency = random_graph(n, graph["avg_degree"], gen(s_graph), label)
        lo, hi = config["physics"]["x0_uniform"]
        x0 = lo + (hi - lo) * torch.rand((n, 1), generator=gen(s_x0),
                                         device=device)
        x0 = x0[node]
    else:
        raise ValueError(f"unknown graph kind {graph['kind']!r}")
    t_full, train = time_grid(solver["T"], solver["time_tick"],
                              np.random.default_rng(s_time))
    t_train = t_full[train]
    apply_l, bound = physics_operator(config["physics"]["operator"],
                                      adjacency, device)
    target = heat_trajectory(apply_l, bound, x0, t_train)
    del apply_l
    return Inputs(adjacency=adjacency, n=n, x0=x0,
                  t_train=t_train, t_full=t_full, target=target,
                  weights=initial_weights(config["model"], gen(s_weights),
                                          units))
