"""The Lotka-Volterra demo of the port (``experiments.lv``) against the
JAX package: the trajectory windows bit-equal, one train step at the same
weights and batch for every method (and dopri5 with the continuous
adjoint), and a short driver run.

Bars: loss within 1e-5 relative and gradients within 1e-4 rel-L1 for the
fixed-grid methods (the same float32 program); 1e-4 / 1e-3 for the
adaptive ones, whose step counts sit on float32 rounding at rtol 1e-7.
The JAX demo's own ``--adjoint`` path hands its parameters to the MLP in
the wrong place and raises a ``TypeError``; the test calls JAX's
``odeint_adjoint`` with the right signature instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndcn_tpu.models import nn as j_nn
from ndcn_tpu.ode import odeint as j_odeint
from ndcn_tpu.ode.adjoint import odeint_adjoint as j_odeint_adjoint
from ndcn_tpu.train.sampling import \
    sample_trajectory_windows as j_sample_trajectory_windows
from ndcn_tpu_torch.convert import model_from_jax
from ndcn_tpu_torch.experiments import lv
from ndcn_tpu_torch.ode import odeint
from ndcn_tpu_torch.train.sampling import sample_trajectory_windows

BATCH_TIME, BATCH = 10, 8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small operations: one thread beats a pool that shares the
    cores with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


@pytest.fixture(scope="module")
def batch():
    """A window batch of the LV truth (200 points over [-5, 5])."""
    t = torch.as_tensor(np.linspace(-5.0, 5.0, 200).astype(np.float32))
    true_y = odeint(lv.lv_rhs, torch.tensor([[0.9, 1.8]]), t, rtol=1e-7,
                    atol=1e-9, method="dopri5",
                    options={"differentiable": False})
    y0, window = sample_trajectory_windows(np.random.RandomState(0),
                                           true_y[:, 0].numpy(), BATCH_TIME,
                                           BATCH)
    return dict(t=(t[:BATCH_TIME] - t[0]).numpy(), y0=y0, window=window)


def test_trajectory_windows_are_bit_equal_to_jax():
    traj = np.random.RandomState(3).rand(100, 2).astype(np.float32)
    for seed in (0, 1):
        a = sample_trajectory_windows(np.random.RandomState(seed), traj, 25,
                                      30)
        b = j_sample_trajectory_windows(np.random.RandomState(seed), traj, 25,
                                        30)
        assert a[0].shape == (30, 2) and a[1].shape == (25, 30, 2)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("method,adjoint,bars", [
    ("rk4", False, (1e-5, 1e-4)), ("euler", False, (1e-5, 1e-4)),
    ("dopri5", False, (1e-4, 1e-3)), ("adams", False, (1e-4, 1e-3)),
    ("dopri5", True, (1e-4, 1e-3))])
def test_one_train_step_matches_jax(batch, method, adjoint, bars):
    """The demo's loss and its gradients at JAX's weights and batch."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"l1": j_nn.linear_init(k1, 2, 20),
              "l2": j_nn.linear_init(k2, 20, 2)}
    bt, by0, by = (jnp.asarray(batch[k]) for k in ("t", "y0", "window"))

    def func(p, y):
        return j_nn.linear_apply(p["l2"],
                                 jnp.tanh(j_nn.linear_apply(p["l1"], y)))

    def j_loss(p):
        if adjoint:
            pred = j_odeint_adjoint(lambda tt, y, q: func(q, y), by0, bt, p,
                                    rtol=1e-7, atol=1e-9, method=method)
        else:
            pred = j_odeint(lambda tt, y: func(p, y), by0, bt, method=method)
        return jnp.mean(jnp.abs(pred - by))

    want, j_grads = jax.jit(jax.value_and_grad(j_loss))(params)
    mlp = lv.LVFunc(generator=torch.Generator().manual_seed(0))
    model_from_jax(jax.tree_util.tree_map(np.asarray, params), mlp)
    loss = lv.lv_loss(mlp, torch.as_tensor(batch["y0"]),
                      torch.as_tensor(batch["window"]),
                      torch.as_tensor(batch["t"]), method, adjoint)
    loss.backward()
    loss_bar, grad_bar = bars
    assert abs(loss.item() - float(want)) <= loss_bar * float(want)
    for name in ("l1", "l2"):
        layer = getattr(mlp, name)
        assert rel_l1(layer.weight.grad.numpy().T,
                      j_grads[name]["w"]) <= grad_bar, name
        assert rel_l1(layer.bias.grad.numpy(),
                      j_grads[name]["b"]) <= grad_bar, name


def test_driver_runs_finite_on_the_cpu(capsys):
    out = lv.main(["--niters", "4", "--test_freq", "2", "--data_size", "200",
                   "--batch_time", "10", "--batch_size", "20", "--platform",
                   "cpu"])
    assert out["device"] == "cpu" and len(out["train_losses"]) == 4
    assert np.all(np.isfinite(out["train_losses"]))
    assert len(out["eval_losses"]) == 2 and np.isfinite(out["final_loss"])
    assert "Iter 0004 | Total Loss" in capsys.readouterr().out


def test_driver_defaults_to_the_card():
    """``--platform`` defaults to gpu, which raises without a card;
    ``--precision high`` runs (TF32 for PyTorch's float32 products; on
    the CPU the same losses) and restores the precision it found."""
    args = lv.build_parser().parse_args([])
    assert args.platform == "gpu" and args.method == "rk4"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lv.run(args)
    precision = torch.get_float32_matmul_precision()
    argv = ["--niters", "4", "--test_freq", "2", "--platform", "cpu"]
    out = lv.main(argv + ["--precision", "high"])
    assert torch.get_float32_matmul_precision() == precision
    assert out["train_losses"] == lv.main(argv)["train_losses"]
