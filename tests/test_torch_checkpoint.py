"""The port's checkpoint / resume (``train.checkpoint``) and the dynamics
drivers' ``--ckpt_dir``, on the CPU.

- atomic, step-stamped files with latest-k retention, as the JAX package's
  ``train/checkpoint.py``;
- a run interrupted at a checkpoint and resumed repeats the uninterrupted
  run's train losses and final evaluation bit for bit (weights, Adam's
  state, the dropout generator and the step budget are restored);
- the payload is the JAX package's: a JAX-written checkpoint's weights load
  into the port (its optax state is not read), and the JAX package reads a
  port-written checkpoint's weights.
"""

import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.train import checkpoint as j_checkpoint
from ndcn_tpu_torch.convert import params_to_jax
from ndcn_tpu_torch.experiments.dynamics import build_parser, run
from ndcn_tpu_torch.models import init_ndcn
from ndcn_tpu_torch.train import checkpoint
from ndcn_tpu_torch.train.optim import torch_adam
from ndcn_tpu_torch.utils.io import atomic_write


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model_and_opt(seed=0):
    model = init_ndcn(torch.Generator().manual_seed(seed), 1, 6, 1)
    return model, torch_adam(model.parameters(), 0.01, 1e-3)


def _step(model, opt):
    opt.zero_grad()
    loss = sum((p ** 2).sum() for p in model.parameters())
    loss.backward()
    opt.step()


def test_atomic_write_leaves_only_the_file(tmp_path):
    path = tmp_path / "sub" / "a.bin"
    atomic_write(str(path), b"abc")
    atomic_write(str(path), b"defg")
    assert path.read_bytes() == b"defg"
    assert os.listdir(path.parent) == ["a.bin"]
    assert oct(path.stat().st_mode & 0o777) == "0o644"


def test_retention_keeps_the_newest_k(tmp_path):
    model, opt = _model_and_opt()
    for step in (5, 10, 15, 20, 25):
        checkpoint.save_checkpoint(str(tmp_path), step, model, opt, keep=3)
    assert sorted(checkpoint.all_checkpoint_steps(str(tmp_path))) == \
        [15, 20, 25]
    assert checkpoint.latest_checkpoint(str(tmp_path)).endswith(
        "ckpt_00000025.pkl")
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert checkpoint.restore_or_init(None, model, opt) == 0
    assert checkpoint.restore_or_init(str(tmp_path / "none"), model,
                                      opt) == 0


def test_restore_repeats_the_weights_and_adams_state(tmp_path):
    """After a restore the next optimizer step is bit-equal to the one the
    saved run takes."""
    model, opt = _model_and_opt()
    for _ in range(3):
        _step(model, opt)
    gen = torch.Generator().manual_seed(9)
    torch.rand(3, generator=gen)
    checkpoint.save_checkpoint(str(tmp_path), 3, model, opt,
                               extra={"rng": gen.get_state(), "note": 7})
    _step(model, opt)
    want = [p.detach().clone() for p in model.parameters()]

    fresh, fresh_opt = _model_and_opt(seed=1)
    step, extra = checkpoint.restore_with_extra(str(tmp_path), fresh,
                                                fresh_opt)
    assert step == 3 and extra["note"] == 7
    gen2 = torch.Generator()
    gen2.set_state(extra["rng"])
    assert torch.equal(torch.rand(3, generator=gen2),
                       torch.rand(3, generator=gen))
    _step(fresh, fresh_opt)
    for a, b in zip(fresh.parameters(), want):
        assert torch.equal(a, b)


def test_a_resumed_run_repeats_the_uninterrupted_run(tmp_path, capsys):
    """The heat driver with dropout (the generator must be restored too):
    20 iterations against 10 and a resumed 10, every recorded loss and the
    final evaluation bit-equal."""
    base = ["--n", "36", "--time_tick", "8", "--test_freq", "5",
            "--method", "dopri5", "--dropout", "0.1", "--platform", "cpu"]
    full = run("heat", build_parser("t").parse_args(base + ["--niters",
                                                            "20"]))
    ckpt = ["--ckpt_dir", str(tmp_path), "--ckpt_freq", "10"]
    first = run("heat", build_parser("t").parse_args(
        base + ["--niters", "10"] + ckpt))
    resumed = run("heat", build_parser("t").parse_args(
        base + ["--niters", "20"] + ckpt))
    assert "resumed from" in capsys.readouterr().out
    assert first["train_losses"] + resumed["train_losses"] == \
        full["train_losses"]
    assert resumed["final"] == full["final"]
    assert sorted(checkpoint.all_checkpoint_steps(str(tmp_path))) == [10, 20]


def test_a_jax_written_checkpoint_loads_into_the_port(tmp_path, capsys):
    """The JAX package's save_checkpoint of its params and optax state: the
    port reads the weights without importing anything for the optax
    state, which it leaves alone; and the JAX package reads a port-written
    checkpoint's weights."""
    j_params = j_init_ndcn(jax.random.PRNGKey(5), 1, 6, 1)
    opt = optax.adam(1e-2)
    j_checkpoint.save_checkpoint(str(tmp_path / "jax"), 40, j_params,
                                 opt.init(j_params))
    model, port_opt = _model_and_opt()
    step, _ = checkpoint.restore_with_extra(str(tmp_path / "jax"), model,
                                            port_opt)
    assert step == 40 and "starts afresh" in capsys.readouterr().out
    assert port_opt.state_dict()["state"] == {}
    ours = params_to_jax(model)
    for name, layer in j_params.items():
        for leaf, value in layer.items():
            assert np.array_equal(ours[name][leaf], np.asarray(value))

    checkpoint.save_checkpoint(str(tmp_path / "port"), 7, model, port_opt)
    payload = j_checkpoint.load_checkpoint(
        j_checkpoint.latest_checkpoint(str(tmp_path / "port")))
    assert payload["step"] == 7
    for name, layer in ours.items():
        for leaf, value in layer.items():
            assert np.array_equal(payload["params"][name][leaf], value)


def test_foreign_classes_are_not_imported(tmp_path):
    """The reader builds numpy arrays and builtins only: a pickled object
    of any other module comes back inert."""
    path = tmp_path / "ckpt_00000001.pkl"
    path.write_bytes(pickle.dumps({"step": 1, "params": {},
                                   "opt_state": optax.EmptyState(),
                                   "x": np.arange(3)}))
    payload = checkpoint.load_checkpoint(str(path))
    assert type(payload["opt_state"]).__module__ == checkpoint.__name__
    assert np.array_equal(payload["x"], np.arange(3))
