"""Whole runs of each cell on the CPU, cut to a test's size
(``tiny_root``): a sound run comes out correct, and a run with the timed
path broken underneath comes out not correct, once for each fault a
training cell can have (a step that leaves its state unchanged, half of
the batch left out with the mean over the rest, an answer altered where it
is produced; one card, so no exchange between chips); and the control,
the reference computed in TF32 put in the program's place, fails the
cell's limits."""

import json
import time

import pytest
import torch

from benchmark import check, harness, inputs, spec
from benchmark.run import run_cell
from benchmark.tests import tiny_root

CELLS = tiny_root.cells(spec.ROOT)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root.make(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run(root, name, seed=11, trace=False):
    code, result = run_cell(name, seed, 0.2, trace, device="cpu", root=root,
                            t_start=time.time())
    assert code == 0
    return result


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(root, name):
    result = _run(root, name)
    assert result["correct"] is True
    assert list(result)[-1] == "check"
    assert set(result["check"]) == set(check.NAMES)
    assert result["failed"] == 0 and result["attempted"] > 0
    cell = spec.cell(name, root)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end
                                      if m["name"] != "peak_mem_gb"}
    json.dumps(result)


def _state_unchanged(monkeypatch):
    from ndcn_tpu_torch.train import optim

    def no_step(self, closure=None):
        return None

    monkeypatch.setattr(torch.optim.Adam, "step", no_step)
    monkeypatch.setattr(optim.CapturableAdam, "step", no_step)


def _half_batch(monkeypatch):
    from ndcn_tpu_torch.train import losses

    whole = losses.l1_loss

    def half(pred, true, group=None):
        rows = pred.shape[1] // 2
        return whole(pred[:, :rows], true[:, :rows], group)

    monkeypatch.setattr(losses, "l1_loss", half)


def _answer_altered(monkeypatch):
    from ndcn_tpu_torch.models import ndcn

    for name in ("ode_func", "ode_func_T"):
        right = getattr(ndcn, name)

        def altered(*a, _right=right, **kw):
            return _right(*a, **kw) * 1.01

        monkeypatch.setattr(ndcn, name, altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(root, name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    assert _run(root, name)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_the_limits(root, name):
    cell = spec.cell(name, root)
    cpu = torch.device("cpu")
    inp = inputs.make(cell.config, 13, cpu)
    ref, rec = harness.reference_steps(cell.config, inp, cpu)
    control, _ = harness.reference_steps(cell.config, inp, cpu, mode="tf32")
    values = check.numbers(control, ref, rec.first_raw_grad)
    assert not check.judge(values, cell.limits), values
