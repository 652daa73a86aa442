"""The committed CPU references of ``chip_smoke.py`` [15] b, [16] b / d,
[17] b / d, [21] a and [24] a / b (``tests/fixtures/smoke_cpu_references.npz``,
written by ``ndcn_tpu_torch.tools.smoke_references``) are what the port
computes on the CPU now: the cheapest entries recomputed, within 1e-6
rel-L1 (the thread count may move a product's last bits; 1e-5 for the
cora step's wide encoder sums) and with equal NFE and flags. A change
that moves the port's CPU arithmetic on these paths fails here until the
fixture is written again."""

import numpy as np
import pytest
import torch

from ndcn_tpu_torch.tools import smoke_references as sr


@pytest.fixture(scope="module")
def fixture():
    return sr.load()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


def test_fixture_holds_every_setting(fixture):
    for method in sr.SERVE_METHODS:
        assert fixture[f"serve/{method}/out"].shape[1:] == (400, 1)
        assert bool(fixture[f"serve/{method}/ok"])
    for label in sr.REPLICA_SETTINGS:
        assert fixture[f"replicas/{label}/loss"].shape == (sr.R,)
        assert fixture[f"replicas/{label}/nfe"].shape == (sr.R,)
        grads = sr.replica_grads(fixture, label)
        grads64 = sr.replica_grads(fixture, label, f64=True)
        assert len(grads) == len(grads64) == 8
        assert all(g.shape[0] == sr.R and g.dtype == torch.float32
                   for g in grads)
        assert all(g.dtype == torch.float64 for g in grads64)
    for fmt in sr.CORA_FORMATS:
        assert int(fixture[f"cora/{fmt}/nfe"]) > 0
        grads = sr.step_grads(fixture, f"cora/{fmt}")
        assert grads["enc1.weight"].shape == (16, 1433) and len(grads) == 6
    assert 0.5 < float(fixture["gcn_driver/test_acc"]) <= 1.0
    for rnn_type in sr.RNN_TYPES:
        for fmt in sr.CORA_FORMATS:
            key = f"temporal/{rnn_type}_{fmt}"
            assert np.isfinite(fixture[f"{key}/loss"])
            assert sr.step_grads(fixture, key)["out.weight"].shape == (400,
                                                                       10)
    for label in sr.LV_RUNS:
        assert fixture[f"lv/{label}/train_losses"].shape == (20,)
    for label in sr.SCAN_SETTINGS:
        grads = sr.step_grads(fixture, f"scan/{label}")
        assert len(grads) == 8 and int(fixture[f"scan/{label}/nfe"]) > 0
        assert np.isfinite(fixture[f"scan/{label}/loss"])
        head = f"scan/{label}/"
        assert {k for k in fixture if k.startswith(head)} == {
            head + "loss", head + "nfe", *(head + "grad/" + n for n in grads)}


@pytest.mark.parametrize("key", ["serve/fixed_adams", "serve/explicit_adams",
                                 "replicas/explicit_adams_dense", "cora/coo",
                                 "temporal/gru_bsr", "lv/rk4",
                                 "scan/dopri5_adjoint_coo",
                                 "scan/explicit_adams_dense"])
def test_fixture_is_current(fixture, key):
    # cora's encoder gradient sums 140 rows of 1433 features, and the
    # adjoint's decoder gradient 16 · 400 states, in blocks that follow the
    # thread count (the fixture's 8, the test's 1): 1e-5
    bar = 1e-5 if key.startswith(("cora/", "scan/")) else 1e-6
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        now = sr.compute([key], log=lambda *a: None)
    finally:
        torch.set_num_threads(threads)
    assert now
    for k, v in now.items():
        if v.dtype.kind in "biu":
            assert np.array_equal(v, fixture[k]), k
        else:
            assert _rel(v, fixture[k]) <= bar, k
