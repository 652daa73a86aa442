"""The arithmetic and the launch plans of the tensor-core kernels K2, K3 and
K4, on the CPU.

The CUDA kernels multiply with every fp32 operand split into two TF32 parts
(``hi = tf32(x)``, ``lo = tf32(x - hi)``) and sum ``lo·hi + hi·lo + hi·hi`` in
fp32. ``fused_rhs_split_plain``, ``bsr_spmm_split_plain`` and
``bsr_fused_rhs_split_plain`` emulate that in plain PyTorch (TF32 = the
mantissa rounded to 10 bits). Held here:

- the emulation within 1e-5·max|y| of a float64 reference (the port's bar for
  a kernel against its plain version), on inputs from numpy seeds, while a
  one-pass TF32 product of the same inputs is not: a kernel that dropped the
  low parts would be caught by the same bound;
- the grid400 inference solve with the emulation as its right-hand side: the
  same NFE as the plain version's (20) and 1e-4 rel-L1 to the oracle fixture;
  the grid400 BSR train step with K3's emulation forward and backward: NFE
  20 and 1e-3 rel-L1 to the ``ndcn_grads_grid400`` gradients;
- the emulation and the plain versions within 1e-5·max|y| of the JAX
  package's Pallas kernels in interpret mode, as its own tests run them;
- the host's plans: shared memory within what a block may use, every row and
  column and depth step owned once, the same on two calls, and the layout
  arithmetic that the C entry checks (K3's: slabs of one warp layout that
  cover X's columns).
"""

import contextlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.kernels.bsr_spmm import bsr_fused_rhs_raw, bsr_spmm_raw
from ndcn_tpu.kernels.bsr_spmm import from_scipy_bsr as j_from_scipy_bsr
from ndcn_tpu.kernels.fused_rhs import fused_graph_rhs
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator, from_dense
from ndcn_tpu_torch.kernels import bsr_spmm, fused_rhs
from ndcn_tpu_torch.models import ndcn, ndcn_forward

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
KINDS = ["uniform", "normal", "wide_range", "laplacian"]


def _grid_lap():
    return operators.normalized_laplacian(generators.build_network("grid", 400))


def _draw(rng, kind, shape):
    if kind == "normal":
        return rng.randn(*shape).astype(np.float32)
    if kind == "wide_range":    # magnitudes from 1e-3 to 1e3, both signs
        return (10.0 ** rng.uniform(-3, 3, shape)
                * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    return rng.rand(*shape).astype(np.float32)


def _dense_inputs(n, k, kind, seed):
    rng = np.random.RandomState(seed)
    a = (_grid_lap().astype(np.float32) if kind == "laplacian"
         else _draw(rng, kind, (n, n)))
    n = a.shape[0]
    return (a, _draw(rng, kind, (n, k)),
            (rng.randn(k, k) / np.sqrt(k)).astype(np.float32),
            (0.1 * rng.randn(k)).astype(np.float32))


def _bsr_inputs(n, d, kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "laplacian":
        mat = sp.csr_matrix(_grid_lap().astype(np.float32))
    else:
        mask = sp.random(n, n, density=0.05, random_state=rng, format="csr")
        mat = mask.copy()
        mat.data = _draw(rng, kind, mat.data.shape)
    n = mat.shape[0]
    return (mat, _draw(rng, kind, (n, d)),
            (rng.randn(d, d) / np.sqrt(d)).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32))


def _rhs64(a, h, w, b):
    a, h, w, b = (np.asarray(v, np.float64) for v in (a, h, w, b))
    return np.maximum((a @ h) @ w + b, 0.0)


def _max_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_tf32_round_keeps_ten_mantissa_bits_and_rounds_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -1.0 - 2.0 ** -11,
                      1.0 + 2.0 ** -12, 3.0e-39, 0.0])
    got = fused_rhs.tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -1.0 - 2.0 ** -10, 1.0, 3.0e-39, 0.0])
    assert torch.equal(got[:5], want[:5]) and got[6] == 0.0
    r = torch.as_tensor(np.random.RandomState(0).randn(4096).astype(np.float32))
    hi = fused_rhs.tf32_round(r)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert float(((r - hi).abs() / r.abs()).max()) <= 2.0 ** -11
    lo = fused_rhs.tf32_round(r - hi)
    assert float(((r - hi - lo).abs() / r.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k", [(400, 20), (275, 13), (2000, 128)])
def test_k2_split_emulation_holds_the_fp32_bar_and_one_pass_does_not(n, k,
                                                                     kind):
    if kind == "laplacian" and n != 400:
        n = 400                     # the Laplacian is the 400-node grid's
    a, h, w, b = _dense_inputs(n, k, kind, seed=n + k)
    ref = _rhs64(a, h, w, b)
    ins = tuple(map(torch.as_tensor, (a, h, w, b)))
    assert _max_rel(fused_rhs.fused_rhs_split_plain(*ins), ref) <= 1e-5
    assert _max_rel(fused_rhs.fused_rhs_plain(*ins), ref) <= 1e-5
    assert _max_rel(fused_rhs.fused_rhs_split_plain(*ins, passes=1),
                    ref) > 1e-5


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,d", [(400, 20), (600, 256)])
def test_k4_split_emulation_holds_the_fp32_bar_and_one_pass_does_not(n, d,
                                                                     kind):
    mat, x, w, b = _bsr_inputs(n, d, kind, seed=n + d)
    ref = _rhs64(mat.toarray(), x, w, b)
    a = bsr_spmm.from_scipy_bsr(mat)
    ins = tuple(map(torch.as_tensor, (x, w, b)))
    assert _max_rel(bsr_spmm.bsr_fused_rhs_split_plain(a, *ins), ref) <= 1e-5
    assert _max_rel(bsr_spmm.bsr_fused_rhs_plain(a, *ins), ref) <= 1e-5
    assert _max_rel(bsr_spmm.bsr_fused_rhs_split_plain(a, *ins, passes=1),
                    ref) > 1e-5


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,d", [(400, 20), (600, 256), (300, 1)])
def test_k3_split_emulation_holds_the_fp32_bar_and_one_pass_does_not(n, d,
                                                                     kind):
    mat, x, _, _ = _bsr_inputs(n, d, kind, seed=n + d)
    ref = np.asarray(mat.toarray(), np.float64) @ x.astype(np.float64)
    a = bsr_spmm.from_scipy_bsr(mat)
    xt = torch.as_tensor(x)
    assert _max_rel(bsr_spmm.bsr_spmm_split_plain(a, xt), ref) <= 1e-5
    assert _max_rel(bsr_spmm.bsr_spmm_plain(a, xt), ref) <= 1e-5
    assert _max_rel(bsr_spmm.bsr_spmm_split_plain(a, xt, passes=1),
                    ref) > 1e-5


@pytest.mark.parametrize("n,d,seed", [(400, 20, 2), (300, 1, 3),
                                      (260, 70, 4)])
def test_k3_emulation_and_plain_match_jax_bsr_spmm_interpret(n, d, seed):
    mat, x, _, _ = _bsr_inputs(n, d, "laplacian" if n == 400 else "normal",
                               seed)
    ref = np.asarray(bsr_spmm_raw(j_from_scipy_bsr(mat), jnp.asarray(x)))
    a = bsr_spmm.from_scipy_bsr(mat)
    xt = torch.as_tensor(x)
    assert _max_rel(bsr_spmm.bsr_spmm_split_plain(a, xt), ref) <= 1e-5
    assert _max_rel(bsr_spmm.bsr_spmm_plain(a, xt), ref) <= 1e-5
    assert _max_rel(bsr_spmm.bsr_spmm(a, a, xt), ref) <= 1e-5


@pytest.mark.parametrize("passes", [3, 1])
def test_grid400_inference_solve_with_the_split_emulation(passes, monkeypatch):
    """The adaptive controller sees the split product as it sees fp32: the
    same NFE and step counts, 1e-4 rel-L1 to the oracle. (A one-pass product
    is off the plain solve by three orders of magnitude more.)"""
    f = dict(np.load(os.path.join(FIX, "ndcn_forward_grid400.npz")))
    tree = {name: {"w": f[f"{name}_w"].T, "b": f[f"{name}_b"]}
            for name in ("enc1", "enc2", "wt", "dec")}
    model, op = params_from_jax(tree), from_dense(_grid_lap())
    kw = dict(nondiff=True, fused=True, rtol=0.01, atol=0.001, method="dopri5")
    x0 = torch.as_tensor(f["x0"])
    plain, p_stats = ndcn_forward(model, op, f["t"], x0, **kw)
    calls = []

    def emulated(a, h, w, b):
        calls.append(1)
        return fused_rhs.fused_rhs_split_plain(a, h, w, b, passes=passes)

    monkeypatch.setattr(ndcn, "fused_rhs", emulated)
    out, stats = ndcn_forward(model, op, f["t"], x0, **kw)
    assert stats.success and len(calls) == stats.nfe
    err_plain = float((out - plain).abs().mean() / plain.abs().mean())
    if passes == 3:
        assert stats.nfe == p_stats.nfe == 20
        assert (stats.n_accepted, stats.n_rejected) == (p_stats.n_accepted,
                                                        p_stats.n_rejected)
        err = np.abs(out.numpy() - f["out"]).mean() / np.abs(f["out"]).mean()
        assert err <= 1e-4
        assert err_plain <= 1e-6
    else:
        assert err_plain > 1e-5


def test_grid400_bsr_train_step_with_the_k3_split_emulation(monkeypatch):
    """The BSR train step with fused=False, K3's split product forward and
    over Aᵀ in the backward: the same NFE (20) and the fixture's loss and
    gradients, as the plain fp32 version holds them."""
    f = dict(np.load(os.path.join(FIX, "ndcn_grads_grid400.npz")))
    tree = {name: {"w": f[f"{name}_w"].T, "b": f[f"{name}_b"]}
            for name in ("enc1", "enc2", "wt", "dec")}
    model = params_from_jax(tree)
    op = as_operator(sp.csr_matrix(_grid_lap()), sparse=True, format="bsr")
    calls = []

    def emulated(a, x):
        calls.append(x.requires_grad)
        return bsr_spmm.bsr_spmm_split_plain(a, x)

    monkeypatch.setattr(bsr_spmm, "_launch_spmm", emulated)
    out, stats = ndcn_forward(model, op, f["t"], torch.as_tensor(f["x0"]),
                              max_steps=64, fused=False, rtol=0.01,
                              atol=0.001, method="dopri5")
    loss = (out[..., 0].T - torch.as_tensor(f["target"])).abs().mean()
    n_forward = len(calls)
    loss.backward()
    assert stats.success and stats.nfe == 20 and n_forward == 20
    assert len(calls) > n_forward               # the backward's K3 over Aᵀ
    ref = float(f["loss_backprop"])
    assert abs(loss.item() - ref) / abs(ref) <= 1e-4
    for name in ("enc1", "enc2", "wt", "dec"):
        layer = getattr(model, name)
        for got, key in ((layer.weight.grad, "w"), (layer.bias.grad, "b")):
            want = f[f"g_{name}_{key}_backprop"]
            assert (np.abs(got.numpy() - want).sum()
                    / np.abs(want).sum()) <= 1e-3


@pytest.mark.parametrize("n,k,seed", [(400, 20, 0), (275, 13, 1)])
def test_k2_emulation_and_plain_match_jax_fused_kernel_interpret(n, k, seed):
    rng = np.random.RandomState(seed)
    a, h = rng.rand(n, n).astype(np.float32), rng.rand(n, k).astype(np.float32)
    w, b = rng.randn(k, k).astype(np.float32), rng.randn(k).astype(np.float32)
    ref = np.asarray(fused_graph_rhs(*map(jnp.asarray, (a, h, w, b))))
    ins = tuple(map(torch.as_tensor, (a, h, w, b)))
    assert _max_rel(fused_rhs.fused_rhs_split_plain(*ins), ref) <= 1e-5
    assert _max_rel(fused_rhs.fused_rhs_plain(*ins), ref) <= 1e-5
    assert _max_rel(fused_rhs.fused_rhs(*ins), ref) <= 1e-5


@pytest.mark.parametrize("n,d,seed", [(400, 20, 2), (260, 40, 4)])
def test_k4_emulation_and_plain_match_jax_fused_kernel_interpret(n, d, seed):
    mat, x, w, b = _bsr_inputs(n, d, "laplacian" if n == 400 else "uniform",
                               seed)
    ref = np.asarray(bsr_fused_rhs_raw(j_from_scipy_bsr(mat),
                                       *map(jnp.asarray, (x, w, b))))
    a = bsr_spmm.from_scipy_bsr(mat)
    ins = tuple(map(torch.as_tensor, (x, w, b)))
    assert _max_rel(bsr_spmm.bsr_fused_rhs_split_plain(a, *ins), ref) <= 1e-5
    assert _max_rel(bsr_spmm.bsr_fused_rhs_plain(a, *ins), ref) <= 1e-5


@pytest.mark.parametrize("n", [1, 70, 400, 1000, 10000])
@pytest.mark.parametrize("k", [1, 13, 20, 64, 128, 300, 512, 1024])
def test_k2_plan_fits_and_covers_every_row_column_and_depth_step(n, k):
    fused_rhs.fused_rhs_plan.cache_clear()
    plan = fused_rhs.fused_rhs_plan(n, k)
    fused_rhs.fused_rhs_plan.cache_clear()
    assert plan == fused_rhs.fused_rhs_plan(n, k)         # deterministic
    assert plan.smem_bytes <= fused_rhs.SMEM_LIMIT == 227 * 1024
    assert plan.smem_bytes == fused_rhs.plan_smem_bytes(
        plan.rows, plan.nt, plan.wk, plan.bk, k)
    assert plan.wn * plan.wk == fused_rhs.WARPS and fused_rhs.STAGES == 2
    assert plan.rows in (16, 32) and plan.rows * plan.nt <= 256
    assert plan.bk % (8 * plan.wk) == 0 and 8 <= plan.bk <= 128
    # no deeper a chunk than the depth needs (or than the depth warps need)
    assert plan.bk // 2 < n or plan.bk == 8 * plan.wk
    rows = [r for lo, hi in plan.row_ranges(n) for r in range(lo, hi)]
    assert rows == list(range(n))
    cols = [c for lo, hi in plan.column_ranges(k) for c in range(lo, hi)]
    assert cols == list(range(k))
    steps = sorted(s for warp in plan.depth_steps() for s in warp)
    assert steps == list(range(plan.bk // 8))
    # a narrow panel where tall ones would leave SMs without a CTA
    if plan.rows > 16:
        assert -(-n // plan.rows) >= fused_rhs.TALL_PANEL_MIN_CTAS
    # the A tile's row stride is an odd multiple of 4 floats, which keeps a
    # fragment load's 32 addresses on 32 banks
    assert (plan.bk + 4) % 8 == 4


@pytest.mark.parametrize("blocks,block,d", [(4, 128, 20), (16, 128, 256),
                                            (16, 128, 512), (3, 128, 1024),
                                            (7, 48, 33), (29, 9, 5),
                                            (200, 128, 64)])
def test_k4_plan_fits_and_tiles_every_row_block(blocks, block, d):
    plan = bsr_spmm.bsr_fused_plan(blocks, block, d)
    assert plan == bsr_spmm.bsr_fused_plan(blocks, block, d)
    assert plan.smem_bytes <= fused_rhs.SMEM_LIMIT
    assert plan.rows <= max(16, -(-block // 16) * 16)
    rows = [r for lo, hi in plan.row_ranges(block) for r in range(lo, hi)]
    assert rows == list(range(block))
    cols = [c for lo, hi in plan.column_ranges(d) for c in range(lo, hi)]
    assert cols == list(range(d))
    assert plan.bk // 2 < block or plan.bk == 8 * plan.wk
    if plan.rows > 16:
        assert (blocks * -(-block // plan.rows)
                >= fused_rhs.TALL_PANEL_MIN_CTAS)


@pytest.mark.parametrize("block", [9, 48, 128])
@pytest.mark.parametrize("d", [1, 5, 20, 33, 256, 1024, 1100])
@pytest.mark.parametrize("blocks", [4, 16, 200])
def test_k3_plan_fits_and_mirrors_make_layout(blocks, block, d):
    bsr_spmm.bsr_spmm_plan.cache_clear()
    plan = bsr_spmm.bsr_spmm_plan(blocks, block, d)
    bsr_spmm.bsr_spmm_plan.cache_clear()
    assert plan == bsr_spmm.bsr_spmm_plan(blocks, block, d)  # deterministic
    p = plan.panel
    # what make_layout takes for the one warp layout K3 is built for
    assert p.nt == 4 and p.wn * p.wk == fused_rhs.WARPS and p.rows in (16, 32)
    assert p.wn * p.nt * 8 >= plan.slab and p.bk % (8 * p.wk) == 0
    assert 8 <= p.bk <= 128 and (p.bk // 2 < block or p.bk == 8 * p.wk)
    assert p.smem_bytes == fused_rhs.plan_smem_bytes(p.rows, p.nt, p.wk, p.bk,
                                                     plan.slab)
    assert p.smem_bytes <= fused_rhs.SMEM_LIMIT == 232448
    # the slabs cover X's columns once; all but the last start and end on
    # whole n8 tiles (16-byte copies)
    assert 1 <= plan.slab <= min(d, bsr_spmm.SLAB_MAX)
    assert plan.slabs == -(-d // plan.slab)
    assert plan.slabs == 1 or plan.slab % 8 == 0
    cols = [c for j in range(plan.slabs)
            for c in range(j * plan.slab, min(d, (j + 1) * plan.slab))]
    assert cols == list(range(d))
    rows = [r for lo, hi in p.row_ranges(block) for r in range(lo, hi)]
    assert rows == list(range(block))
    # past one CTA an SM, two share one
    if blocks * -(-block // p.rows) * plan.slabs > fused_rhs.SMS:
        assert p.smem_bytes <= fused_rhs.TWO_CTAS_SMEM


def test_plans_and_checks_name_the_limit():
    with pytest.raises(ValueError, match="1 <= width <= 1024"):
        fused_rhs.panel_plan(1025, 64, lambda rows: 1)
    with pytest.raises(ValueError, match="1 <= width <= 1024"):
        fused_rhs.panel_plan(0, 64, lambda rows: 1)
    k = fused_rhs.K_MAX + 1
    with pytest.raises(ValueError, match="k <= 1024"):
        fused_rhs.fused_rhs(torch.zeros(4, 4), torch.zeros(4, k),
                            torch.zeros(k, k), torch.zeros(k))
    a = bsr_spmm.from_scipy_bsr(sp.identity(4, format="csr"))
    with pytest.raises(ValueError, match="d <= 1024"):
        bsr_spmm.bsr_fused_rhs(a, a, torch.zeros(4, k), torch.zeros(k, k),
                               torch.zeros(k))


def test_fused_kernel_tools_need_the_card_and_match_the_sources():
    from ndcn_tpu_torch.kernels import build
    from ndcn_tpu_torch.tools import probe_mma_accumulate, tune_fused_plan

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from ndcn_tpu_torch.tools import compare_builds

    for tool, argv in ((tune_fused_plan, []), (tune_fused_plan, ["k3"]),
                       (probe_mma_accumulate, []), (compare_builds, ["."])):
        with pytest.raises(RuntimeError, match="CUDA device"):
            tool.main(argv)
    header = (build.CSRC / "mma_split.cuh").read_text()
    assert f"kStages = {fused_rhs.STAGES};" in header
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert header.count("cvt.rna.tf32.f32") == 2          # hi, and lo
    for src in ("fused_rhs.cu", "bsr_spmm.cu"):
        assert '#include "mma_split.cuh"' in (build.CSRC / src).read_text()
    # K3 is the panel product alone, K2 and K4 the fused panel built on it
    bsr = (build.CSRC / "bsr_spmm.cu").read_text()
    assert "panel_product<MT, kSpmmNt>" in bsr and "fmaf" not in bsr
    assert "panel_product<MT, NT>(smem, L, src, nchunks" in header


@pytest.mark.parametrize("n,k", [(400, 20), (10000, 128), (64, 1024)])
def test_tuning_variants_fit_a_block_and_include_the_plan(n, k):
    from ndcn_tpu_torch.tools import tune_fused_plan

    base = fused_rhs.fused_rhs_plan(n, k)
    plans = list(tune_fused_plan.variants(base, k))
    assert base in plans and len(set(plans)) == len(plans)
    for plan in plans:
        assert plan.smem_bytes <= fused_rhs.SMEM_LIMIT
        assert plan.smem_bytes == fused_rhs.plan_smem_bytes(
            plan.rows, plan.nt, plan.wk, plan.bk, k)
        assert (plan.nt, plan.wn, plan.wk) == (base.nt, base.wn, base.wk)


@pytest.mark.parametrize("blocks,block,d", [
    (22, 128, 16), (22, 128, 7), (4, 128, 20), (4, 128, 5), (22, 128, 256),
    (22, 128, 1433), (16, 128, 20), (16, 128, 64), (7, 48, 33), (29, 9, 5),
    (200, 128, 1)])
@pytest.mark.parametrize("replicas", [1, 2, 3, 16, 25, 100, 65535])
def test_k3_replica_groups_keep_the_one_replica_arithmetic(blocks, block, d,
                                                           replicas):
    """K3's batched plan: replica groups only where the one-replica plan has
    all 8 warps split the depth (wn 1), with that plan's slab, chunk depth
    and depth split; the group's X chunks side by side fit the warps' n8
    tiles and the block's shared memory (as make_layout lays them out); the
    groups cover every replica once, evenly, within gridDim.z."""
    bsr_spmm.bsr_batched_plan.cache_clear()
    plan = bsr_spmm.bsr_batched_plan(blocks, block, d, replicas)
    base = bsr_spmm.bsr_spmm_plan(blocks, block, d)
    assert plan.base == base
    assert plan.group * plan.groups >= replicas > plan.group * (
        plan.groups - 1)
    assert plan.groups <= 65535
    if plan.group == 1:
        assert replicas == 1 or base.panel.wn != 1
        assert plan.groups == replicas
        return
    assert base.panel.wn == 1 and base.slab <= 32
    assert plan.rep_cols % 4 == 0 and base.slab <= plan.rep_cols < base.slab + 4
    assert (plan.rows, plan.nt) in ((32, 8), (16, 16))
    assert plan.group * plan.rep_cols <= 8 * plan.nt
    assert plan.smem_bytes == fused_rhs.plan_smem_bytes(
        plan.rows, plan.nt, fused_rhs.WARPS, base.panel.bk,
        plan.group * plan.rep_cols)
    assert plan.smem_bytes <= fused_rhs.SMEM_LIMIT
    # what the one-replica launch sums a value over: its chunk depth and
    # the 8 warps' k8 steps of each chunk
    assert base.panel.wk == fused_rhs.WARPS and base.panel.bk >= 64
    # as many replicas as the warps' tiles hold, fewer only for CTAs
    ctas = blocks * -(-block // plan.rows) * base.slabs * plan.groups
    if plan.group * plan.rep_cols + plan.rep_cols <= 8 * plan.nt \
            and plan.groups > 1:
        assert ctas >= bsr_spmm.SPMM_MIN_CTAS or plan.group == 2


def test_k3_batched_wrapper_takes_the_grouped_entry(monkeypatch):
    """On cora's shape (22 row blocks) at d = 16 and R = 25 the wrapper
    launches the grouped entry with the plan's panel, the one-replica chunk
    depth and the group; at one replica the batched entry, as before."""
    rng = np.random.RandomState(0)
    n = 2708
    mat = sp.random(n, n, density=0.002, random_state=rng, format="csr",
                    dtype=np.float32)
    a = bsr_spmm.from_scipy_bsr(mat)
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(bsr_spmm, "on_cuda", lambda *t: True)
    monkeypatch.setattr(bsr_spmm.build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    before = (bsr_spmm.BATCHED_SPMM_LAUNCHES, bsr_spmm.GROUPED_SPMM_LAUNCHES)
    for r in (25, 1):
        bsr_spmm._launch_spmm(a, torch.zeros(r, n, 16))
    plan = bsr_spmm.bsr_batched_plan(a.n_row_blocks, a.block, 16, 25)
    (grouped, args25), (batched, args1) = calls
    assert grouped == "ndcn_bsr_spmm_grouped_f32"
    assert args25[10:-1] == (plan.base.slab, plan.rows, plan.nt,
                             plan.base.panel.bk, plan.smem_bytes, 25,
                             plan.group)
    assert plan.group == 4 and plan.groups == 7
    assert batched == "ndcn_bsr_spmm_batched_f32" and args1[-2] == 1
    assert (bsr_spmm.BATCHED_SPMM_LAUNCHES, bsr_spmm.GROUPED_SPMM_LAUNCHES) \
        == (before[0] + 2, before[1] + 1)
