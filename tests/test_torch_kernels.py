"""K1 (CSR SpMV) and K2 (fused RHS): the port's kernel modules against the
JAX package, and the CUDA kernels against their plain versions.

On the CPU the wrappers take the plain PyTorch versions, held here against
the JAX package's f32 segment-sum (≤1e-6·max|y|, the same f32 sums in another
order), its Pallas sliced-tile kernel in interpret mode (1e-4: that kernel's
bf16-split numerics), and its fused Pallas RHS in interpret mode (1e-4, as the
JAX package's own test). The CUDA kernels themselves are tested in
``test_torch_cuda.py``, which needs no jax and runs on the GPU machine.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from ndcn_tpu.graph.sparse import _coo_apply
from ndcn_tpu.graph.sparse import from_scipy_coo as j_from_scipy_coo
from ndcn_tpu.kernels.coo_spmv import tiled_spmv
from ndcn_tpu.kernels.fused_rhs import fused_graph_rhs
from ndcn_tpu_torch.graph.sparse import from_scipy_coo
from ndcn_tpu_torch.kernels import build, coo_spmv, fused_rhs, platform


def _power_law_coo(n, m, seed, d=20):
    """Row-sorted COO with hub rows and empty rows, as the JAX package's
    kernel test builds it."""
    rng = np.random.RandomState(seed)
    rows = rng.zipf(1.5, m) % n
    cols = rng.randint(0, n, m)
    vals = rng.randn(m).astype(np.float32)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    x = rng.randn(n, d).astype(np.float32)
    return a, x


def _fused_inputs(n, k, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, n).astype(np.float32), rng.rand(n, k).astype(np.float32),
            rng.randn(k, k).astype(np.float32), rng.randn(k).astype(np.float32))


@pytest.mark.parametrize("d", [1, 3, 20])
def test_k1_plain_matches_jax_segment_sum(d):
    a, x = _power_law_coo(500, 6000, seed=1, d=d)
    j_op = j_from_scipy_coo(a, tiled=False)
    ref = np.asarray(_coo_apply(j_op.rows, j_op.cols, j_op.vals, j_op.n,
                                jnp.asarray(x)))
    before = coo_spmv.LAUNCHES
    got = coo_spmv.coo_spmv(from_scipy_coo(a), torch.as_tensor(x)).numpy()
    assert coo_spmv.LAUNCHES == before  # CPU tensors never launch the kernel
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_k1_plain_matches_jax_tiled_kernel_interpret():
    a, x = _power_law_coo(300, 3000, seed=0)
    j_op = j_from_scipy_coo(a, tiled=True)
    ref = np.asarray(tiled_spmv(j_op.tiles, j_op.tiles_t, jnp.asarray(x)))
    got = coo_spmv.coo_spmv(from_scipy_coo(a), torch.as_tensor(x)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("n,k,seed", [(400, 20, 0), (275, 13, 1)])
def test_k2_plain_matches_jax_fused_kernel_interpret(n, k, seed):
    # the inputs of the JAX package's own K2 tests, whose tolerance this is
    a, h, w, b = _fused_inputs(n, k, seed)
    ref = np.asarray(fused_graph_rhs(jnp.asarray(a), jnp.asarray(h),
                                     jnp.asarray(w), jnp.asarray(b)))
    before = fused_rhs.LAUNCHES
    got = fused_rhs.fused_rhs(*map(torch.as_tensor, (a, h, w, b))).numpy()
    assert fused_rhs.LAUNCHES == before
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_k2_takes_a_strided_w():
    a, h, w, b = map(torch.as_tensor, _fused_inputs(50, 7, seed=0))
    w_view = w.t().contiguous().t()  # same values, column-major strides
    assert not w_view.is_contiguous()
    assert torch.equal(fused_rhs.fused_rhs(a, h, w_view, b),
                       fused_rhs.fused_rhs(a, h, w, b))


def test_k1_wrapper_rejects_what_the_kernel_does_not_take():
    a, x = _power_law_coo(100, 500, seed=2, d=4)
    op = from_scipy_coo(a)
    x = torch.as_tensor(x)
    with pytest.raises(TypeError, match="float32"):
        coo_spmv.coo_spmv(op, x.double())
    with pytest.raises(ValueError, match="shape"):
        coo_spmv.coo_spmv(op, x[:50])
    with pytest.raises(ValueError, match="shape"):
        coo_spmv.coo_spmv(op, x[:, 0])
    with pytest.raises(ValueError, match="contiguous"):
        coo_spmv.coo_spmv(op, torch.as_tensor(np.asfortranarray(x.numpy())))
    with pytest.raises(ValueError, match="int32"):
        coo_spmv.coo_spmv(op._replace(cols=op.cols.long()), x)
    # the kernel would read host pointers: indices and x must share a device
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        coo_spmv.coo_spmv(op._replace(row_ptr=op.row_ptr.to("meta")), x)


def test_k2_wrapper_rejects_what_the_kernel_does_not_take():
    a, h, w, b = map(torch.as_tensor, _fused_inputs(30, 5, seed=1))
    with pytest.raises(TypeError, match="float32"):
        fused_rhs.fused_rhs(a.double(), h, w, b)
    with pytest.raises(ValueError, match="shape|takes a"):
        fused_rhs.fused_rhs(a[:20], h, w, b)
    with pytest.raises(ValueError, match="takes a"):
        fused_rhs.fused_rhs(a, h, w[:4], b)
    with pytest.raises(ValueError, match="contiguous"):
        fused_rhs.fused_rhs(a.t(), h, w, b)
    wide = torch.zeros(4, fused_rhs.K_MAX + 1)
    with pytest.raises(ValueError, match="k <="):
        fused_rhs.fused_rhs(torch.zeros(4, 4), wide,
                            torch.zeros(fused_rhs.K_MAX + 1, fused_rhs.K_MAX + 1),
                            torch.zeros(fused_rhs.K_MAX + 1))


def test_platform_seam_picks_by_device_and_pins_fp32():
    cpu = torch.zeros(3)
    assert platform.on_cuda(cpu, cpu) is False
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        platform.on_cuda(cpu, torch.zeros(3, device="meta"))
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        platform.pin_fp32()
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
    report = platform.device_report()
    assert set(report) >= {"cuda", "capability", "sm90", "kernels_built"}
    if not report["cuda"]:
        assert report["count"] == 0 and report["sm90"] is False


def test_build_names_the_library_by_source_hash(monkeypatch, tmp_path):
    path = build.library_path()
    assert path == build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert [p.name for p in build.sources()] == [
        "bsr_spmm.cu", "coo_mutual.cu", "coo_spmv.cu", "coo_spmv_T.cu",
        "fused_rhs.cu", "sparse_bench.cu"]
    for src in build.sources():
        text = src.read_text()
        assert "extern \"C\"" in text and "cudaGetLastError" in text
    # every C entry the wrappers call is declared with its argument types
    assert set(build.ENTRY_POINTS) == {
        "ndcn_coo_spmv_f32", "ndcn_coo_spmv_bf16", "ndcn_coo_mutual_f32",
        "ndcn_coo_spmv_T_f32",
        "ndcn_coo_spmv_T_bf16", "ndcn_pack_rows_f32", "ndcn_pack_rows_bf16",
        "ndcn_coo_spmv_T_wide_f32",
        "ndcn_coo_spmv_T_wide_bf16", "ndcn_sliced_tile_reduce_f32",
        "ndcn_row_gather_f32", "ndcn_fused_rhs_f32", "ndcn_bsr_spmm_f32",
        "ndcn_bsr_fused_rhs_f32"}
    entries = "".join(src.read_text() for src in build.sources())
    assert all(f"int {name}(" in entries for name in build.ENTRY_POINTS)
    # without nvcc the build says so, instead of falling back
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
