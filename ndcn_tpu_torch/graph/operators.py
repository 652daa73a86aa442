"""Graph propagation operators (host side, numpy / scipy).

The builders the dynamics experiments need, copied from the jax-free
``ndcn_tpu/graph/operators.py``; the tests hold them bit-equal to it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _inv_pow(x: np.ndarray, p: float) -> np.ndarray:
    """x**p with zeros kept at zero (no inf)."""
    out = np.zeros_like(x, dtype=np.float64)
    nz = x != 0
    out[nz] = np.power(x[nz], p)
    return out


def _sym_norm_dense(m: np.ndarray, row_scale_src: np.ndarray,
                    col_scale_src: np.ndarray) -> np.ndarray:
    """diag(r^-1/2) @ m @ diag(c^-1/2) with zero-degree guards."""
    r = _inv_pow(row_scale_src, -0.5)
    c = _inv_pow(col_scale_src, -0.5)
    return (r[:, None] * m) * c[None, :]


def zipf_smoothing(adj: np.ndarray) -> np.ndarray:
    """(D+I)^-1/2 (A+I) (D+I)^-1/2, the Kipf GCN operator."""
    adj = np.asarray(adj, np.float64)
    a_prime = adj + np.eye(adj.shape[0])
    return _sym_norm_dense(a_prime, a_prime.sum(1),
                           a_prime.sum(0)).astype(np.float32)


def normalized_adj(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 A D^-1/2."""
    adj = np.asarray(adj, np.float64)
    return _sym_norm_dense(adj, adj.sum(1), adj.sum(0)).astype(np.float32)


def normalized_laplacian(adj: np.ndarray) -> np.ndarray:
    """I - D^-1/2 A D^-1/2, the default dynamics operator."""
    adj = np.asarray(adj, np.float64)
    return (np.eye(adj.shape[0])
            - _sym_norm_dense(adj, adj.sum(1), adj.sum(0))).astype(np.float32)


def laplacian_dense(adj: np.ndarray) -> np.ndarray:
    """Combinatorial Laplacian D - A."""
    adj = np.asarray(adj, np.float64)
    return (np.diag(adj.sum(1)) - adj).astype(np.float32)


def normalized_laplacian_sparse(adj: sp.spmatrix) -> sp.csr_matrix:
    """I - D^-1/2 A D^-1/2 in scipy CSR, for graphs too large to densify."""
    adj = sp.csr_matrix(adj, dtype=np.float64)
    out_deg = np.asarray(adj.sum(1)).ravel().astype(np.float64)
    in_deg = np.asarray(adj.sum(0)).ravel().astype(np.float64)
    norm = (sp.diags(_inv_pow(out_deg, -0.5)) @ adj
            @ sp.diags(_inv_pow(in_deg, -0.5))).tocsr()
    return (sp.eye(adj.shape[0]) - norm).tocsr()


def build_dynamics_operator(adj: np.ndarray, kind: str) -> np.ndarray:
    """The --operator switch of the dynamics experiments:
    lap | kipf | norm_adj | norm_lap (default)."""
    if kind == "lap":
        return laplacian_dense(adj)
    if kind == "kipf":
        return zipf_smoothing(adj)
    if kind == "norm_adj":
        return normalized_adj(adj)
    if kind == "norm_lap":
        return normalized_laplacian(adj)
    raise ValueError(f"unknown operator kind {kind!r}")
