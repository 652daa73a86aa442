"""Graph propagation operators (host side, numpy / scipy).

The builders the dynamics and classification experiments need, copied from
the jax-free ``ndcn_tpu/graph/operators.py`` (the dense builders and the
scipy-sparse family of the reference's ``propagation.py``); the tests hold
them bit-equal to it.
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


def normalized_plus(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 (A+I) D^-1/2 (degrees from A, self-loops added after)."""
    adj = np.asarray(adj, np.float64)
    return _sym_norm_dense(adj + np.eye(adj.shape[0]), adj.sum(1),
                           adj.sum(0)).astype(np.float32)


# ------------------------------------------------------------ sparse (scipy CSR)


def _degrees(a: sp.spmatrix):
    out_deg = np.asarray(a.sum(1)).ravel().astype(np.float64)
    in_deg = np.asarray(a.sum(0)).ravel().astype(np.float64)
    return out_deg, in_deg


def _sym_norm_sparse(m: sp.spmatrix, out_deg: np.ndarray,
                     in_deg: np.ndarray) -> sp.csr_matrix:
    r = sp.diags(_inv_pow(out_deg, -0.5))
    c = sp.diags(_inv_pow(in_deg, -0.5))
    return (r @ m @ c).tocsr()


def number_of_self_loops(adj: sp.spmatrix) -> float:
    return float(sp.csr_matrix(adj).diagonal().sum())


def row_normalization(m: sp.spmatrix) -> sp.csr_matrix:
    """D^-1 M (also the features' row normalization)."""
    m = sp.csr_matrix(m, dtype=np.float64)
    deg = np.asarray(m.sum(1)).ravel()
    return (sp.diags(_inv_pow(deg, -1.0)) @ m).tocsr()


random_walk = row_normalization


def normalized_laplacian_sparse(adj: sp.spmatrix) -> sp.csr_matrix:
    """I - D^-1/2 A D^-1/2 in scipy CSR, for graphs too large to densify."""
    adj = sp.csr_matrix(adj, dtype=np.float64)
    out_deg, in_deg = _degrees(adj)
    return (sp.eye(adj.shape[0])
            - _sym_norm_sparse(adj, out_deg, in_deg)).tocsr()


def laplacian(adj: sp.spmatrix) -> sp.csr_matrix:
    """A - D (the reference's sign convention)."""
    adj = sp.csr_matrix(adj, dtype=np.float64)
    deg = np.asarray(adj.sum(1)).ravel()
    return (adj - sp.diags(deg)).tocsr()


def zipf_smoothing_sparse(adj: sp.spmatrix) -> sp.csr_matrix:
    """(D+I)^-1/2 (A+I) (D+I)^-1/2; rejects graphs that already have
    self-loops."""
    adj = sp.csr_matrix(adj, dtype=np.float64)
    if number_of_self_loops(adj) != 0:
        raise ValueError("adjacency matrix must not contain self-loops")
    a_prime = (adj + sp.eye(adj.shape[0])).tocsr()
    return _sym_norm_sparse(a_prime, *_degrees(a_prime))


def zipf_smoothing_alpha(adj: sp.spmatrix, alpha: float = 0.5) -> sp.csr_matrix:
    """(aI+(1-a)D)^-1/2 (aI+(1-a)A) (aI+(1-a)D)^-1/2, the classification
    operator. alpha=0 degenerates to D^-1/2 A D^-1/2."""
    adj = sp.csr_matrix(adj, dtype=np.float64)
    a_prime = (alpha * sp.eye(adj.shape[0]) + (1.0 - alpha) * adj).tocsr()
    return _sym_norm_sparse(a_prime, *_degrees(a_prime))


def zipf_smoothing_prime(adj: sp.spmatrix) -> sp.csr_matrix:
    """(D+I)^-1/2 (A+I) (D+I)^-1/2 - I."""
    adj = sp.csr_matrix(adj, dtype=np.float64)
    a_prime = (adj + sp.eye(adj.shape[0])).tocsr()
    return (_sym_norm_sparse(a_prime, *_degrees(a_prime))
            - sp.eye(adj.shape[0])).tocsr()


def first_order_gcn(adj: sp.spmatrix) -> sp.csr_matrix:
    """I + D^-1/2 A D^-1/2."""
    adj = sp.csr_matrix(adj, dtype=np.float64)
    return (sp.eye(adj.shape[0]) + _sym_norm_sparse(adj, *_degrees(adj))).tocsr()


def residual_smoothing(adj: sp.spmatrix, delta: float) -> sp.csr_matrix:
    """(D'+I)^-1/2 (delta*A + I) (D'+I)^-1/2 with D' degrees of delta*A + I."""
    adj = sp.csr_matrix(adj, dtype=np.float64)
    if number_of_self_loops(adj) != 0:
        raise ValueError("adjacency matrix must not contain self-loops")
    a_prime = (delta * adj + sp.eye(adj.shape[0])).tocsr()
    return _sym_norm_sparse(a_prime, *_degrees(a_prime))


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
