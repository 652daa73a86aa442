"""The work a function needs, counted from shapes, and the card's peaks:
the yardstick of every roofline share the benchmark reports.

A function's least time is the larger of its bytes over the card's memory
bandwidth and its operations over its fastest float32-input product rate
(dense TF32). Each input byte is read once and each output byte written
once, whatever an implementation reads again; the operations are the
function's own (a zero coefficient of the tableau adds none). Values are
float32 (4 bytes); an operand is counted at the shape the solve holds it
in (the feature-major layout's (d_sub, n) state, its zero rows included).

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates at the 700 W
power limit (the run prints the card's limit beside them).

The step's least time (``step``) is the sum of the least times of the
functions one train step needs, with the live NFE and attempts of its
solve (never the step budget):

- each RHS evaluation: the operator product and the control layer, one
  function relu((A h) Wᵀ + b) of A, h, W and b; its VJP in the backward
  (reads the cotangent, h, the output and A, W; writes h's cotangent and
  W's and b's);
- each attempt: dopri5's six stage combinations y_i = y + dt Σ β_ij k_j and
  the error estimate with its ratio (reads its k's, y0 and y1); each
  accepted attempt also the midpoint source y_mid = y + dt Σ c_j k_j and the
  dense-output readout: the five sources through the decoder, then each
  observation from the five decoded sources;
- the encoder (x0 to h0), the L1 loss and, in the backward, the VJP of
  each linear piece above, counted as its forward (a linear map's VJP is
  its transpose: the same bytes and operations);
- Adam's update: reads p, g and both moments, writes p and both moments.

Recomputation (``solve_scan``'s checkpointed attempts) and masked attempts
are an implementation's choices and count nothing.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 tensor cores
F32 = 4

# dopri5's nonzero coefficients: per stage combination, the error
# estimate and the midpoint source (benchmark/reference/dopri5.py)
STAGE_TERMS = (1, 2, 3, 4, 5, 5)
ERROR_TERMS = 6
MID_TERMS = 6
SOURCES = 5


class Work(NamedTuple):
    bytes: float
    flops: float

    def least_s(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S,
                   self.flops / TF32_FLOPS_PER_S)


def total_least_s(works: Iterable[Work]) -> float:
    return sum(w.least_s() for w in works)


def spmv(n: int, nnz: int, d: int) -> Work:
    """A·X over CSR (row pointer, int32 columns, float32 values), X (n, d)."""
    return Work(((n + 1) + 2 * nnz + 2 * n * d) * F32, 2.0 * nnz * d)


def dense_product(n: int, d: int) -> Work:
    """A·X for a dense (n, n) A."""
    return Work((n * n + 2 * n * d) * F32, 2.0 * n * n * d)


def k2(n: int, d: int) -> Work:
    """K2, relu((A h) W + b) with a dense A: A, h, W, b in, (n, d) out."""
    return Work((n * n + 2 * n * d + d * d + d) * F32,
                2.0 * n * n * d + 2.0 * n * d * d)


def k1fm(n: int, nnz: int, d_sub: int) -> Work:
    """K1-fm (pack and gather, one function): (A·X)ᵀ of a (d_sub, n)
    state over A's CSR, forward or over Aᵀ alike."""
    return spmv(n, nnz, d_sub)


def operator_product(w: dict) -> Work:
    if w["operator"] == "dense":
        return dense_product(w["n"], w["state_width"])
    return spmv(w["n"], w["nnz"], w["state_width"])


def rhs(w: dict) -> Work:
    """relu((A h) Wᵀ + b), one function of A, h, W and b."""
    n, d = w["n"], w["state_width"]
    op = operator_product(w)
    # A·X stays inside the function: h in, the activation out, W and b
    return Work(op.bytes + (d * d + d) * F32, op.flops + 2.0 * n * d * d)


def rhs_vjp(w: dict) -> Work:
    n, d = w["n"], w["state_width"]
    op = operator_product(w)
    bytes_ = op.bytes + (2 * n * d + 2 * d * d + d) * F32
    return Work(bytes_, op.flops + 4.0 * n * d * d)


def combination(w: dict, terms: int, outputs: int = 1) -> Work:
    """y + dt Σ c_j k_j over ``terms`` stages."""
    s = w["n"] * w["state_width"]
    return Work((terms + 1 + outputs) * s * F32, 2.0 * terms * s)


def attempt(w: dict) -> list:
    """The stage combinations and the error estimate of one attempt."""
    s = w["n"] * w["state_width"]
    out = [combination(w, t) for t in STAGE_TERMS]
    out.append(Work((ERROR_TERMS + 2) * s * F32,
                    2.0 * ERROR_TERMS * s + 6.0 * s))
    return out


def accepted(w: dict) -> list:
    """The midpoint source and the decoding of the five sources."""
    n, d, c = w["n"], w["state_width"], w["output_size"]
    return [combination(w, MID_TERMS),
            Work(SOURCES * (n * d + n * c) * F32, 2.0 * SOURCES * n * d * c)]


def observation(w: dict) -> Work:
    n, c = w["n"], w["output_size"]
    return Work((SOURCES + 1) * n * c * F32, 2.0 * SOURCES * n * c)


def encoder(w: dict) -> Work:
    n, d, i = w["n"], w["state_width"], w["input_size"]
    return Work((n * i + n * d) * F32, 2.0 * n * i * d + 2.0 * n * d * d)


def loss(w: dict) -> Work:
    o, n, c = w["observations"], w["n"], w["output_size"]
    return Work(2 * o * n * c * F32, 3.0 * o * n * c)


def adam(params: int) -> Work:
    return Work(7 * params * F32, 12.0 * params)


def step(w: dict, nfe: float, attempts: float, accepted_: float) -> float:
    """The least time in seconds of one train step (module docstring)."""
    return (
        nfe * (rhs(w).least_s() + rhs_vjp(w).least_s())
        + 2 * attempts * total_least_s(attempt(w))
        + 2 * accepted_ * total_least_s(accepted(w))
        + 2 * (w["observations"] - 1) * observation(w).least_s()
        + 2 * (encoder(w).least_s() + loss(w).least_s())
        + adam(w["params"]).least_s())
