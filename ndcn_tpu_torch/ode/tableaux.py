"""Butcher tableaux as plain-python constants.

A copy of ``ndcn_tpu/ode/tableaux.py`` (it is only data): Dormand-Prince-
Shampine and Tsitouras 5(4), with the same coefficients as the reference
solvers so that trajectories agree at matched tolerances.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple


class Tableau(NamedTuple):
    alpha: Tuple[float, ...]           # stage times (fractions of dt), len S-1
    beta: Tuple[Tuple[float, ...], ...]  # lower-triangular stage weights
    c_sol: Tuple[float, ...]           # solution weights, len S
    c_error: Tuple[float, ...]         # embedded error weights, len S
    c_mid: Optional[Tuple[float, ...]]  # midpoint weights for quartic dense output
    order: int                         # order used by the step controller
    fsal: bool                         # last stage == solution (saves one combine)


DOPRI5 = Tableau(
    alpha=(1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    beta=(
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    c_sol=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    c_error=(
        35 / 384 - 1951 / 21600,
        0.0,
        500 / 1113 - 22642 / 50085,
        125 / 192 - 451 / 720,
        -2187 / 6784 - -12231 / 42400,
        11 / 84 - 649 / 6300,
        -1.0 / 60.0,
    ),
    # Midpoint coefficients for 4th-order dense output.
    c_mid=(
        6025192743 / 30085553152 / 2,
        0.0,
        51252292925 / 65400821598 / 2,
        -2691868925 / 45128329728 / 2,
        187940372067 / 1594534317056 / 2,
        -1776094331 / 19743644256 / 2,
        11237099 / 235043384 / 2,
    ),
    order=5,
    fsal=True,
)

TSIT5 = Tableau(
    alpha=(0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0),
    beta=(
        (0.161,),
        (-0.008480655492357, 0.3354806554923570),
        (2.897153057105494, -6.359448489975075, 4.362295432869581),
        (5.32586482843925895, -11.74888356406283, 7.495539342889836, -0.09249506636175525),
        (5.86145544294642038, -12.92096931784711, 8.159367898576159, -0.071584973281401006, -0.02826905039406838),
        (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742, -3.290069515436081, 2.324710524099774),
    ),
    c_sol=(0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
           -3.290069515436081, 2.324710524099774, 0.0),
    # Tsitouras (2011)'s embedded-difference weights (sum = 0); the
    # reference's double-subtracted weights are TSIT5_REFERENCE_WEIGHTS below.
    c_error=(
        0.001780011052226,
        0.000816434459657,
        -0.007880878010262,
        0.144711007173263,
        -0.582357165452555,
        0.458082105929187,
        -1 / 66,
    ),
    c_mid=None,  # tsit5 has its own rational dense-output polynomial
    order=5,
    fsal=True,
)


# The reference's tsit5 error weights (they subtract the embedded differences
# from b a second time and sum to 32/33); only for bit-parity experiments.
TSIT5_REFERENCE_WEIGHTS = TSIT5._replace(
    c_error=tuple(s - e for s, e in zip(TSIT5.c_sol[:6], TSIT5.c_error[:6]))
    + (-1 / 66,),
)


def _check(tab: Tableau) -> None:
    s = len(tab.c_sol)
    if len(tab.alpha) != s - 1 or len(tab.beta) != s - 1 \
            or len(tab.c_error) != s:
        raise ValueError("malformed tableau: stage counts disagree")
    for i, row in enumerate(tab.beta):
        if len(row) != i + 1:
            raise ValueError(f"malformed tableau: beta row {i} has "
                             f"{len(row)} entries")


_check(DOPRI5)
_check(TSIT5)
_check(TSIT5_REFERENCE_WEIGHTS)
