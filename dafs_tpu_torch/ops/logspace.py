"""Log-space arithmetic matching the reference's fast approximations.

ProbCons (probconsRNA/ScoreType.h:18-19,37-57,187-262) and the CONTRA*
engines (contrafold/LogSpace.hpp) do log-sum-exp with piecewise polynomial
approximations rather than exact logaddexp, and their downstream decisions
(thresholds at 0.01, argmax decodes) are taken on those approximate values,
so the same polynomials are evaluated here in float32.

Every multiply and add is a separate float32 operation: the guide-tree digits
depend on the rounding, so nothing may contract them into a fused
multiply-add.  The CUDA kernels that evaluate the same polynomials are built
with `-fmad=false` for the same reason.

Port of both halves of `dafs_tpu/ops/logspace.py`: the ProbCons functions
(pair-HMM) and the CONTRA* ones (CONTRAlign pair-CRF).
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(x) -> float:
    """A Python float holding exactly the float32 nearest to `x`."""
    return float(np.float32(x))


LOG_ZERO = _f32(-2e20)
LOG_ONE = 0.0
LOG_UNDERFLOW = _f32(7.5)

# (a, b, c, d) of the 4-piece cubic LOOKUP (ScoreType.h:187-198) and the
# upper bound of each piece
LOOKUP_PIECES = [
    ((-0.009350833524763, 0.130659527668286, 0.498799810682272, 0.693203116424741), 1.0),
    ((-0.014532321752540, 0.139942324101744, 0.495635523139337, 0.692140569840976), 2.5),
    ((-0.004605031767994, 0.063427417320019, 0.695956496475118, 0.514272634594009), 4.5),
    ((-0.000458661602210, 0.009695946122598, 0.930734667215156, 0.168037164329057), None),
]

# (a, b, c, d, e) of the piecewise quartic EXP (ScoreType.h:37-57) and the
# lower bound of each piece
EXP_PIECES = [
    ((0.03254409303190190000, 0.16280432765779600000, 0.49929760485974900000, 0.99995149601363700000, 0.99999925508501600000), -0.5),
    ((0.01973899026052090000, 0.13822379685007000000, 0.48056651562365000000, 0.99326940370383500000, 0.99906756856399500000), -1.0),
    ((0.00940528203591384000, 0.09414963667859410000, 0.40825793595877300000, 0.93933625499130400000, 0.98369508190545300000), -2.0),
    ((0.00217245711583303000, 0.03484829428350620000, 0.22118199801337800000, 0.67049462206469500000, 0.83556950223398500000), -4.0),
    ((0.00012398771025456900, 0.00349155785951272000, 0.03727721426017900000, 0.17974997741536900000, 0.33249299994217400000), -8.0),
    ((0.00000051741713416603, 0.00002721456879608080, 0.00053418601865636800, 0.00464101989351936000, 0.01507447981459420000), -16.0),
]


def _poly3(x, a, b, c, d):
    return ((_f32(a) * x + _f32(b)) * x + _f32(c)) * x + _f32(d)


def _poly4(x, a, b, c, d, e):
    return (((_f32(a) * x + _f32(b)) * x + _f32(c)) * x + _f32(d)) * x + _f32(e)


def lookup(x: torch.Tensor) -> torch.Tensor:
    """log(exp(x)+1) for 0 <= x <= 7.5 (ScoreType.h:187-198), 4-piece cubic."""
    (p1, t1), (p2, t2), (p3, t3), (p4, _) = LOOKUP_PIECES
    return torch.where(
        x <= t1, _poly3(x, *p1),
        torch.where(x <= t2, _poly3(x, *p2),
                    torch.where(x <= t3, _poly3(x, *p3), _poly3(x, *p4))),
    )


def log_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ProbCons LOG_ADD (ScoreType.h:259-262): approximate logaddexp.

    if x < y: (x == LOG_ZERO or y-x >= 7.5) ? y : LOOKUP(y-x)+x
    else:     (y == LOG_ZERO or x-y >= 7.5) ? x : LOOKUP(x-y)+y
    """
    hi = torch.maximum(x, y)
    lo = torch.minimum(x, y)
    d = hi - lo
    use_hi = (lo == LOG_ZERO) | (d >= LOG_UNDERFLOW)
    # clamp the argument so lookup() stays in-domain even where unused
    approx = lookup(torch.clamp(d, max=LOG_UNDERFLOW)) + lo
    return torch.where(use_hi, hi, approx)


def probcons_exp(x: torch.Tensor) -> torch.Tensor:
    """ProbCons EXP approximation (ScoreType.h:37-57), piecewise quartic.

    For x > 0 the reference falls through to libm exp(); the posterior
    computation clamps at 0 first, so only the polynomial branches are
    exercised there.
    """
    out = torch.zeros_like(x)
    # innermost (most negative) piece first, so each wider piece overrides
    for coeffs, lower in reversed(EXP_PIECES):
        out = torch.where(x > lower, _poly4(x, *coeffs), out)
    return torch.where(x > 0, torch.exp(x), out)


# ---------------------------------------------------------------------------
# CONTRA* engines (contrafold/LogSpace.hpp = contralign/LogSpace.hpp)
# ---------------------------------------------------------------------------

NEG_INF = _f32(-2e20)
CONTRA_LEPO_MAX = _f32(11.8624794162)

# (a, b, c, d) of the 8-piece cubic Fast_LogExpPlusOne and the upper bound of
# each piece (the last piece is open above)
LEPO_PIECES = [
    ((-0.0065591595, 0.1276442762, 0.4996554598, 0.6931542306), 0.6615367791),
    ((-0.0155157557, 0.1446775699, 0.4882939746, 0.6958092989), 1.6320158198),
    ((-0.0128909247, 0.1301028251, 0.5150398748, 0.6795585882), 2.4912588184),
    ((-0.0072142647, 0.0877540853, 0.6208708362, 0.5909675829), 3.3792499610),
    ((-0.0031455354, 0.0467229449, 0.7592532310, 0.4348794399), 4.4261691294),
    ((-0.0010110698, 0.0185943421, 0.8831730747, 0.2523695427), 5.7890710412),
    ((-0.0001962780, 0.0046084408, 0.9634431978, 0.0983148903), 7.8162726752),
    ((-0.0000113994, 0.0003734731, 0.9959107193, 0.0149855051), None),
]

# (a, b, c, d) of the 6-piece cubic Fast_Exp and the lower bound of each
# piece, from the most negative upward; the last piece ends at 0
FEXP_PIECES = [
    ((0.0000803850, 0.0021627428, 0.0194708555, 0.0588080014), -9.91152),
    ((0.0013889414, 0.0244676474, 0.1471290604, 0.3042757740), -5.8622823336),
    ((0.0072335607, 0.0906002677, 0.3983111356, 0.6245959221), -3.8396630909),
    ((0.0232410351, 0.2085645908, 0.6906367911, 0.8682322329), -2.4915033807),
    ((0.0573782771, 0.3580258429, 0.9121133217, 0.9793091728), -1.4805375919),
    ((0.1199175927, 0.4815668234, 0.9975991939, 0.9999505077), -0.6725053211),
]


def contra_fast_logexpplusone(x: torch.Tensor) -> torch.Tensor:
    """float Fast_LogExpPlusOne: log(exp(x)+1) for 0 <= x <= 11.8624794162,
    8-piece cubic; the first piece whose upper bound exceeds x wins."""
    out = _poly3(x, *LEPO_PIECES[-1][0])
    for coeffs, upper in reversed(LEPO_PIECES[:-1]):
        out = torch.where(x < _f32(upper), _poly3(x, *coeffs), out)
    return out


def contra_fast_logplus(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float Fast_LogAdd / Fast_LogPlusEquals: with hi >= lo, hi if
    lo <= NEG_INF/2 or hi - lo >= 11.8624794162, else
    Fast_LogExpPlusOne(hi - lo) + lo."""
    hi = torch.maximum(x, y)
    lo = torch.minimum(x, y)
    d = hi - lo
    use_hi = (lo <= _f32(-1e20)) | (d >= CONTRA_LEPO_MAX)
    approx = contra_fast_logexpplusone(torch.clamp(d, max=CONTRA_LEPO_MAX)) + lo
    return torch.where(use_hi, hi, approx)


def contra_fast_exp(x: torch.Tensor) -> torch.Tensor:
    """float Fast_Exp: 6-piece cubic, 0 below -9.91152, libm exp above 0
    (1e20 past 46.052).  Above 0 `torch.exp` and XLA's `exp` may differ in
    the last bit."""
    out = torch.where(x > _f32(46.052), torch.full_like(x, _f32(1e20)), torch.exp(x))
    uppers = [lower for _, lower in FEXP_PIECES[1:]] + [0.0]
    for (coeffs, _), upper in reversed(list(zip(FEXP_PIECES, uppers))):
        out = torch.where(x < _f32(upper), _poly3(x, *coeffs), out)
    return torch.where(x < _f32(-9.91152), torch.zeros_like(x), out)
