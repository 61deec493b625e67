"""The CONTRA* engines' float log-space approximations
(contrafold/LogSpace.hpp = contralign/LogSpace.hpp), for the check's
pair-CRF: a frozen copy of the CONTRA half of the port's
`dafs_tpu_torch/ops/logspace.py` (`logspace.py` here holds its ProbCons
half).

Every multiply and add is a separate float32 operation, as in the port:
nothing may contract them into a fused multiply-add.
"""

from __future__ import annotations

import torch

from portbench.reference.logspace import _f32, _poly3

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
