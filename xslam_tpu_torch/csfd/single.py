"""First-order CSFD dual numbers over PyTorch tensors.

Port of ``xslam_tpu/csfd/single.py`` (the subset the dense SLAM step uses).
A ``CSFD`` holds two same-shaped tensors ``(v, g)``: the value and its
directional derivative, propagated by the reference's accelerated CSFD rules,
which are exactly forward-mode dual arithmetic.

Formula order is kept operation for operation (division is
``inv = 1/o.v; val = v*inv; g = (g - val*o.g)*inv``): the parity tests hold
this module to the JAX one at a few ulps, and a reordered formula rounds
differently.

A Python number is lifted to a constant dual of Python floats rather than
to a tensor, so lifting never copies from the host to the device; PyTorch
rounds a Python float to float32 when it meets a float32 tensor, as JAX does
with its weakly typed scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CSFD(NamedTuple):
    """Dual number ``v + eps * g``: value and directional derivative."""

    v: torch.Tensor
    g: torch.Tensor

    def __add__(self, o):
        o = lift(o)
        return CSFD(self.v + o.v, self.g + o.g)

    __radd__ = __add__

    def __neg__(self):
        return CSFD(-self.v, -self.g)

    def __sub__(self, o):
        o = lift(o)
        return CSFD(self.v - o.v, self.g - o.g)

    def __rsub__(self, o):
        return lift(o).__sub__(self)

    def __mul__(self, o):
        o = lift(o)
        return CSFD(self.v * o.v, self.g * o.v + self.v * o.g)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = lift(o)
        inv = _reciprocal(o.v)
        val = self.v * inv
        return CSFD(val, (self.g - val * o.g) * inv)

    def __rtruediv__(self, o):
        return lift(o).__truediv__(self)

    # comparisons act on values only (DoubleComplex.cpp:248-276)
    def __lt__(self, o):
        return self.v < _val(o)

    def __le__(self, o):
        return self.v <= _val(o)

    def __gt__(self, o):
        return self.v > _val(o)

    def __ge__(self, o):
        return self.v >= _val(o)


def _val(x):
    return x.v if isinstance(x, CSFD) else x


def _reciprocal(x):
    """``1/x`` rounded to float32, for a tensor or a Python number."""
    if isinstance(x, torch.Tensor):
        return 1.0 / x
    return float(np.float32(1.0) / np.float32(x))


def lift(x) -> CSFD:
    """Promote a real tensor or number to a constant CSFD (zero derivative)."""
    if isinstance(x, CSFD):
        return x
    if isinstance(x, torch.Tensor):
        return CSFD(x, torch.zeros_like(x))
    return CSFD(float(x), 0.0)


def _unary(x: CSFD, f, df) -> CSFD:
    x = lift(x)
    v = f(x.v)
    return CSFD(v, df(x.v, v) * x.g)


def sqrt(x: CSFD) -> CSFD:
    # reference: complex sqrt via |z| scaling (cuda_complex.hpp:581-593)
    v = torch.sqrt(_val(x))
    x = lift(x)
    return CSFD(v, 0.5 * x.g / v)


def sin(x: CSFD) -> CSFD:
    # sin_our (test_CSFD/main.cpp:60-65)
    return _unary(x, torch.sin, lambda v, fv: torch.cos(v))


def cos(x: CSFD) -> CSFD:
    return _unary(x, torch.cos, lambda v, fv: -torch.sin(v))


def where(pred, a, b) -> CSFD:
    a, b = lift(a), lift(b)
    return CSFD(torch.where(pred, a.v, b.v), torch.where(pred, a.g, b.g))


def solve(a: CSFD, b: CSFD) -> CSFD:
    """Dual linear solve: ``x.v = A.v^-1 b.v``; ``x.g = A.v^-1 (b.g - A.g x.v)``.

    ``solve_ex`` skips the singularity check, whose error flag would be read
    on the host: callers guard singular systems themselves (ICP's ``det``
    guard) and the solve stays free of host syncs."""
    xv = torch.linalg.solve_ex(a.v, b.v)[0]
    xg = torch.linalg.solve_ex(a.v, b.g - a.g @ xv)[0]
    return CSFD(xv, xg)
