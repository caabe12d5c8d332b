"""Second-order CSFD (DCSFD) as hyper-dual numbers over PyTorch tensors.

Port of ``xslam_tpu/csfd/double.py``. The reference's ``d_complex`` /
``DoubleComplex`` is a complex-of-complex number
(``cuda_double_complex.hpp:16-134``, ``DoubleComplex.cpp``); its h->0 limit
is hyper-dual arithmetic over four lanes ``(v, e1, e2, e12)``: the value, the
derivative seeded through the outer lane, the one seeded through the inner
lane, and the second derivative. The standard seed matches the reference:
``e1 = e2 = direction``, ``e12 = 0``.

Every formula keeps the JAX module's operation order, operation for
operation: kernel B12 (``csrc/tsdf_loss.cu``) repeats this module's
arithmetic and is held to its bits on the card. A Python number lifts to a
constant of Python floats, as in :mod:`.single`; its zero lanes still enter
every product, as the JAX module's zero arrays do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import single as cs
from .single import _reciprocal


class DCSFD(NamedTuple):
    """Hyper-dual number ``v + e1·d1 + e2·d2 + e12·d12``."""

    v: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    e12: torch.Tensor

    # accessors mirroring d_complex (cuda_double_complex.hpp:47-55)
    def value(self):
        return self.v

    def grad(self):
        return self.e1

    def hessian(self):
        return self.e12

    @property
    def dtype(self):
        return self.v.dtype

    def __add__(self, o):
        o = lift(o, like=self)
        return DCSFD(self.v + o.v, self.e1 + o.e1, self.e2 + o.e2, self.e12 + o.e12)

    __radd__ = __add__

    def __neg__(self):
        return DCSFD(-self.v, -self.e1, -self.e2, -self.e12)

    def __sub__(self, o):
        o = lift(o, like=self)
        return DCSFD(self.v - o.v, self.e1 - o.e1, self.e2 - o.e2, self.e12 - o.e12)

    def __rsub__(self, o):
        return lift(o, like=self).__sub__(self)

    def __mul__(self, o):
        # h->0 limit of d_complex::operator*= (cuda_double_complex.hpp:119-125)
        o = lift(o, like=self)
        return DCSFD(
            self.v * o.v,
            self.e1 * o.v + self.v * o.e1,
            self.e2 * o.v + self.v * o.e2,
            self.e12 * o.v + self.e1 * o.e2 + self.e2 * o.e1 + self.v * o.e12,
        )

    __rmul__ = __mul__

    def __truediv__(self, o):
        # h->0 limit of d_complex::operator/= (cuda_double_complex.hpp:126-133)
        o = lift(o, like=self)
        q = _reciprocal(o.v)
        v = self.v * q
        e1 = (self.e1 - v * o.e1) * q
        e2 = (self.e2 - v * o.e2) * q
        e12 = (self.e12 - e1 * o.e2 - e2 * o.e1 - v * o.e12) * q
        return DCSFD(v, e1, e2, e12)

    def __rtruediv__(self, o):
        return lift(o, like=self).__truediv__(self)

    # comparisons on value lane (DoubleComplex.cpp:248-276)
    def __lt__(self, o):
        return self.v < _val(o)

    def __le__(self, o):
        return self.v <= _val(o)

    def __gt__(self, o):
        return self.v > _val(o)

    def __ge__(self, o):
        return self.v >= _val(o)


def _val(x):
    return x.v if isinstance(x, DCSFD) else x


def lift(x, like: DCSFD | None = None) -> DCSFD:
    """A constant DCSFD (zero derivative lanes) of a tensor, a numpy array (a
    float32 tensor on ``like``'s device) or a number (Python floats)."""
    if isinstance(x, DCSFD):
        return x
    c = cs.lift(x, like=None if like is None else cs.CSFD(like.v, like.e1))
    return DCSFD(c.v, c.g, c.g, c.g)


def seed(x, direction=1.0) -> DCSFD:
    """Standard DCSFD perturbation ``re=(x,h), im=(h,0)`` with unit h
    (DoubleComplex::addPerturbation, DoubleComplex.cpp:61-66; the test seed
    ``DoubleComplex(x, h, h, 0)``, test_CSFD/main.cpp:195,208)."""
    xv = torch.as_tensor(x, dtype=torch.float32)
    d = torch.broadcast_to(torch.as_tensor(direction, dtype=torch.float32, device=xv.device), xv.shape).clone()
    return DCSFD(xv, d, d.clone(), torch.zeros_like(xv))


def seed_cross(x, d1, d2) -> DCSFD:
    """Mixed-partial seed ``DoubleComplex(x, h*d1, h*d2, 0)`` of the
    reference's cross-term evaluation (test_CSFD/main.cpp:212)."""
    xv = torch.as_tensor(x, dtype=torch.float32)

    def b(d):
        return torch.broadcast_to(torch.as_tensor(d, dtype=torch.float32, device=xv.device), xv.shape).clone()

    return DCSFD(xv, b(d1), b(d2), torch.zeros_like(xv))


# ---------------------------------------------------------------- elementwise
def _unary(x: DCSFD, f, df, ddf) -> DCSFD:
    x = lift(x)
    fv = f(x.v)
    d1 = df(x.v, fv)
    d2 = ddf(x.v, fv, d1)
    return DCSFD(fv, d1 * x.e1, d1 * x.e2, d1 * x.e12 + d2 * x.e1 * x.e2)


def sqrt(x: DCSFD) -> DCSFD:
    # reference sqrt uses the z+|z| scaling trick (cuda_double_complex.hpp:244-260)
    return _unary(x, torch.sqrt, lambda v, fv: 0.5 / fv, lambda v, fv, d1: -0.25 / (fv * v))


def exp(x: DCSFD) -> DCSFD:
    return _unary(x, torch.exp, lambda v, fv: fv, lambda v, fv, d1: fv)


def log(x: DCSFD) -> DCSFD:
    return _unary(x, torch.log, lambda v, fv: 1.0 / v, lambda v, fv, d1: -1.0 / (v * v))


def sin(x: DCSFD) -> DCSFD:
    # DoubleComplex sin (DoubleComplex.cpp:332-345)
    return _unary(x, torch.sin, lambda v, fv: torch.cos(v), lambda v, fv, d1: -fv)


def cos(x: DCSFD) -> DCSFD:
    return _unary(x, torch.cos, lambda v, fv: -torch.sin(v), lambda v, fv, d1: -fv)


def abs(x: DCSFD) -> DCSFD:  # noqa: A001
    x = lift(x)
    s = torch.sign(x.v)
    return DCSFD(s * x.v, s * x.e1, s * x.e2, s * x.e12)


def powi(x: DCSFD, n) -> DCSFD:
    return _unary(
        x,
        lambda v: v**n,
        lambda v, fv: n * v ** (n - 1),
        lambda v, fv, d1: n * (n - 1) * v ** (n - 2),
    )


def atan2(y: DCSFD, x: DCSFD) -> DCSFD:
    y, x = lift(y), lift(x)
    # chain through the quotient + atan using hyper-dual ops directly
    r = y / x
    base = _unary(
        r,
        torch.atan,
        lambda v, fv: 1.0 / (1.0 + v * v),
        lambda v, fv, d1: -2.0 * v * d1 * d1,
    )
    # fix the branch: atan2 vs atan differ by a constant per quadrant
    shift = torch.atan2(y.v, x.v) - torch.atan(r.v)
    return DCSFD(base.v + shift, base.e1, base.e2, base.e12)


def where(pred, a, b) -> DCSFD:
    a, b = lift(a), lift(b)
    return DCSFD(*(torch.where(pred, x, y) for x, y in zip(a, b)))


def sum(x: DCSFD, axis=None, keepdims=False) -> DCSFD:  # noqa: A001
    def s(a):
        return torch.sum(a) if axis is None else torch.sum(a, dim=axis, keepdim=keepdims)

    return DCSFD(*(s(a) for a in x))


def to_csfd(x: DCSFD) -> cs.CSFD:
    """Drop the second-order lanes (outer complex lane only)."""
    return cs.CSFD(x.v, x.e1)
