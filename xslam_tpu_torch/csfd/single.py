"""First-order CSFD dual numbers over PyTorch tensors.

Port of ``xslam_tpu/csfd/single.py``. A ``CSFD`` holds two same-shaped tensors ``(v, g)``: the value and its
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


def lift(x, like: CSFD | None = None) -> CSFD:
    """Promote a real tensor or number to a constant CSFD (zero derivative).

    A number stays a Python float (see the module's note); a numpy array
    becomes a float32 tensor on the device of ``like``'s value lane, or on
    the CPU."""
    if isinstance(x, CSFD):
        return x
    if isinstance(x, np.ndarray) and x.ndim > 0:
        device = like.v.device if like is not None and isinstance(like.v, torch.Tensor) else None
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if isinstance(x, torch.Tensor):
        return CSFD(x, torch.zeros_like(x))
    return CSFD(float(x), 0.0)


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def seed(x, direction=1.0) -> CSFD:
    """Seed a perturbation: the CSFD analogue of ``x + i*h`` with unit h
    (``DoubleComplex::addPerturbation``, DoubleComplex.cpp:61-66)."""
    xv = _f32(x)
    return CSFD(xv, torch.broadcast_to(_f32(direction, xv.device), xv.shape).clone())


def const(x, dtype=torch.float32) -> CSFD:
    xv = torch.as_tensor(x, dtype=dtype)
    return CSFD(xv, torch.zeros_like(xv))


def grad_of(x: CSFD):
    """Extract the derivative lane (reference: ``.imag()/h``)."""
    return x.g


def _unary(x: CSFD, f, df) -> CSFD:
    x = lift(x)
    v = f(x.v)
    return CSFD(v, df(x.v, v) * x.g)


def sqrt(x: CSFD) -> CSFD:
    # reference: complex sqrt via |z| scaling (cuda_complex.hpp:581-593)
    v = torch.sqrt(_val(x))
    x = lift(x)
    return CSFD(v, 0.5 * x.g / v)


def exp(x: CSFD) -> CSFD:
    # exp_our (test_CSFD/main.cpp:46-51)
    return _unary(x, torch.exp, lambda v, fv: fv)


def log(x: CSFD) -> CSFD:
    return _unary(x, torch.log, lambda v, fv: 1.0 / v)


def sin(x: CSFD) -> CSFD:
    # sin_our (test_CSFD/main.cpp:60-65)
    return _unary(x, torch.sin, lambda v, fv: torch.cos(v))


def cos(x: CSFD) -> CSFD:
    return _unary(x, torch.cos, lambda v, fv: -torch.sin(v))


def tan(x: CSFD) -> CSFD:
    return _unary(x, torch.tan, lambda v, fv: 1.0 + fv * fv)


def sinh(x: CSFD) -> CSFD:
    # sinh_new drops the O(h^2) correction (cuda_complex.hpp:740-751)
    return _unary(x, torch.sinh, lambda v, fv: torch.cosh(v))


def cosh(x: CSFD) -> CSFD:
    return _unary(x, torch.cosh, lambda v, fv: torch.sinh(v))


def tanh(x: CSFD) -> CSFD:
    # reference complex tanh (cuda_complex.hpp:770-793)
    return _unary(x, torch.tanh, lambda v, fv: 1.0 - fv * fv)


def atanh(x: CSFD) -> CSFD:
    # reference atanh (cuda_complex.hpp:697-723)
    return _unary(x, torch.atanh, lambda v, fv: 1.0 / (1.0 - v * v))


def asinh(x: CSFD) -> CSFD:
    return _unary(x, torch.asinh, lambda v, fv: torch.rsqrt(v * v + 1.0))


def acosh(x: CSFD) -> CSFD:
    return _unary(x, torch.acosh, lambda v, fv: torch.rsqrt(v * v - 1.0))


_LN10 = 2.302585092994046


def log10(x: CSFD) -> CSFD:
    # reference log10 = log(z)/ln(10) (cuda_complex.hpp:570-580)
    return _unary(x, torch.log10, lambda v, fv: 1.0 / (v * _LN10))


def pow(x: CSFD, y) -> CSFD:  # noqa: A001 - mirrors reference pow(z, w)
    """General power with dual base and (optionally dual) exponent
    (``pow(complex, complex)``, cuda_complex.hpp:617-638), for positive base
    values."""
    x, y = lift(x), lift(y, like=x)
    v = x.v ** y.v
    return CSFD(v, v * (y.g * torch.log(x.v) + y.v * x.g / x.v))


def polar(rho: CSFD, theta: CSFD = None):
    """Reference ``polar(rho, theta)`` (cuda_complex.hpp:534-545) as the pair
    ``(rho*cos(theta), rho*sin(theta))``, each component a CSFD."""
    rho = lift(rho)
    if theta is None:
        theta = lift(torch.zeros_like(rho.v))
    return rho * cos(theta), rho * sin(theta)


def conj(x: CSFD) -> CSFD:
    """Complex conjugate in CSFD semantics: negates the derivative lane
    (cuda_complex.hpp:485-505)."""
    x = lift(x)
    return CSFD(x.v, -x.g)


def atan(x: CSFD) -> CSFD:
    return _unary(x, torch.atan, lambda v, fv: 1.0 / (1.0 + v * v))


def asin(x: CSFD) -> CSFD:
    return _unary(x, torch.asin, lambda v, fv: torch.rsqrt(1.0 - v * v))


def acos(x: CSFD) -> CSFD:
    return _unary(x, torch.acos, lambda v, fv: -torch.rsqrt(1.0 - v * v))


def powi(x: CSFD, n) -> CSFD:
    # pow_our (test_CSFD/main.cpp:74-79)
    x = lift(x)
    vn1 = x.v ** (n - 1)
    return CSFD(vn1 * x.v, n * vn1 * x.g)


def atan2(y: CSFD, x: CSFD) -> CSFD:
    y, x = lift(y), lift(x)
    v = torch.atan2(y.v, x.v)
    d = 1.0 / (x.v * x.v + y.v * y.v)
    return CSFD(v, (x.v * y.g - y.v * x.g) * d)


def abs(x: CSFD) -> CSFD:  # noqa: A001 - mirrors reference abs_d
    x = lift(x)
    s = torch.sign(x.v)
    return CSFD(s * x.v, s * x.g)


def where(pred, a, b) -> CSFD:
    a, b = lift(a), lift(b)
    return CSFD(torch.where(pred, a.v, b.v), torch.where(pred, a.g, b.g))


def minimum(a, b) -> CSFD:
    return where(_val(a) <= _val(b), lift(a), lift(b))


def maximum(a, b) -> CSFD:
    return where(_val(a) >= _val(b), lift(a), lift(b))


def clip_value(x: CSFD, lo, hi) -> CSFD:
    """Clamp the value lane, zeroing the derivative where saturated."""
    x = lift(x)
    inside = (x.v >= lo) & (x.v <= hi)
    return CSFD(torch.clamp(x.v, lo, hi), torch.where(inside, x.g, 0.0))


# ------------------------------------------------------------------- reshape
def stack(xs, axis=0) -> CSFD:
    return CSFD(torch.stack([x.v for x in xs], axis), torch.stack([x.g for x in xs], axis))


def concatenate(xs, axis=0) -> CSFD:
    return CSFD(torch.cat([x.v for x in xs], axis), torch.cat([x.g for x in xs], axis))


def reshape(x: CSFD, shape) -> CSFD:
    return CSFD(x.v.reshape(shape), x.g.reshape(shape))


def sum(x: CSFD, axis=None, keepdims=False) -> CSFD:  # noqa: A001
    def s(a):
        return torch.sum(a) if axis is None else torch.sum(a, dim=axis, keepdim=keepdims)

    return CSFD(s(x.v), s(x.g))


def _take(a: torch.Tensor, idx, axis):
    idx = torch.as_tensor(idx, device=a.device)
    if axis is None:
        return torch.take(a, idx)
    axis = axis % a.dim()
    flat = a.index_select(axis, idx.reshape(-1))
    return flat.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


def take(x: CSFD, idx, axis=None) -> CSFD:
    """``jnp.take`` of both lanes: flat indices, or indices along ``axis``."""
    return CSFD(_take(x.v, idx, axis), _take(x.g, idx, axis))


# ------------------------------------------------------------------- linalg
def matmul(a: CSFD, b: CSFD) -> CSFD:
    """Dual matmul, three real matmuls: ``A.v = av@bv``, ``A.g = ag@bv +
    av@bg`` (full float32: the package pins TF32 off at import)."""
    a, b = lift(a), lift(b)
    return CSFD(torch.matmul(a.v, b.v), torch.matmul(a.g, b.v) + torch.matmul(a.v, b.g))


def solve(a: CSFD, b: CSFD) -> CSFD:
    """Dual linear solve: ``x.v = A.v^-1 b.v``; ``x.g = A.v^-1 (b.g - A.g x.v)``.

    ``solve_ex`` skips the singularity check, whose error flag would be read
    on the host: callers guard singular systems themselves (ICP's ``det``
    guard) and the solve stays free of host syncs."""
    xv = torch.linalg.solve_ex(a.v, b.v)[0]
    xg = torch.linalg.solve_ex(a.v, b.g - a.g @ xv)[0]
    return CSFD(xv, xg)
