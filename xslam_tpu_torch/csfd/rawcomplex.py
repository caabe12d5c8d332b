"""Reference-compatible h-scaled CSFD complex rules over PyTorch tensors.

Port of ``xslam_tpu/csfd/rawcomplex.py``: the two op families the
reference's ``test_CSFD`` demo benchmarks (``Experiments/test_CSFD/main.cpp:18-86``),
on explicit ``(re, im)`` pairs whose ``im`` carries the h-scaled derivative:

* ``*_raw``: the full complex-arithmetic rules (``cuda::std::complex``);
* ``*_our``: the "accelerated" CSFD rules that drop O(h^2) real-part
  corrections.

Used by :mod:`xslam_tpu_torch.apps.csfd_bench` (part 1) and by the parity
tests against :mod:`.single`, the exact h->0 limit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class C(NamedTuple):
    re: torch.Tensor
    im: torch.Tensor


def mul_raw(a: C, b: C) -> C:
    return C(a.re * b.re - a.im * b.im, a.im * b.re + a.re * b.im)


def mul_our(a: C, b: C) -> C:
    # test_CSFD/main.cpp:18-23
    return C(a.re * b.re, a.im * b.re + a.re * b.im)


def div_raw(a: C, b: C) -> C:
    n = b.re * b.re + b.im * b.im
    return C((a.re * b.re + a.im * b.im) / n, (a.im * b.re - a.re * b.im) / n)


def div_our(a: C, b: C) -> C:
    # test_CSFD/main.cpp:32-37
    n = b.re * b.re + b.im * b.im
    return C(a.re / b.re, (a.im * b.re - a.re * b.im) / n)


def exp_raw(a: C) -> C:
    e = torch.exp(a.re)
    return C(e * torch.cos(a.im), e * torch.sin(a.im))


def exp_our(a: C) -> C:
    # test_CSFD/main.cpp:46-51
    e = torch.exp(a.re)
    return C(e, e * torch.sin(a.im))


def sin_raw(a: C) -> C:
    return C(torch.sin(a.re) * torch.cosh(a.im), torch.sinh(a.im) * torch.cos(a.re))


def sin_our(a: C) -> C:
    # test_CSFD/main.cpp:60-65
    return C(torch.sin(a.re), torch.sinh(a.im) * torch.cos(a.re))


def pow_raw(a: C, n: int) -> C:
    r = torch.sqrt(a.re * a.re + a.im * a.im)
    th = torch.atan2(a.im, a.re)
    return C(r**n * torch.cos(n * th), r**n * torch.sin(n * th))


def pow_our(a: C, n: int) -> C:
    # test_CSFD/main.cpp:74-79
    r = torch.sqrt(a.re * a.re + a.im * a.im)
    th = torch.atan2(a.im, a.re)
    return C(a.re**n, r**n * torch.sin(n * th))
