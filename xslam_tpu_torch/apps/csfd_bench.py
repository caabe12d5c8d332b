"""CSFD numerics demo and microbenchmark.

Port of ``apps/csfd_bench.py``, the parity app of the reference's
``Experiments/test_CSFD/main.cpp``:

Part 1: microbenchmark of the raw and the accelerated complex rules (the
h-scaled op pairs of :mod:`xslam_tpu_torch.csfd.rawcomplex`) and the exact
dual rules that are this package's default, over 1,000,000 lanes on the
device, each printed with its value and derivative side by side
(main.cpp:90-191), the device named by PyTorch.

Part 2: the DCSFD second-order chain-rule check, ``f1(x,y)=(x+y)^2, x=t*t,
y=sin(t)``: gradient and second derivative through the hyper-dual lanes
against the manual chain-rule composition (main.cpp:194-219).

Usage:
    python -m xslam_tpu_torch.apps.csfd_bench [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..csfd import double as dc
from ..csfd import rawcomplex as rc
from ..csfd import single as cs


def bench(name, fn, device, n=5):
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = fn()
    sync()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        sync()
        ts.append(time.perf_counter() - t0)
    print(f"  {name}: {1000 * min(ts):.3f} ms")
    return out


def part1(device, N=1_000_000):
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"1. complex-op microbenchmark over {N} lanes ({name})")
    h = 1e-6

    def full(x):
        return torch.full((N,), x, dtype=torch.float32, device=device)

    a = rc.C(full(0.5), full(h))
    b = rc.C(full(-1.5), full(h))
    da = cs.CSFD(full(0.5), full(1.0))
    db = cs.CSFD(full(-1.5), full(1.0))

    def ab():
        return rc.C(a.re + b.re, a.im + b.im)

    pairs = [
        ("mul", lambda: rc.mul_raw(a, b), lambda: rc.mul_our(a, b), lambda: da * db),
        ("div", lambda: rc.div_raw(a, b), lambda: rc.div_our(a, b), lambda: da / db),
        ("exp", lambda: rc.exp_raw(ab()), lambda: rc.exp_our(ab()), lambda: cs.exp(da + db)),
        ("sin", lambda: rc.sin_raw(ab()), lambda: rc.sin_our(ab()), lambda: cs.sin(da + db)),
        ("pow3", lambda: rc.pow_raw(ab(), 3), lambda: rc.pow_our(ab(), 3), lambda: cs.powi(da + db, 3)),
    ]
    for op, raw, our, dual in pairs:
        print(f" {op}:")
        r = bench("raw complex", raw, device)
        o = bench("accelerated", our, device)
        d = bench("exact dual ", dual, device)
        print(
            f"  value: raw={float(r.re[0]):.6f}  accel={float(o.re[0]):.6f}"
            f"  dual={float(d.v[0]):.6f} | grad: raw={float(r.im[0]) / h:.6f}"
            f"  accel={float(o.im[0]) / h:.6f}  dual={float(d.g[0]):.6f}"
        )


def part2() -> dict:
    """The chain-rule check's numbers: the DCSFD gradient and second
    derivative, and the manual composition's."""
    t = dc.seed(0.5)
    x = t * t
    y = dc.sin(t)
    loss = (x + y) * (x + y)

    # manual chain-rule composition (main.cpp:206-216)
    x_, y_ = float(x.value()), float(y.value())
    dx, dxx = float(x.grad()), float(x.hessian())
    dy, dyy = float(y.grad()), float(y.hessian())

    def f1(xx, yy):
        return (xx + yy) * (xx + yy)

    def hd(v, e1, e2):
        return dc.DCSFD(*(torch.tensor(a, dtype=torch.float32) for a in (v, e1, e2, 0.0)))

    fx, fy = hd(x_, 1.0, 1.0), dc.lift(torch.tensor(y_, dtype=torch.float32))
    df_dx, dff_dxx = float(f1(fx, fy).grad()), float(f1(fx, fy).hessian())
    fx2, fy2 = dc.lift(torch.tensor(x_, dtype=torch.float32)), hd(y_, 1.0, 1.0)
    df_dy, dff_dyy = float(f1(fx2, fy2).grad()), float(f1(fx2, fy2).hessian())
    dff_dxy = float(f1(hd(x_, 1.0, 0.0), hd(y_, 0.0, 1.0)).hessian())

    grad = df_dx * dx + df_dy * dy
    hess = df_dx * dxx + df_dy * dyy + dx * dx * dff_dxx + dy * dy * dff_dyy + 2 * dx * dy * dff_dxy
    return {"dcsfd_grad": float(loss.grad()), "dcsfd_hessian": float(loss.hessian()),
            "chain_grad": grad, "chain_hessian": hess}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device("cuda" if args.device is None else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("csfd_bench: CUDA is not available (pass --device cpu to run on the CPU)")
    part1(device)
    r = part2()
    print("2. DCSFD second-order chain rule: f1(x,y)=(x+y)^2, x=t*t, y=sin(t)")
    print("a. by DCSFD:")
    print(f"  gradient = {r['dcsfd_grad']:.6f}")
    print(f"  second order differentiation = {r['dcsfd_hessian']:.6f}")
    print("b. by chain rule:")
    print(f"  gradient = {r['chain_grad']:.6f}")
    print(f"  second order differentiation = {r['chain_hessian']:.6f}")
    return r


if __name__ == "__main__":
    main()
