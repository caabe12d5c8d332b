"""The port's second-order dual core (``csfd/double.py``), the rest of the
first-order module (``csfd/single.py``), ``csfd/rawcomplex.py``, the generic
SE(3) algebra (``geometry/se3.py``) and ``apps/csfd_bench.py`` against
``xslam_tpu`` on numpy-seeded inputs.

Tolerance: rtol=1e-6, atol=1e-6 (atol for lanes that cancel to near zero).
The port keeps the JAX modules' formula order, so the lanes differ only where
PyTorch's and XLA's float32 kernels (sin, cos, exp, log, tan, the hyperbolic
and inverse functions, sqrt, rsqrt) round differently, by a few ulps; the
SE(3) exponential chains some twenty operations through them and is held at
rtol=1e-5, atol=1e-6, as ``tests/test_torch_csfd.py`` holds the first-order
SE(3) algebra.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (sets one intra-op thread)
from xslam_tpu.csfd import double as jdc
from xslam_tpu.csfd import rawcomplex as jrc
from xslam_tpu.csfd import single as jcs
from xslam_tpu.csfd import vec3 as jv3
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu_torch.apps import csfd_bench
from xslam_tpu_torch.csfd import double as tdc
from xslam_tpu_torch.csfd import rawcomplex as trc
from xslam_tpu_torch.csfd import single as tcs
from xslam_tpu_torch.csfd import vec3 as tv3
from xslam_tpu_torch.geometry import se3 as tse3

TOL = dict(rtol=1e-6, atol=1e-6)
SE3_TOL = dict(rtol=1e-5, atol=1e-6)


def _close(j, t, tol=TOL):
    for a, b in zip(j, t):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.float32(b)
        np.testing.assert_allclose(b, np.asarray(a), **tol)


def _hd(rng, shape, lo=0.5, hi=2.0):
    lanes = [rng.uniform(lo, hi, shape).astype(np.float32)] + [
        rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    return jdc.DCSFD(*map(jnp.asarray, lanes)), tdc.DCSFD(*map(torch.from_numpy, lanes))


DOUBLE_OPS = {
    "add": lambda m, a, b: a + b,
    "sub": lambda m, a, b: a - b,
    "mul": lambda m, a, b: a * b,
    "div": lambda m, a, b: a / b,
    "neg": lambda m, a, b: -a,
    "scalar_radd": lambda m, a, b: 1.5 + a,
    "scalar_rsub": lambda m, a, b: 2.0 - a,
    "scalar_mul": lambda m, a, b: a * 0.3,
    "scalar_div": lambda m, a, b: a / 0.7,
    "scalar_rdiv": lambda m, a, b: 1.0 / a,
    "sqrt": lambda m, a, b: m.sqrt(a),
    "exp": lambda m, a, b: m.exp(a),
    "log": lambda m, a, b: m.log(a),
    "sin": lambda m, a, b: m.sin(a),
    "cos": lambda m, a, b: m.cos(a),
    "abs": lambda m, a, b: m.abs(-a),
    "powi": lambda m, a, b: m.powi(a, 3),
    "atan2": lambda m, a, b: m.atan2(a, -b),
    "where": lambda m, a, b: m.where(a.v > b.v, a, b),
    "sum": lambda m, a, b: m.sum(a, axis=1),
    "sum_all": lambda m, a, b: m.sum(a * b),
}


@pytest.mark.parametrize("op", sorted(DOUBLE_OPS))
def test_dcsfd_ops(op):
    rng = np.random.default_rng(11)
    ja, ta = _hd(rng, (4, 6))
    jb, tb = _hd(rng, (4, 6))
    _close(DOUBLE_OPS[op](jdc, ja, jb), DOUBLE_OPS[op](tdc, ta, tb))


def test_dcsfd_seeds_accessors_and_comparisons():
    x = np.linspace(0.1, 1.3, 7, dtype=np.float32)
    for j, t in ((jdc.seed(x, 0.5), tdc.seed(x, 0.5)), (jdc.seed_cross(x, 1.0, -2.0), tdc.seed_cross(x, 1.0, -2.0)),
                 (jdc.lift(x), tdc.lift(x))):
        _close(j, t, dict(rtol=0, atol=0))
        np.testing.assert_array_equal(t.value().numpy(), np.asarray(j.value()))
        np.testing.assert_array_equal(t.grad().numpy(), np.asarray(j.grad()))
        np.testing.assert_array_equal(t.hessian().numpy(), np.asarray(j.hessian()))
        _close(jdc.to_csfd(j), tdc.to_csfd(t), dict(rtol=0, atol=0))
        for cmp in ("__lt__", "__le__", "__gt__", "__ge__"):
            np.testing.assert_array_equal(getattr(t, cmp)(0.7).numpy(), np.asarray(getattr(j, cmp)(0.7)))
    assert tdc.seed(x).dtype == torch.float32


def _dual(rng, shape, lo=0.5, hi=2.0):
    v = rng.uniform(lo, hi, shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return jcs.CSFD(jnp.asarray(v), jnp.asarray(g)), tcs.CSFD(torch.from_numpy(v), torch.from_numpy(g))


SINGLE_OPS = {
    "exp": lambda m, a, b: m.exp(a),
    "log": lambda m, a, b: m.log(a),
    "log10": lambda m, a, b: m.log10(a),
    "pow": lambda m, a, b: m.pow(a, b),
    "pow_scalar": lambda m, a, b: m.pow(a, 2.5),
    "powi": lambda m, a, b: m.powi(a, 4),
    "polar": lambda m, a, b: m.polar(a, b)[0] + m.polar(a, b)[1] * 2.0 + m.polar(a)[0],
    "conj": lambda m, a, b: m.conj(a),
    "tan": lambda m, a, b: m.tan(a * 0.5),
    "sinh": lambda m, a, b: m.sinh(a),
    "cosh": lambda m, a, b: m.cosh(a),
    "tanh": lambda m, a, b: m.tanh(a),
    "atanh": lambda m, a, b: m.atanh(a * 0.4),
    "asinh": lambda m, a, b: m.asinh(a),
    "acosh": lambda m, a, b: m.acosh(a + 1.0),
    "atan": lambda m, a, b: m.atan(a),
    "asin": lambda m, a, b: m.asin(a * 0.4),
    "acos": lambda m, a, b: m.acos(a * 0.4),
    "atan2": lambda m, a, b: m.atan2(a, -b),
    "abs": lambda m, a, b: m.abs(-a),
    "minimum": lambda m, a, b: m.minimum(a, b),
    "maximum": lambda m, a, b: m.maximum(a, b),
    "clip_value": lambda m, a, b: m.clip_value(a, 0.8, 1.5),
    "stack": lambda m, a, b: m.stack([a, b], 1),
    "concatenate": lambda m, a, b: m.concatenate([a, b], 0),
    "reshape": lambda m, a, b: m.reshape(a, (6, 4)),
    "sum": lambda m, a, b: m.sum(a, axis=0, keepdims=True),
    "sum_all": lambda m, a, b: m.sum(b),
    "take_flat": lambda m, a, b: m.take(a, np.array([[3, 0], [7, 5]])),
    "take_axis": lambda m, a, b: m.take(a, np.array([5, 1, 1]), axis=1),
    "matmul": lambda m, a, b: m.matmul(a, m.reshape(b, (6, 4))),
}


@pytest.mark.parametrize("op", sorted(SINGLE_OPS))
def test_single_lane_ops(op):
    rng = np.random.default_rng(12)
    ja, ta = _dual(rng, (4, 6))
    jb, tb = _dual(rng, (4, 6))

    _close(SINGLE_OPS[op](jcs, ja, jb), SINGLE_OPS[op](tcs, ta, tb))


def test_single_seed_const_lift():
    x = np.linspace(-1.0, 2.0, 5, dtype=np.float32)
    _close(jcs.seed(x, 2.0), tcs.seed(x, 2.0), dict(rtol=0, atol=0))
    _close(jcs.const(x), tcs.const(x), dict(rtol=0, atol=0))
    _close(jcs.lift(x), tcs.lift(x), dict(rtol=0, atol=0))
    np.testing.assert_array_equal(tcs.grad_of(tcs.seed(x, 2.0)).numpy(), np.asarray(jcs.grad_of(jcs.seed(x, 2.0))))


def test_where3():
    rng = np.random.default_rng(13)
    ja, ta = _dual(rng, (3, 5, 4))
    jb, tb = _dual(rng, (3, 5, 4))
    pred = rng.random((5, 4)) > 0.5
    _close(jv3.where3(jnp.asarray(pred), ja, jb), tv3.where3(torch.from_numpy(pred), ta, tb), dict(rtol=0, atol=0))


def _xi(rng, small: bool):
    v = rng.standard_normal(3).astype(np.float32)
    w = (1e-7 if small else 0.4) * rng.standard_normal(3).astype(np.float32)
    return np.concatenate([v, w]).astype(np.float32)


@pytest.mark.parametrize("small", [False, True], ids=["rodrigues", "small_angle"])
@pytest.mark.parametrize("module", ["single", "double"])
def test_se3_exp(module, small):
    rng = np.random.default_rng(14 + small)
    xi = _xi(rng, small)
    lanes = [xi] + [rng.standard_normal(6).astype(np.float32) for _ in range(3 if module == "double" else 1)]
    if module == "double":
        lanes[3] = np.zeros(6, np.float32)  # the relocalizer's seed: e12 = 0
        j = jse3.exp(jdc.DCSFD(*map(jnp.asarray, lanes)), mod=jdc)
        t = tse3.exp(tdc.DCSFD(*map(torch.from_numpy, lanes)), mod=tdc)
    else:
        j = jse3.exp(jcs.CSFD(*map(jnp.asarray, lanes)))
        t = tse3.exp(tcs.CSFD(*map(torch.from_numpy, lanes)))
    assert type(t).__name__ == type(j).__name__
    _close(j, t, SE3_TOL)
    # compose, inverse, identity: generic over the module
    _close(jse3.compose(j, jse3.inverse(j)), tse3.compose(t, tse3.inverse(t)), SE3_TOL)
    mod_j, mod_t = (jdc, tdc) if module == "double" else (jcs, tcs)
    _close(jse3.identity(mod_j), tse3.identity(mod_t), dict(rtol=0, atol=0))


def test_se3_exp_batched_pairs_equal_each_pose():
    """A trailing pair axis computes each pose with the same operations (the
    relocalizer's 21 seed pairs in one call)."""
    rng = np.random.default_rng(16)
    xi = _xi(rng, False)
    d1 = np.eye(6, dtype=np.float32)[[0, 2, 5]]
    d2 = np.eye(6, dtype=np.float32)[[0, 3, 5]]
    batch = tse3.exp(tdc.DCSFD(*(torch.from_numpy(a) for a in (
        np.repeat(xi[:, None], 3, 1), d1.T.copy(), d2.T.copy(), np.zeros((6, 3), np.float32)))), mod=tdc)
    for p in range(3):
        one = jse3.exp(jdc.DCSFD(jnp.asarray(xi), jnp.asarray(d1[p]), jnp.asarray(d2[p]), jnp.zeros(6)), mod=jdc)
        _close(one, tuple(lane[..., p] for lane in batch), SE3_TOL)


def test_se3_real_helpers():
    rng = np.random.default_rng(17)
    xi = _xi(rng, False)
    T = np.array(jse3.exp_real(jnp.asarray(xi)))
    np.testing.assert_allclose(tse3.exp_real(xi).numpy(), T, **SE3_TOL)
    np.testing.assert_allclose(tse3.exp_real(torch.from_numpy(xi)).numpy(), T, **SE3_TOL)
    np.testing.assert_array_equal(tse3.log_real(T), jse3.log_real(T))
    np.testing.assert_array_equal(tse3.log_real(torch.from_numpy(T)), jse3.log_real(T))
    np.testing.assert_allclose(tse3.inverse_real(torch.from_numpy(T)).numpy(),
                               np.asarray(jse3.inverse_real(jnp.asarray(T))), **SE3_TOL)
    np.testing.assert_allclose(tse3.log_real(tse3.exp_real(xi)), xi, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tse3.from_real(T, tcs).v.numpy(), np.asarray(jse3.from_real(T).v))
    euler = [_dual(rng, (), -0.1, 0.1) for _ in range(6)]
    j = jse3.euler_xyz_increment(*(jdc.DCSFD(e[0].v, e[0].g, e[0].g, e[0].g) for e in euler), mod=jdc)
    t = tse3.euler_xyz_increment(*(tdc.DCSFD(e[1].v, e[1].g, e[1].g, e[1].g) for e in euler), mod=tdc)
    _close(j, t, SE3_TOL)


RAW = ("mul", "div", "exp", "sin", "pow")


@pytest.mark.parametrize("rule", ["raw", "our"])
@pytest.mark.parametrize("op", RAW)
def test_rawcomplex(op, rule):
    rng = np.random.default_rng(18)
    re = rng.uniform(0.5, 2.0, (2, 9)).astype(np.float32)
    im = (1e-3 * rng.standard_normal((2, 9))).astype(np.float32)
    ja, jb = (jrc.C(jnp.asarray(re[i]), jnp.asarray(im[i])) for i in range(2))
    ta, tb = (trc.C(torch.from_numpy(re[i]), torch.from_numpy(im[i])) for i in range(2))
    name = f"{op}_{rule}"
    if op == "pow":
        j, t = getattr(jrc, name)(ja, 3), getattr(trc, name)(ta, 3)
    elif op in ("exp", "sin"):
        j, t = getattr(jrc, name)(ja), getattr(trc, name)(ta)
    else:
        j, t = getattr(jrc, name)(ja, jb), getattr(trc, name)(ta, tb)
    _close(j, t, dict(rtol=1e-6, atol=1e-9))


def _jax_part2():
    """apps/csfd_bench.py:314-343 with the JAX package's DCSFD."""
    t = jdc.seed(jnp.float32(0.5))
    x, y = t * t, jdc.sin(t)
    loss = (x + y) * (x + y)
    x_, y_ = float(x.value()), float(y.value())
    dx, dxx, dy, dyy = float(x.grad()), float(x.hessian()), float(y.grad()), float(y.hessian())

    def f1(a, b):
        return (a + b) * (a + b)

    def hd(v, e1, e2):
        return jdc.DCSFD(jnp.float32(v), jnp.float32(e1), jnp.float32(e2), jnp.float32(0.0))

    fx, fy = hd(x_, 1.0, 1.0), jdc.lift(jnp.float32(y_))
    df_dx, dff_dxx = float(f1(fx, fy).grad()), float(f1(fx, fy).hessian())
    fx2, fy2 = jdc.lift(jnp.float32(x_)), hd(y_, 1.0, 1.0)
    df_dy, dff_dyy = float(f1(fx2, fy2).grad()), float(f1(fx2, fy2).hessian())
    dff_dxy = float(f1(hd(x_, 1.0, 0.0), hd(y_, 0.0, 1.0)).hessian())
    return {"dcsfd_grad": float(loss.grad()), "dcsfd_hessian": float(loss.hessian()),
            "chain_grad": df_dx * dx + df_dy * dy,
            "chain_hessian": df_dx * dxx + df_dy * dyy + dx * dx * dff_dxx + dy * dy * dff_dyy + 2 * dx * dy * dff_dxy}


def test_csfd_bench_part2_matches_jax(capsys):
    """The port's csfd_bench (both parts, on the CPU) and part 2's numbers
    against the same composition in the JAX package; DCSFD and the chain
    rule agree in each."""
    out = csfd_bench.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "1. complex-op microbenchmark over 1000000 lanes (cpu)" in text and "pow3:" in text
    want = _jax_part2()
    for key, value in want.items():
        np.testing.assert_allclose(out[key], value, rtol=1e-6)
    np.testing.assert_allclose(out["dcsfd_grad"], out["chain_grad"], rtol=1e-5)
    np.testing.assert_allclose(out["dcsfd_hessian"], out["chain_hessian"], rtol=1e-5)
