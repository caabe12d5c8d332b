"""The port's dual core (CSFD, vec3, SE(3)) against xslam_tpu on random duals.

Tolerance rtol=1e-5, atol=1e-6: the port keeps the reference's formula
order, so the lanes differ only where PyTorch's and XLA's float32 kernels
(sin, cos, sqrt, LU) round differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xslam_tpu_torch
from tests.torch_port_helpers import to_jax, to_torch
from xslam_tpu.csfd import single as jcs
from xslam_tpu.csfd import vec3 as jv3
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu_torch.csfd import single as tcs
from xslam_tpu_torch.csfd import vec3 as tv3
from xslam_tpu_torch.geometry import se3 as tse3
from xslam_tpu_torch.ops import kernels

TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(rng, shape, lo=0.5, hi=2.0):
    v = rng.uniform(lo, hi, shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return jcs.CSFD(jnp.asarray(v), jnp.asarray(g)), tcs.CSFD(torch.from_numpy(v), torch.from_numpy(g))


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(t.v.numpy(), np.asarray(j.v), **tol)
    np.testing.assert_allclose(t.g.numpy(), np.asarray(j.g), **tol)


BINARY = {
    "add": lambda m, a, b: a + b,
    "sub": lambda m, a, b: a - b,
    "mul": lambda m, a, b: a * b,
    "div": lambda m, a, b: a / b,
    "neg": lambda m, a, b: -a,
    "scalar_add": lambda m, a, b: 1.5 + a,
    "scalar_rsub": lambda m, a, b: 2.0 - a,
    "scalar_mul": lambda m, a, b: a * 0.3,
    "scalar_div": lambda m, a, b: a / 0.7,
    "scalar_rdiv": lambda m, a, b: 1.0 / a,
    "sqrt": lambda m, a, b: m.sqrt(a),
    "sin": lambda m, a, b: m.sin(a),
    "cos": lambda m, a, b: m.cos(a),
    "where": lambda m, a, b: m.where(a.v > b.v, a, b),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_dual_arithmetic(op):
    rng = np.random.default_rng(1)
    ja, ta = _pair(rng, (5, 7))
    jb, tb = _pair(rng, (5, 7))
    _close(BINARY[op](jcs, ja, jb), BINARY[op](tcs, ta, tb))


def test_comparisons_act_on_values():
    rng = np.random.default_rng(7)
    ja, ta = _pair(rng, (4, 5))
    jb, tb = _pair(rng, (4, 5))
    for op in ("__lt__", "__le__", "__gt__", "__ge__"):
        np.testing.assert_array_equal(getattr(ta, op)(tb).numpy(), np.asarray(getattr(ja, op)(jb)))
        np.testing.assert_array_equal(getattr(ta, op)(1.2).numpy(), np.asarray(getattr(ja, op)(1.2)))


VEC = {
    "dot": lambda m, a, b: m.dot(a, b),
    "cross": lambda m, a, b: m.cross(a, b),
    "norm": lambda m, a, b: m.norm(a),
    "normalized": lambda m, a, b: m.normalized(a),
    "vec3_comp": lambda m, a, b: m.vec3(m.comp(a, 2), m.comp(b, 0), m.comp(a, 1)),
}


@pytest.mark.parametrize("op", sorted(VEC))
def test_vec3(op):
    rng = np.random.default_rng(2)
    ja, ta = _pair(rng, (3, 4, 6), -1.0, 1.0)
    jb, tb = _pair(rng, (3, 4, 6), -1.0, 1.0)
    _close(VEC[op](jv3, ja, jb), VEC[op](tv3, ta, tb))


def test_matvec():
    rng = np.random.default_rng(3)
    jm, tm = _pair(rng, (3, 3), -1.0, 1.0)
    jx, tx = _pair(rng, (3, 8, 5), -1.0, 1.0)
    _close(jv3.matvec(jm, jx), tv3.matvec(tm, tx))


def _rigid_dual(rng):
    q = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = q * np.sign(np.linalg.det(q))
    T[:3, 3] = rng.standard_normal(3)
    g = np.zeros((4, 4), np.float32)
    g[:3] = rng.standard_normal((3, 4))
    return jcs.CSFD(jnp.asarray(T), jnp.asarray(g))


def test_se3_inverse_matmul_matvec():
    rng = np.random.default_rng(4)
    ja, jb = _rigid_dual(rng), _rigid_dual(rng)
    ta, tb = to_torch(ja), to_torch(jb)
    _close(jse3.inverse(ja), tse3.inverse(ta))
    _close(jse3.matmul(ja, jb), tse3.matmul(ta, tb))
    _close(jse3.matvec(jse3.rotation(ja), jse3.translation(jb)), tse3.matvec(tse3.rotation(ta), tse3.translation(tb)))


def test_euler_xyz_increment():
    rng = np.random.default_rng(5)
    x = [_pair(rng, (), -0.1, 0.1) for _ in range(6)]
    _close(jse3.euler_xyz_increment(*(p[0] for p in x)), tse3.euler_xyz_increment(*(p[1] for p in x)))


def test_dual_solve():
    rng = np.random.default_rng(6)
    m = rng.standard_normal((6, 6)).astype(np.float32)
    r = lambda *shape: jnp.asarray(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    A = jcs.CSFD(jnp.asarray(m @ m.T + 6 * np.eye(6, dtype=np.float32)), r(6, 6))
    b = jcs.CSFD(r(6), r(6))
    _close(jcs.solve(A, b), tcs.solve(to_torch(A), to_torch(b)), dict(rtol=1e-4, atol=1e-5))
    _close(b, to_torch(to_jax(to_torch(b))))


def test_precision_pins():
    """TF32 would corrupt ICP's normal equations as single-pass bf16 did on
    the TPU: importing the port pins full float32."""
    assert xslam_tpu_torch.__name__ == "xslam_tpu_torch"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_kernel_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    not routed to the plain version."""
    depth = torch.zeros((8, 8), dtype=torch.uint16, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kernels.bilateral_filter(depth)
