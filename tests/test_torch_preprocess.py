"""The port's preprocessing (bilateral plain version = kernel K1's twin,
pyr_down, vertex/normal maps, resizes) against xslam_tpu on the CPU.

The wrappers of the preprocess stage (K1 ``kernels.bilateral_filter``, K7
``kernels.pyr_down``, K8 ``kernels.vertex_normal_maps``) return their plain
versions' results bit for bit on CPU tensors and launch nothing; composed as
the engine composes them, they are held against the JAX functions level by
level."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import small_dataset
from tests.torch_port_helpers import frac_equal
from xslam_tpu.geometry.intrinsics import Intrinsics as JIntrinsics
from xslam_tpu.ops import preprocess as jpre
from xslam_tpu.ops.pallas_kernels import bilateral_filter_pallas
from xslam_tpu_torch.geometry.intrinsics import Intrinsics as TIntrinsics
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops import preprocess as tpre


def _golden_depth():
    """The input of tests/test_pallas_kernels.py's golden test (80x128)."""
    rng = np.random.default_rng(0)
    depth = (1500 + 400 * rng.random((80, 128))).astype(np.uint16)
    depth[20:30, 40:60] = 3200
    depth[0, :5] = 0
    return depth


def _rendered_depth():
    return small_dataset(2).get_depth(1)


_DEPTHS = {"golden": _golden_depth, "rendered": _rendered_depth}


@functools.lru_cache(maxsize=None)
def _jax_bilateral(source: str) -> np.ndarray:
    """xslam_tpu's jnp bilateral filter, compiled once per input."""
    return np.array(jax.jit(jpre.bilateral_filter)(jnp.asarray(_DEPTHS[source]())))


@pytest.fixture(scope="module")
def golden():
    depth = _golden_depth()
    port = kernels.bilateral_filter(torch.from_numpy(depth)).numpy()
    return depth, port


def test_bilateral_matches_pallas_kernel(golden):
    """Against the Pallas kernel (interpret mode), the golden test's
    tolerance: atol 1 mm, more than 99.9% of pixels equal (expf and the
    summation can round the last bit differently before the rounding)."""
    depth, port = golden
    ref = np.asarray(bilateral_filter_pallas(jnp.asarray(depth), interpret=True))
    np.testing.assert_allclose(port, ref, atol=1.0)
    assert np.mean(port == ref) > 0.999


@pytest.mark.parametrize("source", ["golden", "rendered"])
def test_bilateral_matches_jnp_twin(golden, source):
    port = tpre.bilateral_filter(torch.from_numpy(_DEPTHS[source]())).numpy()
    ref = _jax_bilateral(source)
    np.testing.assert_allclose(port, ref, atol=1.0)
    assert frac_equal(port, ref) > 0.999


def test_bilateral_wrapper_uses_plain_version_on_cpu(golden):
    depth, port = golden
    before = dict(kernels.launch_counts)
    np.testing.assert_array_equal(port, tpre.bilateral_filter(torch.from_numpy(depth)).numpy())
    kernels.bilateral_filter(torch.from_numpy(depth))
    assert kernels.launch_counts == before  # CPU tensors launch nothing


def _maps_close(t: torch.Tensor, j):
    t, j = t.numpy(), np.asarray(j)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, atol=1e-5, equal_nan=True)


_jpyr_down = jax.jit(jpre.pyr_down)
_jcreate_vmap = jax.jit(jpre.create_vmap, static_argnums=0)
_jcreate_nmap = jax.jit(jpre.create_nmap)
_jresize_vmap = jax.jit(jpre.resize_vmap)
_jresize_nmap = jax.jit(jpre.resize_nmap)


@pytest.mark.parametrize("source", ["golden", "rendered"])
def test_pyramid_and_maps(source):
    jd = jnp.asarray(_jax_bilateral(source))
    H, W = jd.shape
    jintr = JIntrinsics(fx=120.3, fy=-120.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    tintr = TIntrinsics(*jintr)
    td = torch.from_numpy(np.array(jd))
    for level in range(3):
        if level:
            jd2, td2 = _jpyr_down(jd), tpre.pyr_down(td)
            _maps_close(td2, jd2)
            # continue both pyramids from the same input
            jd, td = jd2, torch.from_numpy(np.array(jd2))
        jv = _jcreate_vmap(jintr.level(level), jd)
        tv = tpre.create_vmap(tintr.level(level), td)
        _maps_close(tv, jv)
        jn = _jcreate_nmap(jv)
        tn = tpre.create_nmap(torch.from_numpy(np.array(jv)))
        _maps_close(tn, jn)
        _maps_close(tpre.resize_vmap(torch.from_numpy(np.array(jv))), _jresize_vmap(jv))
        _maps_close(tpre.resize_nmap(torch.from_numpy(np.array(jn))), _jresize_nmap(jn))


@pytest.mark.parametrize("wrapper", ["pyr_down", "vertex_normal_maps"])
def test_preprocess_wrappers_use_plain_versions_on_cpu(wrapper):
    depth = tpre.bilateral_filter(torch.from_numpy(_rendered_depth()))
    H, W = depth.shape
    intr = TIntrinsics(fx=120.3, fy=-120.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    before = dict(kernels.launch_counts)
    if wrapper == "pyr_down":
        pairs = [(kernels.pyr_down(depth), tpre.pyr_down(depth))]
    else:
        vmap, nmap = kernels.vertex_normal_maps(intr, depth)
        plain_v = tpre.create_vmap(intr, depth)
        pairs = [(vmap, plain_v), (nmap, tpre.create_nmap(plain_v))]
    for got, want in pairs:
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert kernels.launch_counts == before  # CPU tensors launch nothing


@pytest.mark.parametrize("source", ["golden", "rendered"])
def test_composed_preprocess_stage(source):
    """K1 wrapper -> K7 wrapper x 2 -> K8 wrapper x 3, as ``process_frame``
    runs them, against the JAX stage on the same depth. The depth pyramids
    must be equal except where the two bilateral filters differ by their one
    allowed millimetre (> 99.9% of pixels equal at every level); the maps are
    compared where the depths are equal: NaN masks equal, vertices within
    1e-5, normals within 1e-4 (a normal is a cross product of differences of
    neighbouring vertices, which amplifies the last-bit differences that the
    two vertex maps are allowed; fed the same vertex map, as in
    ``test_pyramid_and_maps``, the normals agree to 1e-5)."""
    depth_u16 = _DEPTHS[source]()
    H, W = depth_u16.shape
    jintr = JIntrinsics(fx=120.3, fy=-120.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    tintr = TIntrinsics(*jintr)
    td = [kernels.bilateral_filter(torch.from_numpy(depth_u16))]
    jd = [jnp.asarray(_jax_bilateral(source))]
    for _ in range(2):
        td.append(kernels.pyr_down(td[-1]))
        jd.append(_jpyr_down(jd[-1]))
    for level in range(3):
        t, j = td[level].numpy(), np.asarray(jd[level])
        assert t.shape == j.shape == (H >> level, W >> level)
        same = (t == j) | (np.isnan(t) & np.isnan(j))
        assert same.mean() > 0.999
        tv, tn = kernels.vertex_normal_maps(tintr.level(level), td[level])
        jv = _jcreate_vmap(jintr.level(level), jd[level])
        jn = np.asarray(_jcreate_nmap(jv))
        jv = np.asarray(jv)
        np.testing.assert_array_equal(np.isnan(tv.numpy())[:, same], np.isnan(jv)[:, same])
        np.testing.assert_allclose(tv.numpy()[:, same], jv[:, same], atol=1e-5, equal_nan=True)
        # a normal reads its right and lower neighbours too
        near = same.copy()
        near[:, :-1] &= same[:, 1:]
        near[:-1, :] &= same[1:, :]
        np.testing.assert_array_equal(np.isnan(tn.numpy())[:, near], np.isnan(jn)[:, near])
        np.testing.assert_allclose(tn.numpy()[:, near], jn[:, near], atol=1e-4, equal_nan=True)
