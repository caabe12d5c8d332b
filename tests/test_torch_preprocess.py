"""The port's preprocessing (bilateral plain version = kernel K1's twin,
pyr_down, vertex/normal maps, resizes) against xslam_tpu on the CPU.

The wrappers of the preprocess stage (K1 ``kernels.bilateral_filter``, K7
``kernels.depth_pyramid``, K8 ``kernels.vertex_normal_pyramid``) return their
plain versions' results bit for bit on CPU tensors and launch nothing;
composed as the engine composes them, they are held against the JAX functions
level by level. K8 writes every level's maps into one buffer on the card;
where, is computed in Python (``kernels.map_pyramid_layout``) and tested
here. K7 makes both coarser depth levels in one launch from tiles staged in
shared memory; a numpy twin of its tile and halo mapping shows every pixel
written once and every tap it counts staged."""

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
        pyramid = kernels.depth_pyramid(depth, 3)
        half = tpre.pyr_down(depth)
        pairs = [(pyramid[0], depth), (pyramid[1], half), (pyramid[2], tpre.pyr_down(half))]
    else:
        depths = [depth, tpre.pyr_down(depth)]
        intrs = [intr, intr.level(1)]
        vmaps, nmaps = kernels.vertex_normal_pyramid(intrs, depths)
        pairs = []
        for level in range(2):
            plain_v = tpre.create_vmap(intrs[level], depths[level])
            pairs += [(vmaps[level], plain_v), (nmaps[level], tpre.create_nmap(plain_v))]
    for got, want in pairs:
        assert got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert kernels.launch_counts == before  # CPU tensors launch nothing


@pytest.mark.parametrize("source", ["golden", "rendered"])
def test_composed_preprocess_stage(source):
    """K1 wrapper -> K7 wrapper (both coarser levels) -> K8 wrapper, as ``process_frame``
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
    td = kernels.depth_pyramid(kernels.bilateral_filter(torch.from_numpy(depth_u16)), 3)
    jd = [jnp.asarray(_jax_bilateral(source))]
    for _ in range(2):
        jd.append(_jpyr_down(jd[-1]))
    tvs, tns = kernels.vertex_normal_pyramid([tintr.level(level) for level in range(3)], td)
    for level in range(3):
        t, j = td[level].numpy(), np.asarray(jd[level])
        assert t.shape == j.shape == (H >> level, W >> level)
        same = (t == j) | (np.isnan(t) & np.isnan(j))
        assert same.mean() > 0.999
        tv, tn = tvs[level], tns[level]
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


@pytest.mark.parametrize("source", ["golden", "rendered"])
def test_vertex_normal_pyramid_matches_jax(source):
    """K8's wrapper, all three levels in one call, against JAX ``create_vmap``
    and ``create_nmap`` level by level on the same depth pyramid (the JAX
    one): NaN masks equal, vertices within 1e-5, normals within 1e-4 (each
    from its own package's vertex map, whose last bits may differ: see
    ``test_composed_preprocess_stage``)."""
    jd = [jnp.asarray(_jax_bilateral(source))]
    for _ in range(2):
        jd.append(_jpyr_down(jd[-1]))
    H, W = jd[0].shape
    jintr = JIntrinsics(fx=120.3, fy=-120.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H)
    tintr = TIntrinsics(*jintr)
    before = dict(kernels.launch_counts)
    vmaps, nmaps = kernels.vertex_normal_pyramid([tintr.level(level) for level in range(3)],
                                                 [torch.from_numpy(np.array(d)) for d in jd])
    assert kernels.launch_counts == before  # CPU tensors launch nothing
    assert len(vmaps) == len(nmaps) == 3
    for level in range(3):
        jv = _jcreate_vmap(jintr.level(level), jd[level])
        assert vmaps[level].shape == nmaps[level].shape == (3, H >> level, W >> level)
        _maps_close(vmaps[level], jv)
        tn, jn = nmaps[level].numpy(), np.asarray(_jcreate_nmap(jv))
        np.testing.assert_array_equal(np.isnan(tn), np.isnan(jn))
        np.testing.assert_allclose(tn, jn, atol=1e-4, equal_nan=True)


@pytest.mark.parametrize("shapes", [
    [(480, 640), (240, 320), (120, 160)],
    [(240, 320), (120, 160)],
    [(75, 101), (37, 50), (18, 25), (9, 12)],
    [(1, 1)],
])
def test_map_pyramid_layout(shapes):
    """Where K8 writes: level by level, the vertex map then the normal map,
    each (3, H, W), back to back in one buffer; the views are contiguous,
    disjoint and cover it, at the offsets handed to the kernel."""
    offsets, size = kernels.map_pyramid_layout(shapes)
    assert size == sum(6 * H * W for H, W in shapes)
    buffer = torch.arange(size, dtype=torch.float32)
    vmaps, nmaps = kernels.map_pyramid_views(buffer, shapes)
    at = 0
    for (v_off, n_off), vmap, nmap, (H, W) in zip(offsets, vmaps, nmaps, shapes):
        assert (v_off, n_off) == (at, at + 3 * H * W)
        for view, off in ((vmap, v_off), (nmap, n_off)):
            assert view.shape == (3, H, W) and view.is_contiguous()
            assert view.data_ptr() == buffer.data_ptr() + 4 * off
            assert view[0, 0, 0] == off and view[-1, -1, -1] == off + 3 * H * W - 1
        at += 6 * H * W
    assert at == size


def test_map_pyramid_views_and_wrapper_check_their_inputs():
    with pytest.raises(ValueError):
        kernels.map_pyramid_views(torch.zeros(10), [(2, 2)])
    depth = torch.ones((4, 6))
    intr = TIntrinsics(fx=5.0, fy=5.0, cx=2.5, cy=1.5, width=6, height=4)
    with pytest.raises(ValueError):
        kernels.vertex_normal_pyramid([intr, intr.level(1)], [depth])


# --- K7: both coarser levels in one launch (csrc/maps.cu::depth_pyramid_kernel) ---
def _pyramid_tile():
    """K7's tile (level-2 rows, columns a block owns), as csrc/maps.cu defines it."""
    import re

    m = re.search(r"constexpr int PYR_TY = (\d+), PYR_TX = (\d+);", (kernels.CSRC_DIR / "maps.cu").read_text())
    return int(m.group(1)), int(m.group(2))


PYRAMID_SHAPES = [(480, 640), (478, 638), (477, 637)]


@pytest.mark.parametrize("shape", PYRAMID_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_depth_pyramid_tiles_cover_both_levels(shape):
    """numpy twin of K7's mapping: block (bx, by) stages level-0 rows from
    4 TY by - 6 (4 TY + 9 of them) and columns alike, computes the level-1
    tile with a 2-pixel halo where it lies in level 1, writes the tile's
    2 TY x 2 TX interior, then writes its TY x TX level-2 pixels. Every
    level-1 and level-2 pixel is written exactly once, and every tap that
    the [0, size - 2] rule counts is staged (level 0) or computed in the
    block (level 1)."""
    ty_, tx_ = _pyramid_tile()
    H, W = shape
    H1, W1, H2, W2 = H // 2, W // 2, H // 4, W // 4
    l0_rows, l0_cols = 2 * (2 * ty_ + 3) + 3, 2 * (2 * tx_ + 3) + 3
    written1 = np.zeros((H1, W1), np.int32)
    written2 = np.zeros((H2, W2), np.int32)
    taps = np.arange(-2, 3)
    for by in range(-(-H1 // (2 * ty_))):
        for bx in range(-(-W1 // (2 * tx_))):
            r1, c1 = 2 * ty_ * by - 2, 2 * tx_ * bx - 2
            r0, c0 = 2 * r1 - 2, 2 * c1 - 2
            computed1 = np.zeros((2 * ty_ + 3, 2 * tx_ + 3), bool)
            for ty in range(2 * ty_ + 3):
                for tx in range(2 * tx_ + 3):
                    y, x = r1 + ty, c1 + tx
                    if not (0 <= y < H1 and 0 <= x < W1):
                        continue
                    computed1[ty, tx] = True
                    ys, xs = 2 * y + taps, 2 * x + taps
                    ys, xs = ys[(ys >= 0) & (ys <= H - 2)], xs[(xs >= 0) & (xs <= W - 2)]
                    assert ys.min() >= r0 and ys.max() < r0 + l0_rows
                    assert xs.min() >= c0 and xs.max() < c0 + l0_cols
                    if 2 <= ty < 2 + 2 * ty_ and 2 <= tx < 2 + 2 * tx_:
                        written1[y, x] += 1
            for ty in range(ty_):
                for tx in range(tx_):
                    y, x = ty_ * by + ty, tx_ * bx + tx
                    if not (y < H2 and x < W2):
                        continue
                    written2[y, x] += 1
                    ys, xs = 2 * y + taps, 2 * x + taps
                    ys, xs = ys[(ys >= 0) & (ys <= H1 - 2)], xs[(xs >= 0) & (xs <= W1 - 2)]
                    assert computed1[np.ix_(ys - r1, xs - c1)].all()
    assert (written1 == 1).all() and (written2 == 1).all()


@pytest.mark.parametrize("shape", PYRAMID_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_depth_pyramid_plain_chain_matches_jax(shape):
    """K7's plain version (``pyr_down`` level after level, as the wrapper runs
    it on the CPU) against the JAX package's ``pyr_down`` applied twice, on
    a seeded depth with holes and jumps beyond the 90 mm window, equal."""
    rng = np.random.default_rng(shape[1])
    H, W = shape
    depth = (1000.0 + 60.0 * rng.integers(0, 40, (H // 8 + 1, W // 8 + 1))).repeat(8, 0).repeat(8, 1)[:H, :W]
    depth = depth + rng.uniform(-40.0, 40.0, (H, W))
    depth[rng.random((H, W)) < 0.05] = 0.0
    depth = depth.astype(np.float32)
    port = kernels.depth_pyramid(torch.from_numpy(depth), 3)
    jd = [jnp.asarray(depth)]
    for _ in range(2):
        jd.append(_jpyr_down(jd[-1]))
    for level in range(3):
        assert tuple(port[level].shape) == (H >> level, W >> level)
        np.testing.assert_array_equal(port[level].numpy(), np.asarray(jd[level]))
