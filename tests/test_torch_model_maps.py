"""K6, the model-map pyramid in one launch (``models/kinfu.py::
model_map_pyramid``, ``csrc/maps.cu``), on the CPU.

(a) Its plain path (``resize_model_maps`` level after level) against the JAX
    engine's chain (``resize_vmap`` on both lanes of the vertex map and
    ``_resize_nmap_dual``, ``xslam_tpu/models/kinfu.py:525-529``) on seeded
    maps of 118x158, whose halved level is odd in both axes (59x79 -> 29x39).
    Tolerance: NaN masks equal; values within 1e-6 (both sides average four
    float32 numbers of order 1 and renormalise, in their own operation
    order), derivative lanes within 1e-5 of their largest entry.
(b) The one buffer that holds every coarser level on the card: four maps a
    level (v.v, v.g, n.v, n.g), laid out in Python
    (``kernels.map_pyramid_layout``), and the wrapper's input checks.
(c) A numpy twin of the kernel's thread mapping: one thread per level-1
    pixel, a 2x2 quad of them in four neighbouring lanes of one warp, whose
    first lane gathers the quad by shuffles and writes the level-2 pixel.
    Every output pixel of both levels is written exactly once, a level-2
    pixel only from a quad whose four members exist, and the quad's members
    reach the first lane in the order of the 2x2 mean (k = 2 dy + dx). With
    the normals computed in the launch (the brick layout's B4n), a thread a
    2x2 block of the source: every source pixel's normal is written exactly
    once, an odd last row or column and a single level too.
(d) The path that computes level 0's normals (``model_map_pyramid`` with no
    normals given) on CPU tensors: JAX's ``screen_normals`` followed by the
    JAX resize, at even and odd source sizes and 1 and 3 levels; NaN masks
    equal, values within 1e-5, derivative lanes within 1e-4 of their
    largest entry (both sides normalise float32 cross products in their own
    operation order); and ``screen_normals_plain`` then
    ``resize_model_maps`` bit for bit.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xslam_tpu.csfd.single import CSFD as JCSFD
from xslam_tpu.models.kinfu import _resize_nmap_dual as j_resize_nmap_dual
from xslam_tpu.ops import preprocess as jpre
from xslam_tpu.ops import raycast as jraycast
from xslam_tpu_torch.csfd.single import CSFD as TCSFD
from xslam_tpu_torch.models.kinfu import model_map_pyramid, resize_model_maps
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops.raycast import screen_normals_plain


def _seeded_maps(H, W, seed=0):
    """Dual vertex and normal maps as the raycast leaves them: NaN vertices
    and normals (derivative 0) at invalid pixels, a derivative lane of the
    vertex map with NaNs of its own, unit normals of a rough surface
    elsewhere (neighbours within some 20 degrees: where four normals nearly
    cancel, renormalising their mean magnifies each side's rounding)."""
    rng = np.random.default_rng(seed)
    invalid = rng.random((H, W)) < 0.08
    invalid[10:25, 30:47] = True
    vv = rng.uniform(-2.0, 2.0, (3, H, W)).astype(np.float32)
    vv[:, invalid] = np.nan
    vg = (1e-2 * rng.standard_normal((3, H, W))).astype(np.float32)
    vg[:, rng.random((H, W)) < 0.05] = np.nan
    n = np.array([0.3, -0.2, -1.0])[:, None, None] + 0.3 * rng.standard_normal((3, H, W))
    nv = (n / np.linalg.norm(n, axis=0)).astype(np.float32)
    ng = (1e-2 * rng.standard_normal((3, H, W))).astype(np.float32)
    nv[:, invalid] = np.nan
    ng[:, invalid] = 0.0
    return (vv, vg), (nv, ng)


def _lane_close(t, j, atol):
    t, j = t.numpy(), np.asarray(j)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    both = ~np.isnan(t)
    np.testing.assert_allclose(t[both], j[both], rtol=0, atol=atol)


def test_plain_pyramid_against_jax_at_odd_halvings():
    (vv, vg), (nv, ng) = _seeded_maps(118, 158)
    tv, tn = TCSFD(torch.from_numpy(vv), torch.from_numpy(vg)), TCSFD(torch.from_numpy(nv), torch.from_numpy(ng))
    jv, jn = JCSFD(jnp.asarray(vv), jnp.asarray(vg)), JCSFD(jnp.asarray(nv), jnp.asarray(ng))
    before = dict(kernels.launch_counts)
    vmaps, nmaps = model_map_pyramid(tv, tn, 3)
    assert kernels.launch_counts == before  # CPU tensors launch nothing
    assert [tuple(m.v.shape) for m in vmaps] == [(3, 118, 158), (3, 59, 79), (3, 29, 39)]
    for level in (1, 2):
        jv = JCSFD(jpre.resize_vmap(jv.v), jpre.resize_vmap(jv.g))
        jn = j_resize_nmap_dual(jn)
        for t, j in ((vmaps[level], jv), (nmaps[level], jn)):
            _lane_close(t.v, j.v, 1e-6)
            _lane_close(t.g, j.g, 1e-5 * max(1.0, float(np.nanmax(np.abs(np.asarray(j.g))))))
        # the NaN rules: a vertex lane by its own first channel, the normal by the value lane's
        assert 0.05 < float(torch.isnan(vmaps[level].v[0]).float().mean()) < 0.9
        assert not torch.equal(torch.isnan(vmaps[level].v[0]), torch.isnan(vmaps[level].g[0]))
        assert torch.equal(torch.isnan(nmaps[level].v[0]), torch.isnan(vmaps[level].v[0]))
        assert bool((nmaps[level].g[:, torch.isnan(nmaps[level].v[0])] == 0).all())
    # the plain path is resize_model_maps level after level, bit for bit
    v1, n1 = resize_model_maps(vmaps[0], nmaps[0])
    v2, n2 = resize_model_maps(v1, n1)
    for got, want in ((vmaps[2].v, v2.v), (vmaps[2].g, v2.g), (nmaps[2].v, n2.v), (nmaps[2].g, n2.g)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("shapes", [[(240, 320), (120, 160)], [(59, 79), (29, 39)], [(1, 1)]])
def test_model_map_pyramid_layout(shapes):
    """Four maps a level, each (3, H, W), back to back level by level; the
    views are contiguous, disjoint, cover the buffer and start at the offsets
    handed to the kernel."""
    offsets, size = kernels.map_pyramid_layout(shapes, 4)
    assert size == sum(12 * H * W for H, W in shapes)
    buffer = torch.arange(size, dtype=torch.float32)
    views = kernels.map_pyramid_views(buffer, shapes, 4)
    assert len(views) == 4 and all(len(m) == len(shapes) for m in views)
    at = 0
    for level, (H, W) in enumerate(shapes):
        n = 3 * H * W
        assert offsets[level] == (at, at + n, at + 2 * n, at + 3 * n)
        for m in range(4):
            view = views[m][level]
            assert view.shape == (3, H, W) and view.is_contiguous()
            assert view.data_ptr() == buffer.data_ptr() + 4 * offsets[level][m]
            assert view[0, 0, 0] == offsets[level][m] and view[-1, -1, -1] == offsets[level][m] + n - 1
        at += 4 * n
    assert at == size
    # K8's two maps a level stay its default
    assert kernels.map_pyramid_layout(shapes) == (_two_maps(shapes), size // 2)


def _two_maps(shapes):
    at, out = 0, []
    for H, W in shapes:
        out.append((at, at + 3 * H * W))
        at += 6 * H * W
    return out


def test_model_map_pyramid_checks_its_inputs():
    with pytest.raises(ValueError):
        kernels.map_pyramid_views(torch.zeros(12 * 4 + 1), [(2, 2)], 4)
    (vv, vg), (nv, ng) = _seeded_maps(8, 8)
    v = TCSFD(torch.from_numpy(vv), torch.from_numpy(vg))
    n = TCSFD(torch.from_numpy(nv), torch.from_numpy(ng))
    with pytest.raises(ValueError):
        model_map_pyramid(v, n, 0)
    vmaps, nmaps = model_map_pyramid(v, n, 1)
    assert vmaps == (v,) and nmaps == (n,)
    meta = TCSFD(v.v.to("meta"), v.g)
    with pytest.raises(ValueError):  # neither all on the CPU nor all on one CUDA device
        model_map_pyramid(meta, n, 2)


def _kernel_constant(name: str) -> int:
    text = (kernels.CSRC_DIR / "maps.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _quad_twin(H, W, block, normals=False):
    """The kernel's index arithmetic for every thread of its grid (with
    ``normals``, the grid of the launch that computes level 0's normals)."""
    H1, W1 = H // 2, W // 2
    GH, GW = ((H + 1) // 2, (W + 1) // 2) if normals else (H1, W1)
    quads_w, quads_h = (GW + 1) // 2, (GH + 1) // 2
    blocks = -(-4 * quads_h * quads_w // block)
    t = np.arange(blocks * block)
    quad, k = t >> 2, t & 3
    qy, qx = quad // quads_w, quad % quads_w
    y1, x1 = 2 * qy + (k >> 1), 2 * qx + (k & 1)
    in_grid = (qy < quads_h) & (y1 < GH) & (x1 < GW)
    live = in_grid & (y1 < H1) & (x1 < W1)
    lane = (t % block) & 31
    writes2 = (k == 0) & (qy < H1 // 2) & (qx < W1 // 2)
    return dict(t=t, k=k, qy=qy, qx=qx, y1=y1, x1=x1, in_grid=in_grid, live=live, lane=lane, first=lane & ~3,
                writes2=writes2)


@pytest.mark.parametrize("shape", [(480, 640), (240, 320), (118, 158), (7, 9), (3, 5), (2, 2), (4, 4), (5, 2)])
def test_quad_mapping_twin_covers_every_pixel_once(shape):
    H, W = shape
    block = _kernel_constant("PYRAMID_BLOCK")
    assert block % 32 == 0
    tw = _quad_twin(H, W, block)
    H1, W1, H2, W2 = H // 2, W // 2, H // 4, W // 4
    live = tw["live"]
    ones = np.bincount(tw["y1"][live] * W1 + tw["x1"][live], minlength=H1 * W1)
    assert ones.shape == (H1 * W1,) and (ones == 1).all()
    w2 = tw["writes2"]
    ones2 = np.bincount(tw["qy"][w2] * W2 + tw["qx"][w2], minlength=H2 * W2)
    assert ones2.shape == (H2 * W2,) and (ones2 == 1).all()
    # a writer is its quad's first lane; its members are live, in its warp, in the mean's order
    writers = tw["t"][w2]
    assert (tw["lane"][writers] == tw["first"][writers]).all()
    for j in range(4):
        member = writers + j
        assert live[member].all()
        assert (member // 32 == writers // 32).all()
        assert (tw["y1"][member] == 2 * tw["qy"][writers] + (j >> 1)).all()
        assert (tw["x1"][member] == 2 * tw["qx"][writers] + (j & 1)).all()


@pytest.mark.parametrize("shape", [(240, 320), (7, 9), (3, 5), (1, 1), (2, 3), (5, 2), (118, 158)])
def test_normals_grid_twin_covers_every_source_pixel_once(shape):
    """The launch that computes level 0's normals: a thread a 2x2 block of
    the source (the level-1 pixel's where there is one), so an odd last row
    or column, which no level-1 pixel owns, and a map with no coarser level
    get their normals too; the level-1 and level-2 pixels are the plain
    grid's."""
    H, W = shape
    block = _kernel_constant("PYRAMID_BLOCK")
    tw = _quad_twin(H, W, block, normals=True)
    g = tw["in_grid"]
    count = np.zeros((H, W), int)
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = 2 * tw["y1"][g] + dy, 2 * tw["x1"][g] + dx
            on = (y < H) & (x < W)
            np.add.at(count, (y[on], x[on]), 1)
    assert (count == 1).all()
    H1, W1, H2, W2 = H // 2, W // 2, H // 4, W // 4
    live = tw["live"]
    assert np.array_equal(np.sort(tw["y1"][live] * max(W1, 1) + tw["x1"][live]), np.arange(H1 * W1))
    w2 = tw["writes2"]
    assert np.array_equal(np.sort(tw["qy"][w2] * max(W2, 1) + tw["qx"][w2]), np.arange(H2 * W2))
    for j in range(4):  # a level-2 writer's members are live lanes of its warp
        member = tw["t"][w2] + j
        assert live[member].all() and (member // 32 == tw["t"][w2] // 32).all()


def _surface_vmap(H, W, seed):
    """A dual world vertex map of a rough surface seen from the front, with
    NaN holes (derivative 0) as the raycast leaves them."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    vv = np.stack([x * 0.01, y * 0.01, 1.0 + 0.05 * np.sin(x / 7.0) * np.cos(y / 5.0)])
    vv = vv + 2e-4 * rng.standard_normal((3, H, W))
    vg = 1e-3 * rng.standard_normal((3, H, W))
    holes = rng.random((H, W)) < 0.04
    holes[H // 3: H // 3 + 4, W // 4: W // 4 + 6] = True
    vv[:, holes] = np.nan
    vg[:, holes] = 0.0
    return vv.astype(np.float32), vg.astype(np.float32)


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("shape", [(60, 80), (59, 79)])
def test_pyramid_with_screen_normals_against_jax(shape, levels):
    vv, vg = _surface_vmap(*shape, seed=levels)
    tv = TCSFD(torch.from_numpy(vv), torch.from_numpy(vg))
    before = dict(kernels.launch_counts)
    vmaps, nmaps = model_map_pyramid(tv, None, levels)
    assert kernels.launch_counts == before  # CPU tensors launch nothing
    assert len(vmaps) == len(nmaps) == levels and vmaps[0] is tv
    # the plain chain, bit for bit
    n0 = screen_normals_plain(tv)
    plain_v, plain_n = [tv], [n0]
    for _ in range(1, levels):
        v, n = resize_model_maps(plain_v[-1], plain_n[-1])
        plain_v.append(v)
        plain_n.append(n)
    for got, want in zip(vmaps + nmaps, plain_v + plain_n):
        assert torch.equal(got.v.view(torch.int32), want.v.view(torch.int32))
        assert torch.equal(got.g.view(torch.int32), want.g.view(torch.int32))
    # JAX's screen normals and resize
    jv = JCSFD(jnp.asarray(vv), jnp.asarray(vg))
    jn = jraycast.screen_normals(jv)
    for level in range(levels):
        if level:
            jv = JCSFD(jpre.resize_vmap(jv.v), jpre.resize_vmap(jv.g))
            jn = j_resize_nmap_dual(jn)
        for t, j in ((vmaps[level], jv), (nmaps[level], jn)):
            _lane_close(t.v, j.v, 1e-5)
            _lane_close(t.g, j.g, 1e-4 * max(1.0, float(np.nanmax(np.abs(np.asarray(j.g))))))
        valid = float((~torch.isnan(nmaps[level].v[0])).float().mean())
        assert (0.5 if level == 0 else 0.1) < valid < 1.0  # normals where the surface is whole, NaN at holes
    assert torch.isnan(nmaps[0].v[:, 0, :]).all() and torch.isnan(nmaps[0].v[:, :, -1]).all()  # the edges
