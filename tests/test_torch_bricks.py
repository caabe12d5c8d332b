"""The port's brick-major volume (``xslam_tpu_torch.ops.bricks``) and its
fusion in that layout (``ops/fusion.py::integrate_rows``) against
``xslam_tpu.ops.bricks`` / ``fusion_brick.integrate_rows`` and against the
port's own dense fusion, on the CPU at the tests' scale.

- The layout: ``from_dense`` / ``to_dense`` round trips, ``flat_index``
  and ``gather`` (out-of-bounds fills too) equal the JAX functions' bit for
  bit; so do the event mask, the capped brick distance and the jump-packed
  ``skip_rows``, on random volumes whose brick grids are as small as one
  brick along an axis (``jnp.roll`` wraps there, and the port keeps it).
- B5a's kernel rule (a cube of the mask around each brick, the nearest
  event's circular L-inf distance C, then ``min(max(C - 1, 0), 5)``) equals
  the plain dilation loop on every brick of random masks.
- B3c's row variant: the columns it stages and writes cover each lane of a
  brick row once, at ``b * 512 + c * 8``.
- ``integrate_rows`` equals the dense ``integrate`` in brick order, bit for
  bit, at the orbit, a volume corner and the window-coverage regression
  pose, also with a seeded derivative lane; with ``cap=4`` ``"dense"``
  equals dense fusion and ``"flag"`` leaves the dense twin's bricks unfused;
  against JAX's ``integrate_rows`` within K2's tolerances.
- ``utils/convert.py`` carries a JAX ``BrickVolume`` state across and back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fusion_brick import CASES, TINTR, _case, _cfgs, _poses
from tests.torch_port_helpers import jax_state_to_numpy, torch_config
from tests.helpers import small_config, small_dataset
from xslam_tpu.models.kinfu import XSlamEngine as JaxEngine
from xslam_tpu.ops import bricks as jbricks
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops import fusion_brick as jbrick
from xslam_tpu_torch.ops import bricks as tbricks
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

RESOLUTIONS = [(8, 16, 24), (16, 24, 40), (64, 64, 64)]


def _random_volume(res, seed, neg=0.02, weighted=0.5):
    """(value, grad, weight) numpy planes: values in [-1, 1], negatives
    sparse so that some bricks hold none, half the voxels observed."""
    rng = np.random.default_rng(seed)
    value = rng.uniform(0.0, 1.0, res).astype(np.float32)
    value[rng.random(res) < neg] *= -1.0
    grad = rng.standard_normal(res).astype(np.float32)
    weight = np.where(rng.random(res) < weighted, rng.integers(1, 50, res), 0).astype(np.float32)
    return value, grad, weight


def _bits(a: torch.Tensor, b) -> bool:
    return np.array_equal(a.numpy().view(np.int32), np.asarray(b).view(np.int32))


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_layout_round_trip_and_reads(res):
    planes = _random_volume(res, 1)
    jvol = jbricks.from_dense(*(jnp.asarray(p) for p in planes))
    tvol = tbricks.from_dense(*(torch.from_numpy(p) for p in planes))
    for a, b in zip(tvol, jvol):
        assert _bits(a, b)
    for a, p in zip(tbricks.to_dense(tvol, res), planes):
        assert _bits(a, p)
    rng = np.random.default_rng(2)
    idx = [rng.integers(-3, n + 3, 5000) for n in res]
    inside = [np.clip(i, 0, n - 1) for i, n in zip(idx, res)]
    assert np.array_equal(tbricks.flat_index(res, *(torch.from_numpy(i) for i in inside)).numpy(),
                          np.asarray(jbricks.flat_index(res, *(jnp.asarray(i) for i in inside))))
    got = tbricks.gather(tvol.value, res, *(torch.from_numpy(i) for i in idx), fill=-7.0)
    want = jbricks.gather(jvol.value, res, *(jnp.asarray(i) for i in idx), fill=-7.0)
    assert _bits(got, want)
    assert (got.numpy() == -7.0).any()


@pytest.mark.parametrize("res", RESOLUTIONS)
@pytest.mark.parametrize("neg", [0.0005, 0.02])
def test_skip_rows_equal_jax(res, neg):
    planes = _random_volume(res, 3, neg=neg)
    jvol = jbricks.from_dense(*(jnp.asarray(p) for p in planes))
    tvol = tbricks.from_dense(*(torch.from_numpy(p) for p in planes))
    tmask = tbricks.event_brick_mask(tvol)
    assert np.array_equal(tmask.numpy(), np.asarray(jbricks.event_brick_mask(jvol)))
    tdist = tbricks.brick_distance_rows(tvol, res)
    assert tdist.dtype == torch.int32
    assert np.array_equal(tdist.numpy(), np.asarray(jbricks.brick_distance_rows(jvol, res)))
    assert _bits(tbricks.skip_rows(tvol, res), jbricks.skip_rows(jvol, res))
    assert tbricks.skip_field(tvol, res).equal(tdist)  # the wrapper's plain version on CPU tensors


def _twin_skip_distance(mask: np.ndarray) -> np.ndarray:
    """numpy twin of csrc/skip.cu::skip_distance_kernel: per brick, the
    circular L-inf distance C to the nearest event brick over the cube of
    offsets -5..5 (wrapped indices, as the staged tile holds them), then
    min(max(C - 1, 0), 5)."""
    cap = tbricks.DIST_CAP
    nearest = np.full(mask.shape, cap + 1)
    for dx in range(-cap, cap + 1):
        for dy in range(-cap, cap + 1):
            for dz in range(-cap, cap + 1):
                shifted = np.roll(mask, (-dx, -dy, -dz), axis=(0, 1, 2))  # shifted[b] = mask[b + offset]
                c = max(abs(dx), abs(dy), abs(dz))
                nearest = np.where(shifted, np.minimum(nearest, c), nearest)
    return np.minimum(np.maximum(nearest - 1, 0), cap)


@pytest.mark.parametrize("grid", [(1, 2, 3), (3, 8, 5), (12, 11, 13)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.1])
def test_skip_field_kernel_rule_equals_dilation(grid, density):
    rng = np.random.default_rng(sum(grid))
    mask = rng.random(grid) < density
    want = tbricks.distance_grid(torch.from_numpy(mask)).numpy()
    assert np.array_equal(_twin_skip_distance(mask), want)
    if density == 0.0:
        assert (want == tbricks.DIST_CAP).all()


@pytest.mark.parametrize("res", [(8, 8, 8), (16, 24, 32)])
def test_brick_row_columns_cover_each_lane_once(res):
    """csrc/bricks.cu::brick_column<true>: column c of brick b starts at
    b * 512 + c * 8 and its 8 z voxels are the lanes of (x & 7, y & 7) =
    (c // 8, c % 8): together each lane of the rows once, and each voxel's
    lane is flat_index's."""
    X, Y, Z = res
    nbx, nby, nbz = X // 8, Y // 8, Z // 8
    n = nbx * nby * nbz
    b = np.arange(n)[:, None, None]
    c = np.arange(64)[None, :, None]
    z = np.arange(8)[None, None, :]
    idx = b * 512 + c * 8 + z
    assert (np.bincount(idx.reshape(-1), minlength=n * 512) == 1).all()
    bz, by, bx = b % nbz, (b // nbz) % nby, b // (nby * nbz)
    x, y = bx * 8 + c // 8, by * 8 + c % 8
    want = tbricks.flat_index(res, torch.from_numpy(x + 0 * z), torch.from_numpy(y + 0 * z),
                              torch.from_numpy(bz * 8 + z + 0 * c))
    assert np.array_equal(idx, want.numpy())


def _fuse_rows_and_dense(name, seed=None, cap=512, overflow="flag"):
    """The case's frame fused into the same pre-frame volume (the orbit's
    frames 0-2 fused densely) in both layouts: (dense, rows, flags)."""
    cfg, _, tcfg = _cfgs()
    w2v = np.asarray(cfg.world2volume, np.float32)
    ds = small_dataset(3, degrees_per_frame=1.0)
    pre = tfusion.create_volume(tcfg, "cpu")
    for i in range(3):
        v2c = np.linalg.inv(w2v @ ds.get_pose(i)).astype(np.float32)
        _, _, tr, tt = _poses(v2c)
        tfusion.integrate(pre, tfusion.scale_depth(torch.from_numpy(ds.get_depth(i))), tr, tt, TINTR, tcfg)
    v2c, depth = _case(name)
    _, _, tr, tt = _poses(v2c, seed)
    dm = tfusion.scale_depth(torch.from_numpy(depth))
    rows = tbricks.from_dense(*pre)
    flags = tfusion.integrate_rows(rows, dm, tr, tt, TINTR, tcfg, cap=cap, overflow=overflow)
    dense = tfusion.VolumeState(*(x.clone() for x in pre))
    return pre, dense, rows, flags, (dm, tr, tt, tcfg)


@pytest.mark.parametrize("seed", [None, 4], ids=["no_seed", "gradient_seed"])
@pytest.mark.parametrize("name", CASES)
def test_integrate_rows_equals_dense(name, seed):
    pre, dense, rows, (overflow, n_active), (dm, tr, tt, tcfg) = _fuse_rows_and_dense(name, seed)
    tfusion.integrate(dense, dm, tr, tt, TINTR, tcfg)
    assert not bool(overflow) and int(n_active) > 10
    assert int((dense.weight != pre.weight).sum()) > 500
    for d, r in zip(tbricks.from_dense(*dense), rows):
        assert torch.equal(d.view(torch.int32), r.view(torch.int32))  # every bit, the sign of zero too


@pytest.mark.parametrize("overflow", ["flag", "dense"])
def test_integrate_rows_overflow(overflow):
    pre, dense, rows, (flag, n_active), (dm, tr, tt, tcfg) = _fuse_rows_and_dense("orbit", cap=4,
                                                                                   overflow=overflow)
    assert int(n_active) > 4 and bool(flag)  # the ACTIVE list overflowed in both modes
    if overflow == "dense":  # fused exactly everywhere, as the JAX engine's rerun with every brick in the cap
        tfusion.integrate(dense, dm, tr, tt, TINTR, tcfg)
    else:  # the bricks past the cap unfused, as on the dense layout
        tfusion.integrate_brick(dense, dm, tr, tt, TINTR, tcfg, cap=4, overflow="flag")
    for d, r in zip(tbricks.from_dense(*dense), rows):
        assert torch.equal(d.view(torch.int32), r.view(torch.int32))


@pytest.mark.parametrize("name", CASES)
def test_integrate_rows_matches_jax(name):
    _, jcfg, tcfg = _cfgs()
    v2c, depth = _case(name)
    r, t, tr, tt = _poses(v2c, seed=6)
    jvol, joverflow = jbrick.integrate_rows(jbricks.create(jcfg), jfusion.scale_depth(jnp.asarray(depth)), r, t,
                                            TINTR, jcfg, cap=512)
    tvol = tbricks.create(tcfg, "cpu")
    toverflow, _ = tfusion.integrate_rows(tvol, tfusion.scale_depth(torch.from_numpy(depth)), tr, tt, TINTR, tcfg,
                                          cap=512)
    assert bool(joverflow) == bool(toverflow) is False
    jw, tw = np.asarray(jvol.weight), tvol.weight.numpy()
    assert (jw > 0).sum() > 500
    assert np.mean(jw == tw) >= 0.9999
    same = jw == tw
    for plane in ("value", "grad"):
        np.testing.assert_allclose(getattr(tvol, plane).numpy()[same], np.asarray(getattr(jvol, plane))[same],
                                   atol=1e-5)


def test_integrate_rows_checks_its_layout():
    _, _, tcfg = _cfgs()
    dense = tfusion.create_volume(tcfg, "cpu")
    with pytest.raises(ValueError):
        tfusion.integrate_rows(dense, torch.zeros(120, 160), None, None, TINTR, tcfg, cap=4)
    rows = tbricks.create(tcfg, "cpu")
    with pytest.raises(ValueError):
        tfusion.integrate_rows(rows, torch.zeros(120, 160), None, None, TINTR, tcfg, cap=4, overflow="drop")
    with pytest.raises(ValueError):
        tbricks.brick_grid((60, 64, 64))


def test_brick_state_crosses_from_jax():
    """A JAX engine's brick-layout state (after one frame) in the exchange
    format, into the port's SlamState and back: the rows cross as (NB, 512),
    ``t_prev`` with its 1e9 entries, bit for bit."""
    cfg = small_config(end_frame=1, volume_layout="brick", fusion_mode="brick", raycast_march="hier2",
                       raycast_normals="screen")
    ds = small_dataset(1)
    jeng = JaxEngine(cfg)
    jstate, _ = jeng.process_frame(jeng.init_state(), ds.get_depth(0))
    d = jax_state_to_numpy(jstate)
    assert d["value"].shape == (512, 512) and (d["weight"] > 0).any()
    state = state_from_numpy(d, "cpu")
    assert isinstance(state.volume, tbricks.BrickVolume)
    back = state_to_numpy(state)
    for key in ("value", "grad", "weight", "t_prev", "world2camera_v", "world2camera_g"):
        assert np.array_equal(back[key].view(np.int32), np.asarray(d[key], np.float32).view(np.int32)), key
    dense = tbricks.to_dense(state.volume, cfg.tsdf_size)
    jdense = jeng.dense_volume(jstate)
    assert _bits(dense.weight, jdense.weight)
    assert torch_config(cfg).volume_layout == "brick"
