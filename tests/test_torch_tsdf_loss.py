"""B12's band and shared lanes (``ops/tsdf_loss.py``, ``csrc/tsdf_loss.cu``)
on the CPU, on the fixture of ``tests/test_torch_relocalize.py`` (a 64^3
volume at 0.12 m fused from 5 oracle-pose frames, frame 0's depth):

- the band (the voxels that pass gt's test, in flat order) against
  ``torch.nonzero``: the plain version, and a numpy twin of the card's band
  pass (a warp's segment counted by ballots, tiles summed before their own,
  each warp's voxels ranked by its ballots);
- ``seeded_poses``' lanes, which the kernel shares: pair (j, k)'s v lanes are
  pair 0's, its e1 lanes pair j's e1 lanes and its e2 lanes pair k's, bit for
  bit;
- the shared-lane arithmetic (``_shared_lanes_plain``) against
  ``_field_plain``'s four lanes, bit for bit on the mask, for every seed pair
  and for one pose;
- ``newton`` over its band against ``newton`` through the plain version,
  which lists its own voxels: the same accepts and ``xi`` bit for bit, and
  the JAX package's accepts;
- a band that is not of the value plane refused on the CPU as on the card.
"""

import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (sets one intra-op thread)
from xslam_tpu.geometry import se3 as jse3
from tests.test_torch_relocalize import INTR, _jax_newton, _xi_near, jax_lgh, scene  # noqa: F401  (fixtures)
from xslam_tpu_torch.models import relocalize as trel
from xslam_tpu_torch.ops import tsdf_loss as ttl

PAIRS = [(j, k) for j, k in zip(ttl.SEED_J, ttl.SEED_K)]


def _band_twin(gt: np.ndarray):
    """The card's band pass in numpy: each warp counts its segment of
    BAND_SEGMENT voxels (rounds of 32 lanes, a ballot a round), each tile of
    BAND_WARPS segments sums the counts of the tiles before it, and each warp
    with band voxels writes them at its offset, its rounds in order, a
    round's lanes ranked by the ballot's lower bits. ``(indices, count)``."""
    flat = gt.ravel()
    with np.errstate(invalid="ignore"):
        ok = (flat != 0) & (np.abs(flat) <= 0.95)
    n = flat.size
    tiles = -(-n // ttl.BAND_TILE)
    padded = np.zeros(tiles * ttl.BAND_TILE, bool)
    padded[:n] = ok
    ballots = padded.reshape(tiles, ttl.BAND_WARPS, ttl.BAND_SEGMENT // 32, 32)  # tile, warp, round, lane
    warp_counts = ballots.sum(axis=(2, 3))
    tile_counts = warp_counts.sum(axis=1)
    out = np.full(n, -1, np.int64)
    for tile in range(tiles):
        offset = int(tile_counts[:tile].sum())
        for warp in range(ttl.BAND_WARPS):
            at, base = offset, (tile * ttl.BAND_WARPS + warp) * ttl.BAND_SEGMENT
            offset += int(warp_counts[tile, warp])
            if warp_counts[tile, warp] == 0:
                continue
            for r, ballot in enumerate(ballots[tile, warp]):
                lanes = np.nonzero(ballot)[0]
                out[at + np.cumsum(ballot)[lanes] - 1] = base + 32 * r + lanes
                at += lanes.size
    count = int(tile_counts.sum())
    assert (out[:count] >= 0).all() and (out[count:] == -1).all()
    return out[:count], count


def _odd_volume(scene):
    """The fixture with NaN, +-inf, +-0 and +-0.95 (and the floats next to
    0.95) written over some of its voxels."""
    v = scene["value"].clone().reshape(-1)
    rng = np.random.default_rng(3)
    specials = [np.nan, np.inf, -np.inf, 0.0, -0.0, 0.95, -0.95, np.nextafter(np.float32(0.95), np.float32(1)),
                np.nextafter(np.float32(0.95), np.float32(0)), -np.nextafter(np.float32(0.95), np.float32(1))]
    at = rng.choice(v.numel(), size=4000, replace=False)
    v[torch.from_numpy(at)] = torch.tensor(np.resize(np.array(specials, np.float32), at.size))
    return v.reshape(scene["value"].shape)


@pytest.mark.parametrize("case", ["fixture", "ragged crop", "NaN and 0.95"])
def test_band_is_nonzero_in_flat_order(scene, case):
    value = {"fixture": lambda: scene["value"],
             "ragged crop": lambda: scene["value"][3:40, 5:46, 7:52].contiguous(),
             "NaN and 0.95": lambda: _odd_volume(scene)}[case]()
    want = torch.nonzero(((value != 0) & (value.abs() <= 0.95)).reshape(-1)).reshape(-1)
    assert want.numel() > 1000
    band = ttl.make_band(value)  # the plain version on the CPU
    assert band.index.shape == (value.numel(),) and band.index.dtype == torch.int32
    assert int(band.count) == want.numel()
    assert torch.equal(band.index[: int(band.count)].long(), want)
    twin, count = _band_twin(value.numpy())
    assert count == want.numel() and np.array_equal(twin, want.numpy())
    if case == "NaN and 0.95":
        flat = value.reshape(-1)[want]
        assert not torch.isnan(flat).any() and (flat != 0).all() and (flat.abs() <= 0.95).all()
        assert (value.reshape(-1) == 0.95).any() and (value.reshape(-1) == 0.95)[want].any()


@pytest.mark.parametrize("scale", [0.0, 1e-3, 0.1, 1.0])
def test_seeded_poses_share_their_lanes(scene, scale):
    """Pair (j, k)'s v lanes are pair 0's, its e1 lanes pair j's and its e2
    lanes pair k's e1 lanes, bit for bit (the lanes B12 reads once), at the
    fixture's pose and at random ones."""
    rng = np.random.default_rng(int(scale * 1000) + 7)
    for xi in [_xi_near(scene)] + [(scale * rng.normal(size=6)).astype(np.float32) for _ in range(10)]:
        lanes = trel.seeded_poses(torch.from_numpy(xi)).view(21, 4, 12).view(torch.int32)
        for p, (j, k) in enumerate(PAIRS):
            assert torch.equal(lanes[p, 0], lanes[0, 0]), (xi, p)
            assert torch.equal(lanes[p, 1], lanes[j, 1]), (xi, p)
            assert torch.equal(lanes[p, 2], lanes[k, 1]), (xi, p)


@pytest.fixture(scope="module")
def shared(scene):
    """The shared lanes of the 21 seed pairs at the fixture's near pose, at
    the band's voxels."""
    s = scene
    poses = trel.seeded_poses(torch.from_numpy(_xi_near(s)))
    band = ttl.band_plain(s["value"])
    loss, mask = ttl._shared_lanes_plain(s["value"], s["depth"], poses, INTR, s["cfg"], band=band)
    return poses, band, loss, mask


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("pair", range(21))
def test_shared_lanes_equal_the_four_lane_field(scene, shared, pair):
    """Pair p's (v, f[j], f[k], s[p]) of the shared lanes are
    ``_field_plain``'s four lanes of pair p, bit for bit wherever the mask
    holds, and the masks are equal."""
    s = scene
    poses, band, loss, mask = shared
    j, k = PAIRS[pair]
    flat = band.index[: int(band.count)].long()
    field, f_mask = ttl._field_plain(s["value"], s["depth"], poses[pair], INTR, s["cfg"])
    assert torch.equal(f_mask.reshape(-1)[flat], mask) and int(mask.sum()) > 3000
    assert int(f_mask.sum()) == int(mask.sum())
    for lane, mine in zip(field, (loss.v, loss.f[j], loss.f[k], loss.s[pair])):
        assert torch.equal(_bits(lane.reshape(-1)[flat][mask]), _bits(mine[mask])), (pair, j, k)


def test_shared_lanes_of_one_pose(scene):
    """One hyper-dual pose (a cross pair's seeds, as ``tsdf_loss_hessian``
    takes it): its e1 and e2 lanes are two directions, and the shared lanes
    are ``_field_plain``'s bit for bit on the mask."""
    s = scene
    poses = trel.seeded_poses(torch.from_numpy(_xi_near(s)))[12:13].contiguous()
    band = ttl.band_plain(s["value"])
    flat = band.index[: int(band.count)].long()
    loss, mask = ttl._shared_lanes_plain(s["value"], s["depth"], poses, INTR, s["cfg"])
    assert loss.f.shape == (2, flat.numel()) and loss.s.shape == (1, flat.numel())
    field, f_mask = ttl._field_plain(s["value"], s["depth"], poses[0], INTR, s["cfg"])
    assert torch.equal(f_mask.reshape(-1)[flat], mask)
    for lane, mine in zip(field, (loss.v, loss.f[0], loss.f[1], loss.s[0])):
        assert torch.equal(_bits(lane.reshape(-1)[flat][mask]), _bits(mine[mask]))
    with pytest.raises(ValueError, match="seed pairs or one pose"):
        ttl._shared_lanes_plain(s["value"], s["depth"], poses.repeat(2, 1), INTR, s["cfg"])


def test_shared_lane_sums_are_the_plain_sums(scene, shared):
    """The 28 sums of the shared lanes over the band, in float64 and rounded
    once, equal the plain version's (which lists the voxels that pass gt's
    test itself and runs each pair's four lanes over them), and the wrapper
    given the band gives the same on the CPU."""
    s = scene
    poses, band, loss, mask = shared
    msum = lambda a: torch.where(mask, a, 0.0).to(torch.float64).sum(-1)  # noqa: E731
    mine = torch.cat([msum(loss.v)[None], msum(loss.f), msum(loss.s)]).to(torch.float32)
    plain, count = ttl.tsdf_loss_hessian_plain(s["value"], s["depth"], poses, INTR, s["cfg"])
    banded, b_count = ttl.tsdf_loss_pairs(s["value"], s["depth"], poses, INTR, s["cfg"], band=band)
    assert int(count) == int(b_count) == int(mask.sum())
    assert torch.equal(plain, mine) and torch.equal(banded, plain)
    value, v_count = ttl.tsdf_loss_pairs(s["value"], s["depth"], poses, INTR, s["cfg"], mode="value", band=band)
    assert torch.equal(value, plain[:1]) and int(v_count) == int(count)


def test_newton_over_a_band_is_newton_over_the_volume(scene, jax_lgh):
    """``newton`` makes its band once and passes it to every evaluation of
    B12's wrapper; through the plain version (``pairs``, which lists its own
    voxels from the volume and takes no band, as the card's comparison runs
    it) it takes the same accepts to the same ``xi``, bit for bit, and the
    JAX package's accepts (``tests/test_torch_relocalize.py`` holds the
    loop's numbers to JAX's)."""
    s = scene
    xi_true = jse3.log_real(s["c2v"]).astype(np.float32)
    rng = np.random.default_rng(1)
    xi0 = (xi_true + np.concatenate([0.04 * rng.normal(size=3), 0.01 * rng.normal(size=3)])).astype(np.float32)
    iters = 4

    band_out, band_acc, band_means = trel.newton(s["value"], s["depth"], xi0, INTR, s["cfg"], iters=iters)
    vol_out, vol_acc, vol_means = trel.newton(s["value"], s["depth"], xi0, INTR, s["cfg"], iters=iters,
                                              pairs=ttl.tsdf_loss_hessian_plain)
    assert torch.equal(band_acc, vol_acc) and band_acc.any()
    assert torch.equal(band_out.xi, vol_out.xi)
    assert torch.equal(band_out.loss_history, vol_out.loss_history) and int(band_out.count) == int(vol_out.count)
    assert all(torch.equal(a, b) for a, b in zip(band_means, vol_means))
    steps = _jax_newton(jax_lgh, xi0, iters)
    assert [bool(a) for a in band_acc] == [a for a, _, _ in steps]


@pytest.mark.parametrize("bad", ["length", "dtype", "count"])
def test_a_band_of_another_plane_is_refused(scene, shared, bad):
    """``tsdf_loss_pairs`` holds a given band to ``make_band``'s layout for
    this value plane (its length the volume's voxels, int32 indices, a 0-d
    count) on CPU tensors as on CUDA ones, though the plain version lists its
    own band."""
    s = scene
    poses, band, _, _ = shared
    index, count = band
    wrong = {"length": ttl.Band(index[:-1], count), "dtype": ttl.Band(index.long(), count),
             "count": ttl.Band(index, count[None])}[bad]
    with pytest.raises(ValueError, match="make_band of this value plane"):
        ttl.tsdf_loss_pairs(s["value"], s["depth"], poses, INTR, s["cfg"], band=wrong)


def test_constants_follow_the_kernel_source():
    """The wrapper's and the twins' constants are the kernel's: its block and
    grid (the sums' order), the band pass's segment and warps, the most
    pairs and the pose's floats; the resource report's block sizes are the
    kernels' own."""
    import re

    from xslam_tpu_torch.apps.kernel_resources import BLOCK_THREADS
    from xslam_tpu_torch.ops.kernels import CSRC_DIR

    text = (CSRC_DIR / "tsdf_loss.cu").read_text()
    cu = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert (cu["LOSS_THREADS"], cu["LOSS_BLOCKS"], cu["GROUPS"]) == (ttl.LOSS_THREADS, ttl.LOSS_BLOCKS,
                                                                     ttl.LOSS_GROUPS)
    assert (cu["BAND_SEGMENT"], cu["BAND_THREADS"] // 32) == (ttl.BAND_SEGMENT, ttl.BAND_WARPS)
    assert (cu["MAX_PAIRS"], cu["POSE_FLOATS"]) == (ttl.MAX_PAIRS, ttl.POSE_FLOATS)
    assert BLOCK_THREADS["tsdf_loss_kernel"] == cu["LOSS_THREADS"]
    assert BLOCK_THREADS["tsdf_field_kernel"] == cu["FIELD_THREADS"]
    assert BLOCK_THREADS["tsdf_band_count_kernel"] == BLOCK_THREADS["tsdf_band_list_kernel"] == cu["BAND_THREADS"]
    # the seed pairs are the JAX package's, in its order
    from xslam_tpu.models import relocalize as jrel

    assert np.array_equal(trel._D1, jrel._D1) and np.array_equal(trel._D2, jrel._D2)
    assert trel._D1.dtype == jrel._D1.dtype == np.float32
