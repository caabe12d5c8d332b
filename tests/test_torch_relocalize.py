"""The port's relocalization (``ops/tsdf_loss.py``, ``models/relocalize.py``)
against ``xslam_tpu`` on the JAX test's fixture: a 64^3 volume at 0.12 m
fused from 5 oracle-pose frames of the small orbit, frame 0's depth.

Tolerances, and why they are what they are. The per-voxel loss is
ill-conditioned at depth edges: where the bilinear taps straddle a
discontinuity, one float32 ulp of the image coordinate moves the sampled
depth by millimetres. XLA's float32 code on the CPU (which contracts
multiply-adds) lies up to 2.1e-4 of a lane's largest magnitude from the JAX
function run in float64, and the port's float32 up to 3.4e-4 (the poses
differ by an ulp); both lie within 1e-5 of it on all but a few voxels. So:

- fields: the masks equal; every masked voxel within 5e-4 of the lane's
  largest magnitude on the mask, and 99% of them within 1e-5 of it;
- sums: the count equal; the loss within 1e-4 relative, H within 1e-4 of its
  largest entry, the gradient within 3e-4 of its largest entry (JAX's own
  float32 gradient lies 7.8e-5 from its float64 one, the port's 1.8e-4);
- relocalize: xi within 1e-4, the same accept decisions (each printed with
  its relative margin), the first loss within 1e-4 relative and the history
  within 1e-4 relative plus one voxel's worth, 1 / count: a voxel whose error
  sits at a mask threshold may fall on either side in the two packages, and
  then moves the mean by its loss (at most 1) over the count (measured: one
  entry 1.0e-3 relative, 1.8e-5 absolute; the others within 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import SMALL_INTR, small_config, small_dataset
import tests.torch_port_helpers  # noqa: F401  (sets one intra-op thread)
from xslam_tpu.csfd import double as jdc
from xslam_tpu.csfd.single import lift as jlift
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu.models import relocalize as jrel
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops.tsdf_loss import tsdf_loss_hessian as jax_tsdf_loss_hessian
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.models import relocalize as trel
from xslam_tpu_torch.ops import tsdf_loss as ttl
from xslam_tpu_torch.ops.fusion import VolumeConfig
from xslam_tpu_torch.utils import convert

INTR = Intrinsics(SMALL_INTR.fx, SMALL_INTR.fy, SMALL_INTR.cx, SMALL_INTR.cy, SMALL_INTR.width, SMALL_INTR.height)


@pytest.fixture(scope="module")
def scene():
    """tests/test_relocalize.py's fixture, carried to the port as numpy."""
    cfg = small_config(tsdf_size=(64, 64, 64), voxel_size=0.12)
    vol_cfg = jfusion.VolumeConfig(tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    w2v = np.asarray(cfg.world2volume, np.float32)
    ds = small_dataset(5, degrees_per_frame=2.0)
    vol = jfusion.create_volume(vol_cfg)
    integ = jax.jit(lambda v, d, r, t: jfusion.integrate(v, d, r, t, SMALL_INTR, vol_cfg))
    for i in range(5):
        depth_m = jfusion.scale_depth(jnp.asarray(ds.get_depth(i)))
        c2v = jse3.matmul(jlift(jnp.asarray(w2v)), jlift(jnp.asarray(ds.get_pose(i), jnp.float32)))
        v2c = jse3.inverse(c2v)
        vol = integ(vol, depth_m, jse3.rotation(v2c), jse3.translation(v2c))
    depth_m0 = jfusion.scale_depth(jnp.asarray(ds.get_depth(0)))
    return dict(
        j_value=vol.value, j_depth=depth_m0, j_cfg=vol_cfg, c2v=w2v @ ds.get_pose(0),
        value=torch.from_numpy(np.array(vol.value)), depth=torch.from_numpy(np.array(depth_m0)),
        cfg=VolumeConfig(vol_cfg.resolution, vol_cfg.voxel_size, vol_cfg.trunc_dist, vol_cfg.max_weight),
    )


@pytest.fixture(scope="module")
def jax_lgh(scene):
    """JAX's ``loss_grad_hessian`` on the fixture, compiled once for the
    module."""
    s = scene
    return jax.jit(lambda x: jrel.loss_grad_hessian(s["j_value"], s["j_depth"], x, SMALL_INTR, s["j_cfg"]))


def _xi_near(s):
    return (jse3.log_real(s["c2v"]) + 0.02).astype(np.float32)  # test_relocalize.py:78


@pytest.mark.parametrize("pair", [0, 10])  # a diagonal pair (e0, e0) and a cross pair (e1, e3)
def test_field_matches_jax(scene, pair):
    s = scene
    xi = _xi_near(s)
    d1, d2 = jrel._D1[pair], jrel._D2[pair]

    def field():
        c2v = jse3.exp(jdc.DCSFD(jnp.asarray(xi), jnp.asarray(d1), jnp.asarray(d2), jnp.zeros(6)), mod=jdc)
        v2c = jse3.inverse(c2v)
        return jax_tsdf_loss_hessian(s["j_value"], s["j_depth"], jse3.rotation(v2c), jse3.translation(v2c),
                                     SMALL_INTR, s["j_cfg"], return_field=True)

    j_loss, j_mask = jax.jit(field)()
    poses = trel.seeded_poses(torch.from_numpy(xi))
    loss, mask = ttl.tsdf_loss_field(s["value"], s["depth"], poses, INTR, s["cfg"], pair=pair)
    m = np.asarray(j_mask)
    np.testing.assert_array_equal(mask.numpy(), m)
    assert m.sum() > 3000
    for name, a, b in zip(("v", "e1", "e2", "e12"), j_loss, loss):
        a, b = np.asarray(a)[m], b.numpy()[m]
        scale = np.abs(a).max()
        gap = np.abs(a - b) / scale
        print(f"pair {pair} {name}: scale {scale:.6g}, largest gap {gap.max():.3g}, 99th percentile "
              f"{np.quantile(gap, 0.99):.3g}")
        assert gap.max() <= 5e-4, (name, gap.max())
        assert np.quantile(gap, 0.99) <= 1e-5, (name, np.quantile(gap, 0.99))


def test_loss_grad_hessian_matches_jax(scene, jax_lgh):
    s = scene
    xi = _xi_near(s)
    j = jax_lgh(jnp.asarray(xi))
    loss, grad, H, count = trel.loss_grad_hessian(s["value"], s["depth"], torch.from_numpy(xi), INTR, s["cfg"])
    assert int(count) == int(j[3]) > 3000
    np.testing.assert_allclose(float(loss), float(j[0]), rtol=1e-4)
    jg, jH = np.asarray(j[1]), np.asarray(j[2])
    np.testing.assert_allclose(grad.numpy(), jg, rtol=0, atol=3e-4 * np.abs(jg).max())
    np.testing.assert_allclose(H.numpy(), jH, rtol=0, atol=1e-4 * np.abs(jH).max())
    np.testing.assert_array_equal(H.numpy(), H.numpy().T)


def test_value_only_equals_the_pairs(scene, jax_lgh):
    """The trial step's value-only evaluation gives the 21-pair evaluation's
    loss and count bit for bit (both the plain version here), and JAX's loss
    (1e-4 relative) and count."""
    s = scene
    xi = torch.from_numpy(_xi_near(s))
    loss, _, _, count = trel.loss_grad_hessian(s["value"], s["depth"], xi, INTR, s["cfg"])
    v_loss, v_count = trel._value_count(s["value"], s["depth"], xi, INTR, s["cfg"])
    assert v_loss.numpy().tobytes() == loss.numpy().tobytes()
    assert int(v_count) == int(count)
    j = jax_lgh(jnp.asarray(_xi_near(s)))
    assert int(v_count) == int(j[3])
    np.testing.assert_allclose(float(v_loss), float(j[0]), rtol=1e-4)


def _jax_newton(lgh, xi0, iters, damping=1e-4):
    """xslam_tpu/models/relocalize.py:101-123's loop body, step by step, with
    JAX's loss_grad_hessian ``lgh``: the accept decisions and both means."""
    xi = jnp.asarray(xi0)
    count0 = lgh(xi)[3]
    lam = jnp.float32(damping)
    out = []
    for _ in range(iters):
        loss, g, H, count = lgh(xi)
        mean = loss / jnp.maximum(count, 1)
        xi_new = xi - jnp.linalg.solve(H + lam * jnp.eye(6, dtype=jnp.float32), g)
        loss_new, _, _, count_new = lgh(xi_new)
        mean_new = loss_new / jnp.maximum(count_new, 1)
        accept = bool((mean_new < mean) & (count_new >= (0.7 * count0).astype(count_new.dtype))
                      & ~jnp.any(jnp.isnan(xi_new)))
        xi = xi_new if accept else xi
        lam = jnp.maximum(lam * 0.5, 1e-6) if accept else jnp.minimum(lam * 4.0, 1e2)
        out.append((accept, float(mean), float(mean_new)))
    return out


def test_relocalize_matches_jax(scene, jax_lgh):
    s = scene
    xi_true = jse3.log_real(s["c2v"]).astype(np.float32)
    rng = np.random.default_rng(1)  # test_relocalize.py:118-121
    xi0 = xi_true + np.concatenate([0.04 * rng.normal(size=3), 0.01 * rng.normal(size=3)]).astype(np.float32)
    iters = 4
    j = jax.jit(lambda x: jrel.relocalize(s["j_value"], s["j_depth"], x, SMALL_INTR, s["j_cfg"], iters=iters))(
        jnp.asarray(xi0))
    out, accepts, (means, means_new) = trel.newton(s["value"], s["depth"], xi0, INTR, s["cfg"], iters=iters)
    steps = _jax_newton(jax_lgh, xi0, iters)
    for i, ((j_accept, j_mean, j_new), accept, mean, new) in enumerate(zip(steps, accepts, means, means_new)):
        print(f"iteration {i}: accept JAX {j_accept} port {bool(accept)}; relative margin of mean_new < mean: "
              f"JAX {(j_mean - j_new) / j_mean:.3g}, port {(float(mean) - float(new)) / float(mean):.3g}")
        assert bool(accept) == j_accept, i
    carried = convert.reloc_result_from_numpy(
        {"xi": np.array(j.xi), "loss_history": np.array(j.loss_history), "count": int(j.count)}, "cpu")
    np.testing.assert_allclose(out.xi.numpy(), carried.xi.numpy(), rtol=0, atol=1e-4)
    assert convert.reloc_result_to_numpy(carried)["count"] == int(j.count)
    history, j_history = out.loss_history.numpy(), carried.loss_history.numpy()
    print("loss history: JAX", j_history, "port", history)
    np.testing.assert_allclose(history[0], j_history[0], rtol=1e-4)
    np.testing.assert_allclose(history, j_history, rtol=1e-4, atol=1.0 / int(j.count))
    assert abs(int(out.count) - int(j.count)) <= 1
    assert out.loss_history.shape == (iters + 1,)
    assert np.all(np.diff(out.loss_history.numpy()) < 1e-5)


def _twin_sum(terms: np.ndarray) -> float:
    """csrc/tsdf_loss.cu's order of one sum over the band's terms (in band
    order): thread t of block b adds entries b * LOSS_THREADS + t, then
    + LOSS_BLOCKS * LOSS_THREADS, ... in double; the block adds its
    LOSS_THREADS columns in order; the last block adds blocks g, g + 4, ...
    for each of four groups, then the groups in order; one rounding to
    float32."""
    blocks, voxels = ttl.LOSS_BLOCKS, ttl.LOSS_THREADS
    per = voxels * blocks
    padded = np.zeros(max(1, -(-terms.size // per)) * per)
    padded[:terms.size] = terms
    steps = padded.reshape(-1, blocks, voxels)
    column = np.zeros((blocks, voxels))
    for k in range(steps.shape[0]):  # each position's band entries in order
        column += steps[k]
    block = np.zeros(blocks)
    for c in range(voxels):  # the columns in order
        block += column[:, c]
    groups = [0.0] * ttl.LOSS_GROUPS
    for b in range(blocks):
        groups[b % ttl.LOSS_GROUPS] += block[b]
    total = groups[0]
    for g in groups[1:]:
        total += g
    return float(np.float32(total))


def test_block_order_depends_on_the_shape_alone(scene):
    """B12's grid is fixed, so the order of every sum is a function of the
    band's length alone (the voxels that pass gt's test, in flat order): the
    numpy twin of that order gives the float64 sum within a float32 ulp, on
    the fixture's terms in band order, on the same terms shuffled and on a
    band longer than the grid's threads (each thread adds 40 terms), and
    the plain version's sum of the fixture's terms."""
    s = scene
    poses = trel.seeded_poses(torch.from_numpy(_xi_near(s)))
    loss, mask = ttl.tsdf_loss_field(s["value"], s["depth"], poses, INTR, s["cfg"], pair=0)
    band = ttl.make_band(s["value"])
    flat = band.index[: int(band.count)].long()
    terms = torch.where(mask, loss.e12, 0.0).reshape(-1)[flat].numpy().astype(np.float64)
    assert 3000 < terms.size < ttl.LOSS_BLOCKS * ttl.LOSS_THREADS  # the fixture's band: one entry a thread at most
    sums, _ = ttl.tsdf_loss_hessian_plain(s["value"], s["depth"], poses[:1], INTR, s["cfg"])
    for t in (terms, np.random.default_rng(0).permutation(terms), np.tile(terms, 40)):
        twin = _twin_sum(t)
        want = np.float32(np.sum(t))
        assert abs(np.float32(twin) - want) <= np.spacing(np.abs(want)), (twin, want)
    assert abs(np.float32(_twin_sum(terms)) - sums[2].numpy()) <= np.spacing(np.abs(sums[2].numpy()))
    # and the JAX package's Hessian entry of the same pair, 1e-4 relative (the module's tolerance for H)
    xi = jnp.asarray(_xi_near(s))
    v2c = jse3.inverse(jse3.exp(jdc.DCSFD(xi, jnp.asarray(jrel._D1[0]), jnp.asarray(jrel._D2[0]), jnp.zeros(6)),
                                mod=jdc))
    j = jax_tsdf_loss_hessian(s["j_value"], s["j_depth"], jse3.rotation(v2c), jse3.translation(v2c), SMALL_INTR,
                              s["j_cfg"])
    np.testing.assert_allclose(_twin_sum(terms), float(j.hessian), rtol=1e-4)


def test_pose_packing(scene):
    """pack_pose lays out R and t lane after lane; one pose packs as P = 1;
    a pair's unpacked pose is the JAX package's volume->camera pose of the
    same seeds (rtol=1e-5, atol=1e-6, as tests/test_torch_csfd_double.py
    holds SE(3))."""
    xi = _xi_near(scene)
    poses = trel.seeded_poses(torch.from_numpy(xi))
    assert poses.shape == (21, ttl.POSE_FLOATS) and poses.is_contiguous()
    r, t = ttl._unpack_pose(poses[3])
    again = ttl.pack_pose(r, t)
    assert again.shape == (1, ttl.POSE_FLOATS) and torch.equal(again[0], poses[3])
    v2c = jse3.inverse(jse3.exp(jdc.DCSFD(jnp.asarray(xi), jnp.asarray(jrel._D1[3]), jnp.asarray(jrel._D2[3]),
                                          jnp.zeros(6)), mod=jdc))
    for port, jax_lanes in ((r, jse3.rotation(v2c)), (t, jse3.translation(v2c))):
        for a, b in zip(port, jax_lanes):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_tsdf_loss_at_the_true_pose_matches_jax(scene):
    """The real-valued path (``tsdf_loss``) at the true pose, as
    tests/test_relocalize.py:45-66 evaluates it: the count equal, the loss
    within 1e-4 relative, the mean loss near zero; gradient and Hessian 0."""
    from xslam_tpu.ops.tsdf_loss import tsdf_loss as jax_tsdf_loss

    s = scene
    v2c = np.linalg.inv(s["c2v"]).astype(np.float32)
    j = jax_tsdf_loss(s["j_value"], s["j_depth"], jnp.asarray(v2c[:3, :3]), jnp.asarray(v2c[:3, 3]), SMALL_INTR,
                      s["j_cfg"])
    t = ttl.tsdf_loss(s["value"], s["depth"], torch.from_numpy(v2c[:3, :3].copy()),
                      torch.from_numpy(v2c[:3, 3].copy()), INTR, s["cfg"])
    assert int(t.count) == int(j.count) > 3000
    np.testing.assert_allclose(float(t.loss), float(j.loss), rtol=1e-4)
    assert float(t.loss) / int(t.count) < 0.01
    assert float(t.grad) == float(j.grad) == 0.0 and float(t.hessian) == float(j.hessian) == 0.0


def test_tsdf_loss_hessian_one_pair_matches_jax(scene):
    """``tsdf_loss_hessian`` at one hyper-dual pose (a cross pair's seeds),
    the JAX call's contract: loss, the directional gradient and the Hessian
    entry, the count (tolerances as the module's docstring gives them)."""
    s = scene
    xi = _xi_near(s)
    d1, d2 = jrel._D1[12], jrel._D2[12]
    c2v = jse3.exp(jdc.DCSFD(jnp.asarray(xi), jnp.asarray(d1), jnp.asarray(d2), jnp.zeros(6)), mod=jdc)
    v2c = jse3.inverse(c2v)
    j = jax_tsdf_loss_hessian(s["j_value"], s["j_depth"], jse3.rotation(v2c), jse3.translation(v2c), SMALL_INTR,
                              s["j_cfg"])
    lanes = [np.array(a) for a in (xi, d1, d2, np.zeros(6, np.float32))]
    from xslam_tpu_torch.csfd import double as tdc
    from xslam_tpu_torch.geometry import se3 as tse3

    tv2c = tse3.inverse(tse3.exp(tdc.DCSFD(*map(torch.from_numpy, lanes)), mod=tdc))
    t = ttl.tsdf_loss_hessian(s["value"], s["depth"], tse3.rotation(tv2c), tse3.translation(tv2c), INTR, s["cfg"])
    # and at JAX's own pose lanes, carried across as numpy
    r = convert.dcsfd_from_numpy([np.array(a) for a in jse3.rotation(v2c)], "cpu")
    tr = convert.dcsfd_from_numpy([np.array(a) for a in jse3.translation(v2c)], "cpu")
    np.testing.assert_array_equal(convert.dcsfd_to_numpy(r)[3], np.array(jse3.rotation(v2c).e12))
    same_pose = ttl.tsdf_loss_hessian(s["value"], s["depth"], r, tr, INTR, s["cfg"])
    for out in (t, same_pose):
        assert int(out.count) == int(j.count)
        np.testing.assert_allclose(float(out.loss), float(j.loss), rtol=1e-4)
        np.testing.assert_allclose(float(out.hessian), float(j.hessian), rtol=1e-4)
        np.testing.assert_allclose(float(out.grad), float(j.grad), rtol=3e-4)


def test_wrappers_never_fall_back():
    """A tensor neither on the CPU nor on a CUDA device is refused, not routed
    to the plain version."""
    value = torch.zeros((8, 8, 8), device="meta")
    depth = torch.zeros((6, 6), device="meta")
    poses = torch.zeros((21, ttl.POSE_FLOATS), device="meta")
    cfg = VolumeConfig((8, 8, 8), 0.1, 0.3, 100)
    for call in (lambda: ttl.tsdf_loss_pairs(value, depth, poses, INTR, cfg),
                 lambda: ttl.tsdf_loss_field(value, depth, poses, INTR, cfg)):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()
