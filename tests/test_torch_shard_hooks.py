"""The sharded engine's slab hooks (B19) in the port against the JAX
functions that the sharded stages call, on the CPU, one process: a 2-rank
split of the small 64^3 volume (slabs of 32 rows, a halo of
``halo_width`` = 6 rows, wrapping at the volume's ends as the ring does),
fused by the port's engine over 3 frames of the small sweep with a seeded
pose derivative.

- Fusion of each slab at ``x_offset = jnp.int32(32 k)`` (the sharded engine's
  traced offset, so ``x_offset * voxel_size`` rounds once in float32), run
  eagerly: the voxels' positions in K2's and in the brick pass's rounding
  bit for bit; brick fusion's classes exactly, its volume the port's
  whole-volume fusion's slab bit for bit; both volumes against JAX within
  K2's tolerance (weights equal on >= 99.99% of voxels, value and grad
  within 1e-5 where they agree: XLA and PyTorch may round a multiply-add
  apart, as ``tests/test_torch_fusion.py`` finds on the whole volume).
- The fixed march over each slab with its halo under a ``ShardSpec``: the
  event step index equal on >= 99.9% of rays and the times within 1e-6 m,
  as ``tests/test_torch_raycast.py`` holds the whole-volume march (XLA
  contracts ``0.2 + k * step`` into one fused multiply-add).
- ``refine(spec=)`` of the owning slab at the ranks' minimum crossing: the
  masks equal on >= 99.5% of pixels and the maps within 1e-4 where both are
  valid (derivative lanes relative to their largest entry), as the whole
  volume's refine is held.
- The ICP system of each rank's column block, and the tail over the blocks'
  summed system: A and b within rtol 1e-4 of each lane's largest entry and
  the inlier counts within 0.1%; ``x`` within rtol 1e-3, the pose within
  2e-5 and its derivative lane within 1e-3 of its largest entry
  (``tests/test_torch_icp.py``'s tolerances)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import SMALL_INTR, small_config, small_dataset
from tests.torch_port_helpers import seeded_pose_direction, to_jax, to_torch, torch_config
from xslam_tpu.csfd.single import CSFD as JCSFD
from xslam_tpu.csfd.single import lift as jlift
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops import fusion_brick as jbrick
from xslam_tpu.ops import icp as jicp
from xslam_tpu.ops import raycast as jray
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.models.kinfu import XSlamEngine
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import fusion_brick as tbrick
from xslam_tpu_torch.ops import icp as ticp
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops import raycast as tray
from xslam_tpu_torch.parallel.sharded import halo_width

RANKS = 2
TINTR = Intrinsics(*SMALL_INTR)
BRICK_CAP = 1024


def _cfgs(local_x=None):
    cfg = small_config()
    res = tuple(cfg.tsdf_size) if local_x is None else (local_x,) + tuple(cfg.tsdf_size[1:])
    j = jfusion.VolumeConfig(res, cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    t = tfusion.VolumeConfig(res, cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    return cfg, j, t


@pytest.fixture(scope="module")
def scene():
    """The port's engine over 3 frames; the next frame's depth, pose and
    current maps; the camera at the last pose."""
    cfg = torch_config(small_config())
    ds = small_dataset(4, degrees_per_frame=1.0)
    engine = XSlamEngine(cfg, device="cpu")
    state = engine.init_state()
    for i in range(3):
        state, _ = engine.process_frame(state, ds.get_depth(i))
    w2v = np.asarray(cfg.world2volume, np.float32)
    c2w = np.linalg.inv(ds.get_pose(0)) @ ds.get_pose(3)
    c2v = JCSFD(jnp.asarray((w2v @ c2w).astype(np.float32)), jnp.asarray(seeded_pose_direction(3)))
    v2c = jse3.inverse(c2v)
    return dict(engine=engine, state=state, depth=ds.get_depth(3), v2c=v2c, c2v=c2v, w2v=w2v)


def _slab(plane: torch.Tensor, k: int, h: int = 0) -> np.ndarray:
    """Rows [32 k - h, 32 (k + 1) + h) of a (64, Y, Z) plane, wrapping at its ends as the ring does."""
    X = plane.shape[0]
    local = X // RANKS
    rows = np.arange(k * local - h, (k + 1) * local + h) % X
    return plane.numpy()[rows].copy()


def _fused_whole(scene):
    """The port's dense fusion of the frame into the whole volume (a copy): brick fusion's bits on any slab."""
    if "whole" not in scene:
        _, _, tcfg = _cfgs()
        r, t = jse3.rotation(scene["v2c"]), jse3.translation(scene["v2c"])
        vol = tfusion.VolumeState(*(p.clone() for p in scene["state"].volume))
        tfusion.integrate(vol, tfusion.scale_depth(torch.from_numpy(scene["depth"])), to_torch(r), to_torch(t),
                          TINTR, tcfg)
        scene["whole"] = vol
    return scene["whole"]


def _assert_k2_class(tvol, jvol):
    """K2's tolerance against the JAX package (tests/test_torch_fusion.py)."""
    tw, jw = tvol.weight.numpy(), np.asarray(jvol.weight)
    assert np.mean(tw == jw) >= 0.9999
    same = tw == jw
    for t, j in ((tvol.value, jvol.value), (tvol.grad, jvol.grad)):
        np.testing.assert_allclose(t.numpy()[same], np.asarray(j)[same], atol=1e-5)


@pytest.mark.parametrize("k", range(RANKS))
def test_slab_voxel_positions_bit_equal(k):
    """The hook itself: a slab's voxel x in K2's rounding (``gx + x_offset *
    voxel_size`` with a traced int32 offset, one float32 rounding of the
    product) and in the brick pass's (``((x + x_offset) + 0.5) *
    voxel_size``), bit for bit against the JAX expressions run eagerly."""
    _, jcfg, _ = _cfgs(64 // RANKS)
    vs = jcfg.voxel_size
    jx = np.asarray(jfusion._voxel_grid_coords(jcfg.resolution, vs)[0] + jnp.int32(32 * k) * vs).reshape(-1)
    tx = ((torch.arange(32, dtype=torch.float32) + 0.5) * vs + kernels.slab_shift_m(32 * k, vs)).numpy()
    np.testing.assert_array_equal(tx.view(np.int32), jx.view(np.int32))
    jb = np.asarray((jnp.arange(32, dtype=jnp.float32) + 0.5 + jnp.int32(32 * k)) * vs)
    tb = ((torch.arange(32, dtype=torch.float32) + 0.5 + 32 * k) * vs).numpy()
    np.testing.assert_array_equal(tb.view(np.int32), jb.view(np.int32))


@pytest.fixture(scope="module")
def jax_slabs(scene):
    """JAX's fusion of each slab, dense and brick, and its brick classes, each
    function jitted once with the offset traced (as the sharded stage traces
    it) and run for both slabs."""
    _, jcfg, _ = _cfgs(64 // RANKS)
    r, t = jse3.rotation(scene["v2c"]), jse3.translation(scene["v2c"])
    jdm = jfusion.scale_depth(jnp.asarray(scene["depth"]))
    dense = jax.jit(functools.partial(jfusion.integrate, intr=SMALL_INTR, cfg=jcfg))
    brick = jax.jit(functools.partial(jbrick.integrate_brick, intr=SMALL_INTR, cfg=jcfg, cap=BRICK_CAP))
    classes = jax.jit(functools.partial(jbrick.classify_bricks, intr=SMALL_INTR, cfg=jcfg, res=jcfg.resolution))
    out = []
    for k in range(RANKS):
        slab = jfusion.VolumeState(*(jnp.asarray(_slab(p, k)) for p in scene["state"].volume))
        off = jnp.int32(32 * k)
        out.append(dict(dense=dense(slab, jdm, r, t, x_offset=off), brick=brick(slab, jdm, r, t, x_offset=off),
                        cls=np.asarray(classes(jdm, r.v, t.v, x_offset=off))))
    return out


@pytest.mark.parametrize("k", range(RANKS))
def test_slab_fusion(scene, jax_slabs, k):
    """K2's plain path on a slab against ``integrate(x_offset=jnp.int32(32 k))``
    within K2's tolerance (weights equal on >= 99.99% of voxels, value and
    grad within 1e-5 where they agree: XLA and PyTorch may round a fused
    multiply-add apart, as on the whole volume)."""
    _, jcfg, tcfg = _cfgs(64 // RANKS)
    state, v2c = scene["state"], scene["v2c"]
    r, t = jse3.rotation(v2c), jse3.translation(v2c)
    depth = scene["depth"]
    slab = [_slab(p, k) for p in state.volume]
    jvol = jax_slabs[k]["dense"]
    tvol = tfusion.VolumeState(*(torch.from_numpy(p.copy()) for p in slab))
    tfusion.integrate(tvol, tfusion.scale_depth(torch.from_numpy(depth)), to_torch(r), to_torch(t), TINTR, tcfg,
                      x_offset=32 * k)
    assert int((tvol.weight.numpy() != slab[2]).sum()) > 1000  # the frame lands on this slab
    _assert_k2_class(tvol, jvol)


@pytest.mark.parametrize("k", range(RANKS))
def test_slab_brick_fusion(scene, jax_slabs, k):
    """Brick fusion of a slab: its classes equal JAX's
    ``classify_bricks(x_offset=jnp.int32(32 k))`` on >= 99.9% of bricks (under
    jit XLA may move a bound by an ulp: tests/test_torch_fusion_brick.py; on
    these inputs every brick agrees), its volume is the
    port's whole-volume dense fusion's slab bit for bit (the brick pass
    places a voxel at the whole volume's own centre) and JAX's slab brick
    fusion within K2's tolerance."""
    _, jcfg, tcfg = _cfgs(64 // RANKS)
    state, v2c = scene["state"], scene["v2c"]
    r, t = jse3.rotation(v2c), jse3.translation(v2c)
    depth = scene["depth"]
    slab = [_slab(p, k) for p in state.volume]
    jcls = jax_slabs[k]["cls"]
    jvol, jflag = jax_slabs[k]["brick"]
    tdm = tfusion.scale_depth(torch.from_numpy(depth))
    pose = kernels.fusion_pose(to_torch(r), to_torch(t))
    tcls = tbrick.classify_bricks(tbrick.depth_mips(tdm), pose, TINTR, tcfg, BRICK_CAP, x_offset=32 * k).cls
    assert np.mean(tcls.numpy() == jcls) >= 0.999
    assert int((tcls == tbrick.ACTIVE).sum()) > 0
    tvol = tfusion.VolumeState(*(torch.from_numpy(p.copy()) for p in slab))
    flag, _ = tfusion.integrate_brick(tvol, tdm, to_torch(r), to_torch(t), TINTR, tcfg, cap=BRICK_CAP,
                                      x_offset=32 * k)
    assert not bool(flag) and not bool(jflag)
    whole = _fused_whole(scene)
    for p, w in zip(tvol, whole):
        assert torch.equal(p.view(torch.int32), w[32 * k:32 * (k + 1)].view(torch.int32))
    _assert_k2_class(tvol, jvol)


@pytest.fixture(scope="module")
def marched(scene):
    """Each slab's march with its halo, in JAX and in the port, and the
    ranks' minima."""
    cfg, jcfg, tcfg = _cfgs()
    state, c2v = scene["state"], scene["c2v"]
    h = halo_width(tcfg, 64 // RANKS)
    v2w = jse3.inverse(jlift(jnp.asarray(scene["w2v"])))
    r_c2v, t_c2v = jse3.rotation(c2v), jse3.translation(c2v)
    j_dir, j_start = jray._camera_rays(r_c2v, t_c2v, SMALL_INTR)
    pose = kernels.pack_ray_pose(to_torch(r_c2v), to_torch(t_c2v), to_torch(jse3.rotation(v2w)),
                                 to_torch(jse3.translation(v2w)))
    out = []
    for k in range(RANKS):
        x0, x1 = 32 * k, 32 * (k + 1)
        value, grad = _slab(state.volume.value, k, h), _slab(state.volume.grad, k, h)
        jspec = jray.ShardSpec(x_base=x0 - h, x_total=64, core_start=x0, core_end=x1)
        tspec = tray.ShardSpec(x_base=x0 - h, x_total=64, core_start=x0, core_end=x1)
        jhit = jray.march(jnp.asarray(value), j_start, j_dir, jcfg, jspec)
        thit = kernels.march_fixed(torch.from_numpy(value), pose, TINTR, tcfg.voxel_size, tcfg.trunc_dist,
                                   spec=tspec)
        out.append(dict(value=value, grad=grad, jspec=jspec, tspec=tspec, jhit=jhit, thit=thit))
    return dict(slabs=out, pose=pose, rays=(j_dir, j_start), v2w=v2w, h=h)


@pytest.mark.parametrize("k", range(RANKS))
@pytest.mark.parametrize("event", ["t_found", "t_dead"])
def test_slab_march(marched, k, event):
    s = marched["slabs"][k]
    j = np.asarray(getattr(s["jhit"], event))
    t = s["thit"][0 if event == "t_found" else 1].numpy()
    step = small_config().trunc_dist * 0.8

    def step_index(x):
        return np.where(x < jray.INF_T, np.round((x - jray.RAY_MIN_M) / step), -1)

    if event == "t_found":
        assert np.mean(j < jray.INF_T) > 0.05  # this slab owns crossings
    same = step_index(j) == step_index(t)
    assert np.mean(same) >= 0.999
    np.testing.assert_allclose(t[same], j[same], rtol=0, atol=1e-6)


def test_slab_minima_are_the_whole_march(scene, marched):
    """The ranks' minimum first crossing and first death are the whole
    volume's march at every pixel whose crossing is accepted."""
    _, _, tcfg = _cfgs()
    whole = kernels.march_fixed(scene["state"].volume.value, marched["pose"], TINTR, tcfg.voxel_size,
                                tcfg.trunc_dist)
    found = torch.minimum(*(s["thit"][0] for s in marched["slabs"]))
    dead = torch.minimum(*(s["thit"][1] for s in marched["slabs"]))
    accept = whole[0] < torch.clamp(whole[1], max=kernels.INF_T)
    assert float(accept.float().mean()) > 0.5
    assert torch.equal(found[accept], whole[0][accept]) and torch.equal(dead[accept], whole[1][accept])
    assert torch.equal(found < torch.clamp(dead, max=kernels.INF_T), accept)


@pytest.mark.parametrize("k", range(RANKS))
def test_slab_refine(marched, k):
    _, jcfg, tcfg = _cfgs()
    s = marched["slabs"][k]
    j_found = [np.asarray(x["jhit"].t_found) for x in marched["slabs"]]
    j_dead = [np.asarray(x["jhit"].t_dead) for x in marched["slabs"]]
    found_min, dead_min = np.minimum(*j_found), np.minimum(*j_dead)
    owner = (found_min < jray.INF_T) & (found_min < dead_min) & (j_found[k] == found_min)
    assert owner.mean() > 0.05
    v2w = marched["v2w"]
    j_dir, j_start = marched["rays"]
    jvol = jfusion.VolumeState(jnp.asarray(s["value"]), jnp.asarray(s["grad"]), jnp.asarray(s["value"]))
    jv, jn, jvok, jnok = jray.refine(jvol, j_start, j_dir, jnp.asarray(found_min), jnp.asarray(owner),
                                     jse3.rotation(v2w), jse3.translation(v2w), jcfg, s["jspec"])
    tvol = tfusion.VolumeState(torch.from_numpy(s["value"]), torch.from_numpy(s["grad"]), None)
    r_c2v, t_c2v, r_v2w, t_v2w = kernels.unpack_ray_pose(marched["pose"])
    t_dir, t_start = kernels.camera_rays(r_c2v, t_c2v, TINTR)
    tv, tn, tvok, tnok = tray.refine(tvol, t_start, t_dir, torch.from_numpy(found_min), torch.from_numpy(owner),
                                     r_v2w, t_v2w, tcfg, spec=s["tspec"])
    for jm, tm, jok, tok in ((jv, tv, jvok, tvok), (jn, tn, jnok, tnok)):
        jok, tok = np.asarray(jok), tok.numpy()
        assert jok.mean() > 0.02 and np.mean(jok == tok) >= 0.995
        both = jok & tok
        np.testing.assert_allclose(tm.v.numpy()[:, both], np.asarray(jm.v)[:, both], atol=1e-4)
        jg = np.asarray(jm.g)[:, both]
        np.testing.assert_allclose(tm.g.numpy()[:, both], jg, atol=1e-4 * max(1.0, np.abs(jg).max()))
        # zeros, not NaN, outside the masks: the planes the ranks sum
        assert not np.isnan(tm.v.numpy()).any() and (tm.v.numpy()[:, ~tok] == 0).all()


@pytest.fixture(scope="module")
def blocks(scene):
    """Each rank's column block of the next frame's level-0 maps against the
    whole model maps, in JAX and the port, at the last pose."""
    state = scene["state"]
    cfg = small_config()
    depth0 = kernels.bilateral_filter(torch.from_numpy(scene["depth"]))
    vmaps, nmaps = kernels.vertex_normal_pyramid([TINTR], [depth0])
    vmap, nmap = vmaps[0].numpy(), nmaps[0].numpy()
    build = jax.jit(functools.partial(jicp.build_system, intr=SMALL_INTR, dist_thres=cfg.dist_thres,
                                      angle_thres=cfg.angle_thres_sine))
    c2w_prev = jse3.inverse(to_jax(state.world2camera))
    r, t = jse3.rotation(c2w_prev), jse3.translation(c2w_prev)
    r_inv = jse3.rotation(to_jax(state.world2camera))
    vprev, nprev = state.vmaps_prev[0], state.nmaps_prev[0]
    W = vmap.shape[-1] // RANKS
    out = []
    for k in range(RANKS):
        vb = np.asarray(vmap)[:, :, k * W:(k + 1) * W].copy()
        nb = np.asarray(nmap)[:, :, k * W:(k + 1) * W].copy()
        jsys = build(r, t, jnp.asarray(vb), jnp.asarray(nb), r_inv, t, vmap_g_prev=to_jax(vprev),
                     nmap_g_prev=to_jax(nprev))
        tsys = ticp.build_system(to_torch(r), to_torch(t), torch.from_numpy(vb), torch.from_numpy(nb),
                                 to_torch(r_inv), to_torch(t), TINTR, vprev, nprev, cfg.dist_thres,
                                 cfg.angle_thres_sine)
        out.append((jsys, tsys))
    return dict(systems=out, pose=(r, t), cfg=cfg)


@pytest.mark.parametrize("k", range(RANKS))
def test_block_system(blocks, k):
    jsys, tsys = blocks["systems"][k]
    assert int(jsys.inlier_count) > 1000
    assert abs(int(tsys.inlier_count) - int(jsys.inlier_count)) <= 1e-3 * int(jsys.inlier_count)
    for jl, tl in ((jsys.A, tsys.A), (jsys.b, tsys.b)):
        for j, t in ((np.asarray(jl.v), tl.v.numpy()), (np.asarray(jl.g), tl.g.numpy())):
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


def test_tail_over_summed_system(blocks):
    """The sharded iteration's tail: the blocks' systems summed, then JAX's
    ``solve_increment`` + Euler increment + composition against the port's
    ``icp_step_plain`` on the same (JAX) sum."""
    systems = [j for j, _ in blocks["systems"]]
    jsum = jicp.IcpSystem(
        A=JCSFD(sum(s.A.v for s in systems), sum(s.A.g for s in systems)),
        b=JCSFD(sum(s.b.v for s in systems), sum(s.b.g for s in systems)),
        inlier_count=sum(s.inlier_count for s in systems),
    )
    r, t = blocks["pose"]
    damping = blocks["cfg"].icp_damping
    jx, ok = jicp.solve_increment(jsum, damping=damping)
    assert bool(ok)
    inc = jse3.euler_xyz_increment(*[JCSFD(jx.v[i], jx.g[i]) for i in range(6)])
    r_inc = jse3.rotation(inc)
    want_t = jse3.matvec(r_inc, t) + jse3.translation(inc)
    want_r = jse3.matmul(r_inc, r)
    tsum = ticp.IcpSystem(A=to_torch(jsum.A), b=to_torch(jsum.b), inlier_count=torch.tensor(int(jsum.inlier_count)))
    step = ticp.icp_step_plain(tsum, to_torch(r), to_torch(t), damping)
    assert bool(step.ok)
    np.testing.assert_allclose(step.x.v.numpy(), np.asarray(jx.v), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(step.x.g.numpy(), np.asarray(jx.g), rtol=1e-3, atol=1e-3 * np.abs(np.asarray(jx.g)).max())
    for got, want in ((step.r_curr, want_r), (step.t_curr, want_t)):
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=2e-5)
        np.testing.assert_allclose(got.g.numpy(), np.asarray(want.g),
                                   atol=1e-3 * max(1.0, np.abs(np.asarray(want.g)).max()))
