"""The port's brick-layout raycast (``xslam_tpu_torch.ops.raycast_bricks``,
the plain versions of kernels B4, B4n, B5a and B5b) and its engine in
bench.py's configuration against ``xslam_tpu.ops.raycast_bricks`` and the
JAX engine, on the CPU at the tests' scale (a 64^3 brick volume fused by
the JAX package over four orbit frames, 160x120 rays).

- ``trilinear_pair_bricks`` gives the bits of the dense scalar taps on the
  volume's dense twin; JAX's within 1e-5.
- ``march_skip_plain`` over ``skip_rows``: the accepted rays and their
  ``t_found`` are the fixed march's on the dense twin; both events are
  JAX's ``march_skip``'s at the same step index on >= 99.9% of rays, times
  within 1e-6, as K3's (XLA on the CPU fuses multiply-adds that PyTorch
  rounds twice, which can move a sample across a voxel boundary).
- ``_window_repair`` and ``march_temporal`` (with their bracketing samples):
  the events agree with JAX's on >= 99.9% of rays, the same way.
- ``refine_from_samples`` and ``screen_normals_plain`` on JAX's inputs:
  masks >= 99.5% equal, values and derivatives within 1e-4.
- The kernels' index rules, in numpy: B4's anchor (a pixel's 2x2 coarse
  neighbourhood, or the 2x2 pool of an anchor map) equals the plain
  version's padded repeat; B5b's reads of the distance instead of the
  packed rows give the packed values and jumps bit for bit; B4's rounds
  (a round's steps all read before any is tested) give the serial loop's
  events and samples bit for bit (seeded cases and a hypothesis case).
- ``raycast_bricks`` through the wrappers equals ``raycast_bricks_rays``
  bit for bit, temporal and refresh; the refresh (all anchors infinite)
  agrees with JAX's temporal raycast on the same volume, and so does the
  anchored march (each package on its own rays: the normals' derivatives,
  some above 1, within 1e-4 absolute plus 1e-4 relative).
- The coverage quirk: after a frame both engines' ``t_prev`` holds 1e9
  (finite) where a ray found nothing, so the anchor coverage reads 1.0.
- bench.py's configuration through both engines: the first tracked frame
  within 5e-4, a 6-frame run in the same ATE class; with ``use_gt_pose`` the
  brick layout's volume is the dense layout's bit for bit; B15's fusion
  options still raise, beside each raycast option, and the JAX engine's
  checks raise ValueError (the other raycasts: test_torch_brick_raycasts.py,
  test_torch_temporal_compact.py, test_torch_raycast_options.py).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.helpers import SMALL_INTR, small_config, small_dataset
from tests.torch_port_helpers import frac_equal, seeded_pose_direction, to_jax, to_torch, torch_config
from xslam_tpu.csfd.single import CSFD as JCSFD
from xslam_tpu.csfd.single import lift as jlift
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu.models.kinfu import XSlamEngine as JaxEngine
from xslam_tpu.ops import bricks as jbricks
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops import fusion_brick as jbrick
from xslam_tpu.ops import raycast as jraycast
from xslam_tpu.ops import raycast_bricks as jrb
from xslam_tpu.utils.evaluation import ate_rmse, normalize_to_first
from xslam_tpu_torch.csfd.single import CSFD as TCSFD
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.models import kinfu as tkinfu
from xslam_tpu_torch.models.kinfu import XSlamEngine as TorchEngine
from xslam_tpu_torch.ops import bricks as tbricks
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops import raycast as traycast
from xslam_tpu_torch.ops import raycast_bricks as trb
from xslam_tpu_torch.ops.kernels import INF_T

TINTR = Intrinsics(*SMALL_INTR)
BENCH = dict(volume_layout="brick", fusion_mode="brick", fusion_brick_cap=2816, fusion_overflow="dense",
             raycast_normals="screen", raycast_march="temporal", model_map_level=1, icp_fixed_assoc=True,
             raycast_refine="reuse", num_levels=2)  # bench.py:78-95; two levels at 160x120 (test_torch_kinfu.py)
N_FRAMES = 6


@pytest.fixture(scope="module")
def scene():
    """A JAX brick volume fused over 4 orbit frames, its port twin (rows and
    dense), and both packages' rays and world pose at frames 2 and 3 (a
    seeded derivative lane on the camera pose)."""
    cfg = small_config()
    args = (tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    jcfg, tcfg = jfusion.VolumeConfig(*args), tfusion.VolumeConfig(*args)
    w2v = np.asarray(cfg.world2volume, np.float32)
    ds = small_dataset(4, degrees_per_frame=1.0)
    jvol = jbricks.create(jcfg)
    integ = jax.jit(lambda v, d, r, t: jbrick.integrate_rows(v, d, r, t, SMALL_INTR, jcfg, cap=512)[0])
    for i in range(4):
        dm = jfusion.scale_depth(jnp.asarray(ds.get_depth(i)))
        v2c = jse3.inverse(jse3.matmul(jlift(jnp.asarray(w2v)), jlift(jnp.asarray(ds.get_pose(i), jnp.float32))))
        jvol = integ(jvol, dm, jse3.rotation(v2c), jse3.translation(v2c))
    tvol = tbricks.BrickVolume(*(torch.from_numpy(np.array(x)) for x in jvol))

    def at(i, seed):
        c2v = jse3.matmul(jlift(jnp.asarray(w2v)), jlift(jnp.asarray(ds.get_pose(i), jnp.float32)))
        c2v = JCSFD(c2v.v, jnp.asarray(seeded_pose_direction(seed)))
        v2w = jse3.inverse(jlift(jnp.asarray(w2v)))
        jargs = (jse3.rotation(c2v), jse3.translation(c2v), jse3.rotation(v2w), jse3.translation(v2w))
        jdir, jstart = jraycast._camera_rays(jargs[0], jargs[1], SMALL_INTR)
        return dict(jargs=jargs, targs=tuple(to_torch(a) for a in jargs), jdir=jdir, jstart=jstart,
                    tdir=to_torch(jdir), tstart=to_torch(jstart))

    return dict(jcfg=jcfg, tcfg=tcfg, jvol=jvol, tvol=tvol, dense=tbricks.to_dense(tvol, tcfg.resolution),
                frames={2: at(2, 1), 3: at(3, 2)})


def _jreader(plane, res):
    return jrb._value_reader(plane, res)


def _step_index(t, step):
    """A march time's step on the global grid (-1 for INF_T)."""
    t = np.asarray(t, np.float64)
    return np.where(t >= INF_T, -1, np.round((t - 0.2) / step)).astype(np.int64)


def _events_agree(jhit, thit, step):
    """Per ray: both events at the same step index (INF_T alike), times within 1e-6."""
    ok = np.ones(np.shape(jhit.t_found), bool)
    for j, t in ((jhit.t_found, thit.t_found), (jhit.t_dead, thit.t_dead)):
        j, t = np.asarray(j), t.numpy()
        ok &= (_step_index(j, step) == _step_index(t, step)) & (np.abs(j - t) <= 1e-6)
    return ok


def test_trilinear_pair_bricks(scene):
    tcfg, res = scene["tcfg"], scene["tcfg"].resolution
    rng = np.random.default_rng(0)
    n = 20000
    pts = [TCSFD(torch.from_numpy(rng.uniform(-0.2, 7.9, n).astype(np.float32)),
                 torch.from_numpy(rng.standard_normal(n).astype(np.float32))) for _ in range(3)]
    got = trb.trilinear_pair_bricks(trb.interleave_vg(scene["tvol"]), res, *pts, tcfg.voxel_size)
    dense = traycast.trilinear_tsdf_shard(scene["dense"].value, scene["dense"].grad, *pts, tcfg.voxel_size)
    for a, b in ((got.v, dense.v), (got.g, dense.g)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ok = ~torch.isnan(got.v)
    assert 0.5 < float(ok.float().mean()) < 1.0  # inside and outside the interior both taken
    want = jrb.trilinear_pair_bricks(jrb.interleave_vg(scene["jvol"]), res, *(to_jax(p) for p in pts),
                                     tcfg.voxel_size)
    assert frac_equal(np.isnan(np.asarray(want.v)), ~ok.numpy()) == 1.0
    np.testing.assert_allclose(got.v.numpy()[ok], np.asarray(want.v)[ok.numpy()], atol=1e-5)
    np.testing.assert_allclose(got.g.numpy()[ok], np.asarray(want.g)[ok.numpy()], atol=1e-5)


def test_march_skip(scene):
    tcfg, res = scene["tcfg"], scene["tcfg"].resolution
    f = scene["frames"][3]
    stats = {}
    packed = tbricks.skip_rows(scene["tvol"], res)
    hit = traycast.march_skip_plain(f["tstart"], f["tdir"].v, tcfg, trb._value_reader(packed, res), res, stats=stats)
    ff, fd = kernels.march_fixed_plain(scene["dense"].value, f["tstart"], f["tdir"], tcfg.voxel_size,
                                       tcfg.trunc_dist)
    accept = hit.t_found < torch.clamp(hit.t_dead, max=INF_T)
    assert float(accept.float().mean()) > 0.5
    assert torch.equal(accept, ff < torch.clamp(fd, max=INF_T))
    assert torch.equal(hit.t_found[accept], ff[accept])
    steps = kernels.march_steps(tcfg.trunc_dist)
    assert stats["samples"] < (steps + 1) * accept.numel()  # fewer reads than the fixed march's
    jhit = jraycast.march_skip(None, None, f["jstart"], f["jdir"], scene["jcfg"],
                               packed_read=_jreader(jbricks.skip_rows(scene["jvol"], res), res), shape=res)
    assert _events_agree(jhit, hit, tcfg.trunc_dist * 0.8).mean() >= 0.999  # as K3's (test_torch_raycast.py)


def test_window_repair_events(scene):
    """The refresh's half level: 12 steps around the quarter-level skip hits."""
    tcfg, res = scene["tcfg"], scene["tcfg"].resolution
    f = scene["frames"][3]
    packed = jbricks.skip_rows(scene["jvol"], res)
    qdir = JCSFD(f["jdir"].v[:, ::4, ::4], f["jdir"].g[:, ::4, ::4])
    coarse = jraycast.march_skip(None, None, f["jstart"], qdir, scene["jcfg"], packed_read=_jreader(packed, res),
                                 shape=res)
    jhit = jraycast._window_repair(None, f["jstart"], f["jdir"].v[:, ::2, ::2], coarse, 12, scene["jcfg"],
                                   read_fn=_jreader(scene["jvol"].value, res), shape=res)
    tcoarse = traycast.RaycastHit(torch.from_numpy(np.array(coarse.t_found)), torch.from_numpy(np.array(coarse.t_dead)))
    thit = traycast._window_repair(f["tstart"], f["tdir"].v[:, ::2, ::2], tcoarse, 12, tcfg,
                                   trb._value_reader(scene["tvol"].value, res), res)
    agree = _events_agree(jhit, thit, tcfg.trunc_dist * 0.8)
    assert agree.mean() >= 0.999, agree.mean()
    assert (thit.t_found < INF_T).float().mean() > 0.5


@pytest.fixture(scope="module")
def temporal(scene):
    """Both packages' anchored march at frame 3 around the exact skip march's
    hits at frame 2, with the bracketing samples."""
    tcfg, res = scene["tcfg"], scene["tcfg"].resolution
    f2, f3 = scene["frames"][2], scene["frames"][3]
    prev = jraycast.march_skip(None, None, f2["jstart"], f2["jdir"], scene["jcfg"],
                               packed_read=_jreader(jbricks.skip_rows(scene["jvol"], res), res), shape=res)
    jout = jraycast.march_temporal(None, prev.t_found, f3["jstart"], f3["jdir"], scene["jcfg"], window=12,
                                   read_fn=_jreader(scene["jvol"].value, res), shape=res, return_samples=True)
    tout = traycast.march_temporal(torch.from_numpy(np.array(prev.t_found)), f3["tstart"], f3["tdir"], tcfg, 12,
                                   trb._value_reader(scene["tvol"].value, res), res, return_samples=True)
    return jout, tout


def test_march_temporal_events(scene, temporal):
    (jhit, jf0, jf1), (thit, tf0, tf1) = temporal
    agree = _events_agree(jhit, thit, scene["tcfg"].trunc_dist * 0.8)
    assert agree.mean() >= 0.999, agree.mean()
    assert (thit.t_found < INF_T).float().mean() > 0.5
    for j, t in ((jf0, tf0), (jf1, tf1)):
        assert frac_equal(np.asarray(j)[agree], t.numpy()[agree]) >= 0.999


def _map_close(j, t, min_equal=0.995, atol=1e-4, rtol=0.0):
    jv, tv = np.asarray(j.v), t.v.numpy()
    jok, tok = ~np.isnan(jv[0]), ~np.isnan(tv[0])
    assert np.mean(jok == tok) >= min_equal, np.mean(jok == tok)
    both = jok & tok
    assert both.mean() > 0.3
    np.testing.assert_allclose(tv[:, both], jv[:, both], atol=atol, rtol=rtol)
    np.testing.assert_allclose(t.g.numpy()[:, both], np.asarray(j.g)[:, both], atol=atol, rtol=rtol)


def test_refine_from_samples(scene, temporal):
    """The reuse refine on JAX's march outputs, through each package's pair
    taps: the world vertex map (finalized), both lanes."""
    tcfg, res = scene["tcfg"], scene["tcfg"].resolution
    f = scene["frames"][3]
    jhit, jf0, jf1 = temporal[0]
    jvg = jrb.interleave_vg(scene["jvol"])

    def jtrilin(p):
        return jrb.trilinear_pair_bricks(jvg, res, *(JCSFD(p.v[i], p.g[i]) for i in range(3)), tcfg.voxel_size)

    accept = jhit.t_found < jnp.minimum(jhit.t_dead, INF_T)
    jv, jn, jok, jnok = jraycast.refine_from_samples(jtrilin, f["jstart"], f["jdir"], jhit.t_found, jf0, jf1, accept,
                                                     f["jargs"][2], f["jargs"][3], scene["jcfg"])
    jmap = jraycast.finalize_maps(jv, jn, jok, jnok)[0]
    thit = traycast.RaycastHit(torch.from_numpy(np.array(jhit.t_found)), torch.from_numpy(np.array(jhit.t_dead)))
    tmap, _ = trb._reuse_maps(scene["tvol"], f["tstart"], f["tdir"],
                              (thit, torch.from_numpy(np.array(jf0)), torch.from_numpy(np.array(jf1))),
                              f["targs"][2], f["targs"][3], tcfg)
    _map_close(jmap, tmap)
    assert float(np.abs(np.asarray(jmap.g)[~np.isnan(np.asarray(jmap.v))]).max()) > 1e-4  # the lane carries values
    ref = traycast.screen_normals_plain(tmap)
    _map_close(jraycast.screen_normals(jmap), ref)
    assert float(torch.isfinite(ref.v[0]).float().mean()) > 0.3


def test_screen_normals_on_a_seeded_map():
    """B4n's plain version on a seeded dual vertex map (a tilted ramp with
    noise and NaN holes) against JAX's ``screen_normals``."""
    rng = np.random.default_rng(4)
    v = np.cumsum(np.ones((3, 120, 160)), axis=2) * 0.01 + rng.standard_normal((3, 120, 160)) * 1e-3
    v[:, rng.random((120, 160)) < 0.05] = np.nan
    g = 1e-3 * rng.standard_normal((3, 120, 160))
    jmap = JCSFD(jnp.asarray(v, jnp.float32), jnp.asarray(g, jnp.float32))
    _map_close(jraycast.screen_normals(jmap), traycast.screen_normals_plain(to_torch(jmap)))


def _twin_anchor(anchor, dead, H, W):
    """numpy twin of csrc/window.cu's anchor: pixel (y, x) takes the min of
    coarse_event at (y//2 + a, x//2 + b), a, b in {0, 1}; coarse_event is
    INF_T past the coarse grid, min(found, dead) with ``dead``, else the
    2x2 pool of the (H, W) map with non-finite entries as INF_T."""
    if dead is None:
        ch, cw = H // 2, W // 2
        fin = np.where(np.isfinite(anchor), anchor, INF_T)
        event = np.minimum(fin[0::2, 0::2][:ch, :cw], fin[1::2, 0::2][:ch, :cw])
        event = np.minimum(event, np.minimum(fin[0::2, 1::2][:ch, :cw], fin[1::2, 1::2][:ch, :cw]))
        event = np.minimum(event, INF_T)
    else:
        ch, cw = anchor.shape
        event = np.minimum(anchor, dead)
    out = np.empty((H, W), np.float32)
    for y in range(H):
        for x in range(W):
            m = INF_T
            for a in (0, 1):
                for b in (0, 1):
                    i, j = y // 2 + a, x // 2 + b
                    m = min(m, event[i, j] if i < ch and j < cw else INF_T)
            out[y, x] = m
    return out


@pytest.mark.parametrize("case", ["pooled", "coarse_even", "coarse_odd"])
def test_window_anchor_kernel_rule(case):
    rng = np.random.default_rng(len(case))
    H, W = (16, 20) if case != "coarse_odd" else (15, 19)
    if case == "pooled":
        anchor = rng.uniform(0.3, 4.0, (H, W)).astype(np.float32)
        anchor[rng.random((H, W)) < 0.3] = np.inf
        anchor[rng.random((H, W)) < 0.1] = np.nan
        anchor[rng.random((H, W)) < 0.1] = INF_T
        dead = None
        want = traycast.window_anchor(traycast.pooled_anchors(torch.from_numpy(anchor), H, W), H, W)
    else:
        ch, cw = (H + 1) // 2, (W + 1) // 2
        anchor = np.where(rng.random((ch, cw)) < 0.3, INF_T, rng.uniform(0.3, 4.0, (ch, cw))).astype(np.float32)
        dead = np.where(rng.random((ch, cw)) < 0.5, INF_T, rng.uniform(0.3, 4.0, (ch, cw))).astype(np.float32)
        want = traycast.window_anchor(traycast.RaycastHit(torch.from_numpy(anchor), torch.from_numpy(dead)), H, W)
    assert np.array_equal(_twin_anchor(anchor, dead, H, W), want.numpy())


RAY_MAX = np.float32(5.0)
NO_STEP = 2 ** 31 - 1
CSRC = Path(trb.__file__).resolve().parents[1] / "csrc"


def _march_times(t_begin, step, n):
    """t_curr of steps 0 .. n - 1 as the kernel and the plain loop take them:
    t_begin + float32(k) * step, two roundings."""
    return np.float32(t_begin) + np.arange(n, dtype=np.float32) * np.float32(step)


def _serial_window(first, samples, inside, t_curr, window):
    """B4's march as PR 10's kernel and the plain loop march it, one step at
    a time: ``samples[k]`` is step k's read (0 + 1e-5
    outside the volume), ``first`` the read at the clamped voxel."""
    t_found = t_dead = np.float32(INF_T)
    f0, f1 = np.float32(1.0), np.float32(-1.0)
    prev = first
    for k in range(window):
        if not t_curr[k] < RAY_MAX:
            break
        tsdf = samples[k]
        death = not inside[k] or (prev < 0 and tsdf > 0)
        crossing = inside[k] and prev > 0 and tsdf < 0
        if crossing and t_curr[k] < t_found:
            t_found, f0, f1 = t_curr[k], prev, tsdf
        if death and t_curr[k] < t_dead:
            t_dead = t_curr[k]
        prev = tsdf
        if t_found < INF_T and t_dead < INF_T:
            break
    return t_found, t_dead, f0, f1


def _round_window(first, samples, inside, t_curr, window, batch):
    """numpy twin of window_march_kernel's march: rounds of ``batch`` steps,
    every read of a round before any test (a dead step, past the window or
    5 m, reads nothing), the steps then tested in order, each ray's first
    crossing and death kept by step; a round that ends with both events known
    is the last."""
    kc = kd = NO_STEP
    f0, f1 = np.float32(1.0), np.float32(-1.0)
    prev = first
    base = 0
    while base < window and t_curr[base] < RAY_MAX:
        ks = range(base, base + batch)
        live = [k < window and t_curr[k] < RAY_MAX for k in ks]
        smp = [samples[k] if ok and inside[k] else np.float32(1e-5) for k, ok in zip(ks, live)]
        for k, ok, tsdf in zip(ks, live, smp):
            if ok:
                death = not inside[k] or (prev < 0 and tsdf > 0)
                crossing = inside[k] and prev > 0 and tsdf < 0
                if crossing and kc == NO_STEP:
                    kc, f0, f1 = k, prev, tsdf
                if death and kd == NO_STEP:
                    kd = k
            prev = tsdf
        if kc != NO_STEP and kd != NO_STEP:
            break
        base += batch
    t_found = t_curr[kc] if kc != NO_STEP else np.float32(INF_T)
    t_dead = t_curr[kd] if kd != NO_STEP else np.float32(INF_T)
    return t_found, t_dead, f0, f1


def _kernel_batch() -> int:
    """csrc/window.cu's BATCH: the steps a ray reads before it tests them."""
    m = re.search(r"constexpr int BATCH = (\d+);", (CSRC / "window.cu").read_text())
    assert m, "window.cu has no BATCH"
    return int(m.group(1))


# round sizes the twin is held to: the kernel's, and others around it so that rounds end before, on and past the
# window's end and the 5 m cut
ROUND_SIZES = (1, 2, 3, 4, 5)


def _window_case(rng, kind, window):
    """(first, samples, inside, t_curr) of one ray: seeded samples in
    [-1, 1] (biased to positive before a surface), the volume exit and the
    times as ``kind`` asks."""
    n = window + 16  # the rounds twin reads up to a round past the window
    t_begin, step = np.float32(rng.uniform(0.2, 3.0)), np.float32(0.072)
    samples = rng.uniform(0.05, 1.0, n).astype(np.float32)
    inside = np.ones(n, bool)
    first = np.float32(rng.uniform(0.05, 1.0))
    if kind == "crossing_then_death":  # a +->- step, then at once a -->+ one: they share a sample
        k = int(rng.integers(0, window - 1))
        samples[k], samples[k + 1] = -rng.uniform(0.05, 1.0), rng.uniform(0.05, 1.0)
    elif kind == "exit":  # death by leaving the volume, with or without a crossing before
        k = int(rng.integers(0, window))
        inside[k:] = False
        if k > 0 and rng.random() < 0.5:
            samples[int(rng.integers(0, k))] = -0.5
    elif kind == "past_5m":  # the window runs past 5 m: later steps are cut
        t_begin = np.float32(5.0 - step * rng.uniform(0.5, window))
        samples[int(rng.integers(0, window))] = -0.5
    elif kind == "random":
        samples = rng.uniform(-1.0, 1.0, n).astype(np.float32)
        inside = rng.random(n) > 0.1
        first = np.float32(rng.uniform(-1.0, 1.0))
    samples = np.where(inside, samples, np.float32(0.0)) + np.float32(1e-5)
    return first, samples.astype(np.float32), inside, _march_times(t_begin, step, n)


@pytest.mark.parametrize("window", [12, 8])
@pytest.mark.parametrize("kind", ["no_event", "crossing_then_death", "exit", "past_5m", "random"])
def test_window_rounds_are_the_serial_loop(kind, window):
    """B4's rounds: reading ``batch`` steps before testing them, for the
    kernel's BATCH and the sizes around it, gives the serial loop's t_found,
    t_dead, f0 and f1, bits and all. A crossing and a death cannot fall on
    one step (the crossing needs prev > 0 and an inside read, the death prev
    < 0 or an exit), so the case that has both puts them on neighbouring
    steps, which share a sample, often across a round's end."""
    assert _kernel_batch() in ROUND_SIZES
    rng = np.random.default_rng([window, len(kind)])
    for _ in range(200):
        case = _window_case(rng, kind, window)
        want = _serial_window(*case, window)
        for batch in ROUND_SIZES:
            got = _round_window(*case, window, batch)
            assert np.array(got, np.float32).tobytes() == np.array(want, np.float32).tobytes(), (batch, got, want)
        if kind == "no_event":
            assert want[:2] == (INF_T, INF_T)
        if kind == "past_5m":
            assert want[1] == INF_T or want[1] < RAY_MAX


@settings(max_examples=150, deadline=None)
@given(signs=st.lists(st.integers(-2, 2), min_size=28, max_size=28), exit_at=st.integers(0, 30),
       window=st.integers(0, 12), t_begin=st.floats(0.25, 5.25, width=32), first=st.integers(-1, 1))
def test_window_rounds_hypothesis(signs, exit_at, window, t_begin, first):
    """B4's rounds against the serial loop on drawn sign patterns (0 a
    sample of exactly 1e-5: neither side of a crossing's tests), exits and
    start times."""
    samples = np.array(signs, np.float32) * np.float32(0.25) + np.float32(1e-5)
    inside = np.arange(28) < exit_at
    samples = np.where(inside, samples, np.float32(1e-5)).astype(np.float32)
    case = (np.float32(first * 0.5) + np.float32(1e-5), samples, inside, _march_times(t_begin, 0.072, 28))
    want = _serial_window(*case, window)
    for batch in ROUND_SIZES:
        got = _round_window(*case, window, batch)
        assert np.array(got, np.float32).tobytes() == np.array(want, np.float32).tobytes(), batch


def test_skip_reads_of_the_distance_are_the_packed_rows():
    """B5b reads a brick's distance d and, where d >= 2, takes (1000 + d) +
    1e-5, as the packed rows read: an exact integer, so ``c - 1000`` is d
    and the jump max(1, floor((d - 1) * steps_per_cell)) is the plain one's,
    for the bench's and the tests' volumes."""
    for voxel, trunc in ((0.03, 0.09), (0.12, 0.36)):
        spc = np.float32(8 * voxel / (trunc * 0.8))
        for d in range(2, tbricks.DIST_CAP + 1):
            packed = torch.full((1, 512), tbricks.JUMP_BASE) + torch.tensor(float(d))
            c = np.float32(np.float32(1000.0) + np.float32(d)) + np.float32(1e-5)
            assert c == packed[0, 0].item() + np.float32(1e-5) and c - np.float32(1000.0) == d
            jump = max(1, int(np.floor(np.float32(np.float32(c - np.float32(1000.0)) - np.float32(1.0)) * spc)))
            assert jump == max(1, int(np.floor((d - 1) * float(spc) + 1e-6)))


JUMP = np.float32(tbricks.JUMP_BASE)
STEP = np.float32(0.072)  # the bench volume's step, 0.8 of a 9 cm truncation


def _skip_time(k, step=STEP):
    """t_curr of step k as the kernel and the plain loop take it: 0.2 + float32(k) * step."""
    return np.float32(np.float32(0.2) + np.float32(k) * np.float32(step))


def _skip_jump(c, spc):
    """The steps a jump from sample c takes: max(1, floor(((c - 1000) - 1) * steps_per_cell)), in float32."""
    return max(1, int(np.floor(np.float32(np.float32(np.float32(c) - JUMP) - np.float32(1.0)) * np.float32(spc))))


def _serial_skip(first, c, inside, n_steps, spc, step=STEP):
    """B5b's serial loop (csrc/skip.cu, ops/raycast.py::march_skip_plain) over
    a ray's per-step samples ``c`` (packed, + 1e-5) and inside flags:
    ``(t_found, t_dead, visited steps)``."""
    t_found = t_dead = np.float32(INF_T)
    prev, k, visited = first, 0, []
    while True:
        visited.append(k)
        can_jump = inside[k] and c[k] >= JUMP - np.float32(0.5)
        death = not can_jump and (not inside[k] or (prev < 0 and c[k] > 0))
        crossing = not can_jump and inside[k] and prev > 0 and c[k] < 0
        if crossing:
            t_found = _skip_time(k, step)
        if death:
            t_dead = _skip_time(k, step)
        if crossing or death or k + 1 >= n_steps:
            return t_found, t_dead, visited
        if can_jump:
            k, prev = k + _skip_jump(c[k], spc), np.float32(1.0)
        else:
            k, prev = k + 1, c[k]


def _lanes_skip(first, c, inside, n_steps, spc, lanes, step=STEP):
    """numpy twin of march_skip_kernel: rounds of ``lanes`` steps from
    k0, every sample of a round read first; then from position cur (0 at a
    round's start, prev carried) the lanes up to the first jumping lane J at
    or after cur are tested at once (prev of each the left lane's sample),
    the first that ends the ray (crossing, death, the n_steps stop) taken;
    else the replay goes on at J's landing (prev 1.0) inside the round, or
    the next round starts there or, with no jumping lane, at k0 + lanes (prev
    the last lane's sample). ``(t_found, t_dead, rounds)``."""
    prev, k0, rounds = first, 0, 0
    j = np.arange(lanes)
    while True:
        rounds += 1
        ks = k0 + j
        cc, ins = c[ks], inside[ks]
        can_jump = ins & (cc >= JUMP - np.float32(0.5))
        jump = np.array([_skip_jump(x, spc) if cj else 1 for x, cj in zip(cc, can_jump)])
        left = np.concatenate([cc[:1], cc[:-1]])
        stop = ks + 1 >= n_steps
        cur = 0
        while True:
            pv = np.where(j == cur, prev, left)
            death = ~can_jump & (~ins | ((pv < 0) & (cc > 0)))
            crossing = ~can_jump & ins & (pv > 0) & (cc < 0)
            after = np.flatnonzero(can_jump & (j >= cur))
            J = int(after[0]) if after.size else lanes
            ends = np.flatnonzero((j >= cur) & (j <= J) & (crossing | death | stop))
            if ends.size:
                e = int(ends[0])
                t = _skip_time(k0 + e, step)
                return (t if crossing[e] else np.float32(INF_T)), (t if death[e] else np.float32(INF_T)), rounds
            if J == lanes:
                prev, nxt = cc[-1], lanes
                break
            nxt, prev = J + int(jump[J]), np.float32(1.0)
            if nxt >= lanes:
                break
            cur = nxt
        k0 += nxt


def _rounds_of(visited, lanes):
    """The rounds a loop that visits ``visited`` takes when a round starts at a
    visited step and covers the visited steps below its start + lanes."""
    rounds, start = 1, visited[0]
    for k in visited[1:]:
        if k >= start + lanes:
            rounds, start = rounds + 1, k
    return rounds


def _landings(visited, lanes):
    """Of the loop's jumps, how many land inside the round they start in and
    how many past it (the rounds of :func:`_rounds_of`)."""
    inside = past = 0
    start = visited[0]
    for a, b in zip(visited, visited[1:]):
        if b >= start + lanes:
            past += b - a > 1
            start = b
        else:
            inside += b - a > 1
    return inside, past


def _kernel_lanes() -> int:
    """csrc/skip.cu's LANES: the lanes a ray of the skip march."""
    m = re.search(r"constexpr int LANES = (\d+);", (CSRC / "skip.cu").read_text())
    assert m, "skip.cu has no LANES"
    return int(m.group(1))


# lanes a ray the twin is held to: the designs measured (4, 8, 32), the one shipped, and 1, 2 and 16
SKIP_LANES = (1, 2, 4, 8, 16, 32)
SKIP_SPC = (0.5, 10.0 / 3.0, 10.0)  # steps a cell: short jumps; the bench's and the tests' 3.33; long ones


def _skip_case(rng, kind, n_steps):
    """(first, samples, inside) of one ray: runs of free space packed as
    1000 + d (jumps), positive samples, and surfaces as ``kind`` asks."""
    n = n_steps + 4 * 50 + 64  # room for the last jump and a round past it
    samples = rng.uniform(0.05, 1.0, n).astype(np.float32)
    packed = rng.random(n) < {"jumps": 0.7, "jump_then_crossing": 0.5}.get(kind, 0.3)
    samples[packed] = JUMP + rng.integers(2, 6, int(packed.sum())).astype(np.float32)
    inside = np.ones(n, bool)
    first = np.float32(rng.uniform(0.05, 1.0))
    if kind == "jump_then_crossing":  # every sample after a packed one is a surface's negative side
        after = np.flatnonzero(packed[:-1]) + 1
        samples[after[~packed[after]]] = -rng.uniform(0.05, 1.0)
    elif kind == "exit":  # leaving the volume through free space or samples
        inside[int(rng.integers(0, n_steps + 8)):] = False
    elif kind == "no_event":
        samples = np.where(packed, samples, np.abs(samples))
    elif kind == "random":
        samples = np.where(packed, samples, rng.uniform(-1.0, 1.0, n)).astype(np.float32)
        inside = rng.random(n) > 0.05
        first = np.float32(rng.uniform(-1.0, 1.0))
    samples = np.where(inside, samples, np.float32(0.0)) + np.float32(1e-5)
    return first, samples.astype(np.float32), inside


@pytest.mark.parametrize("spc", SKIP_SPC)
@pytest.mark.parametrize("kind", ["jumps", "jump_then_crossing", "exit", "no_event", "random"])
def test_skip_rounds_are_the_serial_loop(kind, spc):
    """B5b's rounds, for the lanes measured and shipped and others: the same
    t_found and t_dead as the serial skip loop, bits and all, and as many
    rounds as the loop's visited steps make. The cases cover jumps that land
    inside a round and past it, crossings on the step right after a jump
    (prev 1.0), deaths on leaving the volume and the n_steps stop."""
    assert _kernel_lanes() in SKIP_LANES
    rng = np.random.default_rng([len(kind), int(spc * 3)])
    n_steps = 67  # the bench's: int(4.8 / 0.072) + 1
    seen = dict(stopped=0, landed_inside=0, landed_past=0, crossing_after_jump=0, exit_death=0)
    for _ in range(150):
        first, c, inside = _skip_case(rng, kind, n_steps)
        t_found, t_dead, visited = _serial_skip(first, c, inside, n_steps, spc)
        want = np.array([t_found, t_dead], np.float32).tobytes()
        for lanes in SKIP_LANES:
            got = _lanes_skip(first, c, inside, n_steps, spc, lanes)
            assert np.array(got[:2], np.float32).tobytes() == want, (lanes, got, t_found, t_dead)
            assert got[2] == _rounds_of(visited, lanes)
        landed = _landings(visited, 32)
        seen["landed_inside"] += landed[0]
        seen["landed_past"] += landed[1]
        seen["stopped"] += bool(t_found >= INF_T and t_dead >= INF_T)
        seen["crossing_after_jump"] += bool(t_found < INF_T and len(visited) > 1 and visited[-1] - visited[-2] > 1)
        seen["exit_death"] += bool(t_dead < INF_T and not inside[visited[-1]])
    if kind in ("jumps", "no_event"):
        assert seen["landed_inside"] > 0 and seen["landed_past"] > 0, seen
    if kind == "no_event":
        assert seen["stopped"] == 150  # every ray ran to the n_steps stop, or past it by a jump
    if kind == "jump_then_crossing":
        assert seen["crossing_after_jump"] > 0, seen
    if kind == "exit":
        assert seen["exit_death"] > 0, seen


@settings(max_examples=150, deadline=None)
@given(codes=st.lists(st.integers(-2, 6), min_size=80, max_size=80), exit_at=st.integers(0, 80),
       n_steps=st.integers(1, 40), first=st.integers(-1, 1), spc=st.sampled_from(SKIP_SPC))
def test_skip_rounds_hypothesis(codes, exit_at, n_steps, first, spc):
    """B5b's rounds against the serial loop on drawn samples: codes 3..6 a
    packed brick at distance code - 1 (a jump), -2..2 a sample of code / 4
    (0: exactly 1e-5, neither side of a test), with exits and stops."""
    code = np.array(codes)
    samples = np.where(code >= 3, JUMP + (code - 1).astype(np.float32), code.astype(np.float32) * np.float32(0.25))
    inside = np.arange(80) < exit_at
    samples = (np.where(inside, samples, np.float32(0.0)) + np.float32(1e-5)).astype(np.float32)
    c = np.concatenate([samples, np.full(200, np.float32(1e-5))])
    ins = np.concatenate([inside, np.zeros(200, bool)])
    f = np.float32(first * 0.5) + np.float32(1e-5)
    t_found, t_dead, visited = _serial_skip(f, c, ins, n_steps, spc)
    for lanes in SKIP_LANES:
        got = _lanes_skip(f, c, ins, n_steps, spc, lanes)
        assert np.array(got[:2], np.float32).tobytes() == np.array([t_found, t_dead], np.float32).tobytes(), lanes
        assert got[2] == _rounds_of(visited, lanes)


def test_skip_rounds_on_the_refresh_volume(scene):
    """The twin over the test volume's refresh rays (a quarter of 160x120,
    frame 3), their samples read through ``bricks.pack_rows`` as the plain
    march reads them: every lane count gives ``march_skip_plain``'s events
    bit for bit, and the plain march's per-ray rounds (``stats``) are the
    twin's."""
    tcfg, res = scene["tcfg"], scene["tcfg"].resolution
    f = scene["frames"][3]
    dirs = f["tdir"].v[:, ::trb.SKIP_STRIDE, ::trb.SKIP_STRIDE]
    read = trb._value_reader(tbricks.pack_rows(scene["tvol"].value, tbricks.brick_distance_rows(scene["tvol"], res)),
                             res)
    step = tcfg.trunc_dist * 0.8
    spc = tbricks.BRICK * tcfg.voxel_size / step
    n_steps = kernels.march_steps(tcfg.trunc_dist)
    start = f["tstart"].v[:, None, None]
    H, W = dirs.shape[-2:]
    # every step's sample as march_skip_plain computes it, and the first (clamped, capped at 1)
    g0 = traycast.to_index(torch.floor((start + dirs * kernels.RAY_MIN_M) / tcfg.voxel_size))
    first = torch.clamp(read(traycast._clamped(g0, res)), max=1.0).numpy()
    c, inside = [], []
    for k in range(n_steps + 4 * 50 + 64):
        kf = torch.full((H, W), float(k), dtype=torch.float32)
        g = traycast.to_index(torch.floor((start + dirs * (kernels.RAY_MIN_M + (kf + 1.0) * step)) / tcfg.voxel_size))
        c.append(read(g).numpy())
        inside.append(traycast._in_volume(g, res).numpy())
    c, inside = np.stack(c, -1), np.stack(inside, -1)
    for lanes in (1, 4, 8, 32):
        stats = {"lanes": lanes}
        plain = traycast.march_skip_plain(f["tstart"], dirs, tcfg, read, res, stats=stats)
        want_found, want_dead = plain.t_found.numpy(), plain.t_dead.numpy()
        rounds = stats["ray_rounds"].numpy()
        for y in range(H):
            for x in range(W):
                got = _lanes_skip(first[y, x], c[y, x], inside[y, x], n_steps, spc, lanes, step)
                assert np.array(got[:2], np.float32).tobytes() == np.array(
                    [want_found[y, x], want_dead[y, x]], np.float32).tobytes(), (lanes, y, x)
                assert got[2] == rounds[y, x], (lanes, y, x)
        if lanes == 1:
            assert bool((stats["ray_rounds"] + 1 == stats["ray_samples"]).all())  # a round a visited step
            assert int(stats["ray_samples"].sum()) == stats["samples"]
    assert float((plain.t_found < INF_T).float().mean()) > 0.5


def _port_maps(scene, frame, anchor, refresh):
    """The port's maps through the wrappers (the normals through the
    pyramid's path that computes them, as the engine takes them), held to
    the plain composition on the port's own rays (kernels.camera_rays), bit
    for bit."""
    tcfg, f = scene["tcfg"], scene["frames"][frame]
    vmap, nmap, t_found = trb.raycast_bricks(scene["tvol"], *f["targs"], TINTR, tcfg, anchor, refresh=refresh)
    assert nmap is None  # the screen normals: the pyramid's launch
    wrapped = (vmap, tkinfu.model_map_pyramid(vmap, None, 1)[1][0], t_found)
    ray_dir, ray_start = kernels.camera_rays(f["targs"][0], f["targs"][1], TINTR)
    plain = trb.raycast_bricks_rays(scene["tvol"], ray_start, ray_dir, f["targs"][2], f["targs"][3], tcfg,
                                    march_mode="temporal", refine_mode="reuse", t_anchor=anchor, return_hit=True)
    for a, b in zip((wrapped[0].v, wrapped[0].g, wrapped[1].v, wrapped[1].g, wrapped[2]),
                    (plain[0].v, plain[0].g, plain[1].v, plain[1].g, plain[2])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return wrapped


def _jax_maps(scene, frame, anchor):
    f = scene["frames"][frame]
    return jax.jit(lambda v, a, b, c, d, ta: jrb.raycast_bricks(
        v, a, b, c, d, SMALL_INTR, scene["jcfg"], normals_mode="screen", march_mode="temporal", t_anchor=ta,
        pair_taps=True, refine_mode="reuse", return_hit=True))(scene["jvol"], *f["jargs"], anchor)


def test_refresh_branch(scene):
    """All anchors infinite: the coverage takes the refresh (the skip march at
    a quarter, windows at half and full), through the wrappers as through
    the plain composition, and JAX's temporal raycast takes its hier2 branch."""
    anchor = torch.full((120, 160), torch.inf)
    coverage = float(trb.anchor_coverage(anchor))
    assert coverage == 0.0
    vm, nm, t_found = _port_maps(scene, 3, anchor, refresh=coverage < 0.5)
    jvm, jnm, jt = _jax_maps(scene, 3, jnp.asarray(anchor.numpy()))
    _map_close(jvm, vm)
    _map_close(jnm, nm, rtol=1e-4)
    assert np.mean(_step_index(np.asarray(jt), 0.288) == _step_index(t_found.numpy(), 0.288)) >= 0.999


def test_temporal_branch(scene, temporal):
    """Anchors from frame 2's hits: the anchored march with the refine through
    the wrappers equals the plain composition, and JAX's within tolerance."""
    anchor = temporal[1][0].t_found  # frame 3's own hits: a full coverage
    assert float(trb.anchor_coverage(anchor)) == 1.0
    vm, nm, _ = _port_maps(scene, 3, anchor, refresh=False)
    jvm, jnm, _ = _jax_maps(scene, 3, jnp.asarray(anchor.numpy()))
    _map_close(jvm, vm)
    _map_close(jnm, nm, rtol=1e-4)


def test_wrappers_launch_nothing_on_cpu(scene):
    _port_maps(scene, 2, torch.full((120, 160), torch.inf), refresh=True)
    assert all(kernels.launch_counts[k] == 0 for k in ("window_march", "model_map_normals", "skip_field", "march_skip"))


# ------------------------------------------------------------- the engines
@pytest.fixture(scope="module")
def bench_runs():
    cfg = small_config(end_frame=N_FRAMES, **BENCH)
    ds = small_dataset(N_FRAMES, degrees_per_frame=1.0)
    depths = [ds.get_depth(i) for i in range(N_FRAMES)]
    jeng = JaxEngine(cfg)
    jstate = jeng.init_state()
    jposes, jt_prev = [], []
    for i in range(N_FRAMES):
        jstate, jres = jeng.process_frame(jstate, depths[i])
        jposes.append(np.array(jres.camera2world.v))
        jt_prev.append(np.array(jstate.t_prev))
    teng = TorchEngine(torch_config(cfg), device="cpu")
    tstate = teng.init_state()
    tres_all, tt_prev = [], []
    for i in range(N_FRAMES):
        tstate, tres = teng.process_frame(tstate, depths[i])
        teng.log_pose(tres)
        tres_all.append(tres)
        tt_prev.append(tstate.t_prev.clone())
    gt = normalize_to_first([ds.get_pose(i) for i in range(N_FRAMES)])
    return jposes, jt_prev, teng.pose_log, tres_all, tt_prev, gt


def test_bench_engines_first_tracked_frame(bench_runs):
    jposes, _, tposes, tres, _, _ = bench_runs
    assert all(bool(r.align_ok) for r in tres)
    np.testing.assert_allclose(tposes[1], jposes[1], atol=5e-4)


def test_bench_engines_ate_class(bench_runs):
    jposes, _, tposes, _, _, gt = bench_runs
    ate_j = ate_rmse(normalize_to_first(jposes), gt)
    ate_t = ate_rmse(normalize_to_first(tposes), gt)
    assert ate_j < 0.06 and ate_t < 0.06, (ate_j, ate_t)
    assert abs(ate_j - ate_t) < 5e-3, (ate_j, ate_t)


def test_coverage_quirk_both_engines(bench_runs):
    """``t_prev`` carries the window march's ``t_found``, INF_T = 1e9 where a
    ray found nothing, and 1e9 is finite: after frame 0 every anchor is
    finite (the depth's, else t_prev) and the coverage reads 1.0 whatever
    the rays found, in both packages, so the refresh runs at most on frame 0."""
    _, jt_prev, _, tres, tt_prev, _ = bench_runs
    for j, t in zip(jt_prev, tt_prev):
        assert np.isfinite(j).all() and bool(torch.isfinite(t).all())
        assert (j == INF_T).any() and bool((t == INF_T).any())  # rays that missed: 1e9, finite
    assert all(float(r.anchor_coverage) == 1.0 for r in tres[1:])
    assert float(tres[0].anchor_coverage) > 0.5  # frame 0: the depth's anchors alone


def test_refresh_every_frame_tracks():
    """raycast_temporal_min_coverage above 1, which the JAX engine accepts:
    every frame takes the refresh, and the run tracks."""
    n = 3
    cfg = small_config(end_frame=n, raycast_temporal_min_coverage=2.0, **BENCH)
    ds = small_dataset(n, degrees_per_frame=1.0)
    engine = TorchEngine(torch_config(cfg), device="cpu")
    state = engine.init_state()
    for i in range(n):
        state, res = engine.process_frame(state, ds.get_depth(i))
        engine.log_pose(res)
        assert bool(res.align_ok) and float(res.anchor_coverage) < 2.0
    assert ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first([ds.get_pose(i) for i in range(n)])) < 0.06


def test_use_gt_pose_brick_volume_equals_dense():
    n = 3
    ds = small_dataset(n, degrees_per_frame=1.0)
    volumes = {}
    for name, opts in (("brick", BENCH), ("dense", dict(num_levels=2))):
        engine = TorchEngine(torch_config(small_config(end_frame=n, use_gt_pose=True, **opts)), device="cpu")
        state = engine.init_state()
        for i in range(n):
            state, _ = engine.process_frame(state, ds.get_depth(i), gt_pose=ds.get_pose(i))
        volumes[name] = engine.dense_volume(state)
    assert int((volumes["dense"].weight > 0).sum()) > 5000
    for a, b in zip(volumes["brick"], volumes["dense"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# the brick layout's raycasts all run now (tests/test_torch_brick_raycasts.py, test_torch_temporal_compact.py,
# test_torch_raycast_options.py), and so do B15's fusion options with each raycast they can meet
# (tests/test_torch_fusion_classifier_runs.py); what raises is the JAX engine's own checks
@pytest.mark.parametrize("option, error", [
    (dict(BENCH, raycast_normals="tsdf"), ValueError),  # reuse needs screen normals (the JAX engine's check)
    (dict(BENCH, fusion_mode="dense"), ValueError),
    (dict(raycast_march="temporal"), ValueError),
])
def test_other_options_raise(option, error):
    with pytest.raises(error):
        TorchEngine(torch_config(small_config(**option)), device="cpu")
