"""The schedules of two redesigned march kernels, held to the plain versions
on the CPU (a CUDA kernel cannot run here; the smoke run holds the kernels
themselves to these plain versions and to their earlier designs on the card).

- B19b, K3 over a slab marching only the steps its slab can own
  (``csrc/march.cu``, ``march_shard_kernel<true>``): a torch model of its
  schedule, the start of the owned interval C and the volume's exit found by
  bisection over the step k, the march over C from the step before it, the
  exit death set apart, equal to ``kernels.march_fixed_plain(spec=)`` bit for
  bit on the 64^3 scene of ``tests/test_torch_shard_hooks.py`` (the port's
  engine over 3 frames of the small sweep): each slab of a 2- and a 4-rank
  split with its halo, one rank, a camera outside the volume, rays with a
  1e-15 x-direction. The bisection needs each voxel coordinate of a ray's
  samples to be monotone in k: checked on seeded random rays. A slab that is
  the whole volume gives the whole volume's march (the kernel runs K3's body
  there).
- The skip march's ray form (``csrc/skip.cu``, ``march_skip_ray_kernel``),
  a thread a ray stepping by the serial rule: a twin of its loop equal to
  ``raycast.march_skip_plain`` bit for bit on the scene's skip-packed dense
  volume and on a sphere's, whose rays jump; and the ray counts at which the
  wrappers launch it.
"""

import numpy as np
import pytest
import torch

from tests.helpers import SMALL_INTR, small_config, small_dataset
from tests.torch_port_helpers import seeded_pose_direction, torch_config
from xslam_tpu_torch.csfd.single import CSFD
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.models.kinfu import XSlamEngine
from xslam_tpu_torch.ops import kernels, raycast
from xslam_tpu_torch.ops.kernels import INF_T, RAY_MIN_M
from xslam_tpu_torch.ops.sampling import gather3d, to_index
from xslam_tpu_torch.parallel.sharded import halo_width

TINTR = Intrinsics(*SMALL_INTR)
RAY_MIN32 = torch.tensor(np.float32(RAY_MIN_M))


@pytest.fixture(scope="module")
def scene():
    """The port's engine over 3 frames of the small sweep (the shard hooks'
    scene); the camera rays at the next frame's pose."""
    cfg = torch_config(small_config())
    ds = small_dataset(4, degrees_per_frame=1.0)
    engine = XSlamEngine(cfg, device="cpu")
    state = engine.init_state()
    for i in range(3):
        state, _ = engine.process_frame(state, ds.get_depth(i))
    w2v = np.asarray(cfg.world2volume, np.float32)
    c2w = np.linalg.inv(ds.get_pose(0)) @ ds.get_pose(3)
    c2v = (w2v @ c2w).astype(np.float32)
    return dict(cfg=cfg, volume=state.volume, rays=_rays(c2v), vcfg=engine.vol_cfg)


def _rays(c2v: np.ndarray):
    """The camera rays (value lanes) and their start at the camera->volume pose ``c2v``."""
    r = CSFD(torch.from_numpy(np.ascontiguousarray(c2v[:3, :3])), torch.from_numpy(seeded_pose_direction(3)[:3, :3]))
    t = CSFD(torch.from_numpy(np.ascontiguousarray(c2v[:3, 3])), torch.zeros(3))
    ray_dir, ray_start = kernels.camera_rays(r, t, TINTR)
    return ray_start, ray_dir


# ------------------------------------------------------------------ B19b's schedule
def _t(k: torch.Tensor, step: float) -> torch.Tensor:
    """The march time 0.2 + k step in float32, one rounding an operation."""
    return RAY_MIN32 + k.to(torch.float32) * torch.tensor(np.float32(step))


def _coord(start, dirs, voxel, step, k, i):
    """Axis i's voxel coordinate of step k's sample (at 0.2 + (k + 1) step), for each ray."""
    return to_index(torch.floor((start[i] + dirs[i] * _t(k + 1, step)) / voxel))


def _first_step(start, dirs, voxel, step, i, up, bound, lo, hi):
    """The first step in [lo, hi) at which axis i's coordinate has reached ``bound`` (``up``: >= bound, else
    < bound), hi where none: the kernel's bisection, ray by ray."""
    lo, hi = lo.clone(), hi.clone()
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) // 2
        g = _coord(start, dirs, voxel, step, mid, i)
        reached = torch.where(up, g >= bound, g < bound)
        hi = torch.where(active & reached, mid, hi)
        lo = torch.where(active & ~reached, mid + 1, lo)
    return lo


def slab_steps_march(value, ray_start: CSFD, dirs_v, voxel, trunc_dist, spec, stats=None):
    """A model of ``march_shard_kernel<true>``'s schedule over a slab with its
    halo (``value``) placed by ``spec``: each ray's owned interval C (inside
    the volume, in the core rows) starts where the latest of its axes'
    ranges starts (by bisection), unless C is empty; the march runs from
    there, its prev the read of the step before (or the clamped first
    sample), until both events are known or a sample leaves C; a camera
    outside the volume dies at step 0; a ray that met no death and left C
    inside the volume (or owns no step) dies at its exit from the volume,
    the first step from there at which any axis leaves its range (by
    bisection). ``stats`` gets ``"samples"``: the steps marched."""
    Xl, Y, Z = value.shape
    x_base, X, core0, core1 = kernels.resolve_spec(spec, Xl)
    step = trunc_dist * 0.8
    n = kernels.march_steps(trunc_dist)
    start = ray_start.v.reshape(3, 1).expand(3, dirs_v[0].numel())
    dirs = dirs_v.reshape(3, -1)
    R = dirs.shape[1]
    zero, full = torch.zeros(R, dtype=torch.int64), torch.full((R,), n, dtype=torch.int64)
    up = [dirs[i] > 0.0 for i in range(3)]
    lo, hi = (max(core0, 0), 0, 0), (min(core1, X), Y, Z)

    def read(g):
        return gather3d(value, g[0] - x_base, g[1], g[2]) + 1e-5

    g0 = torch.stack([_coord(start, dirs, voxel, step, zero, i) for i in range(3)])
    inside0 = (g0[0] >= 0) & (g0[0] < X) & (g0[1] >= 0) & (g0[1] < Y) & (g0[2] >= 0) & (g0[2] < Z)
    owned0 = inside0 & (g0[0] >= core0) & (g0[0] < core1)
    c0 = zero
    for i in range(3):
        bound = torch.where(up[i], torch.tensor(lo[i]), torch.tensor(hi[i]))
        c0 = torch.maximum(c0, _first_step(start, dirs, voxel, step, i, up[i], bound, zero, full))
    gc = torch.stack([_coord(start, dirs, voxel, step, c0.clamp(max=n - 1), i) for i in range(3)])
    in_c = (c0 < n) & torch.stack([(gc[i] >= lo[i]) & (gc[i] < hi[i]) for i in range(3)]).all(dim=0)
    c0 = torch.where(owned0, zero, torch.where(in_c, c0, full))

    # prev: the clamped first sample at step 0, else step c0 - 1's read
    gfirst = to_index(torch.floor((start + dirs * RAY_MIN_M) / voxel))
    gfirst = torch.stack([gfirst[0].clamp(0, X - 1), gfirst[1].clamp(0, Y - 1), gfirst[2].clamp(0, Z - 1)])
    gprev = torch.stack([_coord(start, dirs, voxel, step, (c0 - 1).clamp(min=0), i) for i in range(3)])
    prev = torch.where(c0 == 0, read(gfirst), read(gprev))

    t_found = torch.full((R,), INF_T, dtype=torch.float32)
    t_dead = torch.where(inside0, torch.tensor(INF_T, dtype=torch.float32), _t(zero, step))
    done = c0 >= n
    exit_from = torch.where(done, zero, -1)  # where the exit is still to be found: a ray owning no step, from 0
    samples = torch.zeros(R, dtype=torch.int64)
    for k in range(n):
        active = (c0 <= k) & ~done
        if not bool(active.any()):
            continue
        kk = torch.full((R,), k, dtype=torch.int64)
        g = torch.stack([_coord(start, dirs, voxel, step, kk, i) for i in range(3)])
        ins = (g[0] >= 0) & (g[0] < X) & (g[1] >= 0) & (g[1] < Y) & (g[2] >= 0) & (g[2] < Z)
        own = (g[0] >= core0) & (g[0] < core1)
        tsdf = read(g)
        death = active & (~ins | (own & ins & (prev < 0.0) & (tsdf > 0.0)))
        crossing = active & own & ins & (prev > 0.0) & (tsdf < 0.0)
        t_curr = _t(kk, step)
        t_found = torch.where(crossing & (t_curr < t_found), t_curr, t_found)
        t_dead = torch.where(death & (t_curr < t_dead), t_curr, t_dead)
        samples += active
        leaves = active & ~(ins & own)
        exit_from = torch.where(leaves & ins, kk, exit_from)  # left C inside the volume: the exit lies beyond
        done = done | (active & ((t_found < INF_T) & (t_dead < INF_T))) | leaves
        prev = torch.where(active, tsdf, prev)

    # no death met, and the march left C inside the volume (or C is empty): the exit from the volume
    ends = (X, Y, Z)
    e = full
    for i in range(3):
        bound = torch.where(up[i], torch.tensor(ends[i]), torch.tensor(0))
        e = torch.minimum(e, _first_step(start, dirs, voxel, step, i, up[i], bound, exit_from.clamp(min=0), full))
    exits = (t_dead >= INF_T) & (exit_from >= 0) & (e < n)
    t_dead = torch.where(exits, _t(e, step), t_dead)
    if stats is not None:
        stats["samples"] = int(samples.sum())
    shape = dirs_v.shape[1:]
    return t_found.reshape(shape), t_dead.reshape(shape)


def _slabs(scene):
    """Each slab's (name, plane with its halo, ShardSpec)."""
    value = scene["volume"].value
    X = value.shape[0]
    out = [("1 rank", value, raycast.ShardSpec(x_base=0, x_total=X, core_start=0, core_end=X))]
    for ranks in (2, 4):
        local = X // ranks
        h = halo_width(scene["vcfg"], local)
        for k in range(ranks):
            rows = torch.arange(k * local - h, (k + 1) * local + h) % X
            spec = raycast.ShardSpec(x_base=k * local - h, x_total=X, core_start=k * local, core_end=(k + 1) * local)
            out.append((f"{k} of {ranks}", value.index_select(0, rows).contiguous(), spec))
    return out


def _outside_rays():
    """A camera 0.5 m before the volume's x = 0 face, looking along +x: every ray starts outside."""
    cfg = small_config()
    Y, Z = cfg.tsdf_size[1], cfg.tsdf_size[2]
    c2v = np.eye(4, dtype=np.float32)
    c2v[:3, :3] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)  # camera z -> volume +x
    c2v[:3, 3] = (-0.5, 0.5 * Y * cfg.voxel_size, 0.5 * Z * cfg.voxel_size)
    return _rays(c2v)


def _tiny_x_rays(rays):
    """The scene's rays with every third column's x-direction 1e-15 (the kernels' patch of a zero lane)."""
    ray_start, ray_dir = rays
    dirs = ray_dir.v.clone()
    dirs[0, :, ::3] = 1e-15
    return ray_start, CSFD(dirs, ray_dir.g)


def _full_loop_steps(t_found, t_dead, trunc_dist) -> int:
    """The steps the earlier design's full loop reads: a ray's until both events are known, else all n_steps."""
    n = kernels.march_steps(trunc_dist)
    k = lambda t: torch.round((t - RAY_MIN_M) / np.float32(trunc_dist * 0.8)).long()  # noqa: E731
    both = (t_found < INF_T) & (t_dead < INF_T)
    return int(torch.where(both, torch.maximum(k(t_found), k(t_dead)) + 1, n).sum())


@pytest.mark.parametrize("rays_of", ["scene", "outside", "tiny x"])
def test_slab_steps_equal_the_full_march(scene, rays_of):
    """The slab-step schedule gives ``march_fixed_plain(spec=)``'s events bit
    for bit on every slab of 2 and 4 and at one rank; on the scene's rays it
    reads fewer steps than the full loop, and some slab owns crossings."""
    rays = {"scene": lambda: scene["rays"], "outside": _outside_rays,
            "tiny x": lambda: _tiny_x_rays(scene["rays"])}[rays_of]()
    ray_start, ray_dir = rays
    vcfg = scene["vcfg"]
    marched = full = found = 0
    for name, plane, spec in _slabs(scene):
        pf, pd = kernels.march_fixed_plain(plane, ray_start, ray_dir, vcfg.voxel_size, vcfg.trunc_dist, spec)
        stats = {}
        sf, sd = slab_steps_march(plane, ray_start, ray_dir.v, vcfg.voxel_size, vcfg.trunc_dist, spec, stats)
        assert torch.equal(sf.view(torch.int32), pf.view(torch.int32)), (name, "t_found")
        assert torch.equal(sd.view(torch.int32), pd.view(torch.int32)), (name, "t_dead")
        marched += stats["samples"]
        full += _full_loop_steps(pf, pd, vcfg.trunc_dist)
        found += int((pf < INF_T).sum())
    if rays_of == "scene":
        assert found > 0 and marched < full


@pytest.mark.parametrize("rays_of", ["scene", "outside"])
def test_whole_volume_slab_is_the_whole_march(scene, rays_of):
    """A slab that is the whole volume (one rank: no halo, every row owned)
    gives the whole volume's march bit for bit, which is why the kernel runs
    K3's body there."""
    ray_start, ray_dir = scene["rays"] if rays_of == "scene" else _outside_rays()
    vcfg, value = scene["vcfg"], scene["volume"].value
    X = value.shape[0]
    whole = kernels.march_fixed_plain(value, ray_start, ray_dir, vcfg.voxel_size, vcfg.trunc_dist)
    slab = kernels.march_fixed_plain(value, ray_start, ray_dir, vcfg.voxel_size, vcfg.trunc_dist,
                                     raycast.ShardSpec(x_base=0, x_total=X, core_start=0, core_end=X))
    for a, b in zip(whole, slab):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_outside_camera_dies_at_step_0_and_crosses_later(scene):
    """The camera outside: every ray dies at step 0 on every slab, and the
    slabs that own the surface still find its crossings."""
    ray_start, ray_dir = _outside_rays()
    vcfg = scene["vcfg"]
    found = 0
    for name, plane, spec in _slabs(scene):
        tf, td = slab_steps_march(plane, ray_start, ray_dir.v, vcfg.voxel_size, vcfg.trunc_dist, spec)
        assert bool((td == np.float32(RAY_MIN_M)).all()), name
        found += int((tf < INF_T).sum())
    assert found > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_voxel_coordinates_are_monotone_in_the_step(seed):
    """Each voxel coordinate of a ray's samples, floor((s + d t_k) / vs) with
    t_k = 0.2 + (k + 1) step in float32, moves one way with k (up where d > 0,
    down where d < 0, flat for a 1e-15 lane): the bisection's premise."""
    rng = np.random.default_rng(seed)
    R = 4096
    start = torch.from_numpy(rng.uniform(-1.0, 9.0, (3, R)).astype(np.float32))
    d = rng.normal(size=(3, R))
    d /= np.linalg.norm(d, axis=0)
    d[:, : R // 8] *= rng.choice([1.0, 1e-15], size=(3, R // 8))  # some lanes as the kernels' 1e-15 patch
    dirs = torch.from_numpy(d.astype(np.float32))
    for voxel, trunc in ((0.03, 0.1), (0.12, 0.36), (0.0117, 0.047)):
        step = trunc * 0.8
        n = kernels.march_steps(trunc)
        g = torch.stack([torch.stack([_coord(start, dirs, voxel, step, torch.full((R,), k), i) for i in range(3)])
                         for k in range(n)])  # (n, 3, R)
        diff = g[1:] - g[:-1]
        assert bool((diff[:, dirs > 0] >= 0).all()) and bool((diff[:, dirs < 0] <= 0).all())
        assert bool((diff != 0).any())


# ------------------------------------------------------------------ the skip march's ray form
def skip_ray_twin(ray_start: CSFD, dirs_v, cfg, packed_read, shape):
    """``march_skip_ray_kernel``'s loop, every ray at once: test step k's
    sample with the carried prev (a crossing or a death ends the ray); then
    the n_steps stop; else a jumping step moves to its landing with prev 1.0
    and any other to k + 1 with its sample as prev. Returns the events, each
    ray's tested steps and the jumps taken."""
    from xslam_tpu_torch.ops.bricks import BRICK, JUMP_BASE

    voxel, step = cfg.voxel_size, cfg.trunc_dist * 0.8
    steps_per_cell = BRICK * voxel / step
    n = kernels.march_steps(cfg.trunc_dist)
    X, Y, Z = shape
    start = ray_start.v.reshape(3, 1)
    dirs = dirs_v.reshape(3, -1)
    R = dirs.shape[1]
    g0 = to_index(torch.floor((start + dirs * RAY_MIN_M) / voxel))
    g0 = torch.stack([g0[0].clamp(0, X - 1), g0[1].clamp(0, Y - 1), g0[2].clamp(0, Z - 1)])
    prev = torch.clamp(packed_read(g0), max=1.0)
    t_found = torch.full((R,), INF_T, dtype=torch.float32)
    t_dead = torch.full_like(t_found, INF_T)
    k = torch.zeros(R, dtype=torch.int64)
    live = torch.ones(R, dtype=torch.bool)
    tested = torch.zeros(R, dtype=torch.int64)
    jumps = 0
    while bool(live.any()):
        g = to_index(torch.floor((start + dirs * (RAY_MIN_M + (k.to(torch.float32) + 1.0) * step)) / voxel))
        ins = (g[0] >= 0) & (g[0] < X) & (g[1] >= 0) & (g[1] < Y) & (g[2] >= 0) & (g[2] < Z)
        c = packed_read(g)
        can_jump = ins & (c >= JUMP_BASE - 0.5)
        t_curr = RAY_MIN_M + k.to(torch.float32) * step
        crossing = live & ~can_jump & ins & (prev > 0.0) & (c < 0.0)
        death = live & ~can_jump & ~crossing & (~ins | ((prev < 0.0) & (c > 0.0)))
        t_found = torch.where(crossing, t_curr, t_found)
        t_dead = torch.where(death, t_curr, t_dead)
        tested += live
        ends = crossing | death | (k + 1 >= n)
        n_jump = torch.clamp(to_index(torch.floor((c - JUMP_BASE - 1.0) * steps_per_cell)), min=1)
        go = live & ~ends
        jumps += int((go & can_jump).sum())
        k = torch.where(go, k + torch.where(can_jump, n_jump, 1), k)
        prev = torch.where(go, torch.where(can_jump, torch.tensor(1.0), c), prev)
        live = go
    shape2 = dirs_v.shape[1:]
    return t_found.reshape(shape2), t_dead.reshape(shape2), tested.reshape(shape2), jumps


def _sphere_volume():
    """A 64^3 volume at 0.12 m holding a sphere of 1 m about its centre (value the signed distance over the
    truncation, clamped to [-1, 1], weight 1): its far bricks lie up to 5 bricks from the sphere's, so a skip
    march jumps; and the rays of a camera 0.6 m in from a corner looking at the centre."""
    n, voxel, trunc = 64, 0.12, 0.36
    c = (np.arange(n, dtype=np.float32) + 0.5) * voxel - 0.5 * n * voxel
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    value = torch.from_numpy(np.clip((r - 1.0) / trunc, -1.0, 1.0).astype(np.float32))
    eye = np.full(3, 0.6, np.float32)
    z = np.full(3, 0.5 * n * voxel, np.float32) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0.0, 0.0, 1.0], np.float32), z)
    x /= np.linalg.norm(x)
    c2v = np.eye(4, dtype=np.float32)
    c2v[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    c2v[:3, 3] = eye
    vcfg = raycast.VolumeConfig((n, n, n), voxel, trunc, 100.0)
    return value, torch.ones_like(value), vcfg, _rays(c2v)


def test_skip_ray_form_equals_the_serial_march(scene):
    """The ray form's loop gives ``march_skip_plain``'s events bit for bit on
    the skip-packed dense volume, at full resolution and at stride 2, and
    tests the steps the serial loop visits (its reads after the first): on
    the scene's volume and on a sphere's, whose rays jump."""
    vol, vcfg = scene["volume"], scene["vcfg"]
    cases = [(vol.value, vol.weight, vcfg, scene["rays"]), _sphere_volume()]
    jumps = 0
    for value, weight, cfg, (ray_start, ray_dir) in cases:
        shape = tuple(cfg.resolution)
        read = raycast._dense_reader(raycast.pack_dense(value, raycast.brick_distance_field(value, weight)))
        for s in (1, 2):
            dirs = ray_dir.v[:, ::s, ::s]
            stats = {}
            plain = raycast.march_skip_plain(ray_start, dirs, cfg, read, shape, stats=stats)
            tf, td, tested, n_jumps = skip_ray_twin(ray_start, dirs, cfg, read, shape)
            assert torch.equal(tf.view(torch.int32), plain.t_found.view(torch.int32))
            assert torch.equal(td.view(torch.int32), plain.t_dead.view(torch.int32))
            assert torch.equal(tested, stats["ray_samples"] - 1)
            jumps += n_jumps
    assert jumps > 0


def test_skip_ray_form_by_the_number_of_rays():
    """The wrappers launch the ray form from ``SKIP_RAY_FORM_MIN_RAYS`` rays:
    the refresh's 60 x 80 rays keep a warp a ray, the brick skip march's
    240 x 320 and B14b's 480 x 640 take the ray form."""
    n = raycast.SKIP_RAY_FORM_MIN_RAYS
    assert not raycast.skip_ray_form(1, n - 1) and raycast.skip_ray_form(1, n)
    assert not raycast.skip_ray_form(60, 80)
    assert raycast.skip_ray_form(240, 320) and raycast.skip_ray_form(480, 640)
