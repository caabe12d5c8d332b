"""The port's raycast (plain march = kernel K3's twin, dual secant refine, TSDF
normals) against xslam_tpu.ops.raycast on a volume fused by the JAX engine
(pose derivative seeded) and carried across with ``state_from_numpy``.

Tolerance: march events at the same step on >= 99.9% of rays (a sample on a
floor boundary may pick the neighbouring voxel when XLA fuses a
multiply-add), and event times within 1e-6 m: XLA on the CPU contracts the
march time ``0.2 + k * step`` into one fused multiply-add where the port, like
its CUDA kernel built with ``-fmad=false``, rounds twice, so a time may
differ in its last bit;
vertex/normal finite masks agree on >= 99.5% of pixels and values within
1e-4 where both are finite (derivative lanes relative to their largest
entry).

The wrappers of the raycast stage (K3 ``kernels.march_fixed``, K5
``raycast_refine``, K6 ``model_map_pyramid``) take the packed pose; on CPU
tensors each returns its plain version's result bit for bit and launches
nothing, and their composition is held against the JAX functions at the
pyramid's coarser levels with ``test_model_maps``' tolerances. The stop rule
of K3's unrolled loop (take U samples, apply the tests in step order, stop
after the first step at which both events are known) has a numpy twin here,
held equal to ``march_fixed_plain`` for U in {1, 2, 4, 8}."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.torch_port_helpers import jax_state_to_numpy, seed_jax_state, seeded_pose_direction
from xslam_tpu.csfd.single import lift as jlift
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu.models.kinfu import XSlamEngine
from xslam_tpu.models.kinfu import _resize_nmap_dual as j_resize_nmap_dual
from xslam_tpu.ops import preprocess as jpre
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops import raycast as jray
from xslam_tpu_torch.csfd.single import lift as tlift
from xslam_tpu_torch.geometry import se3 as tse3
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.models.kinfu import _resize_nmap_dual, model_map_pyramid
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops import preprocess as tpre
from xslam_tpu_torch.ops import raycast as tray
from xslam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy


def _poses(se3, lift, w2c, w2v):
    c2w = se3.inverse(w2c)
    c2v = se3.matmul(lift(w2v), c2w)
    v2w = se3.inverse(lift(w2v))
    return se3.rotation(c2v), se3.translation(c2v), se3.rotation(v2w), se3.translation(v2w)


@pytest.fixture(scope="module")
def rendered():
    cfg = small_config()
    ds = small_dataset(3, degrees_per_frame=1.0)
    engine = XSlamEngine(cfg)
    state = seed_jax_state(engine.init_state(), seeded_pose_direction(2))
    for i in range(3):
        state, _ = engine.process_frame(state, ds.get_depth(i))
    d = jax_state_to_numpy(state)
    tstate = state_from_numpy(d, "cpu")
    w2v = np.asarray(cfg.world2volume, np.float32)
    jvc = jfusion.VolumeConfig(tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    tvc = tfusion.VolumeConfig(tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)

    jp = _poses(jse3, jlift, state.world2camera, jnp.asarray(w2v))
    j_rays = jax.jit(functools.partial(jray._camera_rays, intr=engine.intr))(jp[0], jp[1])
    j_hit = jax.jit(functools.partial(jray.march, cfg=jvc))(state.volume.value, j_rays[1], j_rays[0])
    j_maps = jax.jit(functools.partial(jray.raycast, intr=engine.intr, cfg=jvc, packed_taps=False))(
        state.volume, *jp)

    tp = _poses(tse3, tlift, tstate.world2camera, torch.from_numpy(w2v))
    tintr = Intrinsics(*engine.intr)
    t_dir, t_start = kernels.camera_rays(tp[0], tp[1], tintr)
    pose = kernels.pack_ray_pose(*tp)
    t_hit = kernels.march_fixed(tstate.volume.value, pose, tintr, tvc.voxel_size, tvc.trunc_dist)
    t_maps = tray.raycast(tstate.volume, *tp, tintr, tvc)
    return d, tstate, (j_rays, j_hit, j_maps), (t_dir, t_hit, t_maps), (tp, pose, tintr, tvc, t_start)


def test_state_roundtrip(rendered):
    d, tstate = rendered[:2]
    back = state_to_numpy(tstate)
    assert back.keys() == d.keys()
    for k, v in d.items():
        for a, b in zip(v if isinstance(v, list) else [v], back[k] if isinstance(v, list) else [back[k]]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_camera_rays(rendered):
    (j_rays, _, _), (t_dir, _, _) = rendered[2], rendered[3]
    np.testing.assert_allclose(t_dir.v.numpy(), np.asarray(j_rays[0].v), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_dir.g.numpy(), np.asarray(j_rays[0].g), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("event", ["t_found", "t_dead"])
def test_march_events(rendered, event):
    j_hit, t_hit = rendered[2][1], rendered[3][1]
    j = np.asarray(getattr(j_hit, event))
    t = t_hit[0 if event == "t_found" else 1].numpy()
    assert np.mean(j < jray.INF_T) > 0.5  # the rays do hit the fused surface
    step = small_config().trunc_dist * 0.8

    def step_index(x):
        return np.where(x < jray.INF_T, np.round((x - jray.RAY_MIN_M) / step), -1)

    same = step_index(j) == step_index(t)
    assert np.mean(same) >= 0.999
    np.testing.assert_allclose(t[same], j[same], rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["vmap", "nmap"])
def test_model_maps(rendered, which):
    j_maps, t_maps = rendered[2][2], rendered[3][2]
    i = 0 if which == "vmap" else 1
    jv, jg = np.asarray(j_maps[i].v), np.asarray(j_maps[i].g)
    tv, tg = t_maps[i].v.numpy(), t_maps[i].g.numpy()
    jf, tf = np.isfinite(jv[0]), np.isfinite(tv[0])
    assert jf.mean() > 0.5
    assert np.mean(jf == tf) >= 0.995
    both = jf & tf
    np.testing.assert_allclose(tv[:, both], jv[:, both], atol=1e-4)
    assert np.abs(jg[:, both]).max() > 0  # the seeded derivative reached the maps
    np.testing.assert_allclose(tg[:, both], jg[:, both], atol=1e-4 * max(1.0, np.abs(jg[:, both]).max()))


def test_other_march_modes_not_ported(rendered):
    tstate = rendered[1]
    with pytest.raises(NotImplementedError):
        tray.raycast(tstate.volume, *([None] * 4), None, None, march_mode="skip")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def test_packed_pose_roundtrip(rendered):
    tp, pose = rendered[4][:2]
    assert pose.shape == (kernels.RAY_POSE_FLOATS,) and pose.dtype == torch.float32
    for back, orig in zip(kernels.unpack_ray_pose(pose), tp):
        assert _bits_equal(back.v, orig.v.contiguous()) and _bits_equal(back.g, orig.g.contiguous())


def test_camera_args_are_the_rays_roundings(rendered):
    """The float32 numbers handed to K3, K5 and K8 against what
    ``camera_rays`` and ``create_vmap`` compute with the Python floats: the
    subtraction is the same, the division by the focal length is a multiply
    by its reciprocal, taken in double and rounded to float32 (PyTorch's CUDA
    rounding), one ulp at most from the CPU's true division."""
    tintr = rendered[4][2]
    cx, cy, inv_fx, inv_fy = kernels.camera_args(tintr)
    assert inv_fx == float(np.float32(1.0 / tintr.fx))
    assert inv_fy == float(np.float32(1.0 / tintr.fy))
    for n, c, inv, f in ((tintr.width, cx, inv_fx, tintr.fx), (tintr.height, cy, inv_fy, tintr.fy)):
        u = torch.arange(n, dtype=torch.float32)
        centred = u - (tintr.cx if n == tintr.width else tintr.cy)
        np.testing.assert_array_equal(centred.numpy(), np.arange(n, dtype=np.float32) - np.float32(c))
        on_card = centred.numpy() * np.float32(inv)
        on_cpu = (centred / f).numpy()
        assert np.all(np.abs(on_card - on_cpu) <= np.spacing(np.abs(on_cpu)))
    assert kernels.reciprocal_f32(1000.0) == float(np.float32(0.001))  # K8's literal


@pytest.mark.parametrize("wrapper", ["march_fixed", "raycast_refine", "resize_model_maps"])
def test_raycast_wrappers_use_plain_versions_on_cpu(rendered, wrapper):
    tstate, t_hit, t_maps = rendered[1], rendered[3][1], rendered[3][2]
    tp, pose, tintr, tvc, t_start = rendered[4]
    before = dict(kernels.launch_counts)
    if wrapper == "march_fixed":
        ray_dir, ray_start = kernels.camera_rays(tp[0], tp[1], tintr)
        plain = kernels.march_fixed_plain(tstate.volume.value, ray_start, ray_dir, tvc.voxel_size, tvc.trunc_dist)
        pairs = list(zip(t_hit, plain))
    elif wrapper == "raycast_refine":
        ray_dir, ray_start = kernels.camera_rays(tp[0], tp[1], tintr)
        accept = t_hit[0] < torch.clamp(t_hit[1], max=kernels.INF_T)
        plain = tray.finalize_maps(*tray.refine(tstate.volume, ray_start, ray_dir, t_hit[0], accept, tp[2], tp[3], tvc))
        out = tray.raycast_refine(tstate.volume, pose, *t_hit, tintr, tvc)
        pairs = [(o.v, p.v) for o, p in zip(out, plain)] + [(o.g, p.g) for o, p in zip(out, plain)]
        pairs += [(o.v, m.v) for o, m in zip(out, t_maps)]  # and raycast() is the composition
    else:  # K6, whose launch count keeps the name of its first, one-level design
        vmaps, nmaps = model_map_pyramid(*t_maps, 3)
        assert vmaps[0] is t_maps[0] and nmaps[0] is t_maps[1]
        pairs, v, n = [], t_maps[0], t_maps[1]
        for level in (1, 2):
            v = type(v)(tpre.resize_vmap(v.v), tpre.resize_vmap(v.g))
            n = _resize_nmap_dual(n)
            pairs += [(vmaps[level].v, v.v), (vmaps[level].g, v.g), (nmaps[level].v, n.v), (nmaps[level].g, n.g)]
    for got, want in pairs:
        assert _bits_equal(got, want)
    assert kernels.launch_counts == before  # CPU tensors launch nothing


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("which", ["vmap", "nmap"])
def test_model_map_pyramid(rendered, which, level):
    """The composed stage, K3 wrapper -> K5 wrapper -> K6 wrapper (all
    levels at once), against the JAX raycast and its pyramid (``resize_vmap``
    on both lanes, ``_resize_nmap_dual``), with ``test_model_maps``'
    tolerances."""
    j_maps, tstate = rendered[2][2], rendered[1]
    _, pose, tintr, tvc, _ = rendered[4]
    t_found, t_dead = kernels.march_fixed(tstate.volume.value, pose, tintr, tvc.voxel_size, tvc.trunc_dist)
    tv, tn = tray.raycast_refine(tstate.volume, pose, t_found, t_dead, tintr, tvc)
    jv, jn = j_maps
    tvmaps, tnmaps = model_map_pyramid(tv, tn, level + 1)
    tv, tn = tvmaps[level], tnmaps[level]
    for _ in range(level):
        jv = type(jv)(jpre.resize_vmap(jv.v), jpre.resize_vmap(jv.g))
        jn = j_resize_nmap_dual(jn)
    t, j = (tv, jv) if which == "vmap" else (tn, jn)
    assert t.v.shape == (3, tintr.height >> level, tintr.width >> level)
    jval, jg = np.asarray(j.v), np.asarray(j.g)
    tval, tg = t.v.numpy(), t.g.numpy()
    jf, tf = np.isfinite(jval[0]), np.isfinite(tval[0])
    assert jf.mean() > 0.4
    assert np.mean(jf == tf) >= 0.995
    both = jf & tf
    np.testing.assert_allclose(tval[:, both], jval[:, both], atol=1e-4)
    np.testing.assert_allclose(tg[:, both], jg[:, both], atol=1e-4 * max(1.0, np.abs(jg[:, both]).max()))


def _march_unrolled_twin(value, start, dirs, voxel_size, trunc_dist, unroll):
    """K3's loop in numpy: every live ray takes ``unroll`` samples at once
    (bounds-checked reads, also past the last step), then applies the crossing
    and death tests in step order and stops after the first step at which
    both events are known; samples past that step, or past the last step, are
    read and ignored."""
    X, Y, Z = value.shape
    f = np.float32
    step, vs = f(trunc_dist * 0.8), f(voxel_size)
    n_steps = kernels.march_steps(trunc_dist)
    d = dirs.reshape(3, -1)
    n = d.shape[1]

    def sample(t):
        g = [np.nan_to_num(np.floor((start[i] + d[i] * f(t)) / vs), nan=-1.0).clip(-2 ** 30, 2 ** 30).astype(np.int64)
             for i in range(3)]
        inside = (g[0] >= 0) & (g[0] < X) & (g[1] >= 0) & (g[1] < Y) & (g[2] >= 0) & (g[2] < Z)
        return g, inside

    g0, _ = sample(kernels.RAY_MIN_M)
    prev = value[g0[0].clip(0, X - 1), g0[1].clip(0, Y - 1), g0[2].clip(0, Z - 1)] + f(1e-5)
    t_found = np.full(n, kernels.INF_T, f)
    t_dead = np.full(n, kernels.INF_T, f)
    done = np.zeros(n, bool)
    reads = 0
    for k0 in range(0, n_steps, unroll):
        if done.all():
            break
        batch = []
        for j in range(unroll):  # the loads, started together
            g, inside = sample(f(kernels.RAY_MIN_M) + f(k0 + j + 1) * step)
            tsdf = np.where(inside, value[g[0].clip(0, X - 1), g[1].clip(0, Y - 1), g[2].clip(0, Z - 1)], f(0)) + f(1e-5)
            batch.append((inside, tsdf.astype(f)))
            reads += int((~done).sum())
        for j, (inside, tsdf) in enumerate(batch):  # the tests, in step order
            k = k0 + j
            if k >= n_steps:
                break
            live = ~done
            t_curr = f(kernels.RAY_MIN_M) + f(k) * step
            death = ~inside | (inside & (prev < 0) & (tsdf > 0))
            crossing = inside & (prev > 0) & (tsdf < 0)
            t_found = np.where(live & crossing & (t_curr < t_found), t_curr, t_found)
            t_dead = np.where(live & death & (t_curr < t_dead), t_curr, t_dead)
            prev = np.where(live, tsdf, prev)
            done = done | ((t_found < kernels.INF_T) & (t_dead < kernels.INF_T))
    return t_found.reshape(dirs.shape[1:]), t_dead.reshape(dirs.shape[1:]), reads


@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
def test_unrolled_march_stop_rule(rendered, unroll):
    tstate, t_dir = rendered[1], rendered[3][0]
    _, _, _, tvc, t_start = rendered[4]
    plain = kernels.march_fixed_plain(tstate.volume.value, t_start, t_dir, tvc.voxel_size, tvc.trunc_dist)
    found, dead, reads = _march_unrolled_twin(
        tstate.volume.value.numpy(), t_start.v.numpy(), t_dir.v.numpy(), tvc.voxel_size, tvc.trunc_dist, unroll)
    np.testing.assert_array_equal(found, plain[0].numpy())
    np.testing.assert_array_equal(dead, plain[1].numpy())
    # stopping early is what the rule is for: fewer reads than the lockstep march's
    n_steps = kernels.march_steps(tvc.trunc_dist)
    assert reads < t_dir.v[0].numel() * (-(-n_steps // unroll) * unroll)


def _cell_twin(p, inv_vs, vs, size):
    """``csrc/refine.cu::cell_at`` in numpy float32 on (N,) coordinates of one
    axis: the base cell (shifted down below the voxel centre) and the bounds
    test on the unshifted index."""
    f = np.float32
    g = np.nan_to_num(np.floor(p * inv_vs), nan=-1.0).clip(-2 ** 30, 2 ** 30).astype(np.int64)
    ok = (g > 0) & (g < size - 1)
    g = g - (p < (g.astype(f) + f(0.5)) * vs)
    return g, ok


def _shared_block_twin(vertex, voxel_size, shape):
    """K5's rule for the six normal samples (``csrc/refine.cu::axis_difference``)
    in numpy float32, for vertices (3, N) inside the normal's margin.

    Returns ``(own, block, staged, distinct)``: for each of the six samples
    (axis a, then + before -), the flat indices (N, 8) of the eight taps its
    own cell names, as ``trilinear_tsdf_shard`` computes the cell; the flat
    indices (N, 8) the kernel takes from the shared block instead (the
    vertex's 2x2x2 block and the face across axis a, picked by h); whether
    the kernel takes them (the sample's cell is where the rule says, else it
    reads its own taps); and the number of distinct voxels of the block and
    the three faces, a vertex."""
    f = np.float32
    vs, inv_vs, half = f(voxel_size), f(kernels.reciprocal_f32(voxel_size)), f(voxel_size * 0.5)
    X, Y, Z = shape

    def flat(x, y, z):
        return (x * Y + y) * Z + z

    gv = [np.floor(vertex[i] * inv_vs).astype(np.int64) for i in range(3)]
    cv = [_cell_twin(vertex[i], inv_vs, vs, shape[i])[0] for i in range(3)]
    own, block, staged, voxels = [], [], [], [flat(*(cv[i] + ((k >> (2 - i)) & 1) for i in range(3)))
                                              for k in range(8)]
    for a in range(3):
        others = [i for i in range(3) if i != a]
        upper = cv[a] == gv[a]  # h = 1: the vertex lies in the upper half of its cell
        face = np.where(upper, gv[a] - 1, gv[a] + 1)
        for j in range(4):
            coords = [None] * 3
            coords[a] = face
            coords[others[0]], coords[others[1]] = cv[others[0]] + (j >> 1), cv[others[1]] + (j & 1)
            voxels.append(flat(*coords))
        # along axis a, line m holds the voxel at g - 1 + m: from the block (at cv, cv + 1) or the face
        line = [np.where(upper, face, cv[a]), np.where(upper, cv[a], cv[a] + 1), np.where(upper, cv[a] + 1, face)]
        for s, sign in enumerate((1.0, -1.0)):
            q = [vertex[i].copy() for i in range(3)]
            q[a] = (vertex[a] + f(sign) * half).astype(f)
            cells = [_cell_twin(q[i], inv_vs, vs, shape[i]) for i in range(3)]
            ok = cells[0][1] & cells[1][1] & cells[2][1]
            # the kernel takes the vertex's cell on the other two axes: the same coordinates, so the same cell
            for i in others:
                np.testing.assert_array_equal(cells[i][0], cv[i])
            staged.append(ok & (cells[a][0] == gv[a] - s))
            corners = [[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)]
            own.append(np.stack([flat(*(cells[i][0] + d[i] for i in range(3))) for d in corners], axis=1))
            picked = []
            for d in corners:
                coords = [cv[i] + d[i] for i in range(3)]
                coords[a] = line[d[a] + 1 - s]
                picked.append(flat(*coords))
            block.append(np.stack(picked, axis=1))
    distinct = np.array([len(set(col)) for col in np.stack(voxels, axis=1)])
    return own, block, staged, distinct


def _rule_vertices(kind, voxel_size, shape, n=4000):
    """float32 vertices (3, n) inside the normal's margin: seeded at random, or
    within two ulps of a cell edge (g * voxel) or of a cell centre
    ((g + 1/2) * voxel) on every axis."""
    rng = np.random.default_rng({"random": 11, "cell edges": 12, "cell centres": 13}[kind])
    f = np.float32
    out = []
    for i in range(3):
        if kind == "random":
            out.append(rng.uniform(2.5 * voxel_size, (shape[i] - 2.5) * voxel_size, n).astype(f))
            continue
        g = rng.integers(3, shape[i] - 3, n)
        at = (g + (0.5 if kind == "cell centres" else 0.0)).astype(f) * f(voxel_size)
        for _ in range(2):  # up to two ulps either way
            step = rng.integers(-1, 2, n)
            at = np.where(step > 0, np.nextafter(at, f(np.inf)), np.where(step < 0, np.nextafter(at, f(-np.inf)), at))
        out.append(at.astype(f))
    return np.stack(out)


@pytest.mark.parametrize("voxel_size, shape", [(0.03, (256, 256, 256)), (0.12, (64, 64, 48))])
@pytest.mark.parametrize("kind", ["random", "cell edges", "cell centres"])
def test_normal_samples_shared_block_rule(kind, voxel_size, shape):
    """Every normal sample that K5 feeds from the shared block gets the very
    voxels its own cell names, tap by tap, so the kernel's sums equal the
    plain version's; the block and the three faces are 20 distinct voxels
    (40 loads where the plain version makes 96). Samples whose cells rounding
    puts elsewhere read their own taps, and none is missed: frequent on
    vertices within an ulp of a cell edge, where the vertex's cell and a
    sample's (half a voxel off, at a voxel centre) come from separate
    roundings; rare on random vertices; none within an ulp of a cell centre,
    where the samples sit half a voxel from any rounding that moves them."""
    vertex = _rule_vertices(kind, voxel_size, shape)
    f = np.float32
    gv = np.floor(vertex * f(kernels.reciprocal_f32(voxel_size)))
    margin = np.all((gv > 1) & (gv < np.array(shape)[:, None] - 2), axis=0)
    assert margin.all()
    own, block, staged, distinct = _shared_block_twin(vertex, voxel_size, shape)
    assert (distinct == 20).all()
    for o, b, s in zip(own, block, staged):
        np.testing.assert_array_equal(o[s], b[s])
    direct = 1.0 - np.mean(staged)
    if kind == "cell edges":
        assert 0.0 < direct < 0.5, direct  # the exact path is needed, and stays the exception
    else:
        assert direct < 1e-3, direct
