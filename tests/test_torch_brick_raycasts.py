"""The brick layout's other raycasts in the port (``xslam_tpu_torch.ops.
raycast_bricks``): the ``skip``, ``hier_skip``, ``hier2_skip`` and
``temporal`` marches with the ``secant2`` refine (K5r's plain version) and
TSDF or screen normals, against ``xslam_tpu.ops.raycast_bricks`` and the JAX
engine, on the CPU at the tests' scale (the 64^3 brick volume of
``tests/test_torch_raycast_bricks.py``, 160x120 rays).

- ``refine`` through the pair taps over the brick rows gives the bits of the
  port's dense ``refine`` on the volume's dense twin (every lane, both
  masks), and JAX's ``refine(trilin_fn=trilinear_pair_bricks)`` within the
  tolerances of ``tests/test_torch_raycast.py`` (masks >= 99.5% equal,
  values within 1e-4, derivatives within 1e-4 of the largest); the
  ``reuse`` refine's maps within those of ``tests/test_torch_raycast_bricks.py``.
- ``raycast_bricks_rays`` for each march, refine and normals mode against
  JAX's jitted function on the same rays: the maps as above (the TSDF
  normals' derivatives also within 1e-3 relative: XLA fuses multiply-adds
  in the jitted refine), the hits at the same step index on >= 99.9% of
  rays (as the march tests hold them).
- ``raycast_bricks`` through the wrappers (B5a, B5b, B4, K5r, B4n in K6's
  plain versions on the CPU) equals ``raycast_bricks_rays`` bit for bit.
- The JAX engine's aliases (``fixed``, ``hier``, ``hier2``) run the marches
  they map to, bit for bit.

The engines with each march and normals mode are in
``tests/test_torch_brick_raycast_engines.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import SMALL_INTR
from tests.test_torch_raycast_bricks import BENCH, TINTR, _map_close, _step_index
from tests.test_torch_raycast_bricks import scene  # noqa: F401  (the module's fixture)
from tests.torch_port_helpers import torch_config
from xslam_tpu.csfd.single import CSFD as JCSFD
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops import raycast as jraycast
from xslam_tpu.ops import raycast_bricks as jrb
from xslam_tpu_torch.models import kinfu as tkinfu
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops import raycast as traycast
from xslam_tpu_torch.ops import raycast_bricks as trb
from xslam_tpu_torch.ops.kernels import INF_T

STEP = 0.288  # 0.8 * the small config's trunc_dist
# (march, refine, normals) of the plain composition; reuse only with the temporal march
RAYS_CASES = [(m, "secant2", n) for m in trb.BRICK_MARCH_MODES for n in ("screen", "tsdf")]
RAYS_CASES.append(("temporal", "reuse", "screen"))
N_FRAMES = 3
SECANT = dict(BENCH, raycast_refine="secant2")


def _hits(scene, frame):
    tcfg, res = scene["tcfg"], scene["tcfg"].resolution
    f = scene["frames"][frame]
    packed = trb._value_reader(trb.bricks.skip_rows(scene["tvol"], res), res)
    return traycast.march_skip_plain(f["tstart"], f["tdir"].v, tcfg, packed, res)


def _k5_close(j, t, rtol=0.0):
    """A ``secant2`` map against JAX's, with ``tests/test_torch_raycast.py::
    test_model_maps``' tolerances: masks >= 99.5% equal, values within 1e-4,
    derivatives within 1e-4 of the largest (the TSDF normals' derivative
    lanes reach some units), plus ``rtol``."""
    jv, tv, jg, tg = np.asarray(j.v), t.v.numpy(), np.asarray(j.g), t.g.numpy()
    jf, tf = np.isfinite(jv[0]), np.isfinite(tv[0])
    assert np.mean(jf == tf) >= 0.995, np.mean(jf == tf)
    both = jf & tf
    assert both.mean() > 0.3
    np.testing.assert_allclose(tv[:, both], jv[:, both], atol=1e-4)
    np.testing.assert_allclose(tg[:, both], jg[:, both], atol=1e-4 * max(1.0, np.abs(jg[:, both]).max()), rtol=rtol)


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def test_refine_over_rows_is_the_dense_refine(scene):
    """K5r's plain version: ``refine`` through the pair taps over the brick
    rows, with the rows' shape, is the dense ``refine`` on the dense twin bit
    for bit, and JAX's ``refine`` through its pair taps within tolerance."""
    tcfg, res, f = scene["tcfg"], scene["tcfg"].resolution, scene["frames"][3]
    hit = _hits(scene, 3)
    accept = hit.t_found < torch.clamp(hit.t_dead, max=INF_T)
    assert float(accept.float().mean()) > 0.5
    args = (f["tstart"], f["tdir"], hit.t_found, accept, *f["targs"][2:], tcfg)
    rows = traycast.refine(None, *args, trilin_fn=trb._pair_trilinear(scene["tvol"], tcfg), shape=res)
    dense = traycast.refine(scene["dense"], *args)
    for a, b in zip((rows[0].v, rows[0].g, rows[1].v, rows[1].g), (dense[0].v, dense[0].g, dense[1].v, dense[1].g)):
        assert _bits(a, b)
    assert torch.equal(rows[2], dense[2]) and torch.equal(rows[3], dense[3])
    assert float(rows[3].float().mean()) > 0.5  # normals on most pixels

    jvg = jrb.interleave_vg(scene["jvol"])

    def jtrilin(p):
        return jrb.trilinear_pair_bricks(jvg, res, *(JCSFD(p.v[i], p.g[i]) for i in range(3)), tcfg.voxel_size)

    shape_only = jax.ShapeDtypeStruct(res, jnp.float32)
    jout = jraycast.refine(jfusion.VolumeState(shape_only, shape_only, shape_only), f["jstart"], f["jdir"],
                           jnp.asarray(hit.t_found.numpy()), jnp.asarray(accept.numpy()), *f["jargs"][2:],
                           scene["jcfg"], normals_mode="tsdf", trilin_fn=jtrilin)
    jv, jn = jraycast.finalize_maps(*jout)
    tv, tn = traycast.finalize_maps(*rows)
    _k5_close(jv, tv)
    _k5_close(jn, tn)


@pytest.fixture(scope="module")
def anchor(scene):
    """Frame 2's exact skip-march hits: the temporal cases' anchors at frame 3."""
    return _hits(scene, 2).t_found


@pytest.mark.parametrize("march, refine, normals", RAYS_CASES)
def test_raycast_bricks_rays_against_jax(scene, anchor, march, refine, normals):
    """The plain composition of each brick raycast against JAX's on the same
    rays (JAX with its pair taps, as the port's)."""
    f = scene["frames"][3]
    kw = dict(normals_mode=normals, march_mode=march, refine_mode=refine, pair_taps=True, return_hit=True,
              t_anchor=anchor if march == "temporal" else None)
    tv, tn, tt = trb.raycast_bricks_rays(scene["tvol"], f["tstart"], f["tdir"], *f["targs"][2:], scene["tcfg"], **kw)
    jkw = dict(kw, t_anchor=None if kw["t_anchor"] is None else jnp.asarray(anchor.numpy()))
    jv, jn, jt = jax.jit(lambda v, a, b, c, d: jrb.raycast_bricks(v, a, b, c, d, SMALL_INTR, scene["jcfg"], **jkw))(
        scene["jvol"], *f["jargs"])
    if refine == "reuse":
        _map_close(jv, tv)
        _map_close(jn, tn, rtol=1e-4)
    else:
        # jit's fused multiply-adds move the TSDF normals' derivative lanes by up to 2.5e-4 of themselves on
        # a few pixels of equal hit times (the eager refine above stays inside 1e-4)
        _k5_close(jv, tv)
        _k5_close(jn, tn, rtol=1e-3)
    agree = np.mean(_step_index(np.asarray(jt), STEP) == _step_index(tt.numpy(), STEP))
    assert agree >= 0.999, agree
    assert float((tt < INF_T).float().mean()) > 0.5


@pytest.mark.parametrize("march, refine, normals", RAYS_CASES + [("temporal", "secant2", "refresh")])
def test_wrappers_are_the_plain_composition(scene, anchor, march, refine, normals):
    """``raycast_bricks`` through the wrappers (their plain versions on the
    CPU; the normals of ``screen`` through the pyramid's path) equals
    ``raycast_bricks_rays`` on the port's own rays, bit for bit; "refresh":
    the temporal march's refresh (the anchors' coverage below its limit)
    with the ``secant2`` refine and TSDF normals."""
    tcfg, f = scene["tcfg"], scene["frames"][3]
    refresh = normals == "refresh"
    normals = "tsdf" if refresh else normals
    t_anchor = torch.full_like(anchor, torch.inf) if refresh else anchor
    vmap, nmap, t_found = trb.raycast_bricks(scene["tvol"], *f["targs"], TINTR, tcfg,
                                             t_anchor if march == "temporal" else None, refresh=refresh,
                                             normals_mode=normals, march_mode=march, refine_mode=refine)
    if normals == "screen":
        assert nmap is None
        nmap = tkinfu.model_map_pyramid(vmap, None, 1)[1][0]
    ray_dir, ray_start = kernels.camera_rays(f["targs"][0], f["targs"][1], TINTR)
    pv, pn, pt = trb.raycast_bricks_rays(scene["tvol"], ray_start, ray_dir, *f["targs"][2:], tcfg,
                                         normals_mode=normals, march_mode=march, refine_mode=refine,
                                         t_anchor=t_anchor, return_hit=True)
    for a, b in zip((vmap.v, vmap.g, nmap.v, nmap.g, t_found), (pv.v, pv.g, pn.v, pn.g, pt)):
        assert _bits(a, b)
    assert float(torch.isfinite(vmap.v[0]).float().mean()) > 0.5
    assert all(kernels.launch_counts[k] == 0 for k in ("raycast_refine_bricks", "window_march", "march_skip"))


def test_raycast_refine_bricks_on_cpu_is_its_plain_version(scene):
    """K5r's wrapper on CPU tensors: the plain refine of the hits it is given."""
    tcfg, f = scene["tcfg"], scene["frames"][3]
    hit = _hits(scene, 3)
    pose = kernels.pack_ray_pose(*f["targs"])
    vmap, nmap = trb.raycast_refine_bricks(scene["tvol"], pose, hit.t_found, hit.t_dead, TINTR, tcfg)
    ray_dir, ray_start = kernels.camera_rays(f["targs"][0], f["targs"][1], TINTR)
    pv, pn = trb._secant_maps(scene["tvol"], ray_start, ray_dir, hit, *f["targs"][2:], tcfg)
    dense = traycast.raycast_refine(scene["dense"], pose, hit.t_found, hit.t_dead, TINTR, tcfg)  # K5's plain
    for a, b, c in zip((vmap.v, vmap.g, nmap.v, nmap.g), (pv.v, pv.g, pn.v, pn.g),
                       (dense[0].v, dense[0].g, dense[1].v, dense[1].g)):
        assert _bits(a, b) and _bits(a, c)
    assert kernels.launch_counts["raycast_refine_bricks"] == 0


@pytest.mark.parametrize("option, error", [
    (dict(march_mode="hier2"), ValueError),  # the engine's alias, not a march of the brick layout
    (dict(refine_mode="newton"), ValueError),
    (dict(march_mode="temporal", refine_mode="reuse", normals_mode="tsdf"), ValueError),
    (dict(march_mode="temporal"), ValueError),  # no anchors
    (dict(skip_gran=2), ValueError),
])
def test_raycast_bricks_rays_checks(scene, option, error):
    """The JAX function's checks, in the port's plain composition."""
    f = scene["frames"][3]
    with pytest.raises(error):
        trb.raycast_bricks_rays(scene["tvol"], f["tstart"], f["tdir"], *f["targs"][2:], scene["tcfg"], **option)


@pytest.mark.parametrize("alias, march", [("fixed", "skip"), ("hier", "hier_skip"), ("hier2", "hier2_skip")])
def test_brick_aliases_run_their_marches(alias, march):
    """The JAX engine maps ``fixed`` to ``skip`` (the same events) and the
    hier modes to the skip-anchored marches (xslam_tpu/models/kinfu.py:
    470-476): the port's engine runs the same march, bit for bit."""
    from tests.helpers import small_config, small_dataset
    from xslam_tpu_torch.models.kinfu import XSlamEngine as TorchEngine

    ds = small_dataset(N_FRAMES, degrees_per_frame=1.0)
    out = []
    for mode in (alias, march):
        engine = TorchEngine(torch_config(small_config(end_frame=N_FRAMES, **dict(SECANT, raycast_march=mode,
                                                                                  raycast_normals="tsdf"))),
                             device="cpu")
        state = engine.init_state()
        for i in range(N_FRAMES):
            state, res = engine.process_frame(state, ds.get_depth(i))
            engine.log_pose(res)
        out.append((np.stack(engine.pose_log), state.t_prev, state.vmaps_prev[0].v))
    assert out[0][0].tobytes() == out[1][0].tobytes()
    assert _bits(out[0][1], out[1][1]) and _bits(out[0][2], out[1][2])
