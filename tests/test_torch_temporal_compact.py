"""The first-event temporal march (``raycast_temporal_phase1 > 0``) in the port:
``xslam_tpu_torch.ops.raycast.march_temporal_compact``, the plain version of
kernel B16, against ``xslam_tpu/ops/raycast.py::march_temporal_compact`` and
the JAX engine, on the CPU at the tests' scale (the 64^3 brick volume of
``tests/test_torch_raycast_bricks.py``, 160x120 rays).

- Against the JAX function at ``phase1`` 1, 4 and 12 and ``cap_frac`` 0.16
  and 0.001 (the last leaves nearly every survivor to the JAX function's
  exact sweep): ``t_found`` and ``t_dead`` at the same step index on >=
  99.9% of rays with times within 1e-6, and ``f0``, ``f1`` equal on >= 99.9%
  of those rays, as ``tests/test_torch_raycast_bricks.py`` holds the window
  march (XLA fuses multiply-adds that PyTorch rounds twice). The port's own
  ``phase1`` and ``cap_frac`` change no bit.
- The claim of the JAX docstring, in the port: the accepted rays and their
  hits are ``march_temporal``'s bit for bit; each ray records one event.
- B16's rounds, in numpy: reading a round's steps before testing them and
  stopping at the first event gives the serial first-event loop's outputs,
  bits and all, for the kernel's round size and those around it.
- B16's wrapper on CPU tensors is its plain version, with and without the
  ``reuse`` refine.
- The engines in bench.py's configuration with ``raycast_temporal_phase1=4``,
  with the ``reuse`` refine and with ``secant2`` (3 frames): every frame
  aligns, the first tracked frame within 5e-4, the ATE in one class, and the
  port's run within that class of its run with ``phase1`` 0
  (``tests/test_march_skip.py::test_engine_temporal_phase1_matches_plain``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_raycast_bricks import (
    BENCH, INF_T, NO_STEP, RAY_MAX, ROUND_SIZES, TINTR, _events_agree, _jreader, _kernel_batch, _march_times,
    _window_case,
)
from tests.test_torch_raycast_bricks import scene  # noqa: F401  (the module's fixture)
from tests.torch_port_helpers import paired_engine_runs
from xslam_tpu.ops import raycast as jraycast
from xslam_tpu.utils.evaluation import ate_rmse, normalize_to_first
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops import raycast as traycast
from xslam_tpu_torch.ops import raycast_bricks as trb

WINDOW = 12
STEP = 0.288  # 0.8 * the small config's trunc_dist
N_FRAMES = 3


@pytest.fixture(scope="module")
def anchors(scene):
    """Frame 3's anchors: frame 2's exact skip-march hits, with a band of
    holes (no anchor in their neighbourhood) and a band moved two steps late
    (rays that die or cross past the window), so every kind of ray occurs."""
    tcfg, res, f = scene["tcfg"], scene["tcfg"].resolution, scene["frames"][2]
    packed = trb._value_reader(trb.bricks.skip_rows(scene["tvol"], res), res)
    t = traycast.march_skip_plain(f["tstart"], f["tdir"].v, tcfg, packed, res).t_found.clone()
    t[40:48] = torch.inf
    t[80:96] += 2 * STEP
    return t


def _port_compact(scene, anchors, **kw):
    tcfg, res, f = scene["tcfg"], scene["tcfg"].resolution, scene["frames"][3]
    return traycast.march_temporal_compact(anchors, f["tstart"], f["tdir"], tcfg, WINDOW,
                                           read_fn=trb._value_reader(scene["tvol"].value, res), shape=res,
                                           return_samples=True, **kw)


@pytest.mark.parametrize("cap_frac", [0.16, 0.001])
@pytest.mark.parametrize("phase1", [1, 4, 12])
def test_march_temporal_compact_against_jax(scene, anchors, phase1, cap_frac):
    res, f = scene["tcfg"].resolution, scene["frames"][3]
    jhit, jf0, jf1 = jraycast.march_temporal_compact(
        None, jnp.asarray(anchors.numpy()), f["jstart"], f["jdir"], scene["jcfg"], window=WINDOW, phase1=phase1,
        cap_frac=cap_frac, read_fn=_jreader(scene["jvol"].value, res), shape=res, return_samples=True)
    thit, tf0, tf1 = _port_compact(scene, anchors, phase1=phase1, cap_frac=cap_frac)
    agree = _events_agree(jhit, thit, STEP)
    assert agree.mean() >= 0.999, agree.mean()
    for j, t in ((jf0, tf0), (jf1, tf1)):
        assert np.mean(np.asarray(j)[agree] == t.numpy()[agree]) >= 0.999
    found, dead = thit.t_found < INF_T, thit.t_dead < INF_T
    assert float(found.float().mean()) > 0.5 and bool(dead.any()) and bool((~found & ~dead).any())
    assert not bool((found & dead).any())  # one event a ray


def test_port_schedule_changes_nothing(scene, anchors):
    base = _port_compact(scene, anchors)
    for kw in (dict(phase1=1, cap_frac=0.001), dict(phase1=12, cap_frac=1.0)):
        other = _port_compact(scene, anchors, **kw)
        for a, b in zip((base[0].t_found, base[0].t_dead, base[1], base[2]),
                        (other[0].t_found, other[0].t_dead, other[1], other[2])):
            assert torch.equal(a, b)


def test_accepted_rays_are_the_window_marchs(scene, anchors):
    """``march_temporal_compact``'s docstring: the accepted rays, their hits
    and samples are ``march_temporal``'s; only rejected rays may differ
    (a death before the crossing leaves the crossing unrecorded)."""
    tcfg, res, f = scene["tcfg"], scene["tcfg"].resolution, scene["frames"][3]
    chit, cf0, cf1 = _port_compact(scene, anchors)
    phit, pf0, pf1 = traycast.march_temporal(anchors, f["tstart"], f["tdir"], tcfg, WINDOW,
                                             trb._value_reader(scene["tvol"].value, res), res, return_samples=True)
    c_ok = chit.t_found < torch.clamp(chit.t_dead, max=INF_T)
    p_ok = phit.t_found < torch.clamp(phit.t_dead, max=INF_T)
    assert torch.equal(c_ok, p_ok) and float(c_ok.float().mean()) > 0.5
    for a, b in ((chit.t_found, phit.t_found), (cf0, pf0), (cf1, pf1)):
        assert torch.equal(a[c_ok], b[c_ok])
    assert bool((chit.t_dead != phit.t_dead).any())  # the first event ends a ray: later deaths go unrecorded


# ------------------------------------------------- B16's rounds, in numpy
def _serial_first_event(first, samples, inside, t_curr, window):
    """The JAX function's per-ray rule, one step at a time: a ray stops at its
    first crossing (with its two samples) or death, at the window's end or
    once ``t_curr`` reaches 5 m."""
    t_found = t_dead = np.float32(INF_T)
    f0, f1 = np.float32(1.0), np.float32(-1.0)
    prev = first
    for k in range(window):
        if not t_curr[k] < RAY_MAX:
            break
        tsdf = samples[k]
        if not inside[k] or (prev < 0 and tsdf > 0):
            t_dead = t_curr[k]
            break
        if prev > 0 and tsdf < 0:
            t_found, f0, f1 = t_curr[k], prev, tsdf
            break
        prev = tsdf
    return t_found, t_dead, f0, f1


def _round_first_event(first, samples, inside, t_curr, window, batch):
    """numpy twin of ``window_march_kernel<false, true>``'s march: B4's rounds
    of ``batch`` steps, every read of a round before any test (a dead step
    reads nothing), the steps then tested in order; the first event ends the
    round's tests and the march."""
    kc = kd = NO_STEP
    f0, f1 = np.float32(1.0), np.float32(-1.0)
    prev = first
    base, stop = 0, False
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
                if crossing or death:
                    stop = True
                    break
            prev = tsdf
        if stop or (kc != NO_STEP and kd != NO_STEP):
            break
        base += batch
    t_found = t_curr[kc] if kc != NO_STEP else np.float32(INF_T)
    t_dead = t_curr[kd] if kd != NO_STEP else np.float32(INF_T)
    return t_found, t_dead, f0, f1


@pytest.mark.parametrize("window", [12, 8])
@pytest.mark.parametrize("kind", ["no_event", "crossing_then_death", "exit", "past_5m", "random"])
def test_first_event_rounds_are_the_serial_rule(kind, window):
    """B16's rounds, for the kernel's BATCH and the sizes around it, give the
    serial first-event rule's t_found, t_dead, f0 and f1, bits and all; at
    most one of the two events is recorded."""
    assert _kernel_batch() in ROUND_SIZES
    rng = np.random.default_rng([window, len(kind), 16])
    for _ in range(200):
        case = _window_case(rng, kind, window)
        want = _serial_first_event(*case, window)
        assert want[0] == INF_T or want[1] == INF_T
        for batch in ROUND_SIZES:
            got = _round_first_event(*case, window, batch)
            assert np.array(got, np.float32).tobytes() == np.array(want, np.float32).tobytes(), (batch, got, want)
        if kind == "crossing_then_death":  # the crossing comes first: the death after it is not recorded
            assert want[1] == INF_T


@settings(max_examples=150, deadline=None)
@given(signs=st.lists(st.integers(-2, 2), min_size=28, max_size=28), exit_at=st.integers(0, 30),
       window=st.integers(0, 12), t_begin=st.floats(0.25, 5.25, width=32), first=st.integers(-1, 1))
def test_first_event_rounds_hypothesis(signs, exit_at, window, t_begin, first):
    samples = np.array(signs, np.float32) * np.float32(0.25) + np.float32(1e-5)
    inside = np.arange(28) < exit_at
    samples = np.where(inside, samples, np.float32(1e-5)).astype(np.float32)
    case = (np.float32(first * 0.5) + np.float32(1e-5), samples, inside, _march_times(t_begin, 0.072, 28))
    want = _serial_first_event(*case, window)
    for batch in ROUND_SIZES:
        got = _round_first_event(*case, window, batch)
        assert np.array(got, np.float32).tobytes() == np.array(want, np.float32).tobytes(), batch


@pytest.mark.parametrize("refine", [False, True])
def test_b16_wrapper_on_cpu_is_its_plain_version(scene, anchors, refine):
    tcfg, f = scene["tcfg"], scene["frames"][3]
    pose = kernels.pack_ray_pose(*f["targs"])
    got = trb.window_march(scene["tvol"], pose, TINTR, tcfg, anchors, WINDOW, refine=refine, first_event=True)
    ray_dir, ray_start = kernels.camera_rays(f["targs"][0], f["targs"][1], TINTR)
    out = traycast.march_temporal_compact(anchors, ray_start, ray_dir, tcfg, WINDOW,
                                          read_fn=trb._value_reader(scene["tvol"].value, tcfg.resolution),
                                          shape=tcfg.resolution, return_samples=refine)
    if refine:
        vmap, hit = trb._reuse_maps(scene["tvol"], ray_start, ray_dir, out, *f["targs"][2:], tcfg)
        pairs = ((got[0].v, vmap.v), (got[0].g, vmap.g), (got[1], hit.t_found))
        assert float(torch.isfinite(vmap.v[0]).float().mean()) > 0.5
    else:
        pairs = ((got.t_found, out.t_found), (got.t_dead, out.t_dead))
    for a, b in pairs:
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert kernels.launch_counts["window_march_first_event"] == 0
    with pytest.raises(ValueError):  # B16 takes an anchor map, not coarse hits
        trb.window_march(scene["tvol"], pose, TINTR, tcfg, anchors, WINDOW, anchor_dead=anchors, first_event=True)


# ------------------------------------------------------------- the engines
ENGINE_CASES = {"reuse": dict(BENCH, raycast_temporal_phase1=4),
                "secant2": dict(BENCH, raycast_temporal_phase1=4, raycast_refine="secant2")}


@pytest.fixture(scope="module", params=sorted(ENGINE_CASES))
def engines(request):
    return paired_engine_runs(ENGINE_CASES[request.param], N_FRAMES)


def test_engines_first_tracked_frame(engines):
    assert all(engines["jax"]["ok"]) and all(engines["port"]["ok"])
    np.testing.assert_allclose(engines["port"]["poses"][1], engines["jax"]["poses"][1], atol=5e-4)


def test_engines_ate_class(engines):
    ate_j = ate_rmse(normalize_to_first(engines["jax"]["poses"]), engines["gt"])
    ate_t = ate_rmse(normalize_to_first(engines["port"]["poses"]), engines["gt"])
    assert ate_j < 0.06 and ate_t < 0.06, (ate_j, ate_t)
    assert abs(ate_j - ate_t) < 5e-3, (ate_j, ate_t)


def test_engines_t_prev(engines):
    """The first-event march's hits are the next frame's anchors in both."""
    for i, (j, t) in enumerate(zip(engines["jax"]["t_prev"], engines["port"]["t_prev"])):
        agree = np.mean(np.where(j >= INF_T, -1, np.round((j - 0.2) / STEP)) ==
                        np.where(t >= INF_T, -1, np.round((t - 0.2) / STEP)))
        assert agree >= (0.999 if i == 0 else 0.99), (i, agree)


def test_port_phase1_keeps_the_ate_class():
    """The port with ``phase1`` 4 against itself with ``phase1`` 0, as the
    JAX package holds its own (tests/test_march_skip.py:471)."""
    from tests.helpers import small_config, small_dataset
    from tests.torch_port_helpers import torch_config
    from xslam_tpu_torch.models.kinfu import XSlamEngine as TorchEngine

    ds = small_dataset(N_FRAMES, degrees_per_frame=1.0)
    gt = normalize_to_first([ds.get_pose(i) for i in range(N_FRAMES)])
    ates = []
    for phase1 in (0, 4):
        engine = TorchEngine(torch_config(small_config(end_frame=N_FRAMES, raycast_temporal_phase1=phase1,
                                                       **BENCH)), device="cpu")
        state = engine.init_state()
        for i in range(N_FRAMES):
            state, res = engine.process_frame(state, ds.get_depth(i))
            engine.log_pose(res)
            assert bool(res.align_ok)
        ates.append(ate_rmse(normalize_to_first(engine.pose_log), gt))
    assert abs(ates[0] - ates[1]) < max(0.2 * ates[0], 0.005), ates
