"""The sharded backend on the CPU: the observation-sharded bundle adjustment
(``xslam_tpu_torch/models/ba.py`` ``schur_ba(group=)``, ``schur_ba_cg(group=)``)
and the recovering engine over ``ShardedXSlamEngine``, against the port's
single forms and the JAX package's; and B18's plain passes (the two passes of
``S x`` that ``csrc/schur_cg.cu`` computes on the card).

Tolerances, and why:

- One rank (a gloo group of one in this process): the sharded forms equal the
  single forms bit for bit, and the recovering sharded engine the recovering
  single engine (its pose log, recovery events, keyframes and refined
  trajectory): a sum over one rank changes no bit, and the sharded engine is
  ``XSlamEngine``'s bit for bit at one rank.
- Two gloo ranks (one spawn of ``tests/sharded_rank.py`` with a ``"ba"`` and a
  ``"recover"`` job, beside JAX's ``shard_map`` over 8 CPU devices in this
  process): the sums' order changes, so BA's poses and anchors are held within
  1e-4 of the single form and of JAX's sharded result
  (tests/test_ba.py:165-167, :306-310); both ranks hold the same bits. The
  recovering engine: both ranks' logs identical (every rank decides on the
  same summed values), poses within 1e-3 of the single recovering engine
  (A11's rule), and tests/test_recovery.py:141-146's thresholds (a descending
  relocalization, the end within 60 mm).
- B18's plain passes against the matvec they replace (the same sums, with the
  per-observation products added by ``torch.sum``, whose order on the CPU is
  not the index order the kernel takes): within 2e-6 of each output's largest
  magnitude (float32 rounding of the products, measured 1.2e-7 of it), the
  same bits on a second call, and no launch on CPU tensors.
- B18's sum order (a numpy twin of the kernel's chunks, its threads' serial
  runs, warp scans and block carries, and its crossing sums,
  ``tests/test_torch_cg_march_redesigns.py::b18_sums``): every key written once, each sum
  within 1 float32 ulp of ``_Segments``' (both sum in float64 and round once;
  the orders differ).
"""

import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import tests.torch_port_helpers  # noqa: F401  (sets one intra-op thread)
from tests.helpers import small_config, small_dataset
from tests.test_torch_cg_march_redesigns import b18_sums
from tests.torch_port_helpers import torch_config
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu.models import ba as jba
from xslam_tpu_torch import run_slam
from xslam_tpu_torch.models import ba as tba
from xslam_tpu_torch.models.recovery import RecoveringEngine
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.parallel.engine import ShardedXSlamEngine
from xslam_tpu_torch.parallel.mesh import SpaceGroup, destroy_space_group, init_space_group
from xslam_tpu_torch.utils.evaluation import normalize_to_first

REPO = pathlib.Path(__file__).resolve().parents[1]
BA_ITERS = 6  # tests/test_ba.py:145, :288
SHARDED_TOL = 1e-4
RECOVER_POSE_TOL = 1e-3
PLAIN_PASS_TOL = 2e-6


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _bits(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


# ---------------------------------------------------------------- problems
def _ba_problem():
    """tests/test_ba.py:55's 5 keyframes x 40 anchors, its noisy start
    (:111-117) and its padding to a multiple of 8 rows with copies of row 0
    (:121-130): numpy arrays."""
    rng = np.random.default_rng(1)
    K, L = 5, 40
    gt = np.stack([np.array([1.5 * np.cos(0.15 * k), 0.1 * k, 1.5 * np.sin(0.15 * k), 0.0, 0.15 * k, 0.0],
                            np.float32) for k in range(K)])
    gt_T = [np.asarray(jse3.exp_real(jnp.asarray(x))) for x in gt]
    anchors = rng.uniform(-1.0, 1.0, size=(L, 3)).astype(np.float32)
    anchors[:, 2] += 3.0
    fi, ai, meas = [], [], []
    for k in range(K):
        w2c = np.linalg.inv(gt_T[k])
        for l in range(L):
            cam = w2c[:3, :3] @ anchors[l] + w2c[:3, 3]
            if cam[2] > 0.5:
                fi.append(k)
                ai.append(l)
                meas.append(cam)
    rng = np.random.default_rng(2)
    poses = gt + np.concatenate([0.05 * rng.normal(size=(K, 3)), 0.02 * rng.normal(size=(K, 3))],
                                axis=1).astype(np.float32)
    poses[0] = gt[0]
    start = anchors + 0.05 * rng.normal(size=(L, 3)).astype(np.float32)
    pad = (-len(fi)) % 8
    return dict(frame_idx=np.asarray(fi + [0] * pad, np.int32), anchor_idx=np.asarray(ai + [0] * pad, np.int32),
                meas_cam=np.concatenate([np.stack(meas), np.tile(meas[0], (pad, 1))]).astype(np.float32),
                poses=poses.astype(np.float32), anchors=start.astype(np.float32), iters=BA_ITERS)


def _torch_problem(spec, normals=False):
    prob = tba.BAProblem(*(_t(spec[k]) for k in ("frame_idx", "anchor_idx", "meas_cam")))
    if not normals:
        return prob
    rng = np.random.default_rng(5)
    n = rng.normal(size=(len(spec["frame_idx"]), 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    w = rng.uniform(0.5, 1.0, len(n)).astype(np.float32)
    return prob._replace(meas_normal=_t(n), obs_weight=_t(w))


def _jax_sharded(spec):
    """JAX's ``shard_map`` of ``schur_ba`` and ``schur_ba_cg`` over 8 CPU
    devices, as tests/test_ba.py:132-163 and :275-304 run them."""
    from jax.sharding import PartitionSpec as P

    from xslam_tpu.parallel.mesh import SPACE_AXIS, make_space_mesh

    try:
        from jax import shard_map as sm
    except ImportError:
        from jax.experimental.shard_map import shard_map as sm
    mesh = make_space_mesh(8)
    out = {}
    for name, fn in (("dense", jba.schur_ba), ("cg", jba.schur_ba_cg)):
        def stage(p, a, fi, ai, mc, fn=fn):
            return fn(p, a, jba.BAProblem(frame_idx=fi, anchor_idx=ai, meas_cam=mc), iters=BA_ITERS,
                      axis_name=SPACE_AXIS)

        res = jax.jit(sm(stage, mesh=mesh, in_specs=(P(), P(), P(SPACE_AXIS), P(SPACE_AXIS), P(SPACE_AXIS, None)),
                         out_specs=P(), check_vma=False))(
            *(jnp.asarray(spec[k]) for k in ("poses", "anchors", "frame_idx", "anchor_idx", "meas_cam")))
        out[name] = (np.asarray(res.poses), np.asarray(res.anchors))
    return out


def _blackout():
    """tests/test_recovery.py:30's configuration and :41's sequence: 5 tracked
    frames, 2 blank, a paused resume."""
    cfg = small_config(end_frame=12, reloc_after_failures=2, reloc_iters=15, reloc_min_count=200.0,
                       max_translation_per_frame=0.15, min_inlier_fraction=0.35)
    ds = small_dataset(n_frames=12, degrees_per_frame=2.5)
    blank = np.zeros_like(ds.get_depth(0))
    seq = [(i, ds.get_depth(i)) for i in range(5)] + [(4, blank)] * 2 + [(7, ds.get_depth(7))] * 4
    return torch_config(cfg), ds, seq


def _recover(engine, seq):
    state = engine.init_state()
    for _, depth in seq:
        state, _ = engine.process_frame(state, depth)
    return engine, engine.refine_trajectory()


@pytest.fixture(scope="module")
def single_blackout():
    """The port's single recovering engine over the blackout, refined."""
    cfg, ds, seq = _blackout()
    return _recover(RecoveringEngine(cfg, device="cpu"), seq)


@pytest.fixture
def one_rank():
    group = init_space_group("cpu")
    yield group
    destroy_space_group()


# ---------------------------------------------------------------- two ranks
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, request):
    """Two gloo ranks in one spawn: the ``"ba"`` job on the padded problem,
    the ``"recover"`` job on the blackout; meanwhile JAX's sharded BA, the
    port's single forms and the single recovering engine here."""
    spec = _ba_problem()
    cfg, ds, seq = _blackout()
    tmp = tmp_path_factory.mktemp("backend_ranks")
    with open(tmp / "jobs.pkl", "wb") as f:
        pickle.dump([{"name": "ba", "ba": spec}, {"name": "recover", "config": cfg, "recover": True}], f)
    np.save(tmp / "depths.npy", np.stack([d for _, d in seq]))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "sharded_rank.py"), str(tmp / "jobs.pkl"),
                               str(tmp / "depths.npy"), str(tmp / "out"), "--rank", str(r), "--world-size", "2",
                               "--init-method", f"file://{tmp / 'rendezvous'}", "--device", "cpu"],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        jax_out = _jax_sharded(spec)
        prob = _torch_problem(spec)
        single = {name: fn(_t(spec["poses"]), _t(spec["anchors"]), prob, iters=BA_ITERS)
                  for name, fn in (("dense", tba.schur_ba), ("cg", tba.schur_ba_cg))}
        single_rec = request.getfixturevalue("single_blackout")
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    ranks = [dict(np.load(tmp / f"out.{r}.npz")) for r in range(2)]
    return dict(spec=spec, jax=jax_out, single=single, single_rec=single_rec, ranks=ranks, ds=ds, seq=seq)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_two_ranks_sharded_ba(two_ranks, solver):
    """Each rank its half of the rows; both ranks the same bits; within 1e-4
    of the single form and of JAX's 8-device ``shard_map``."""
    r0, r1 = two_ranks["ranks"]
    assert int(r0["ba.rows"]) == int(r1["ba.rows"]) == len(two_ranks["spec"]["frame_idx"]) // 2
    for key in (f"ba.{solver}_poses", f"ba.{solver}_anchors", f"ba.{solver}_hist"):
        assert _bits(r0[key], r1[key]), key
    single = two_ranks["single"][solver]
    jax_poses, jax_anchors = two_ranks["jax"][solver]
    for ref_poses, ref_anchors in ((single.poses.numpy(), single.anchors.numpy()), (jax_poses, jax_anchors)):
        np.testing.assert_allclose(r0[f"ba.{solver}_poses"], ref_poses, atol=SHARDED_TOL)
        np.testing.assert_allclose(r0[f"ba.{solver}_anchors"], ref_anchors, atol=SHARDED_TOL)
    assert r0[f"ba.{solver}_hist"][-1] < 1e-6


def test_two_ranks_recovering_engine(two_ranks):
    """Both ranks hold the same pose log, decisions, keyframes and refined
    trajectory; the poses within 1e-3 of the single recovering engine's; a
    relocalization descends and the end lies within 60 mm of the truth."""
    r0, r1 = two_ranks["ranks"]
    for key in ("pose_log", "align_ok", "events", "keyframes", "loop_edges", "refined"):
        assert _bits(r0[f"recover.{key}"], r1[f"recover.{key}"]), key
    eng, _ = two_ranks["single_rec"]
    log = r0["recover.pose_log"]
    assert len(log) == len(eng.pose_log) == len(two_ranks["seq"])
    worst = max(float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(log, eng.pose_log))
    assert worst < RECOVER_POSE_TOL, worst
    events = r0["recover.events"]  # (frame, accepted, loss before, loss after, jump)
    assert ((events[:, 2] > 0) & (events[:, 3] < events[:, 2])).any(), events
    gt = normalize_to_first([two_ranks["ds"].get_pose(f) for f, _ in two_ranks["seq"]])
    errs = [1000 * np.linalg.norm(e[:3, 3] - g[:3, 3]) for e, g in zip(normalize_to_first(list(log)), gt)]
    assert errs[-1] < 60.0, errs
    assert np.isfinite(r0["recover.refined"]).all() and r0["recover.refined"].shape == (len(log), 4, 4)


# ---------------------------------------------------------------- one rank
@pytest.mark.parametrize("solver, normals", [("dense", False), ("cg", False), ("cg", True)],
                         ids=["dense", "cg", "cg_normals"])
def test_one_rank_sharded_ba_is_the_single_form(one_rank, solver, normals):
    spec = _ba_problem()
    prob = _torch_problem(spec, normals)
    fn = tba.schur_ba if solver == "dense" else tba.schur_ba_cg
    start = (_t(spec["poses"]), _t(spec["anchors"]))
    ref = fn(*start, prob, iters=BA_ITERS)
    out = fn(*start, tba.observation_block(prob, one_rank), iters=BA_ITERS, group=one_rank)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_one_rank_recovering_sharded_engine_is_the_single_one(one_rank, single_blackout):
    cfg, _, seq = _blackout()
    eng, refined = _recover(RecoveringEngine(cfg, engine=ShardedXSlamEngine(cfg, group=one_rank)), seq)
    ref, ref_refined = single_blackout
    assert all(_bits(a, b) for a, b in zip(eng.pose_log, ref.pose_log)) and len(eng.pose_log) == len(ref.pose_log)
    assert eng.recovery_events == ref.recovery_events and eng.recovery_events
    assert [k.frame_index for k in eng.keyframes] == [k.frame_index for k in ref.keyframes]
    assert [(i, j) for i, j, _ in eng.loop_edges] == [(i, j) for i, j, _ in ref.loop_edges]
    assert _bits(refined, ref_refined)


def test_run_slam_sharded_backend(tmp_path, capsys):
    """``run_slam --sharded`` on a backend yaml prints the refined line, and
    at one rank gives the single engine's ATE and refined ATE digits."""
    cfg = yaml.safe_load(open(REPO / "configs" / "synthetic.yaml"))
    cfg.update(end_frame=5, tsdf_size_x=64, tsdf_size_y=64, tsdf_size_z=64, tsdf_voxel_size=0.12, depth_width=160,
               depth_height=120, fx=120.3, fy=-120.0, cx=79.5, cy=59.5, output_dir=str(tmp_path / "out") + "/",
               draw_pcd=False, reloc_after_failures=3, loop_detect=True, keyframe_dist=0.05)
    path = tmp_path / "backend.yaml"
    path.write_text(yaml.safe_dump(cfg))
    try:
        sharded = run_slam.main([str(path), "--device", "cpu", "--sharded"])
    finally:
        destroy_space_group()
    printed = capsys.readouterr().out
    single = run_slam.main([str(path), "--device", "cpu"])
    assert isinstance(sharded.engine, RecoveringEngine) and isinstance(sharded.engine.engine, ShardedXSlamEngine)
    assert "refined ATE RMSE = " in printed and sharded.refined_ate is not None
    assert sharded.ate == single.ate and sharded.refined_ate == single.refined_ate


# ---------------------------------------------------------------- B18's plain passes
def test_observation_blocks():
    """A rank's block is its contiguous 1/n of the rows of the problem
    padded to a multiple of n with weight-0 rows; at one rank the problem."""
    prob = _torch_problem(_ba_problem())
    N = int(prob.frame_idx.shape[0])
    assert tba.observation_block(prob, SpaceGroup(None, 0, 1, torch.device("cpu"))) is prob
    for n in (2, 3, 7):
        blocks = [tba.observation_block(prob, SpaceGroup(None, r, n, torch.device("cpu"))) for r in range(n)]
        padded = tba.pad_problem(prob, -(-N // n) * n)
        assert len({int(b.frame_idx.shape[0]) for b in blocks}) == 1
        for field, whole in zip(tba.BAProblem._fields, padded):
            if whole is not None:
                assert torch.equal(torch.cat([getattr(b, field) for b in blocks]), whole), (n, field)


def _live_rows(normals: bool):
    """Jacobians of the padded toy problem at its start, the plan, Hll's
    inverse and a gauge-masked step."""
    spec = _ba_problem()
    prob = _torch_problem(spec, normals)
    poses, anchors = _t(spec["poses"]), _t(spec["anchors"])
    K, L = poses.shape[0], anchors.shape[0]
    plan = tba.SchurCgPlan(prob, K, L)
    _, Jc, Jl = tba._obs_terms(poses, anchors, prob, plan.ks, plan.ls)
    Hll = plan.seg_l(tba._outer(Jl, Jl).reshape(-1, 9)).reshape(L, 3, 3)
    Hll_inv = torch.linalg.inv_ex(Hll + 1e-4 * torch.eye(3))[0]
    x = _t(np.random.default_rng(3).normal(size=(K, 6)).astype(np.float32)) * tba._gauge(K, "cpu")
    return plan, Jc.contiguous(), Jl.contiguous(), Hll_inv, x


@pytest.mark.parametrize("normals", [False, True], ids=["point", "plane"])
def test_plain_passes_are_the_matvec(normals):
    plan, Jc, Jl, Hll_inv, x = _live_rows(normals)
    kernels.reset_launch_counts()
    v = tba.schur_cg_anchors(plan, Jc, Jl, x)
    hz = tba.schur_cg_keyframes(plan, Jc, Jl, Hll_inv, v, x)
    assert kernels.launch_counts["schur_cg_anchors"] == kernels.launch_counts["schur_cg_keyframes"] == 0
    assert torch.equal(v, tba.schur_cg_anchors(plan, Jc, Jl, x))
    assert torch.equal(hz, tba.schur_cg_keyframes(plan, Jc, Jl, Hll_inv, v, x))
    # the matvec they replace (models/ba.py before B18): the products summed by torch.sum
    u = tba._j(Jc, x[plan.ks])
    v_ref = plan.seg_l(tba._jT(Jl, u))
    z = tba._j(Jl, tba._block_solve(Hll_inv, v_ref)[plan.ls])
    hz_ref = plan.seg_k(torch.cat([tba._jT(Jc, u), tba._jT(Jc, z)], 1))
    for got, ref in ((v, v_ref), (hz, hz_ref), (hz[:, :6] - hz[:, 6:], hz_ref[:, :6] - hz_ref[:, 6:])):
        assert float((got - ref).abs().max()) <= PLAIN_PASS_TOL * float(ref.abs().max())


@pytest.mark.parametrize("chunk", [8, 256, tba.CG_CHUNK])
def test_kernel_sum_order(chunk):
    """Keys with runs from 0 to 3,000 rows (empty keys, runs crossing many
    chunks and ending on a chunk's edge) and some outside the range, summed as
    the kernel sums them (:func:`b18_sums`: 4 positions a thread, chunks of
    ``chunk`` positions; the kernel's is ``CG_CHUNK``)."""
    rng = np.random.default_rng(chunk)
    n_keys = 60
    lengths = rng.choice([0, 1, 2, 5, 17, 255, 256, 257, 3000], n_keys)
    keys = np.concatenate([np.full(n, k) for k, n in enumerate(lengths)] + [np.full(9, n_keys + 1), [-1] * 4])
    keys = rng.permutation(keys)
    rows = rng.normal(0, 1, (len(keys), 3)).astype(np.float32)
    seg = tba._Segments(_t(keys), n_keys)
    ref = seg(_t(rows)).numpy()
    order = seg.order.numpy()
    out, writes = b18_sums(seg.sorted_keys.numpy(), rows[order], seg.start.numpy(), seg.end.numpy(),
                           chunk // tba.CG_PER_THREAD, tba.CG_PER_THREAD)
    assert (writes == 1).all(), writes
    def ordered(a):
        i = a.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    ulps = np.abs(ordered(out) - ordered(ref))
    assert ulps.max() <= 1 and (ulps == 0).mean() > 0.9, ulps.max()
