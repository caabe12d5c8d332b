"""The port's bundle adjustment (``xslam_tpu_torch/models/ba.py``) against
``xslam_tpu.models.ba`` on the CPU, on the scenarios of tests/test_ba.py and
tests/test_ba_live.py (the same seeds), the JAX function run once a module.

Tolerances, and why:

- Jacobians: within 1e-6 of ``jax.jacfwd`` (entries of order 1; the port
  seeds the six directions through ``se3.exp`` once a keyframe and applies
  the chain rule, the same function rounded otherwise: measured 1.2e-7), at
  a random pose and at ``xi = 0`` (``se3.exp``'s small-angle branch).
- ``build_ba_problem``: the indices equal and the float32 arrays bit-equal
  (the same numpy code).
- Solvers: poses within 1e-5 and anchors within 2e-5 of JAX's, JAX's own
  margin between its CG and dense solvers (tests/test_ba.py:171-196,
  :313-340; measured up to 7.2e-7); residual histories within 1e-4 relative
  plus 1e-6 of the first entry (the last entries sit at float32 noise,
  1e-11 against a first entry of 4).
- Segment sums: within float32 rounding (1.2e-7 relative) of float64
  ``index_add_`` (they are float64 prefix differences rounded once), and
  the same bits on a second call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (sets one intra-op thread)
from tests.helpers import SMALL_INTR, small_dataset
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu.models import ba as jba
from xslam_tpu_torch.geometry import se3 as tse3
from xslam_tpu_torch.models import ba as tba
from xslam_tpu_torch.utils import convert

POSE_TOL = 1e-5
ANCHOR_TOL = 2e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _hist_close(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-6 * ref[0])


# the JAX Jacobians, compiled once for the module
_JAC_REL = jax.jit(jax.jacfwd(jba._rel_residual, argnums=(0, 1)))
_JAC_PLANE = jax.jit(jax.jacfwd(jba._obs_residual_plane, argnums=(0, 1)))
_JAC_POINT = jax.jit(jax.jacfwd(jba._obs_residual, argnums=(0, 1)))


def _make_poses(K):
    """Orbit-like keyframe poses as se(3) vectors (tests/test_ba.py:13)."""
    return np.stack([np.array([1.5 * np.cos(0.15 * k), 0.1 * k, 1.5 * np.sin(0.15 * k), 0.0, 0.15 * k, 0.0],
                              np.float32) for k in range(K)])


# ---------------------------------------------------------------- Jacobians
@pytest.mark.parametrize("at_zero", [False, True], ids=["random", "xi0"])
def test_rel_residual_jacobians(at_zero):
    rng = np.random.default_rng(3)
    xi_i = np.zeros(6, np.float32) if at_zero else rng.normal(0, 0.3, 6).astype(np.float32)
    xi_j = rng.normal(0, 0.3, 6).astype(np.float32)
    m_inv = np.linalg.inv(np.asarray(jse3.exp_real(rng.normal(0, 0.3, 6).astype(np.float32)))).astype(np.float32)
    r_ref = np.asarray(jba._rel_residual(xi_i, xi_j, m_inv))
    ji, jj = (np.asarray(j) for j in _JAC_REL(xi_i, xi_j, m_inv))
    r, Ji, Jj = tba._rel_terms(_t(np.stack([xi_i, xi_j])), torch.tensor([0]), torch.tensor([1]), _t(m_inv)[None])
    np.testing.assert_allclose(tba._rel_residual(xi_i, xi_j, m_inv).numpy(), r_ref, atol=1e-6)
    np.testing.assert_allclose(r[0].numpy(), r_ref, atol=1e-6)
    np.testing.assert_allclose(Ji[0].numpy(), ji, atol=1e-6)
    np.testing.assert_allclose(Jj[0].numpy(), jj, atol=1e-6)
    assert np.isfinite(Ji.numpy()).all() and np.isfinite(Jj.numpy()).all()


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "point"])
@pytest.mark.parametrize("at_zero", [False, True], ids=["random", "xi0"])
def test_obs_residual_jacobians(plane, at_zero):
    """Three observations of two anchors from two keyframes (keyframe 0 at
    ``xi`` 0 in the ``xi0`` case), weighted 1, 0.5 and 0."""
    rng = np.random.default_rng(4)
    poses = rng.normal(0, 0.3, (2, 6)).astype(np.float32)
    if at_zero:
        poses[0] = 0.0
    anchors = rng.normal(0, 1, (2, 3)).astype(np.float32)
    ks, ls = np.array([0, 1, 0], np.int32), np.array([0, 1, 1], np.int32)
    meas = rng.normal(0, 1, (3, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (3, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    w = np.array([1.0, 0.5, 0.0], np.float32)
    jprob = jba.BAProblem(jnp.asarray(ks), jnp.asarray(ls), jnp.asarray(meas),
                          jnp.asarray(nrm) if plane else None, jnp.asarray(w))
    tprob = tba.BAProblem(_t(ks), _t(ls), _t(meas), _t(nrm) if plane else None, _t(w))
    res = jba._residual_fn(jprob)
    tres = tba._residual_fn(tprob)
    r, Jc, Jl = tba._obs_terms(_t(poses), _t(anchors), tprob, *tba._indices(tprob))
    for o in range(3):
        xi, p = jnp.asarray(poses[ks[o]]), jnp.asarray(anchors[ls[o]])
        r_ref = np.asarray(res(xi, p, o))
        np.testing.assert_allclose(r[o].numpy(), r_ref, atol=1e-6)
        np.testing.assert_allclose(tres(poses[ks[o]], anchors[ls[o]], o).numpy(), r_ref, atol=1e-6)
        jc, jl = _JAC_PLANE(xi, p, meas[o], nrm[o]) if plane else _JAC_POINT(xi, p, meas[o])
        np.testing.assert_allclose(Jc[o].numpy(), w[o] * np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(Jl[o].numpy(), w[o] * np.asarray(jl), atol=1e-6)
    assert not Jc[2].any() and not Jl[2].any() and not r[2].any()  # weight 0: inert


# ---------------------------------------------------------------- ordered segment sums
@pytest.mark.parametrize("rows", [7, 1000])
def test_segment_sums(rows):
    """:class:`_Segments` against float64 ``index_add_`` on random keys with
    some outside the range (which add nothing, as JAX drops them); a second
    call gives the same bits."""
    rng = np.random.default_rng(rows)
    n = 13
    keys = rng.integers(-2, n + 2, rows)
    vals = rng.normal(0, 1, (rows, 2, 3)).astype(np.float32)
    seg = tba._Segments(_t(keys), n)
    out = seg(_t(vals))
    inside = (keys >= 0) & (keys < n)
    ref = torch.zeros((n, 2, 3), dtype=torch.float64).index_add_(0, _t(keys[inside]), _t(vals[inside]).double())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1.2e-7, atol=1e-12)
    assert torch.equal(out, seg(_t(vals)))


# ---------------------------------------------------------------- pose graphs
@pytest.fixture(scope="module")
def loop_graph():
    """tests/test_ba.py:313's loop-closed graph of 10 keyframes, through
    JAX's dense and CG solvers."""
    rng = np.random.default_rng(0)
    K = 10
    gt = [np.eye(4)]
    for _ in range(1, K):
        xi = np.concatenate([rng.normal(0, 0.3, 3), rng.normal(0, 0.2, 3)])
        gt.append(gt[-1] @ np.asarray(jse3.exp_real(xi.astype(np.float32))))
    edges = [(k, k + 1) for k in range(K - 1)] + [(0, K - 1)]
    rel = [np.linalg.inv(gt[i]) @ gt[j] for (i, j) in edges]
    init = np.stack([jse3.log_real(g.astype(np.float32)) for g in gt]) + rng.normal(0, 0.05, (K, 6))
    init[0] = jse3.log_real(gt[0].astype(np.float32))
    args = (init.astype(np.float32), np.asarray(edges, np.int32), np.stack(rel).astype(np.float32))
    j = tuple(jnp.asarray(a) for a in args)
    return args, jba.pose_graph_gn(*j, iters=10), jba.pose_graph_cg(*j, iters=10)


@pytest.mark.parametrize("solver", ["gn", "cg"])
def test_pose_graph_matches_jax(loop_graph, solver):
    args, ref_gn, ref_cg = loop_graph
    fn, ref = (tba.pose_graph_gn, ref_gn) if solver == "gn" else (tba.pose_graph_cg, ref_cg)
    out = fn(*(_t(a) for a in args), iters=10)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), atol=POSE_TOL)
    _hist_close(out.residual_history.numpy(), ref.residual_history)
    if solver == "cg":  # tests/test_ba.py:337-340 in the port
        assert float(out.residual_history[-1]) < 1e-9
        dense = tba.pose_graph_gn(*(_t(a) for a in args), iters=10)
        np.testing.assert_allclose(dense.poses.numpy(), out.poses.numpy(), atol=1e-5)
    back = convert.pose_graph_result_from_numpy(convert.pose_graph_result_to_numpy(ref), "cpu")
    assert np.array_equal(back.poses.numpy(), np.asarray(ref.poses))


def test_pose_graph_recovers_from_noise():
    """tests/test_ba.py:24 through both packages' dense solver: the same
    poses, and the port's recovers the graph's relative poses."""
    rng = np.random.default_rng(0)
    K = 6
    gt = _make_poses(K)
    gt_T = [np.asarray(jse3.exp_real(jnp.asarray(x))) for x in gt]
    edges = [(i, i + 1) for i in range(K - 1)] + [(0, K - 1)]
    rel = np.stack([np.linalg.inv(gt_T[i]) @ gt_T[j] for i, j in edges]).astype(np.float32)
    noisy = gt + np.concatenate([0.05 * rng.normal(size=(K, 3)), 0.02 * rng.normal(size=(K, 3))],
                                axis=1).astype(np.float32)
    noisy[0] = gt[0]
    e = np.asarray(edges, np.int32)
    ref = jax.jit(lambda p: jba.pose_graph_gn(p, jnp.asarray(e), jnp.asarray(rel), iters=15))(jnp.asarray(noisy))
    out = tba.pose_graph_gn(_t(noisy), _t(e), _t(rel), iters=15)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), atol=POSE_TOL)
    assert float(out.residual_history[-1]) < 1e-6
    T0 = tse3.exp_real(out.poses[0]).numpy()
    for k in range(K):
        rel_est = np.linalg.inv(T0) @ tse3.exp_real(out.poses[k]).numpy()
        np.testing.assert_allclose(rel_est, np.linalg.inv(gt_T[0]) @ gt_T[k], atol=5e-3)


def test_pose_graph_cg_scales_to_1k_keyframes():
    """tests/test_ba.py:344 in the port alone: 1000 keyframes and loop
    closures converge matrix-free."""
    rng = np.random.default_rng(1)
    K = 1000
    gt = np.cumsum(rng.normal(0, 0.05, (K, 6)).astype(np.float32), axis=0)
    poses_gt = [tse3.exp_real(x).numpy() for x in gt]
    edges = [(k, k + 1) for k in range(K - 1)]
    rel = [np.linalg.inv(poses_gt[k]) @ poses_gt[k + 1] for k in range(K - 1)]
    for _ in range(20):
        i, j = sorted(rng.integers(0, K, 2))
        if j - i < 10:
            continue
        edges.append((int(i), int(j)))
        rel.append(np.linalg.inv(poses_gt[i]) @ poses_gt[j])
    init = gt + rng.normal(0, 0.02, (K, 6)).astype(np.float32)
    init[0] = gt[0]
    out = tba.pose_graph_cg(_t(init), _t(np.asarray(edges, np.int32)), _t(np.stack(rel).astype(np.float32)),
                            iters=5)
    hist = out.residual_history.numpy()
    assert hist[-1] < hist[0] * 1e-3


# ---------------------------------------------------------------- Schur BA
@pytest.fixture(scope="module")
def toy_ba():
    """tests/test_ba.py:67's 5 keyframes x 40 anchors, perturbed as :81, and
    JAX's dense and CG solutions."""
    rng = np.random.default_rng(1)
    K, L = 5, 40
    gt_poses = _make_poses(K)
    gt_T = [np.asarray(jse3.exp_real(jnp.asarray(x))) for x in gt_poses]
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
    prob = dict(frame_idx=np.asarray(fi, np.int32), anchor_idx=np.asarray(ai, np.int32),
                meas_cam=np.stack(meas).astype(np.float32))
    rng = np.random.default_rng(2)
    noisy_p = gt_poses + np.concatenate([0.05 * rng.normal(size=(K, 3)), 0.02 * rng.normal(size=(K, 3))],
                                        axis=1).astype(np.float32)
    noisy_p[0] = gt_poses[0]
    noisy_a = anchors + 0.05 * rng.normal(size=(L, 3)).astype(np.float32)
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()})
    start = (jnp.asarray(noisy_p), jnp.asarray(noisy_a))
    dense = jax.jit(lambda p, a: jba.schur_ba(p, a, jprob, iters=10))(*start)
    cg = jax.jit(lambda p, a: jba.schur_ba_cg(p, a, jprob, iters=10))(*start)
    return prob, (noisy_p, noisy_a), gt_T, dense, cg


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_schur_ba_matches_jax(toy_ba, solver):
    prob, (p0, a0), gt_T, dense, cg = toy_ba
    fn, ref = (tba.schur_ba, dense) if solver == "dense" else (tba.schur_ba_cg, cg)
    out = fn(_t(p0), _t(a0), convert.ba_problem_from_numpy(prob, "cpu"), iters=10)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), atol=POSE_TOL)
    np.testing.assert_allclose(out.anchors.numpy(), np.asarray(ref.anchors), atol=ANCHOR_TOL)
    _hist_close(out.residual_history.numpy(), ref.residual_history)
    # tests/test_ba.py:98-104 and :193-196 in the port
    assert float(out.residual_history[-1]) < 1e-6
    T0 = tse3.exp_real(out.poses[0]).numpy()
    for k in range(len(gt_T)):
        rel_est = np.linalg.inv(T0) @ tse3.exp_real(out.poses[k]).numpy()
        np.testing.assert_allclose(rel_est, np.linalg.inv(gt_T[0]) @ gt_T[k], atol=1e-2)
    if solver == "cg":
        ref_dense = tba.schur_ba(_t(p0), _t(a0), convert.ba_problem_from_numpy(prob, "cpu"), iters=10)
        np.testing.assert_allclose(out.poses.numpy(), ref_dense.poses.numpy(), atol=1e-4)
        np.testing.assert_allclose(out.anchors.numpy(), ref_dense.anchors.numpy(), atol=1e-4)
    back = convert.ba_result_from_numpy(convert.ba_result_to_numpy(ref), "cpu")
    assert np.array_equal(back.anchors.numpy(), np.asarray(ref.anchors))


def test_schur_ba_cg_large_scale():
    """tests/test_ba.py:199 in the port alone: 60 keyframes x 6000 anchors x
    24k observations recover ground truth."""
    rng = np.random.default_rng(7)
    K, L = 60, 6000
    gt_poses = np.stack([np.array([2.0 * np.cos(0.05 * k), 0.02 * k, 2.0 * np.sin(0.05 * k), 0.0, 0.05 * k, 0.0],
                                  np.float32) for k in range(K)])
    gt_T = np.stack([tse3.exp_real(x).numpy() for x in gt_poses])
    anchors = rng.uniform(-1.5, 1.5, size=(L, 3)).astype(np.float32)
    anchors[:, 2] += 4.0
    fi = rng.integers(0, K, size=(L, 4)).reshape(-1)  # each anchor seen by 4 keyframes
    ai = np.repeat(np.arange(L), 4)
    w2c = np.linalg.inv(gt_T)
    meas = np.einsum("nij,nj->ni", w2c[fi, :3, :3], anchors[ai]) + w2c[fi, :3, 3]
    prob = tba.BAProblem(frame_idx=_t(fi.astype(np.int32)), anchor_idx=_t(ai.astype(np.int32)),
                         meas_cam=_t(meas.astype(np.float32)))
    noisy_p = gt_poses + np.concatenate([0.03 * rng.normal(size=(K, 3)), 0.01 * rng.normal(size=(K, 3))],
                                        axis=1).astype(np.float32)
    noisy_p[0] = gt_poses[0]
    noisy_a = anchors + 0.03 * rng.normal(size=(L, 3)).astype(np.float32)
    out = tba.schur_ba_cg(_t(noisy_p), _t(noisy_a), prob, iters=8, cg_iters=40)
    assert float(out.residual_history[-1]) < 1e-6
    T0 = tse3.exp_real(out.poses[0]).numpy()
    for k in range(0, K, 7):
        rel_est = np.linalg.inv(T0) @ tse3.exp_real(out.poses[k]).numpy()
        np.testing.assert_allclose(rel_est, np.linalg.inv(gt_T[0]) @ gt_T[k], atol=1e-4)


# ---------------------------------------------------------------- live data
@pytest.fixture(scope="module")
def live():
    """tests/test_ba_live.py:24's perturbed keyframes (6 of the small orbit at
    3 degrees a frame) and JAX's two re-association rounds of
    ``build_ba_problem`` + ``schur_ba_cg`` (:55)."""
    n = 6
    ds = small_dataset(n, degrees_per_frame=3.0)
    gt = [np.asarray(ds.get_pose(i), np.float64) for i in range(n)]
    depths = [np.asarray(ds.get_depth(i)) for i in range(n)]
    rng = np.random.default_rng(0)
    kf = [gt[0]]
    for i in range(1, n):
        xi = np.concatenate([0.025 * rng.normal(size=3), 0.008 * rng.normal(size=3)]).astype(np.float32)
        kf.append(gt[i] @ np.asarray(jse3.exp_real(jnp.asarray(xi)), np.float64))
    rounds, poses = [], [np.asarray(p) for p in kf]
    for _ in range(2):
        problem, anchors = jba.build_ba_problem(poses, depths, SMALL_INTR, stride=6, match_dist=0.3)
        xi0 = np.stack([jse3.log_real(p) for p in poses]).astype(np.float32)
        out = jba.schur_ba_cg(jnp.asarray(xi0), jnp.asarray(anchors), problem, iters=4, cg_iters=30)
        rounds.append((poses, convert.ba_problem_to_numpy(problem), anchors, xi0, out))
        poses = [np.asarray(jse3.exp_real(x)) for x in np.asarray(out.poses)]
    return gt, kf, depths, rounds


def test_build_ba_problem_bit_equal(live):
    """The port's ``build_ba_problem`` (the JAX package's numpy) gives the
    same problem bit for bit in both rounds; tests/test_ba_live.py:40's
    properties hold."""
    _, kf, depths, rounds = live
    for poses, ref, anchors_ref, _, _ in rounds:
        problem, anchors = tba.build_ba_problem(poses, depths, SMALL_INTR, stride=6, match_dist=0.3)
        got = convert.ba_problem_to_numpy(problem)
        assert sorted(got) == sorted(ref) == ["anchor_idx", "frame_idx", "meas_cam", "meas_normal"]
        for key in ref:
            assert got[key].dtype == ref[key].dtype and np.array_equal(got[key], ref[key]), key
        assert anchors.dtype == np.float32 and np.array_equal(anchors, anchors_ref)
    problem, anchors = tba.build_ba_problem(kf, depths, SMALL_INTR, stride=8, match_dist=0.3)
    N, L = int(problem.frame_idx.shape[0]), int(anchors.shape[0])
    assert N > 400 and L > 100, (N, L)
    assert np.bincount(problem.anchor_idx.numpy(), minlength=L).min() >= 2
    assert len(np.unique(problem.frame_idx.numpy())) == len(kf)


def test_schur_ba_live_matches_jax(live):
    """Each round's ``schur_ba_cg`` from the round's own problem (JAX's,
    carried across) against JAX's; then tests/test_ba_live.py:55's claim
    in the port: the first round's residual halves and two rounds take
    the mean translation error below a fifth of the perturbation's."""
    gt, kf, depths, rounds = live
    for _, prob, anchors, xi0, ref in rounds:
        out = tba.schur_ba_cg(_t(xi0), _t(anchors), convert.ba_problem_from_numpy(prob, "cpu"), iters=4,
                              cg_iters=30)
        np.testing.assert_allclose(out.poses.numpy(), np.asarray(ref.poses), atol=POSE_TOL)
        np.testing.assert_allclose(out.anchors.numpy(), np.asarray(ref.anchors), atol=ANCHOR_TOL)
        _hist_close(out.residual_history.numpy(), ref.residual_history)

    def terr(poses):
        return np.mean([np.linalg.norm(np.asarray(p)[:3, 3] - g[:3, 3]) for p, g in zip(poses, gt)])

    poses, first = [np.asarray(p) for p in kf], None
    for _ in range(2):
        problem, anchors = tba.build_ba_problem(poses, depths, SMALL_INTR, stride=6, match_dist=0.3)
        xi0 = np.stack([tse3.log_real(p) for p in poses]).astype(np.float32)
        out = tba.schur_ba_cg(_t(xi0), _t(anchors), problem, iters=4, cg_iters=30)
        poses = [tse3.exp_real(x).numpy() for x in out.poses.numpy()]
        first = out.residual_history.numpy() if first is None else first
    assert first[-1] < 0.5 * first[0], first
    assert terr(poses) < 0.2 * terr(kf), (terr(kf), terr(poses))


def test_pad_problem(live):
    """``pad_problem`` lays out JAX's rows, and its weight-0 rows change
    nothing: the padded problem's solution is the unpadded one's (within
    1e-6: the ordered sums' blocks shift with the row count)."""
    _, _, _, rounds = live
    _, prob, anchors, xi0, _ = rounds[0]
    N = prob["frame_idx"].shape[0]
    bucket = -(-int(N * 1.25) // 4096) * 4096
    ref = convert.ba_problem_to_numpy(jba.pad_problem(jba.BAProblem(**{k: jnp.asarray(v) for k, v in prob.items()}),
                                                      bucket))
    problem = convert.ba_problem_from_numpy(prob, "cpu")
    padded = tba.pad_problem(problem, bucket)
    got = convert.ba_problem_to_numpy(padded)
    assert sorted(got) == sorted(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match="observations > bucket"):
        tba.pad_problem(problem, N - 1)
    a = tba.schur_ba_cg(_t(xi0), _t(anchors), problem, iters=2, cg_iters=30)
    b = tba.schur_ba_cg(_t(xi0), _t(anchors), padded, iters=2, cg_iters=30)
    np.testing.assert_allclose(b.poses.numpy(), a.poses.numpy(), atol=1e-6)
    np.testing.assert_allclose(b.anchors.numpy(), a.anchors.numpy(), atol=1e-6)
    np.testing.assert_allclose(b.residual_history.numpy(), a.residual_history.numpy(), rtol=1e-6)
