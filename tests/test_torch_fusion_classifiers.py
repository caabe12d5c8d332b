"""The port's opt-in fusion classifiers and subcell fusion (kernels B15s,
B15f, B15c and B3c's MIXED and subcell variants; plain versions in
``xslam_tpu_torch.ops.fusion_brick``) against ``xslam_tpu.ops.fusion_brick``
and against the port's own dense fusion, on the CPU at the JAX tests' scale
(64^3 at 0.12 m, 160x120 depth, ``SMALL_INTR``).

- The split classifier's classes and windows (far cells, origin, cell edge)
  equal ``classify_bricks_full(split=True)``'s exactly, as do the 4^3 grid's
  classes, the fine classifier's fold (``classify_bricks_fine``) and the
  subcell stage's classes and list ranks (``_classify_boxes`` on the
  candidates' subcells, ``_integrate_rows_core``'s per-id cumsums): at the
  orbit, the volume corner, the window-coverage regression pose, the 8 seeded
  poses of ``tests/test_fusion_brick.py::test_classify_split_equals_dense_and_tighter``
  and a cell-aligned depth step where MIXED fires. The split classifier
  never lists more ACTIVE bricks than the coarse one (it only adds proofs;
  the fine one may: a brick whose subcells mix NONE with far ones stays
  ACTIVE).
- ``integrate_brick`` and ``integrate_rows`` with each option (and with the
  options combined) equal the port's dense ``integrate`` bit for bit with
  the nearest sample, every bit of the three planes; against the JAX
  functions within ``tests/test_torch_fusion_brick.py``'s tolerances
  (weights equal on >= 99.99% of voxels, value and grad within 1e-5 where
  they agree), also with the bilinear sample (``bi_threshold`` 0.1), where
  the classes' proofs are the nearest sample's in both packages.
- A starved ``subcell_cap`` under ``"flag"`` raises the flag and leaves the
  same voxels unfused as the JAX function (weights equal everywhere);
  under ``"dense"`` the frame is dense fusion's.
- The packed window word round-trips. B15c's single-pass scan has its
  numpy twin in ``tests/test_torch_subcell_rows_redesigns.py``.

Alone this file takes about 65 s (the JAX functions run eagerly: under jit
XLA may fuse the interval arithmetic so that a bound moves by an ulp). The
engines with these options are in ``tests/test_torch_fusion_classifier_runs.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import SMALL_INTR, small_config, small_dataset, small_scene
from tests.test_torch_fusion_brick import _case, _cfgs, _poses
from xslam_tpu.io.synthetic import render_depth
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops import fusion_brick as jbrick
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.ops import bricks as tbricks
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import fusion_brick as tbrick
from xslam_tpu_torch.ops import kernels

TINTR = Intrinsics(*SMALL_INTR)
STEP_COLUMN = 90  # tests/test_fusion_brick.py::test_classify_split_mixed_class_fires_and_is_exact: 3 MIXED bricks
BI_THRESHOLD = 0.1


def _seeded_case(trial):
    """Trial ``trial`` of tests/test_fusion_brick.py:281's seeded poses (rng 7)."""
    rng = np.random.default_rng(7)
    for _ in range(trial + 1):
        ang, t = rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.5, 0.5, 3)
    c, s = np.cos(ang), np.sin(ang)
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = (rx @ ry @ rz).astype(np.float32)
    c2w[:3, 3] = t
    w2v = np.asarray(small_config().world2volume, np.float32)
    return np.linalg.inv(w2v @ c2w).astype(np.float32), np.asarray(render_depth(small_scene(), c2w, SMALL_INTR))


def _step_case():
    """A near strip (1.0 m) left of ``STEP_COLUMN``, far (4.2 m) right of it,
    seen from the volume's centre along +z."""
    depth = np.full((SMALL_INTR.height, SMALL_INTR.width), 4200, np.uint16)
    depth[:, :STEP_COLUMN] = 1000
    w2v = np.asarray(small_config().world2volume, np.float32)
    return np.linalg.inv(w2v).astype(np.float32), depth


# C4: the small camera moved 4040 px right in a 4200 px wide image, near (1.0 m) left of WIDE_STEP and far (4.2 m)
# right of it; at this column the split classifier makes MIXED bricks whose windows start past column 4096
WIDE = (120.3, -120.0, 79.5 + 4040, 59.5, 4200, 120)
WIDE_STEP = 4170


def _wide_case():
    depth = np.full((WIDE[5], WIDE[4]), 4200, np.uint16)
    depth[:, :WIDE_STEP] = 1000
    w2v = np.asarray(small_config().world2volume, np.float32)
    return np.linalg.inv(w2v).astype(np.float32), depth


def _any_case(name):
    if name == "step":
        return _step_case()
    if name.startswith("seeded"):
        return _seeded_case(int(name[6:]))
    return _case(name)


CLASS_CASES = ("orbit", "corner", "regression", "step") + tuple(f"seeded{i}" for i in range(8))


def _inputs(name):
    """(JAX depth, rotation and translation value lanes; port mip table and
    fusion pose) of a case."""
    v2c, depth = _any_case(name)
    r, t, tr, tt = _poses(v2c)
    table = tbrick.depth_mips(tfusion.scale_depth(torch.from_numpy(depth)))
    return jfusion.scale_depth(jnp.asarray(depth)), r.v, t.v, table, kernels.fusion_pose(tr, tt)


# ----------------------------------------------------------- B15s, B15f classes
@pytest.mark.parametrize("name", CLASS_CASES)
def test_split_and_fine_classes_equal_jax(name):
    _, jcfg, tcfg = _cfgs()
    jdm, r, t, table, pose = _inputs(name)
    res = jcfg.resolution
    # eager JAX: under jit XLA may fuse the interval arithmetic so that a few bricks' bounds move by an ulp (4
    # bricks of the step frame, NONE there where eager says ACTIVE); the plain versions follow the operations as
    # written
    jsplit = jbrick.classify_bricks_full(jdm, r, t, SMALL_INTR, jcfg, res, split=True)
    tsplit = tbrick.classify_bricks_full_plain(table, pose, TINTR, tcfg, split=True)
    for field in jbrick.BrickAux._fields:
        np.testing.assert_array_equal(getattr(tsplit, field).numpy(), np.asarray(getattr(jsplit, field)), field)
    # the packed word the kernels pass carries the window whole
    unpacked = tbrick.unpack_aux(tbrick.pack_aux(tsplit))
    for field in ("farbits", "win_u0", "win_v0", "win_ts"):
        assert torch.equal(getattr(unpacked, field), getattr(tsplit, field)), field
    coarse = tbrick.classify_bricks_plain(table, pose, TINTR, tcfg)
    assert int((tsplit.cls == tbrick.ACTIVE).sum()) <= int((coarse == tbrick.ACTIVE).sum())
    if name == "step":
        assert int((tsplit.cls == tbrick.MIXED).sum()) > 0, "MIXED did not fire on the aligned depth step"

    if name.startswith("seeded") and name != "seeded0":
        return  # the 4^3 grid on four cases: it costs 8x the brick grid
    jsub = np.asarray(jbrick.classify_bricks(jdm, r, t, SMALL_INTR, jcfg, res, cell=4))
    tsub = tbrick.classify_bricks_full_plain(table, pose, TINTR, tcfg, cell=tbrick.SUBCELL).cls.numpy()
    np.testing.assert_array_equal(tsub, jsub)
    jfine = np.asarray(jbrick.classify_bricks_fine(jdm, r, t, SMALL_INTR, jcfg, res))
    tfine = tbrick.classify_bricks_fine_plain(table, pose, TINTR, tcfg).numpy()
    np.testing.assert_array_equal(tfine, jfine)


def test_classify_bricks_applies_the_precedence_and_lists_mixed_as_work():
    _, _, tcfg = _cfgs()
    _, _, _, table, pose = _inputs("step")
    split = tbrick.classify_bricks(table, pose, TINTR, tcfg, 4096, split=True)
    fine = tbrick.classify_bricks(table, pose, TINTR, tcfg, 4096, split=True, fine=True)
    assert split.aux is not None and fine.aux is None
    assert torch.equal(fine.cls, tbrick.classify_bricks_fine_plain(table, pose, TINTR, tcfg))
    n_work = int(split.totals[1])
    mixed = torch.nonzero(split.cls.reshape(-1) == tbrick.MIXED).reshape(-1).to(torch.int32)
    assert len(mixed) > 0 and bool(torch.isin(mixed, split.work_ids[:n_work]).all())
    assert bool((split.rank[mixed.long()] == -1).all())
    # the windows are carried whole (pack_aux's three ints): an image of any size is classified
    big = Intrinsics(100.0, 100.0, 2500.0, 50.0, 5000, 100)
    big_table = tbrick.depth_mips(torch.full((100, 5000), 2.0))
    wide = tbrick.classify_bricks(big_table, pose, big, tcfg, 4096, split=True)
    assert wide.aux.shape == (wide.cls.numel(), tbrick.AUX_INTS)


def test_split_classifier_on_an_image_wider_than_4096():
    """C4: the split classifier and B3c's MIXED variant on a 4200 px wide
    image, where a window's origin lies past column 4096: the classes and
    windows equal JAX's ``classify_bricks_full(split=True)`` (run eagerly)
    exactly, ``classify_bricks`` takes the image and carries every window
    whole (``pack_aux``'s three ints, as the JAX package's four int32
    arrays), and the MIXED fusion pass gives dense fusion's volume bit for
    bit."""
    from xslam_tpu.geometry.intrinsics import Intrinsics as JIntrinsics

    _, jcfg, tcfg = _cfgs()
    v2c, depth = _wide_case()
    r, t, tr, tt = _poses(v2c)
    intr, jintr = Intrinsics(*WIDE), JIntrinsics(*WIDE)
    dm = tfusion.scale_depth(torch.from_numpy(depth))
    table, pose = tbrick.depth_mips(dm), kernels.fusion_pose(tr, tt)
    jsplit = jbrick.classify_bricks_full(jfusion.scale_depth(jnp.asarray(depth)), r.v, t.v, jintr, jcfg,
                                         jcfg.resolution, split=True)
    tsplit = tbrick.classify_bricks_full_plain(table, pose, intr, tcfg, split=True)
    for field in jbrick.BrickAux._fields:
        np.testing.assert_array_equal(getattr(tsplit, field).numpy(), np.asarray(getattr(jsplit, field)), field)
    mixed = tsplit.cls == tbrick.MIXED
    assert int(mixed.sum()) > 0 and int(tsplit.win_u0[mixed].min()) > 4096
    classes = tbrick.classify_bricks(table, pose, intr, tcfg, 4096, split=True)
    unpacked = tbrick.unpack_aux(classes.aux)
    for field in ("farbits", "win_u0", "win_v0", "win_ts"):
        assert torch.equal(getattr(unpacked, field), getattr(tsplit, field).reshape(-1)), field
    vol = tfusion.create_volume(tcfg, "cpu")
    dense = [x.clone() for x in vol]
    tbrick.fuse_bricks_plain(*vol, dm, pose, intr, tcfg, classes, 4096, False)
    kernels.fuse_volume_plain(*dense, dm, tr, tt, intr, tcfg.voxel_size, tcfg.trunc_dist, tcfg.max_weight)
    assert all(torch.equal(a, b) for a, b in zip(vol, dense))
    assert int((dense[2] > 0).sum()) > 0


# ------------------------------------------------------------- B15c subcells
def _jax_subcells(jdm, r, t, jcfg, cls_flat, cap, subcell_cap):
    """The subcell stage of xslam_tpu/ops/fusion_brick.py::_integrate_rows_core up to its lists: the
    candidates' (cap, 8) classes and each id's cumsum ranks, and the lists' overflow."""
    res = jcfg.resolution
    NB = cls_flat.size
    vs = jcfg.voxel_size
    active = cls_flat == 2
    ids = np.flatnonzero(active)[:cap]
    valid = np.zeros(cap, bool)
    valid[:len(ids)] = True
    ids_c = np.full(cap, NB - 1)
    ids_c[:len(ids)] = ids
    nby, nbz = res[1] // 8, res[2] // 8
    bx, by, bz = ids_c // (nby * nbz), (ids_c // nbz) % nby, ids_c % nbz
    sxa = (np.arange(8) // 4).astype(np.float32) * 4.0
    sya = ((np.arange(8) // 2) % 2).astype(np.float32) * 4.0
    sza = (np.arange(8) % 2).astype(np.float32) * 4.0
    box_x = (jnp.asarray((bx * 8).astype(np.float32))[:, None] + sxa[None] + 0) * vs
    box_y = (jnp.asarray((by * 8).astype(np.float32))[:, None] + sya[None]) * vs
    box_z = (jnp.asarray((bz * 8).astype(np.float32))[:, None] + sza[None]) * vs
    scls = np.asarray(jbrick._classify_boxes(jdm, r, t, SMALL_INTR, jcfg, box_x, box_y, box_z, 4.0 * vs).cls)
    mask = valid[:, None] & (scls == 2)
    rank = np.where(mask, np.cumsum(mask, axis=0) - 1, -1)
    return scls, rank, valid, bool((mask.sum(0) > subcell_cap).any())


@pytest.mark.parametrize("name", ("orbit", "corner", "regression", "step", "seeded3"))
def test_subcell_classes_and_ranks_equal_jax(name):
    _, jcfg, tcfg = _cfgs()
    jdm, r, t, table, pose = _inputs(name)
    cap = 64  # past the ACTIVE count at the corner and the regression pose: rows past it are NONE
    for subcell_cap in (1024, 4):
        classes = tbrick.classify_bricks(table, pose, TINTR, tcfg, cap)
        flag = bool(classes.overflow)
        sub = tbrick.classify_subcells(table, pose, TINTR, tcfg, classes, cap, subcell_cap)
        jcls, jrank, valid, joverflow = _jax_subcells(jdm, r, t, jcfg, classes.cls.numpy().reshape(-1), cap,
                                                      subcell_cap)
        np.testing.assert_array_equal(sub.cls.numpy()[valid], jcls[valid])
        assert not sub.cls.numpy()[~valid].any()
        np.testing.assert_array_equal(sub.rank.numpy(), jrank)
        assert bool(sub.overflow) == joverflow and bool(classes.overflow) == (flag or joverflow)
        assert np.array_equal(sub.counts.numpy(), (jrank >= 0).sum(0))
    assert joverflow or name in ("step",), "a starved subcell_cap of 4 overflows"


# ------------------------------------------------- the fused volume, each option
OPTIONS = {
    "split": dict(classify_split=True),
    "fine": dict(classify_fine=True),
    "subcell": dict(subcell_cap=1024),
    "split_subcell": dict(classify_split=True, subcell_cap=1024),
    "fine_subcell": dict(classify_fine=True, subcell_cap=1024),
    "fine_over_split": dict(classify_fine=True, classify_split=True),
}


def _pre_volume(tcfg):
    """The orbit's frames 0-2 fused densely."""
    cfg = small_config()
    w2v = np.asarray(cfg.world2volume, np.float32)
    ds = small_dataset(3, degrees_per_frame=1.0)
    pre = tfusion.create_volume(tcfg, "cpu")
    for i in range(3):
        v2c = np.linalg.inv(w2v @ ds.get_pose(i)).astype(np.float32)
        _, _, tr, tt = _poses(v2c)
        tfusion.integrate(pre, tfusion.scale_depth(torch.from_numpy(ds.get_depth(i))), tr, tt, TINTR, tcfg)
    return pre


@pytest.fixture(scope="module")
def pre_volume():
    return _pre_volume(_cfgs()[2])


@pytest.mark.parametrize("option", OPTIONS)
@pytest.mark.parametrize("name", ("orbit", "step", "regression"))
def test_options_equal_dense_bit_for_bit_on_both_layouts(pre_volume, name, option):
    _, _, tcfg = _cfgs()
    v2c, depth = _any_case(name)
    _, _, tr, tt = _poses(v2c, seed=5)
    dm = tfusion.scale_depth(torch.from_numpy(depth))
    dense = tfusion.VolumeState(*(x.clone() for x in pre_volume))
    tfusion.integrate(dense, dm, tr, tt, TINTR, tcfg)
    brick = tfusion.VolumeState(*(x.clone() for x in pre_volume))
    overflow, n_active = tfusion.integrate_brick(brick, dm, tr, tt, TINTR, tcfg, cap=4096, **OPTIONS[option])
    rows = tbricks.from_dense(*pre_volume)
    overflow_rows, _ = tfusion.integrate_rows(rows, dm, tr, tt, TINTR, tcfg, cap=4096, **OPTIONS[option])
    assert not bool(overflow) and not bool(overflow_rows) and int(n_active) > 0
    assert int((dense.weight != pre_volume.weight).sum()) > 500
    for d, b, rw in zip(dense, brick, rows):
        assert torch.equal(d.view(torch.int32), b.view(torch.int32))
        assert torch.equal(tbrick.to_bricks(d).view(torch.int32), rw.view(torch.int32))


def _tolerance(jvol, tvol, min_equal=0.9999):
    """tests/test_torch_fusion_brick.py's tolerance: weights equal on >= 99.99% of voxels, value and grad within
    1e-5 where they are."""
    jw, tw = np.asarray(jvol.weight), tvol.weight.numpy()
    assert (jw > 0).sum() > 500
    assert np.mean(jw == tw) >= min_equal
    same = jw == tw
    for plane in ("value", "grad"):
        np.testing.assert_allclose(getattr(tvol, plane).numpy()[same], np.asarray(getattr(jvol, plane))[same],
                                   atol=1e-5)


@pytest.mark.parametrize("bi_threshold", [0.0, BI_THRESHOLD], ids=["nearest", "bilinear"])
@pytest.mark.parametrize("option", ("split", "fine", "subcell", "split_subcell"))
def test_options_match_jax(option, bi_threshold):
    """One frame into an empty volume with a seeded pose, at the step (where
    MIXED fires) and at the orbit: the port's integrate_brick against JAX's."""
    _, jcfg, tcfg = _cfgs()
    for name in ("step", "orbit"):
        v2c, depth = _any_case(name)
        r, t, tr, tt = _poses(v2c, seed=6)
        jvol, joverflow = jbrick.integrate_brick(jfusion.create_volume(jcfg), jfusion.scale_depth(jnp.asarray(depth)),
                                                 r, t, SMALL_INTR, jcfg, bi_threshold=bi_threshold, cap=512,
                                                 **OPTIONS[option])
        tvol = tfusion.create_volume(tcfg, "cpu")
        toverflow, _ = tfusion.integrate_brick(tvol, tfusion.scale_depth(torch.from_numpy(depth)), tr, tt, TINTR,
                                               tcfg, cap=512, bi_threshold=bi_threshold, **OPTIONS[option])
        assert bool(joverflow) == bool(toverflow) is False
        _tolerance(jvol, tvol)


@pytest.mark.parametrize("layout", ["dense", "rows"])
def test_starved_subcell_cap(pre_volume, layout):
    """subcell_cap=4: the flag rises; under "flag" the same voxels stay
    unfused as in the JAX function (its weights everywhere), under "dense"
    the frame is dense fusion's bit for bit."""
    _, jcfg, tcfg = _cfgs()
    v2c, depth = _case("orbit")
    r, t, tr, tt = _poses(v2c)
    jdm = jfusion.scale_depth(jnp.asarray(depth))
    dm = tfusion.scale_depth(torch.from_numpy(depth))
    fuse = tfusion.integrate_rows if layout == "rows" else tfusion.integrate_brick
    to = tbricks.from_dense if layout == "rows" else (lambda *planes: tfusion.VolumeState(*planes))
    jvol, joverflow = jbrick.integrate_brick(jfusion.create_volume(jcfg), jdm, r, t, SMALL_INTR, jcfg, cap=512,
                                             subcell_cap=4)
    tvol = to(*tfusion.create_volume(tcfg, "cpu"))
    toverflow, _ = fuse(tvol, dm, tr, tt, TINTR, tcfg, cap=512, subcell_cap=4)
    assert bool(joverflow) and bool(toverflow)
    weight = tvol.weight if layout == "dense" else tbrick.from_bricks(tvol.weight, tcfg.resolution)
    full = tfusion.create_volume(tcfg, "cpu")
    tfusion.integrate(full, dm, tr, tt, TINTR, tcfg)
    unfused = (full.weight > 0) & (weight == 0)
    assert int(unfused.sum()) > 0
    np.testing.assert_array_equal(weight.numpy(), np.asarray(jvol.weight))

    # "dense": the exact update everywhere, from the pre-frame volume
    pre = _pre_volume(tcfg)
    dense = tfusion.VolumeState(*(x.clone() for x in pre))
    tfusion.integrate(dense, dm, tr, tt, TINTR, tcfg)
    vol = to(*(x.clone() for x in pre))
    flag, _ = fuse(vol, dm, tr, tt, TINTR, tcfg, cap=512, overflow="dense", subcell_cap=4)
    assert bool(flag)
    for d, b in zip(dense, vol):
        want = d if layout == "dense" else tbrick.to_bricks(d)
        assert torch.equal(want.view(torch.int32), b.view(torch.int32))


def test_b15_wrappers_launch_nothing_on_cpu(pre_volume):
    _, _, tcfg = _cfgs()
    before = dict(kernels.launch_counts)
    v2c, depth = _step_case()
    _, _, tr, tt = _poses(v2c)
    vol = tfusion.VolumeState(*(x.clone() for x in pre_volume))
    tfusion.integrate_brick(vol, tfusion.scale_depth(torch.from_numpy(depth)), tr, tt, TINTR, tcfg, cap=64,
                            classify_split=True, subcell_cap=16)
    assert kernels.launch_counts == before
    for name in ("classify_bricks_split", "classify_bricks_fine", "classify_subcells", "fuse_bricks_mixed",
                 "fuse_bricks_subcell"):
        assert before[name] == 0
