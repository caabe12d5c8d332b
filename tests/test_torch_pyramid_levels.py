"""Four pyramid levels (C3): the port's engine against the JAX package's at
``num_levels=4`` (icp_iterations (5, 4, 3, 2)) over 3 frames of the small
sweep, on the CPU, where the plain versions run any number of levels (on
the card K7, K8 and K6 take three levels a launch and are launched again
past them; ``chip_smoke.py`` holds the first three levels of a 4-level run
to the 3-level run's bits).

At 160x120 the fourth level is 20x15 pixels, too coarse to solve: on both
engines every tracked frame fails its alignment at that level, so the poses
stay at frame 0's, bit for bit alike. Held: the align flags equal, the poses
within 1e-6, the volumes within K2's tolerance (weights equal on >= 99.99%
of voxels, values within 1e-5 where they agree), four model-map levels of
the JAX shapes with finite masks equal on >= 99.5% of pixels and values
within 1e-4 where both are valid (tests/test_torch_raycast.py's), and the
depth pyramid's four levels equal to the JAX package's ``pyr_down`` chain
bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.torch_port_helpers import torch_config
from xslam_tpu.models.kinfu import XSlamEngine as JaxEngine
from xslam_tpu.ops import preprocess as jpre
from xslam_tpu_torch.models.kinfu import XSlamEngine
from xslam_tpu_torch.ops import kernels

LEVELS = 4
OPTIONS = dict(end_frame=3, num_levels=LEVELS, icp_iterations=(5, 4, 3, 2))


@pytest.fixture(scope="module")
def runs():
    cfg = small_config(**OPTIONS)
    ds = small_dataset(3, degrees_per_frame=0.5)
    jeng, teng = JaxEngine(cfg), XSlamEngine(torch_config(cfg), device="cpu")
    js, ts = jeng.init_state(), teng.init_state()
    jres, tres = [], []
    for i in range(3):
        js, r = jeng.process_frame(js, ds.get_depth(i))
        jres.append((np.array(r.camera2world.v), bool(r.align_ok)))
        ts, r = teng.process_frame(ts, ds.get_depth(i))
        tres.append((r.camera2world.v.numpy(), bool(r.align_ok)))
    return js, ts, jres, tres, ds


def test_four_levels_track_jax(runs):
    js, ts, jres, tres, _ = runs
    assert [ok for _, ok in tres] == [ok for _, ok in jres]
    for (tp, _), (jp, _) in zip(tres, jres):
        np.testing.assert_allclose(tp, jp, atol=1e-6)
    jw, tw = np.asarray(js.volume.weight), ts.volume.weight.numpy()
    assert (jw > 0).sum() > 1000 and np.mean(jw == tw) >= 0.9999
    same = jw == tw
    np.testing.assert_allclose(ts.volume.value.numpy()[same], np.asarray(js.volume.value)[same], atol=1e-5)


@pytest.mark.parametrize("level", range(LEVELS))
def test_four_levels_of_model_maps(runs, level):
    js, ts = runs[:2]
    for jm, tm in ((js.vmaps_prev[level], ts.vmaps_prev[level]), (js.nmaps_prev[level], ts.nmaps_prev[level])):
        jv, tv = np.asarray(jm.v), tm.v.numpy()
        assert jv.shape == tv.shape == (3, 120 >> level, 160 >> level)
        jf, tf = np.isfinite(jv[0]), np.isfinite(tv[0])
        assert jf.mean() > 0.1 and np.mean(jf == tf) >= 0.995  # a fifth of the 20x15 level is valid
        both = jf & tf
        np.testing.assert_allclose(tv[:, both], jv[:, both], atol=1e-4)


def test_four_level_depth_pyramid(runs):
    depth = runs[4].get_depth(1)
    tp = kernels.depth_pyramid(kernels.bilateral_filter(torch.from_numpy(depth)), LEVELS)
    jp = [jnp.asarray(tp[0].numpy())]
    for _ in range(1, LEVELS):
        jp.append(jpre.pyr_down(jp[-1]))
    assert [tuple(t.shape) for t in tp] == [(120 >> i, 160 >> i) for i in range(LEVELS)]
    for t, j in zip(tp, jp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
