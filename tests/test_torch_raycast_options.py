"""The raycast options that the JAX package shows give the same results, in the
port's engine on the CPU against the JAX engine's with the same option.

The port runs the same kernels whatever these options say
(``xslam_tpu_torch/ops/raycast_bricks.py::raycast_bricks_rays``,
``ops/raycast.py::raycast``), as the JAX package's tests show each gives the
results of the path the port has: on the brick layout the compacted skip
march (``raycast_compact``, ``tests/test_bricks.py:328``), the 4-voxel skip
cells (``raycast_skip_gran=4``, ``:275``), the quad taps (``:462``) and the
packed taps (``raycast_packed_taps`` with ``raycast_pair_taps`` off, ``:245``;
with TSDF normals within 1e-6, ``:95-135``); on the dense layout the packed
taps (``tests/test_packed_gathers.py:74``) and the compacted skip march.

Each option over 3 frames: the port's run with the option is its run
without it, bit for bit (poses, ``t_prev``, model maps); against the JAX
engine with the option, every frame aligns, the first tracked frame within
5e-4, the ATE in one class and frame 0's model maps within
``tests/test_torch_raycast.py``'s tolerances (masks >= 99.5% equal, values
within 1e-4, derivatives within 1e-4 of the largest and, as the JAX engine is
jitted and XLA fuses multiply-adds, 1e-3 of themselves), as the settings
without the option are held (``tests/test_torch_brick_raycasts.py``).
"""

import functools

import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.test_torch_brick_raycasts import SECANT, _k5_close
from tests.torch_port_helpers import paired_engine_runs, torch_config
from xslam_tpu.utils.evaluation import ate_rmse, normalize_to_first
from xslam_tpu_torch.models.kinfu import XSlamEngine as TorchEngine

N_FRAMES = 3
# option -> (the setting it is read in, the option's values)
CASES = {
    "brick compact": (dict(SECANT, raycast_march="skip", raycast_normals="tsdf"), dict(raycast_compact=True)),
    "brick skip_gran 4": (dict(SECANT, raycast_march="hier_skip", raycast_normals="screen"),
                          dict(raycast_skip_gran=4)),
    "brick packed taps": (dict(SECANT, raycast_march="skip", raycast_normals="tsdf"),
                          dict(raycast_pair_taps=False, raycast_packed_taps=True)),
    "brick quad taps": (dict(SECANT, raycast_march="hier2_skip", raycast_normals="tsdf"),
                        dict(raycast_quad_taps=True)),
    "dense compact": (dict(raycast_march="skip"), dict(raycast_compact=True)),
    "dense packed taps": (dict(raycast_march="fixed"), dict(raycast_packed_taps=True)),
}


def _port_run(options):
    return _port_run_cached(tuple(sorted(options.items())))


@functools.lru_cache(maxsize=None)
def _port_run_cached(items):
    """The port's run of a setting, once a module: cases that read their
    options in one setting share its run without them."""
    options = dict(items)
    ds = small_dataset(N_FRAMES, degrees_per_frame=1.0)
    engine = TorchEngine(torch_config(small_config(end_frame=N_FRAMES, **options)), device="cpu")
    state = engine.init_state()
    for i in range(N_FRAMES):
        state, res = engine.process_frame(state, ds.get_depth(i))
        engine.log_pose(res)
    return np.stack(engine.pose_log), state.t_prev, state.vmaps_prev[0], state.nmaps_prev[0]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    setting, option = CASES[request.param]
    return setting, option, paired_engine_runs(dict(setting, **option), N_FRAMES)


def test_option_changes_nothing_in_the_port(case):
    setting, option, _ = case
    with_option, without = _port_run(dict(setting, **option)), _port_run(setting)
    assert with_option[0].tobytes() == without[0].tobytes()
    assert torch.equal(with_option[1], without[1])
    for a, b in zip(with_option[2:], without[2:]):
        assert torch.equal(a.v.view(torch.int32), b.v.view(torch.int32))
        assert torch.equal(a.g.view(torch.int32), b.g.view(torch.int32))


def test_option_first_tracked_frame(case):
    runs = case[2]
    assert all(runs["jax"]["ok"]) and all(runs["port"]["ok"])
    np.testing.assert_allclose(runs["port"]["poses"][1], runs["jax"]["poses"][1], atol=5e-4)


def test_option_ate_class(case):
    runs = case[2]
    ate_j = ate_rmse(normalize_to_first(runs["jax"]["poses"]), runs["gt"])
    ate_t = ate_rmse(normalize_to_first(runs["port"]["poses"]), runs["gt"])
    assert ate_j < 0.06 and ate_t < 0.06, (ate_j, ate_t)
    assert abs(ate_j - ate_t) < 5e-3, (ate_j, ate_t)


def test_option_model_maps_after_frame_0(case):
    (jv, jn), (tv, tn) = case[2]["jax"]["maps"], case[2]["port"]["maps"]
    _k5_close(jv, tv, rtol=1e-3)  # the jitted engine: XLA's fused multiply-adds, as in the raycast tests
    _k5_close(jn, tn, rtol=1e-3)
