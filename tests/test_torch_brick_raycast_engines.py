"""The engines of the brick layout's other raycasts (``tests/test_torch_brick_raycasts.py``'s
marches and normals) in bench.py's brick configuration with the ``secant2``
refine, JAX's and the port's, 3 frames each: every frame aligns; the first
tracked frame within 5e-4 and the ATE in one class, as
``tests/test_torch_raycast_bricks.py`` holds bench.py's; frame 0's model maps
within the tolerances of ``tests/test_torch_brick_raycasts.py::_k5_close``
(the TSDF normals' derivatives also within 1e-3 relative: XLA fuses
multiply-adds in the jitted refine); ``t_prev`` holds the march's hits after
every frame in both, at the same step on >= 99.9% of rays after frame 0 (one
pose) and >= 99% after the tracked frames (poses 1e-4 apart). Apart from the
other raycast tests so that another worker carries its engine set-ups (each
JAX configuration compiles anew).
"""

import numpy as np
import pytest

from tests.test_torch_brick_raycasts import N_FRAMES, SECANT, STEP, _k5_close
from tests.test_torch_raycast_bricks import _step_index
from tests.torch_port_helpers import paired_engine_runs
from xslam_tpu.utils.evaluation import ate_rmse, normalize_to_first
from xslam_tpu_torch.ops.kernels import INF_T

ENGINE_CASES = {f"{m}-{n}": dict(SECANT, raycast_march=m, raycast_normals=n)
                for m in ("skip", "hier_skip", "hier2_skip", "temporal") for n in ("screen", "tsdf")}


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


def test_engines_model_maps_after_frame_0(engines):
    (jv, jn), (tv, tn) = engines["jax"]["maps"], engines["port"]["maps"]
    _k5_close(jv, tv, rtol=1e-3)  # the jitted engine: XLA's fused multiply-adds, as in the raycast tests
    _k5_close(jn, tn, rtol=1e-3)


def test_engines_t_prev_holds_the_march_hits(engines):
    """Every brick march stores its hits as the next frame's anchors (1e9
    where none), in both engines."""
    for i, (j, t) in enumerate(zip(engines["jax"]["t_prev"], engines["port"]["t_prev"])):
        assert np.isfinite(t).all() and (t == INF_T).any() and (t < INF_T).mean() > 0.5
        agree = np.mean(_step_index(j, STEP) == _step_index(t, STEP))
        assert agree >= (0.999 if i == 0 else 0.99), (i, agree)
