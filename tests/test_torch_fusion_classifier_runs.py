"""The engines with B15's fusion options (``fusion_classify_split``,
``fusion_classify_fine``, ``fusion_subcell_cap > 0``; kernels B15s, B15f,
B15c and B3c's MIXED and subcell variants, plain versions on the CPU), at
the tests' scale (64^3, 160x120).

- Two JAX/port engine pairs of 3 frames through
  ``torch_port_helpers.paired_engine_runs``: bench.py's configuration with
  the split classifier and the subcell stage, and the dense layout with brick
  fusion and the fine classifier. Every frame aligns on both, and the ATEs
  lie under 0.06 m and within 5e-3 m of each other (the engines' ATE class of
  tests/test_torch_kinfu.py: runs diverge from 1-ulp differences, so they are
  compared by ATE, not pose by pose).
- The option sets the port refused before it had these paths (each alone and
  combined, on both layouts, beside the raycast options they can meet) build
  an engine on the CPU and run a frame at 64^3; the frame's volume is the
  run's without the options, bit for bit, since every classifier and the
  subcell stage give dense fusion's volume, except where a subcell list of
  64 or 32 overflows under ``"flag"``: the flag rises and the subcells past
  the capacity stay unfused.

Alone this file takes about a minute (the JAX engines' compiles).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.torch_port_helpers import paired_engine_runs, torch_config
from xslam_tpu.utils.evaluation import ate_rmse, normalize_to_first
from xslam_tpu_torch.models.kinfu import XSlamEngine as TorchEngine

BENCH = dict(volume_layout="brick", fusion_mode="brick", fusion_brick_cap=2816, fusion_overflow="dense",
             raycast_normals="screen", raycast_march="temporal", model_map_level=1, icp_fixed_assoc=True,
             raycast_refine="reuse", num_levels=2)  # bench.py:78-95; two levels at 160x120 (test_torch_kinfu.py)
SECANT = dict(BENCH, raycast_refine="secant2")


@pytest.mark.parametrize("options", [
    dict(BENCH, fusion_classify_split=True, fusion_subcell_cap=2816),
    dict(fusion_mode="brick", fusion_brick_cap=2816, fusion_overflow="flag", fusion_classify_fine=True),
], ids=["bench_split_subcell", "dense_layout_fine"])
def test_engine_pairs(options):
    runs = paired_engine_runs(options, 3)
    assert all(runs["jax"]["ok"]) and all(runs["port"]["ok"])
    ate_j = ate_rmse(normalize_to_first(runs["jax"]["poses"]), runs["gt"])
    ate_t = ate_rmse(normalize_to_first(runs["port"]["poses"]), runs["gt"])
    assert ate_j < 0.06 and ate_t < 0.06 and abs(ate_j - ate_t) < 5e-3, (ate_j, ate_t)


# the option sets that raised NotImplementedError before B15 was ported: tests/test_torch_kinfu.py's seven and
# tests/test_torch_raycast_bricks.py's nine
B15_OPTION_SETS = [
    dict(volume_layout="brick", fusion_mode="brick", fusion_subcell_cap=64),
    dict(fusion_mode="brick", fusion_classify_fine=True),
    dict(fusion_mode="brick", fusion_classify_split=True),
    dict(fusion_mode="brick", fusion_subcell_cap=64),
    dict(raycast_packed_taps=True, fusion_mode="brick", fusion_classify_fine=True),
    dict(raycast_compact=True, fusion_mode="brick", fusion_classify_split=True),
    dict(volume_layout="brick", fusion_mode="brick", raycast_march="hier_skip", raycast_refine="secant2",
         fusion_classify_fine=True),
    dict(volume_layout="brick", fusion_mode="brick", fusion_classify_fine=True),
    dict(SECANT, fusion_classify_split=True),
    dict(SECANT, raycast_march="hier2", fusion_subcell_cap=64),
    dict(BENCH, raycast_quad_taps=True, fusion_classify_fine=True),
    dict(BENCH, raycast_temporal_phase1=4, fusion_classify_split=True),
    dict(BENCH, raycast_skip_gran=4, fusion_subcell_cap=64),
    dict(BENCH, raycast_compact=True, fusion_classify_fine=True),
    dict(raycast_compact=True, fusion_mode="brick", fusion_subcell_cap=32),
    dict(volume_layout="brick", fusion_mode="brick", raycast_march="hier_skip", raycast_refine="secant2",
         raycast_normals="screen", fusion_classify_split=True),
]
B15_KEYS = ("fusion_classify_fine", "fusion_classify_split", "fusion_subcell_cap")


def _one_frame(cfg):
    engine = TorchEngine(torch_config(cfg), device="cpu")
    state, res = engine.process_frame(engine.init_state(), small_dataset(1, degrees_per_frame=1.0).get_depth(0))
    return engine.dense_volume(state), res


@pytest.mark.parametrize("options", B15_OPTION_SETS)
def test_b15_option_sets_run_a_frame(options):
    cfg = small_config(end_frame=1, **options)
    volume, res = _one_frame(cfg)
    plain, _ = _one_frame(dataclasses.replace(cfg, **{k: getattr(small_config(), k) for k in B15_KEYS}))
    assert bool(res.align_ok) and int(res.fusion_active) > 0 and np.isfinite(res.camera2world.v.numpy()).all()
    assert int((volume.weight > 0).sum()) > 1000
    same = volume.weight == plain.weight
    if bool(res.fusion_overflow):
        # a subcell list of 64 or 32 under "flag" overflows on the first frame: its subcells past the capacity
        # stay unfused, the other voxels are fused as without the options
        assert cfg.fusion_overflow == "flag" and cfg.fusion_subcell_cap > 0
        assert not bool(same.all()) and bool((volume.weight[~same] == 0).all())
    for a, b in zip(volume, plain):
        assert torch.equal(a[same].view(torch.int32), b[same].view(torch.int32))
