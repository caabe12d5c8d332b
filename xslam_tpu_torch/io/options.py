"""The configuration options a command-line run may set over its YAML
file's values, shared by :mod:`xslam_tpu_torch.run_slam`,
:mod:`xslam_tpu_torch.profile_step` and
:mod:`xslam_tpu_torch.apps.compare_trees`.

``--fixed-assoc``, ``--model-map-level``, ``--fusion-mode``,
``--fusion-brick-cap``, ``--fusion-overflow``, ``--volume-layout``,
``--raycast-march``, ``--raycast-refine``, ``--raycast-normals`` and
``--bi-interpolate-threshold`` set ``icp_fixed_assoc``, ``model_map_level``,
``fusion_mode``, ``fusion_brick_cap``, ``fusion_overflow``,
``volume_layout``, ``raycast_march``, ``raycast_refine``,
``raycast_normals`` and ``bi_interpolate_threshold`` (the YAML's
``biInterpolate_threshold``); :data:`BENCH_ARGS` is bench.py's
configuration, :data:`HIER2_ARGS` the dense layout's ``hier2`` march with
screen normals and bilinear fusion.
"""

from __future__ import annotations

import argparse

# bench.py:78-95's configuration as command-line options
BENCH_ARGS = ("--fixed-assoc", "--model-map-level", "1", "--fusion-mode", "brick", "--fusion-brick-cap", "2816",
              "--fusion-overflow", "dense", "--volume-layout", "brick", "--raycast-march", "temporal",
              "--raycast-refine", "reuse", "--raycast-normals", "screen")
# the dense layout's hierarchical march with screen normals and bilinear depth sampling in fusion
HIER2_ARGS = ("--raycast-march", "hier2", "--raycast-normals", "screen", "--bi-interpolate-threshold", "0.1")
OPTIONS = ("model_map_level", "fusion_mode", "fusion_brick_cap", "fusion_overflow", "volume_layout", "raycast_march",
           "raycast_refine", "raycast_normals", "bi_interpolate_threshold")
MARCHES = ("fixed", "skip", "hier", "hier_skip", "hier2", "hier2_skip", "temporal")  # hier2_skip: brick layout only


def set_options(config, args) -> None:
    """Set on ``config`` the options given on the command line; the others
    keep the file's values."""
    for key in OPTIONS:
        if getattr(args, key) is not None:
            setattr(config, key, getattr(args, key))
    if args.fixed_assoc:
        config.icp_fixed_assoc = True


def add_options(ap: argparse.ArgumentParser) -> None:
    """The configuration options a run may set over its file's (:func:`set_options`)."""
    ap.add_argument("--fixed-assoc", action="store_true", help="icp_fixed_assoc=True")
    ap.add_argument("--model-map-level", type=int, default=None, help="model_map_level")
    ap.add_argument("--fusion-mode", choices=("dense", "brick"), default=None, help="fusion_mode")
    ap.add_argument("--fusion-brick-cap", type=int, default=None, help="fusion_brick_cap")
    ap.add_argument("--fusion-overflow", choices=("flag", "dense"), default=None, help="fusion_overflow")
    ap.add_argument("--volume-layout", choices=("dense", "brick"), default=None, help="volume_layout")
    ap.add_argument("--raycast-march", choices=MARCHES, default=None, help="raycast_march")
    ap.add_argument("--raycast-refine", choices=("secant2", "reuse"), default=None, help="raycast_refine")
    ap.add_argument("--raycast-normals", choices=("tsdf", "screen"), default=None, help="raycast_normals")
    ap.add_argument("--bi-interpolate-threshold", type=float, default=None,
                    help="bi_interpolate_threshold (biInterpolate_threshold): > 0 samples fusion's depth bilinearly")
