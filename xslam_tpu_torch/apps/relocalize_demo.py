"""Camera relocalization demo: second-order CSFD optimization through the map.

Port of ``apps/relocalize_demo.py``: build a TSDF map from the first frames
of a sequence at their oracle poses (``fusion.integrate``, kernel K2 on the
card), then relocalize held-out frames from perturbed initial poses with the
DCSFD Newton optimizer (``models/relocalize.py``: full 6x6 Hessians from
hyper-dual cross seeds, each evaluation one launch of kernel B12 on the
card). The perturbations are ``numpy.random.default_rng(0)``'s, as in the
JAX app, and so are the printed lines.

Usage:
    python -m xslam_tpu_torch.apps.relocalize_demo [config.yaml] [--frames 12] [--holdout 3]
        [--perturb 0.10] [--iters 12] [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from ..csfd.single import lift
from ..geometry import se3
from ..io.config import load_config
from ..io.dataset import make_dataset
from ..models.relocalize import RelocResult, relocalize
from ..ops import fusion


class Holdout(NamedTuple):
    """One relocalized frame: its id, the result, the initial and final
    translation errors (m) and the seconds the ``relocalize`` call took."""

    frame: int
    result: RelocResult
    init_err: float
    err: float
    seconds: float


def build_map(config, ds, frames: int, device):
    """The TSDF map of the first ``frames`` frames of ``ds`` at their oracle
    poses (camera->volume ``world2volume @ pose``), fused with
    ``fusion.integrate`` (kernel K2 on the card): ``(volume, vol_cfg)``."""
    vol_cfg = fusion.VolumeConfig(
        resolution=tuple(config.tsdf_size),
        voxel_size=config.voxel_size,
        trunc_dist=config.trunc_dist,
        max_weight=config.max_integration_weight,
    )
    w2v = torch.as_tensor(np.asarray(config.world2volume, np.float32), device=device)
    vol = fusion.create_volume(vol_cfg, device)
    for i in range(frames):
        c2v = se3.matmul(lift(w2v), lift(torch.as_tensor(np.asarray(ds.get_pose(i), np.float32), device=device)))
        v2c = se3.inverse(c2v)
        fusion.integrate(vol, depth_metres(ds, i, device), se3.rotation(v2c), se3.translation(v2c),
                         config.intrinsics, vol_cfg)
    return vol, vol_cfg


def depth_metres(ds, i: int, device) -> torch.Tensor:
    return fusion.scale_depth(torch.as_tensor(np.asarray(ds.get_depth(i), np.uint16)).to(device))


def holdout_start(config, ds, fid: int, rng, perturb: float):
    """Frame ``fid``'s true camera->volume pose and its perturbed start
    ``xi``: ``log_real`` of the pose plus ``perturb`` m of translation and
    0.02 of rotation noise from ``rng`` (numpy), as the JAX app draws them."""
    c2v_true = np.asarray(config.world2volume, np.float32) @ ds.get_pose(fid)
    delta = np.concatenate([perturb * rng.normal(size=3), 0.02 * rng.normal(size=3)]).astype(np.float32)
    return c2v_true, se3.log_real(c2v_true) + delta


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default="configs/synthetic.yaml")
    ap.add_argument("--frames", type=int, default=12, help="map-building frames")
    ap.add_argument("--holdout", type=int, default=3, help="frames to relocalize")
    ap.add_argument("--perturb", type=float, default=0.10, help="init offset (m)")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = torch.device("cuda" if args.device is None else args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("relocalize_demo: CUDA is not available (pass --device cpu to run on the CPU)")
    config = load_config(args.config)
    config.end_frame = args.frames + args.holdout
    ds = make_dataset(config)

    print(f"building map from {args.frames} frames...")
    vol, vol_cfg = build_map(config, ds, args.frames, dev)

    rng = np.random.default_rng(0)
    out = []
    for k in range(args.holdout):
        fid = args.frames + k
        dm = depth_metres(ds, fid, dev)
        c2v_true, xi0 = holdout_start(config, ds, fid, rng, args.perturb)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = relocalize(vol.value, dm, torch.as_tensor(xi0, device=dev), config.intrinsics, vol_cfg,
                         iters=args.iters)
        losses = res.loss_history.cpu().numpy()  # waits for the call's work
        seconds = time.perf_counter() - t0
        T_est = se3.exp_real(res.xi).cpu().numpy()
        T_init = se3.exp_real(xi0).numpy()
        e0 = float(np.linalg.norm(T_init[:3, 3] - c2v_true[:3, 3]))
        e1 = float(np.linalg.norm(T_est[:3, 3] - c2v_true[:3, 3]))
        print(
            f"frame {fid}: init err {e0 * 100:.1f} cm -> {e1 * 100:.1f} cm; "
            f"mean loss {losses[0]:.4f} -> {losses[-1]:.4f}; inliers {int(res.count)}"
        )
        out.append(Holdout(fid, res, e0, e1, seconds))
    return out


if __name__ == "__main__":
    main()
