"""One rank of the port's sharded engine over frames given in files: the
process that ``tests/test_torch_sharded.py`` starts once a rank. It imports
only torch and the port, so a rank does not load JAX through a test module.

Usage (from the repo's root, with it on ``PYTHONPATH``):
    python tests/sharded_rank.py CONFIG.pkl DEPTHS.npy OUT_PREFIX --rank R --world-size N
        --init-method file:///... [--device cpu]

``CONFIG.pkl``: a pickled :class:`xslam_tpu_torch.io.config.SlamConfig`;
``DEPTHS.npy``: a (K, H, W) uint16 stack. Rank r writes ``OUT_PREFIX.r.npz``:
each frame's pose (value and derivative lanes), ``align_ok``, inlier count
and overflow flag, and on rank 0 the whole volume (the ranks' slabs
gathered) and level 0's model maps.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from xslam_tpu_torch.parallel.engine import ShardedXSlamEngine
from xslam_tpu_torch.parallel.mesh import destroy_space_group, init_space_group


def run(config, depths: np.ndarray, rank: int, world_size: int, init_method: str, device=None) -> dict:
    """This rank's run over ``depths``: what :func:`main` writes."""
    group = init_space_group(device, init_method=init_method, rank=rank, world_size=world_size)
    try:
        engine = ShardedXSlamEngine(config, group=group)
        state = engine.init_state()
        out = {k: [] for k in ("pose_v", "pose_g", "align_ok", "inliers", "overflow")}
        for depth in depths:
            state, res = engine.process_frame(state, depth)
            out["pose_v"].append(res.camera2world.v.cpu().numpy())
            out["pose_g"].append(res.camera2world.g.cpu().numpy())
            out["align_ok"].append(bool(res.align_ok))
            out["inliers"].append(int(res.inlier_count))
            out["overflow"].append(bool(res.fusion_overflow))
        out = {k: np.asarray(v) for k, v in out.items()}
        volume = engine.dense_volume(state)  # a collective: every rank takes part
        if rank == 0:
            out.update(value=volume.value.cpu().numpy(), weight=volume.weight.cpu().numpy(),
                       vmap=state.vmaps_prev[0].v.cpu().numpy(), nmap=state.nmaps_prev[0].v.cpu().numpy())
        out["slab"] = np.asarray(engine.slab)
        return out
    finally:
        destroy_space_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("depths")
    ap.add_argument("out_prefix")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--device", default=None, help="torch device (default: cuda, NCCL); cpu: gloo")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    with open(args.config, "rb") as f:
        config = pickle.load(f)
    out = run(config, np.load(args.depths), args.rank, args.world_size, args.init_method, args.device)
    np.savez(f"{args.out_prefix}.{args.rank}.npz", **out)


if __name__ == "__main__":
    main()
