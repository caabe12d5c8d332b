"""Multi-process launcher of the sharded engine: the port of
``apps/run_distributed.py``.

Every process runs this program as one rank; ``torchrun`` gives each its
rank, the world size and the rendezvous, and the volume's X-slabs are spread
over the ranks (:class:`xslam_tpu_torch.parallel.engine.ShardedXSlamEngine`):

    torchrun --nproc_per_node N -m xslam_tpu_torch.apps.run_distributed configs/synthetic.yaml
    torchrun --nproc_per_node 2 -m xslam_tpu_torch.apps.run_distributed configs/x.yaml --device cpu   # gloo

Either volume layout: a brick config (``volume_layout: brick``) gathers the
rows for the raycast, and each rank marches a block of the model maps'
columns (:mod:`xslam_tpu_torch.parallel.sharded`).

On the card each rank takes ``cuda:LOCAL_RANK`` over NCCL (one card a rank);
``--device cpu`` takes gloo on the CPU. Without torchrun's variables it is a
group of one. Every rank reads the frames; rank 0 prints the ranks and the
slab size, then the frame rate and the ATE, as the JAX launcher does.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default="configs/synthetic.yaml")
    ap.add_argument("--frames", type=int, default=None, help="override end_frame")
    ap.add_argument("--device", default=None, help="torch device (default: cuda, NCCL); cpu: gloo")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from ..io.config import load_config
    from ..io.dataset import make_dataset
    from ..parallel.engine import ShardedXSlamEngine
    from ..parallel.mesh import destroy_space_group
    from ..utils.evaluation import ate_rmse, normalize_to_first

    config = load_config(args.config)
    if args.frames is not None:
        config.end_frame = args.frames
    dataset = make_dataset(config)
    n_frames = min(len(dataset), config.end_frame - config.start_frame)

    engine = ShardedXSlamEngine(config, device=args.device)
    group = engine.group
    state = engine.init_state()
    if group.rank == 0:
        print(f"ranks: {group.world_size} over {group.backend}; volume slab per rank: "
              f"{config.tsdf_size[0] // group.world_size} x {config.tsdf_size[1]} x {config.tsdf_size[2]}",
              flush=True)
    total = 0.0
    for i in range(n_frames):
        depth = dataset.get_depth(config.start_frame + i)
        t0 = time.perf_counter()
        state, res = engine.process_frame(state, depth)
        engine.log_pose(res)  # reads the pose back: the frame's work is done
        if i > 0:
            total += time.perf_counter() - t0
    if group.rank == 0 and n_frames > 1:
        gt = [dataset.get_pose(config.start_frame + i) for i in range(n_frames)]
        ate = ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first(gt))
        print(f"frames/s (all ranks): {(n_frames - 1) / total:.2f}; ATE RMSE: {ate:.5f} m", flush=True)
    if dist.is_initialized():
        dist.barrier()
    destroy_space_group()


if __name__ == "__main__":
    main()
