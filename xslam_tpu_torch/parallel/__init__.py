"""The sharded engine on ``torch.distributed``: the port of
``xslam_tpu/parallel/`` for the dense volume layout.

A rank holds one X-slab of the TSDF volume where the JAX package has a mesh
device (:mod:`.mesh`); :mod:`.sharded` holds the stages (slab fusion, the
halo-exchanged raycast, the ICP over column blocks) and :mod:`.engine` the
per-frame step, :class:`~xslam_tpu_torch.parallel.engine.ShardedXSlamEngine`.
The ranks talk over NCCL on the card, or over gloo where the caller asks for
the CPU.
"""

from .mesh import SpaceGroup, init_space_group

__all__ = ["SpaceGroup", "init_space_group"]
