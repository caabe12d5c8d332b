"""Wall-clock timing that waits for the device.

Port of ``xslam_tpu/utils/timers.py`` (reference ``cx::timer``,
``Common/include/cxtimers.h:19-89``). PyTorch returns before a CUDA launch
has run, so a lap waits first on the devices of the tensors it is given, as
the JAX package's lap blocks on its arrays and the reference's kernel
wrappers call ``cudaDeviceSynchronize``.
"""

from __future__ import annotations

import time

import torch


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in ``tree``: a tensor, or a nest of
    tuples (NamedTuples too), lists and dicts of them; other leaves are
    ignored."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def block_until_ready(tree):
    """Wait until the work queued on the devices of ``tree``'s CUDA tensors
    has run (CPU tensors are ready); returns ``tree``."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)
    return tree


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.total = 0.0

    def reset(self):
        self.t0 = time.perf_counter()

    def lap_ms(self, sync=None) -> float:
        """Milliseconds since reset; waits on ``sync`` (a tensor or a nest of
        them) first, so that the device work is included."""
        if sync is not None:
            block_until_ready(sync)
        dt = (time.perf_counter() - self.t0) * 1000.0
        self.total += dt
        return dt
