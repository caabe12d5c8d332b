"""Camera relocalization by second-order (Newton) optimization through the
TSDF map.

Port of ``xslam_tpu/models/relocalize.py``, X-SLAM's task-aware
optimization: the relocalization loss with its directional first and second
derivatives via DCSFD pose seeds (reference ``ComputeLocalTsdfHessianKernel``
and the host Newton logic of ``KinectFusionReconstruction.cpp:403-436``, the
complex ``se3Exp`` of ``KinectFusionReconstruction.h:176-219``). The full
6x6 Hessian comes from hyper-dual cross seeds: with ``e1 = e_j, e2 = e_k``
the ``e12`` lane carries ``e_j^T H e_k``; 6 diagonal and 15 cross pairs.

The 21 pairs' poses are made by plain PyTorch, batched over a trailing pair
axis (``se3.exp`` -> ``inverse``), and evaluated over the map's band (the
voxels that pass ``gt``'s test, listed once a call by B12's band pass,
``ops/tsdf_loss.py::make_band``) in ONE launch of kernel B12 (its plain
version on CPU tensors). A trial step needs only the loss and the count: it
is B12's value-only launch on the same packed poses, whose v lanes are the
21-pair launch's bit for bit. A ``relocalize`` call launches the band pass
once and B12 ``2 * iters + 2`` times: the count at the start, a 21-pair and
a value-only launch an iteration, and the loss at the returned pose.

Nothing in :func:`relocalize` reads a value back to the host: the Newton loop
(JAX's ``lax.scan``) is a Python loop whose pose, damping and accept flags
stay on the device, with a 6x6 ``solve_ex`` and ``torch.where`` for the
accept.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..csfd import double as dc
from ..csfd.double import DCSFD
from ..geometry import se3
from ..geometry.intrinsics import Intrinsics
from ..ops.fusion import VolumeConfig
from ..ops.tsdf_loss import SEED_J, SEED_K, make_band, pack_pose, tsdf_loss_pairs


class RelocResult(NamedTuple):
    xi: torch.Tensor  # (6,) optimized se(3) pose
    loss_history: torch.Tensor  # (iters + 1,)
    count: torch.Tensor


# (21, 6) direction pairs: 6 diagonal then 15 upper-triangle cross (ops/tsdf_loss.py::SEED_J, SEED_K)
_D1, _D2 = np.eye(6, dtype=np.float32)[SEED_J], np.eye(6, dtype=np.float32)[SEED_K]
_H_INDEX = np.zeros((6, 6), np.int64)  # which pair's e12 sum each entry of H is (:78-86)
_H_INDEX[np.arange(6), np.arange(6)] = np.arange(6)
_H_INDEX[np.triu_indices(6, 1)] = np.arange(6, 21)
_H_INDEX.T[np.triu_indices(6, 1)] = np.arange(6, 21)


_constants: dict = {}  # device -> the seed directions and H's index, uploaded once (no copy in the loop)


def _on(device):
    """``(d1, d2, zeros, H's index)`` on ``device``: (6, 21) seed lanes and the
    (6, 6) index of each entry of H into the pairs' e12 sums."""
    if device not in _constants:
        d1 = torch.as_tensor(np.ascontiguousarray(_D1.T), device=device)
        _constants[device] = (d1, torch.as_tensor(np.ascontiguousarray(_D2.T), device=device), torch.zeros_like(d1),
                              torch.as_tensor(_H_INDEX, device=device))
    return _constants[device]


def seeded_poses(xi: torch.Tensor) -> torch.Tensor:
    """The 21 seed pairs' hyper-dual volume->camera poses at ``xi``, packed
    (21, 48) as B12 reads them: ``se3.exp`` of ``DCSFD(xi, d1, d2, 0)`` for
    every pair at once (a trailing pair axis), then ``inverse``."""
    d1, d2, zeros, _ = _on(xi.device)
    x = xi.to(torch.float32)[:, None].expand(6, 21)
    c2v = se3.exp(DCSFD(x, d1, d2, zeros), mod=dc)
    v2c = se3.inverse(c2v)
    return pack_pose(se3.rotation(v2c), se3.translation(v2c))


def _hessian(e12: torch.Tensor) -> torch.Tensor:
    return e12[_on(e12.device)[3]]


def loss_grad_hessian(
    gt_value: torch.Tensor,
    depth_m: torch.Tensor,
    xi: torch.Tensor,
    intr: Intrinsics,
    cfg: VolumeConfig,
):
    """Full (loss, grad(6), H(6,6), count) at pose ``xi``: the 21 seed pairs
    in one B12 launch (its plain version on CPU tensors)."""
    sums, count = tsdf_loss_pairs(gt_value, depth_m, seeded_poses(xi), intr, cfg)
    return sums[0], sums[1:7], _hessian(sums[7:28]), count


def _value_count(gt_value, depth_m, xi, intr, cfg, pairs=tsdf_loss_pairs):
    """The loss and count of :func:`loss_grad_hessian` at ``xi``, bit for
    bit, from B12's value-only launch on the same packed poses."""
    sums, count = pairs(gt_value, depth_m, seeded_poses(xi), intr, cfg, mode="value")
    return sums[0], count


def relocalize(
    gt_value: torch.Tensor,
    depth_m: torch.Tensor,
    xi0,
    intr: Intrinsics,
    cfg: VolumeConfig,
    iters: int = 10,
    damping: float = 1e-4,
) -> RelocResult:
    """Damped Newton iteration on the relocalization loss.

    The reference's LM scaffolding (damp/lambda fields,
    KinectFusionReconstruction.h:74-79) is realized as Levenberg-style
    diagonal damping with accept/reject: a step is taken where the mean loss
    falls, the count keeps at least 70% of the start's and the pose is a
    number; ``lam`` is halved on accept (to 1e-6) and multiplied by 4 on
    reject (to 1e2)."""
    return newton(gt_value, depth_m, xi0, intr, cfg, iters, damping)[0]


def newton(gt_value, depth_m, xi0, intr: Intrinsics, cfg: VolumeConfig, iters: int = 10, damping: float = 1e-4,
           pairs=None):
    """:func:`relocalize`'s loop with what it decided: ``(result, accepts,
    (means, means_new))``, each a device tensor of one entry an iteration.
    ``pairs(gt_value, depth_m, poses, intr, cfg, mode=...)`` evaluates the
    packed poses. Where None it is B12's wrapper over the band of
    ``gt_value`` (``make_band``, listed here once and passed to every
    evaluation of the call: ``gt_value`` does not change inside it). On the
    card, B12's plain version (``tsdf_loss_hessian_plain``, which lists its
    own voxels) holds the two loops to one another."""
    dev = gt_value.device
    if pairs is None:
        pairs = partial(tsdf_loss_pairs, band=make_band(gt_value))
    xi = torch.as_tensor(xi0, dtype=torch.float32, device=dev)
    _, count0 = _value_count(gt_value, depth_m, xi, intr, cfg, pairs)
    floor = (count0.to(torch.float32) * 0.7).to(torch.int32)  # astype: truncated toward zero
    lam = torch.tensor(damping, dtype=torch.float32, device=dev)
    eye = torch.eye(6, dtype=torch.float32, device=dev)
    means, means_new, accepts = [], [], []
    for _ in range(iters):
        sums, count = pairs(gt_value, depth_m, seeded_poses(xi), intr, cfg)
        g, H = sums[1:7], _hessian(sums[7:28])
        mean = sums[0] / torch.clamp(count, min=1)
        delta = -torch.linalg.solve_ex(H + lam * eye, g)[0]
        xi_new = xi + delta
        loss_new, count_new = _value_count(gt_value, depth_m, xi_new, intr, cfg, pairs)
        mean_new = loss_new / torch.clamp(count_new, min=1)
        # accept on mean-loss descent with a coverage guard: the raw summed loss rewards shrinking the
        # valid-voxel set, so a step may not sacrifice coverage
        accept = (mean_new < mean) & (count_new >= floor) & ~torch.any(torch.isnan(xi_new))
        xi = torch.where(accept, xi_new, xi)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-6), torch.clamp(lam * 4.0, max=1e2))
        means.append(mean)
        means_new.append(mean_new)
        accepts.append(accept)
    # close the history with the loss AT the returned xi (exp_real, inverse_real, the real-valued loss): the
    # loop records the mean at the START of each iteration, so the last entry would describe the pose before
    # the final accepted step
    v2c = se3.inverse_real(se3.exp_real(xi))
    z = torch.zeros((3, 3), dtype=torch.float32, device=dev)
    poses = pack_pose(DCSFD(v2c[:3, :3], z, z, z), DCSFD(v2c[:3, 3], z[0], z[0], z[0]))
    loss_final, count_final = pairs(gt_value, depth_m, poses, intr, cfg, mode="value")
    mean_final = loss_final[0] / torch.clamp(count_final, min=1)
    result = RelocResult(xi=xi, loss_history=torch.stack(means + [mean_final]), count=count_final)
    stack = (lambda xs: torch.stack(xs)) if iters else (lambda xs: torch.zeros(0, device=dev))
    return result, stack(accepts), (stack(means), stack(means_new))
