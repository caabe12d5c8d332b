"""Depth dataset loaders: ICL-NUIM and 7-Scenes.

Port of ``xslam_tpu/io/dataset.py`` (the reference's OpenCV-based loaders,
``XKinectFusion/src/Dataset.cpp``): 16-bit depth PNGs divided by a format
factor, optional horizontal flip, ground-truth pose files. The PNGs are read
by :func:`xslam_tpu_torch.io.png.read_png16` (no PIL, no native runtime).

:meth:`Dataset.get_depth` returns a C-contiguous uint16 array, flipped or
not: the JAX loader's flip is a negative-stride view, which
``torch.as_tensor`` refuses.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .png import read_png16


class Dataset:
    """Base protocol mirroring ``Dataset`` (Dataset.h:18-46): indexed depth
    frames (uint16 mm after ``/= factor``) plus ground-truth c2w poses."""

    factor: int = 1
    is_flip: bool = False
    depth_files: List[str]
    gt_poses: List[np.ndarray]

    def __len__(self):
        return len(self.depth_files)

    def get_depth(self, i: int) -> np.ndarray:
        depth = read_png16(self.depth_files[i])
        if self.factor != 1:
            depth = (depth // self.factor).astype(np.uint16)
        if self.is_flip:
            depth = np.ascontiguousarray(depth[:, ::-1])
        return depth

    def get_pose(self, i: int) -> np.ndarray:
        return self.gt_poses[i]


class ICLDataset(Dataset):
    """ICL-NUIM living-room sequences (Dataset.cpp:69-125): depth factor 5,
    poses read as 4-row blocks from ``livingRoom1n.gt.sim``."""

    def __init__(self, dataset_dir: str, start_frame: int, end_frame: int, is_flip=False):
        self.factor = 5
        self.is_flip = is_flip
        self.depth_files = [os.path.join(dataset_dir, "depth", f"{i}.png") for i in range(start_frame, end_frame + 1)]
        poses_path = os.path.join(dataset_dir, "livingRoom1n.gt.sim")
        self.gt_poses = self._read_sim_poses(poses_path, start_frame, end_frame)

    @staticmethod
    def _read_sim_poses(path: str, start: int, end: int) -> List[np.ndarray]:
        # 4 file lines per frame (3 matrix rows + separator), indexed by raw
        # line number like the reference (Dataset.cpp:90-118) — blank lines
        # count.
        with open(path) as f:
            lines = [ln.split() for ln in f]
        poses = []
        for i in range(start, end + 1):
            block = lines[4 * i: 4 * i + 3]
            pose = np.eye(4)
            for r, row in enumerate(block):
                pose[r, : len(row)] = [float(x) for x in row]
            poses.append(pose)
        return poses


class SevenScenesDataset(Dataset):
    """7-Scenes frames ``seq-N/frame-XXXXXX.depth.png`` + ``.pose.txt``
    (Dataset.cpp:13-39), multi-sequence via an info file (":41-67")."""

    def __init__(self, dataset_dir: str, start_frames: List[int], end_frames: List[int], seq_names: List[str],
                 is_flip=False):
        self.factor = 1
        self.is_flip = is_flip
        self.depth_files = []
        self.gt_poses = []
        for start, end, seq in zip(start_frames, end_frames, seq_names):
            for frame in range(start, end + 1):
                stem = os.path.join(dataset_dir, seq, f"frame-{frame:06d}")
                self.depth_files.append(stem + ".depth.png")
                self.gt_poses.append(np.loadtxt(stem + ".pose.txt").reshape(4, 4))

    @classmethod
    def from_info_file(cls, dataset_dir: str, info_path: str, is_flip=False):
        with open(info_path) as f:
            rows = [ln.split() for ln in f if ln.strip()]
        starts = [int(x) for x in rows[0]]
        ends = [int(x) for x in rows[1]]
        seqs = [f"seq-{x}" for x in rows[2]]
        return cls(dataset_dir, starts, ends, seqs, is_flip)


def make_dataset(config):
    """Instantiate from a :class:`~xslam_tpu_torch.io.config.SlamConfig`."""
    fmt = config.dataset_format.lower()
    if fmt == "icl":
        return ICLDataset(config.dataset_dir, config.start_frame, config.end_frame, config.is_flip)
    if fmt in ("7scenes", "seven_scenes"):
        return SevenScenesDataset.from_info_file(
            config.dataset_dir, os.path.join(config.dataset_dir, "info.txt"), config.is_flip
        )
    if fmt == "synthetic":
        from .synthetic import SyntheticDataset

        return SyntheticDataset(n_frames=config.end_frame - config.start_frame + 1, intr=config.intrinsics)
    raise ValueError(f"unknown dataset format: {config.dataset_format}")
