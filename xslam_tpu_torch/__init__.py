"""xslam_tpu_torch — the PyTorch/CUDA port of ``xslam_tpu`` for NVIDIA Hopper.

A second package beside ``xslam_tpu`` (the JAX reference, which it never
imports). Module paths mirror the reference so each counterpart is found by
path: ``xslam_tpu/ops/fusion.py`` -> ``xslam_tpu_torch/ops/fusion.py``. The
frame's heavy passes run as hand-written CUDA kernels
(``xslam_tpu_torch/csrc``, bound in :mod:`xslam_tpu_torch.ops.kernels`);
everything else is plain PyTorch on an explicit ``device``.

Importing the package pins float32 matmuls and convolutions to full
precision: ICP's normal equations broke silently when its f32 matmuls ran
at reduced precision on the TPU (single-pass bf16, ``xslam_tpu/ops/icp.py``),
and TF32 is the same danger on Hopper.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
