"""How PyTorch's own operators round on a device, where a hand kernel has to
repeat them to equal its plain version bit for bit.

Usage:
    python -m xslam_tpu_torch.apps.torch_rounding [--device cuda|cpu]

Prints one JSON object with fractions of equal results over seeded inputs:

- ``div_<c>``: ``x / c`` for a Python number ``c`` against ``x * float32(1.0 /
  c)`` (reciprocal in double, rounded once), ``x * (float32(1) / float32(c))``
  (reciprocal in float32) and the true float32 division;
- ``mean_2x2``: ``torch.mean`` over the 2x2 blocks of ``reshape(3, h, 2, w,
  2)``, as the model-map pyramid takes it, against the four ways to add four
  numbers;
- ``sum_3``: ``torch.sum`` over a leading axis of 3 against the three orders;
- ``rdiv_<c>``: ``c / x`` for a Python number ``c`` against
  ``torch.reciprocal(x) * c`` (what ``Tensor.__rtruediv__`` computes) and the
  true float32 division; ``reciprocal``: ``torch.reciprocal(x)`` against the
  true division ``1 / x``.

On a CUDA device the kernels of ``csrc/`` follow the variants in
:data:`FOLLOWED` (``ops/kernels.py::reciprocal_f32``, ``csrc/maps.cu``,
``csrc/dual.cuh``, ``csrc/tsdf_loss.cu``), which read 1.0 on torch 2.11; on the CPU the division is
the true one. :func:`not_followed` lists those that no longer read 1.0: after
an upgrade of PyTorch that changes one of them, K3, K5, K6 and K8 leave their
plain versions by an ulp with no change of their own, and ``chip_smoke.py``
says so before it compares them.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

DIVISORS = (1000.0, 481.2, 0.03, -480.0, 240.6, 0.12)
NUMERATORS = (1.0, 0.5, -0.25)  # c / x as csfd/double.py takes it (dc.sqrt's derivatives, DCSFD division)
# what the kernels repeat on a CUDA device: report key (or its prefix) -> variant
FOLLOWED = {"div_": "reciprocal_in_double", "mean_2x2": "(q00+q10)+(q01+q11)", "sum_3": "(0+1)+2",
            "rdiv_": "reciprocal_times_c", "reciprocal": "true_division"}


def measure(device) -> dict:
    device = torch.device(device)
    rng = np.random.default_rng(0)

    def frac(a, b):
        return float((a == b).float().mean())

    x = torch.as_tensor((rng.random(1 << 20) * 5000 - 2500).astype(np.float32), device=device)
    out = {}
    for c in DIVISORS:
        q = x / c
        out[f"div_{c}"] = {
            "reciprocal_in_double": frac(q, x * float(np.float32(1.0 / c))),
            "reciprocal_in_float32": frac(q, x * float(np.float32(1.0) / np.float32(c))),
            "true_division": frac(q, x / torch.tensor(c, dtype=torch.float32, device=device)),
        }
    m = torch.as_tensor(rng.standard_normal((3, 480, 640)).astype(np.float32), device=device)
    q = m.reshape(3, 240, 2, 320, 2)
    mean = torch.mean(q, dim=(2, 4))
    a, b, c, d = q[:, :, 0, :, 0], q[:, :, 0, :, 1], q[:, :, 1, :, 0], q[:, :, 1, :, 1]
    out["mean_2x2"] = {
        "((q00+q01)+q10)+q11": frac(mean, (((a + b) + c) + d) * 0.25),
        "(q00+q01)+(q10+q11)": frac(mean, ((a + b) + (c + d)) * 0.25),
        "((q00+q10)+q01)+q11": frac(mean, (((a + c) + b) + d) * 0.25),
        "(q00+q10)+(q01+q11)": frac(mean, ((a + c) + (b + d)) * 0.25),
    }
    sq = m * m
    total = torch.sum(sq, dim=0)
    out["sum_3"] = {
        "(0+1)+2": frac(total, (sq[0] + sq[1]) + sq[2]),
        "0+(1+2)": frac(total, sq[0] + (sq[1] + sq[2])),
        "(0+2)+1": frac(total, (sq[0] + sq[2]) + sq[1]),
    }
    for c in NUMERATORS:
        out[f"rdiv_{c}"] = {
            "reciprocal_times_c": frac(c / x, torch.reciprocal(x) * c),
            "true_division": frac(c / x, torch.full_like(x, c) / x),
        }
    out["reciprocal"] = {"true_division": frac(torch.reciprocal(x), torch.ones_like(x) / x)}
    return {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "torch": torch.__version__, **out}


def not_followed(report: dict) -> list:
    """The entries of a CUDA device's report in which the variant the kernels
    follow is not PyTorch's own (does not read 1.0)."""
    return [f"{key}: {variant} = {entry[variant]}"
            for prefix, variant in FOLLOWED.items()
            for key, entry in report.items() if key.startswith(prefix) and entry[variant] != 1.0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("torch_rounding: CUDA is not available (pass --device cpu)")
    print(json.dumps(measure(args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
