"""The port stands alone: no module of ``xslam_tpu_torch``, and not
``chip_smoke.py``, imports JAX, the JAX package or PIL, which the machine
with the card lacks (each module is imported in
a fresh interpreter, one after the other, and the modules it pulled in are
listed); and its measuring entry points need the card rather than fall back
to the CPU."""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import xslam_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
MODULES = sorted(
    ["xslam_tpu_torch"]
    + [m.name for m in pkgutil.walk_packages(xslam_tpu_torch.__path__, "xslam_tpu_torch.")]
    + ["chip_smoke"]
)
FORBIDDEN = ("jax", "jaxlib", "xslam_tpu", "PIL")

_PROBE = """
import importlib, json, sys
seen = set(sys.modules)
out = {}
for name in sys.argv[1:]:
    importlib.import_module(name)
    new = set(sys.modules) - seen
    out[name] = sorted(m for m in new if m.split(".")[0] in %r)
    seen |= new
print(json.dumps(out))
""" % (FORBIDDEN,)


@pytest.fixture(scope="module")
def imported():
    proc = subprocess.run([sys.executable, "-c", _PROBE, *MODULES], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_no_jax(imported, module):
    assert imported[module] == [], f"{module} pulled in {imported[module]}"


def test_every_port_module_is_probed():
    assert {"xslam_tpu_torch.ops.fusion_brick", "xslam_tpu_torch.ops.kernels", "xslam_tpu_torch.models.kinfu",
            "xslam_tpu_torch.ops.bricks", "xslam_tpu_torch.ops.raycast_bricks", "xslam_tpu_torch.profile_step",
            "xslam_tpu_torch.io.options", "xslam_tpu_torch.io.png", "xslam_tpu_torch.io.dataset",
            "xslam_tpu_torch.io.ply", "xslam_tpu_torch.ops.extract", "xslam_tpu_torch.utils.checkpoint",
            "xslam_tpu_torch.apps.make_realistic_dataset", "chip_smoke"} <= set(MODULES)


def test_profile_step_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: profile_step measures it")
    from xslam_tpu_torch import profile_step

    with pytest.raises(RuntimeError, match="CUDA"):
        profile_step.main([str(ROOT / "configs" / "synthetic.yaml")])
