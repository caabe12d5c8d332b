"""The port's last modules against the JAX package's on the CPU: the engine's
two PLY exports, ``Timer``, ``state_health`` / ``assert_state_sane``, the
``view_cloud`` app, and ``load_state``'s default device.

- Exports: a state carried across by ``utils/convert.py`` (the port's maps
  of a rendered frame at three levels, NaN where invalid) written by both
  engines.
  ``export_model_maps_ply`` gives the same points and normals bit for bit
  (tolerance 0) at levels 0 and 1. ``export_current_maps_ply`` runs the
  bilateral filter first, held to JAX's within 1 mm on more than 99.9% equal
  pixels (``tests/test_torch_preprocess.py``): the same valid pixels, the
  points within 1e-3 m (a millimetre of depth) plus 1e-5 of their size (the
  text's six digits) and more than 99% of the rows equal, at levels 0 and 1.
- ``state_health`` equals JAX's (names, shapes, NaN and infinity shares,
  finite min and max, tolerance 0) on the dense and the brick layout with
  injected NaN and infinities, and on a dict; ``assert_state_sane`` raises on
  a NaN in ``.volume.value`` and not on the model maps' NaN.
- ``Timer`` keeps JAX's contract: a lap waits on its ``sync`` argument and
  counts the time since ``reset``, and ``total`` sums the laps.
- ``view_cloud`` renders the same pixels as ``apps/view_cloud.py``.
- ``load_state`` without a device asks for the card, and raises without CUDA.
"""

import importlib.util
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.test_torch_checkpoint import _jax_state
from tests.torch_port_helpers import torch_config
from xslam_tpu.io.ply import read_ply
from xslam_tpu.models.kinfu import XSlamEngine as JaxEngine
from xslam_tpu.ops import bricks as jbricks
from xslam_tpu.utils import debug as jdebug
from xslam_tpu.utils.timers import Timer as JaxTimer
from xslam_tpu_torch.models.kinfu import XSlamEngine as TorchEngine
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.utils import Timer, checkpoint, timers
from xslam_tpu_torch.utils import debug as tdebug
from xslam_tpu_torch.utils.convert import state_from_numpy

ROOT = Path(__file__).resolve().parents[1]
POINT_TOL_M = 1e-3  # a millimetre of depth, the bilateral filter's tolerance (tests/test_torch_preprocess.py)
TEXT_RTOL = 1e-5  # the PLY's six significant digits, each value within 5e-6 of itself


@pytest.fixture(scope="module")
def setup():
    """The engines of the small config and a state dict whose model maps are
    a rendered frame's camera-space maps at three levels."""
    cfg = small_config()
    ds = small_dataset(3)
    tcfg = torch_config(cfg)
    depths = kernels.depth_pyramid(kernels.bilateral_filter(torch.from_numpy(ds.get_depth(1))), 3)
    vmaps, nmaps = kernels.vertex_normal_pyramid([tcfg.intrinsics.level(i) for i in range(3)], depths)
    vm, nm = [v.numpy() for v in vmaps], [n.numpy() for n in nmaps]
    rng = np.random.default_rng(24)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    state = {
        "value": f(64, 64, 64), "grad": f(64, 64, 64), "weight": np.abs(f(64, 64, 64)),
        "world2camera_v": f(4, 4), "world2camera_g": f(4, 4),
        "vmaps_v": vm, "vmaps_g": [f(*m.shape) for m in vm], "nmaps_v": nm, "nmaps_g": [f(*m.shape) for m in nm],
        "frame_idx": 2, "last_align_ok": True, "t_prev": f(120, 160),
    }
    return JaxEngine(cfg), TorchEngine(tcfg, device="cpu"), state, ds.get_depth(2)


@pytest.mark.parametrize("level", [0, 1])
def test_model_maps_export_is_jax(setup, tmp_path, level):
    jeng, teng, d, _ = setup
    jeng.export_model_maps_ply(_jax_state(d), str(tmp_path / "jax.ply"), level)
    teng.export_model_maps_ply(state_from_numpy(d, "cpu"), str(tmp_path / "port.ply"), level)
    (jp, jn), (tp, tn) = read_ply(str(tmp_path / "jax.ply")), read_ply(str(tmp_path / "port.ply"))
    valid = ~np.isnan(d["vmaps_v"][level][0]) & ~np.isnan(d["nmaps_v"][level][0])
    assert len(tp) == int(valid.sum()) > 100
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tn, jn)


@pytest.mark.parametrize("level", [0, 1])
def test_current_maps_export_is_jax(setup, tmp_path, level):
    jeng, teng, _, depth = setup
    jeng.export_current_maps_ply(depth, str(tmp_path / "jax.ply"), level)
    teng.export_current_maps_ply(depth, str(tmp_path / "port.ply"), level)
    (jp, jn), (tp, tn) = read_ply(str(tmp_path / "jax.ply")), read_ply(str(tmp_path / "port.ply"))
    assert len(tp) == len(jp) > 100
    np.testing.assert_allclose(tp, jp, rtol=TEXT_RTOL, atol=POINT_TOL_M)
    rows_equal = np.mean(np.all((tp == jp) & (tn == jn), axis=1))
    assert rows_equal > 0.99
    # a uint16 tensor on the engine's device is taken as it is
    teng.export_current_maps_ply(torch.from_numpy(depth), str(tmp_path / "tensor.ply"), level)
    assert (tmp_path / "tensor.ply").read_text() == (tmp_path / "port.ply").read_text()
    with pytest.raises(ValueError, match="uint16"):
        teng.export_current_maps_ply(torch.from_numpy(depth.astype(np.int32)), str(tmp_path / "x.ply"), level)


def _injected(d: dict, layout: str) -> dict:
    d = {k: ([x.copy() for x in v] if isinstance(v, list) else np.copy(v)) for k, v in d.items()}
    if layout == "brick":
        rows = jbricks.from_dense(jnp.asarray(d["value"]), jnp.asarray(d["grad"]), jnp.asarray(d["weight"]))
        d["value"], d["grad"], d["weight"] = (np.array(x) for x in rows)
    d["grad"].reshape(-1)[:5] = [np.inf, -np.inf, np.nan, np.inf, 1e30]
    d["t_prev"][:2, :3] = np.inf
    d["world2camera_g"][0, 0] = np.nan
    return d


def _same_health(t: dict, j: dict):
    assert list(t) == list(j)
    for name in j:
        assert t[name] == j[name], name


@pytest.mark.parametrize("layout", ["dense", "brick"])
def test_state_health_is_jax(setup, layout):
    _, _, d, _ = setup
    d = _injected(d, layout)
    j = jdebug.state_health(_jax_state(d))
    t = tdebug.state_health(state_from_numpy(d, "cpu"))
    _same_health(t, j)
    assert {".volume.value", ".volume.grad", ".vmaps_prev[2].g", ".t_prev", ".world2camera.g"} <= set(t)
    assert ".frame_idx" not in t and ".last_align_ok" not in t  # only floating leaves
    assert t[".volume.grad"]["inf_frac"] > 0 and t[".volume.grad"]["nan_frac"] > 0
    assert t[".volume.grad"]["max"] == np.float32(1e30)


def test_state_health_of_a_dict_is_jax():
    """tests/test_datasets.py's case, and a nest of a list in a dict."""
    tree = {"b": np.ones(3, np.float32), "a": np.array([1.0, np.nan], np.float32),
            "c": [np.full(4, np.inf, np.float32), np.arange(3)]}
    j = jdebug.state_health({k: ([jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v))
                             for k, v in tree.items()})
    t = tdebug.state_health({k: ([torch.from_numpy(x) for x in v] if isinstance(v, list) else torch.from_numpy(v))
                             for k, v in tree.items()})
    _same_health(t, j)
    assert t["['a']"]["nan_frac"] == 0.5 and t["['c'][0]"]["min"] is None and "['c'][1]" not in t


def test_assert_state_sane(setup):
    _, _, d, _ = setup
    state = state_from_numpy(d, "cpu")
    assert bool(torch.isnan(state.nmaps_prev[0].v).any())
    tdebug.assert_state_sane(state)  # the model maps' NaN are allowed
    state.volume.value[3, 4, 5] = torch.nan
    with pytest.raises(AssertionError, match=r"\.volume\.value"):
        tdebug.assert_state_sane(state)
    with pytest.raises(AssertionError, match=r"\.volume\.value"):
        jdebug.assert_state_sane(_jax_state({**d, "value": state.volume.value.numpy()}))


def test_timer_keeps_jax_contract():
    for timer, ready in ((JaxTimer(), jnp.ones(4)), (Timer(), {"a": (torch.ones(4), [torch.zeros(2)])})):
        time.sleep(0.01)
        first = timer.lap_ms(sync=ready)
        assert first >= 10.0 and timer.total == first
        second = timer.lap_ms()
        assert second >= first and timer.total == first + second  # laps count from the last reset
        timer.reset()
        assert timer.lap_ms() < first
    assert timers.block_until_ready(ready) is ready


def _jax_view_cloud():
    spec = importlib.util.spec_from_file_location("jax_view_cloud", ROOT / "apps" / "view_cloud.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_view_cloud_renders_jax_pixels(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    import matplotlib.image as mpimg

    from xslam_tpu_torch.apps import view_cloud
    from xslam_tpu_torch.io.ply import export_ply

    rng = np.random.default_rng(3)
    points = rng.standard_normal((400, 3)).astype(np.float32)
    normals = points / np.linalg.norm(points, axis=1, keepdims=True)
    src = str(tmp_path / "cloud.ply")
    export_ply(src, points, normals)
    monkeypatch.setattr(sys, "argv", ["view_cloud.py", src, str(tmp_path / "jax.png")])
    _jax_view_cloud().main()
    assert view_cloud.main([src, str(tmp_path / "port.png")]) == 0
    jax_png, port_png = mpimg.imread(str(tmp_path / "jax.png")), mpimg.imread(str(tmp_path / "port.png"))
    assert port_png.shape == jax_png.shape and port_png.shape[1] > port_png.shape[0] > 100
    np.testing.assert_array_equal(port_png, jax_png)


def test_load_state_defaults_to_the_card(setup, tmp_path, monkeypatch):
    _, _, d, _ = setup
    path = str(tmp_path / "c.npz")
    checkpoint.save_state(path, state_from_numpy(d, "cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.load_state(path)
    state, _ = checkpoint.load_state(path, device="cpu")
    assert state.volume.value.device.type == "cpu"
