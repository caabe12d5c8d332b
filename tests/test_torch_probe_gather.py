"""The gather probes of ``xslam_tpu_torch.apps.probe_gather`` against the
Pallas probes of ``apps/probe_pallas_gather.py``.

Each probe's plain version runs on the CPU on the original's inputs and must
equal, exactly (copies, short ordered float sums, integers): the Pallas
kernel run in interpret mode (``pl.pallas_call`` with ``interpret=True``,
patched in for the test; nothing in the JAX package changes), and the numpy
expression of what the probe computes. Probe E runs at a small table for
speed and once at 4 steps of the real one. On CPU tensors the wrappers run
the plain versions and launch nothing; the entry point exits 0 with
``--device cpu`` and raises without a card otherwise.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (one intra-op thread per test process)
from xslam_tpu_torch.apps import probe_gather as tp
from xslam_tpu_torch.ops import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_probes():
    """``apps/probe_pallas_gather.py`` loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_gather", os.path.join(ROOT, "apps", "probe_pallas_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpreted(jax_probes, monkeypatch):
    """The JAX probes with their Pallas calls in interpret mode."""
    monkeypatch.setattr(jax_probes.pl, "pallas_call", functools.partial(jax_probes.pl.pallas_call, interpret=True))
    return jax_probes


def _numpy_a():
    table = np.arange(4096 * 128, dtype=np.float32).reshape(4096, 128)
    idx = (np.arange(8 * 128, dtype=np.int32).reshape(8, 128) * 37) % 4096
    return np.take_along_axis(table, idx, axis=0)


def _numpy_b():
    table = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    idx = (np.arange(8 * 128, dtype=np.int32).reshape(8, 128) * 17) % 128
    return np.take_along_axis(table, idx, axis=1)


def _numpy_c():
    table = np.arange(64 * 128, dtype=np.float32).reshape(64, 128)
    acc = np.float32(0)
    for k in range(16):
        acc = np.float32(acc + table[7 + k, k])
    return acc.reshape(1, 1)


def _numpy_d():
    table = np.arange(256 * 128, dtype=np.float32).reshape(256, 128)
    out = np.zeros((8, 128), np.float32)
    for k in range(8):
        start = (k * 24) % 248
        out = out + table[start:start + 8]
    return out


def _numpy_e(n_rows, rays_sub, n_steps):
    table = (np.arange(n_rows * 128, dtype=np.int32) % 3).reshape(n_rows, 128)
    idx = (np.arange(rays_sub * 128, dtype=np.int32).reshape(rays_sub, 128) * 97) % n_rows
    for _ in range(n_steps):
        idx = (idx + np.take_along_axis(table, idx, axis=0) + 1) % n_rows
    return idx.astype(np.int32)


PROBES = {
    "a": (lambda: tp.probe_a(*tp.inputs_a(CPU)), lambda j: j.probe_a(), _numpy_a, np.float32, (8, 128)),
    "b": (lambda: tp.probe_b(*tp.inputs_b(CPU)), lambda j: j.probe_b(), _numpy_b, np.float32, (8, 128)),
    "c": (lambda: tp.probe_c(*tp.inputs_c(CPU)), lambda j: j.probe_c(), _numpy_c, np.float32, (1, 1)),
    "d": (lambda: tp.probe_d(*tp.inputs_d(CPU)), lambda j: j.probe_d(), _numpy_d, np.float32, (8, 128)),
}


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_against_pallas_interpret(interpreted, name):
    port, jax_probe, _, dtype, shape = PROBES[name]
    out = port().numpy()
    ref = np.asarray(jax_probe(interpreted))
    assert out.dtype == dtype and out.shape == shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_against_numpy(name):
    port, _, expected, _, _ = PROBES[name]
    np.testing.assert_array_equal(port().numpy(), expected())


@pytest.mark.parametrize(
    "n_rows,rays_sub,n_steps",
    [(256, 8, 4), (256, 8, 64), (tp.E_ROWS, tp.E_RAYS_SUB, 4)],
    ids=["small_4_steps", "small_64_steps", "real_table_4_steps"],
)
def test_probe_e_against_pallas_interpret_and_numpy(interpreted, n_rows, rays_sub, n_steps):
    table, idx0 = tp.inputs_e(CPU, n_rows, rays_sub)
    out = tp.probe_e(table, idx0, n_steps).numpy()
    assert out.dtype == np.int32 and out.shape == (rays_sub, 128)
    np.testing.assert_array_equal(out, _numpy_e(n_rows, rays_sub, n_steps))
    ref = interpreted.make_e(n_rows, rays_sub, n_steps)(jnp.asarray(table.numpy()), jnp.asarray(idx0.numpy()))
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_probe_inputs_are_the_originals():
    """The port builds its inputs on the device from ``torch.arange`` with
    the original's formulas."""
    table, idx0 = tp.inputs_e(CPU)
    assert tuple(table.shape) == (16384, 128) and table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), (np.arange(16384 * 128, dtype=np.int32) % 3).reshape(16384, 128))
    np.testing.assert_array_equal(
        idx0.numpy(), (np.arange(64 * 128, dtype=np.int32).reshape(64, 128) * 97) % 16384)
    table, idx = tp.inputs_a(CPU)
    assert table.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), (np.arange(8 * 128, dtype=np.int32).reshape(8, 128) * 37) % 4096)


def test_entry_point_on_cpu(capsys):
    before = dict(kernels.launch_counts)
    assert tp.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for tag in ("[A_row_gather] OK", "A correct: True", "[B_lane_gather] OK", "[C_scalar_read] OK",
                "[D_dyn_row_slice] OK", "[E_chained_gather_4_steps] OK", '"ns_per_gathered_elem"'):
        assert tag in out, out
    assert '"timed_on": "cpu"' in out  # a host time is never reported as the card's
    assert kernels.launch_counts == before  # plain versions only


def test_entry_point_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device selects it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.main([])


def test_wrappers_refuse_mixed_devices():
    table, idx = tp.inputs_a(CPU)
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        tp.probe_a(table, idx.to("meta"))
