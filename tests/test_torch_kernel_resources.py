"""The reader of ``ptxas -v`` output in
``xslam_tpu_torch.apps.kernel_resources`` (the compiler itself runs only on
the machine with the card): registers, shared memory, stack and spills per
kernel, from the text ``nvcc -Xptxas -v`` prints. And
``xslam_tpu_torch.apps.torch_rounding`` on the CPU, where PyTorch divides
truly, and the reader of a smoke run's output in
``xslam_tpu_torch.apps.compare_trees``."""

import pytest

from xslam_tpu_torch.apps.kernel_resources import BLOCK_THREADS, function_name, parse_ptxas, parse_sass
from xslam_tpu_torch.ops.kernels import CSRC_DIR, HEADERS, SOURCES

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function 'fuse_kernel' for 'sm_90a'
ptxas info    : Function properties for fuse_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function 'icp_system_kernel' for 'sm_90a'
ptxas info    : Function properties for icp_system_kernel
    184 bytes stack frame, 208 bytes spill stores, 300 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 184 bytes cumulative stack size, 36729 bytes smem
ptxas info    : Compiling entry function 'model_map_pyramid_kernel<true>' for 'sm_90a'
ptxas info    : Function properties for model_map_pyramid_kernel<true>
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 496 bytes cmem[0]
"""


def test_parse_ptxas_reads_registers_and_spills():
    out = parse_ptxas(PTXAS)
    assert out["fuse_kernel"] == dict(stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0, registers=64,
                                      shared_bytes=0)
    assert out["icp_system_kernel"] == dict(stack_bytes=184, spill_store_bytes=208, spill_load_bytes=300,
                                            registers=48, shared_bytes=36729)
    assert out["model_map_pyramid_kernel<true>"] == dict(stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0,
                                                         registers=64, shared_bytes=0)
    assert BLOCK_THREADS["model_map_pyramid_kernel<true>".split("<")[0]] == 32


def test_parse_ptxas_of_nothing_is_empty():
    assert parse_ptxas("nvcc warning : nothing here\n") == {}


@pytest.mark.parametrize("demangled, name", [
    ("(anonymous namespace)::fuse_kernel(float*, float*, int)", "fuse_kernel"),
    ("void (anonymous namespace)::march_kernel<4, true>((anonymous namespace)::Volume, float const*, int)",
     "march_kernel<4, true>"),
    ("void (anonymous namespace)::bilateral_kernel<false>(unsigned short const*, float*, int, int, int, int)",
     "bilateral_kernel<false>"),
    ("_Z4nope", None),
])
def test_function_name_of_a_demangled_signature(demangled, name):
    assert function_name(demangled) == name


def test_every_source_is_present_and_every_kernel_has_its_block_size():
    """The sources the build and the resource report compile exist, with the
    headers they include, and each ``__global__`` function in them has its
    block size in the report's table."""
    import re

    for src in SOURCES + HEADERS:
        assert (CSRC_DIR / src).is_file(), src
    text = "".join((CSRC_DIR / src).read_text() for src in SOURCES if src.endswith(".cu"))
    for header in HEADERS:
        assert f'#include "{header}"' in text or any(
            f'#include "{header}"' in (CSRC_DIR / h).read_text() for h in HEADERS), header
    kernels = set(re.findall(r"\b(\w+_kernel)\s*\(", text))
    main_path = {k for k in kernels if not k.startswith("probe")}
    assert main_path and main_path <= set(BLOCK_THREADS), main_path - set(BLOCK_THREADS)


def test_block_threads_covers_every_global_function():
    """Every ``__global__`` function of the sources, whatever its name, has its
    block size in the report's table (the probes' kernels aside)."""
    import re

    text = "".join((CSRC_DIR / src).read_text() for src in SOURCES if src.endswith(".cu"))
    declared = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^()]*\)\s*)?(\w+)\s*\(", text))
    assert {"refine_kernel", "vertex_normal_maps_kernel", "march_kernel", "icp_system_kernel"} <= declared
    assert len(declared) == text.count("__global__")
    main_path = {k for k in declared if not k.startswith("probe")}
    assert main_path <= set(BLOCK_THREADS), main_path - set(BLOCK_THREADS)


SASS = """\
\tcode for sm_90a
\t\tFunction : refine_kernel
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0090*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*00a0*/                   LDG.E R5, desc[UR4][R6.64] ;
        /*00b0*/                   LDS R8, [R9] ;
        /*00c0*/                   STG.E desc[UR4][R2.64], R5 ;
\t\tFunction : pyr_down_kernel
        /*0010*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
\t\tFunction : bilateral_weights_kernel
        /*0010*/                   STG.E desc[UR4][R2.64], R5 ;
"""


def test_parse_sass_counts_global_loads():
    assert parse_sass(SASS) == {"refine_kernel": 2, "pyr_down_kernel": 1, "bilateral_weights_kernel": 0}
    assert parse_sass("") == {}


def test_torch_rounding_on_the_cpu():
    """On the CPU ``x / c`` is the true division and the 2x2 mean and the sum
    of three match one of the listed orders; the factor the kernels use on the
    card is the double reciprocal rounded once."""
    import numpy as np

    from xslam_tpu_torch.apps.torch_rounding import DIVISORS, measure, not_followed
    from xslam_tpu_torch.ops.kernels import reciprocal_f32

    out = measure("cpu")
    assert out["device"] == "cpu"
    for c in DIVISORS:
        assert out[f"div_{c}"]["true_division"] == 1.0
        assert reciprocal_f32(c) == float(np.float32(1.0 / c))
    assert max(out["mean_2x2"].values()) == 1.0
    assert max(out["sum_3"].values()) == 1.0
    # the CPU divides truly, so the card's variant is reported as not followed here; a report in
    # which every followed variant reads 1.0 passes
    assert any(line.startswith("div_") for line in not_followed(out))
    card = {f"div_{c}": {"reciprocal_in_double": 1.0} for c in DIVISORS}
    card.update(mean_2x2={"(q00+q10)+(q01+q11)": 1.0}, sum_3={"(0+1)+2": 1.0})
    assert not_followed(card) == []


def test_compare_trees_reads_a_smoke_runs_output(tmp_path):
    import json

    from xslam_tpu_torch.apps.compare_trees import COMMANDS, smoke_summary

    lines = [
        "card: NVIDIA H100 80GB HBM3, 700.00 W",
        json.dumps({"phase": "build", "seconds": 41.5}),
        json.dumps({"phase": "main path", "mean_frame_ms": 12.5, "p50_frame_ms": 12.4, "ate_m": 0.00124,
                    "peak_mem_bytes": 3, "device_launches_in_profiled_frame": 662, "frames": 10}),
        json.dumps({"phase": "main path, fixed association", "mean_frame_ms": 15.0, "ate_m": 0.00123}),
        json.dumps({"kernels": [{"name": "march_fixed", "ms": 0.0585}, {"name": "pyr_down", "ms": 0.0038}]}),
        json.dumps({"ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}),
    ]
    path = tmp_path / "smoke.txt"
    path.write_text("\n".join(lines) + "\n")
    out = smoke_summary(path)
    assert out["build_seconds"] == 41.5
    assert out["kernel_ms"] == {"march_fixed": 0.0585, "pyr_down": 0.0038}
    assert out["main path"] == dict(mean_frame_ms=12.5, p50_frame_ms=12.4, ate_m=0.00124, peak_mem_bytes=3,
                                    device_launches_in_profiled_frame=662)
    assert out["main path, fixed association"] == dict(mean_frame_ms=15.0, ate_m=0.00123)
    assert COMMANDS["smoke"] == ["chip_smoke.py"]


def test_stage_launches_counts_the_calls_inside_each_range():
    """``profile_step.stage_launches``, which ``chip_smoke.py`` asserts on: a
    launch, copy or fill call counts for the stage whose range it starts in,
    averaged over the frames; calls outside every range and device events
    count nowhere."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from xslam_tpu_torch.profile_step import stage_launches

    def event(name, start, end, device=DeviceType.CPU):
        return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(start=start, end=end))

    events = [
        event("preprocess", 0, 10), event("cudaLaunchKernel", 1, 2), event("cudaMemcpyAsync", 3, 4),
        event("bilateral_kernel", 1, 2, DeviceType.CUDA), event("cudaLaunchKernel", 15, 16),
        event("icp", 20, 30), event("cudaLaunchKernel", 21, 22), event("aten::add", 23, 24),
        event("preprocess", 40, 50), event("cudaMemsetAsync", 41, 42),
    ]
    assert stage_launches(events, 2) == {"preprocess": 1.5, "icp": 0.5}


@pytest.mark.parametrize("flags, want", [
    ([], ("brick", 1234, "flag")),
    (["--fusion-mode", "dense"], ("dense", 1234, "flag")),
    (["--fusion-brick-cap", "2816", "--fusion-overflow", "dense"], ("brick", 2816, "dense")),
])
def test_profile_step_keeps_the_files_fusion_settings(flags, want):
    """``profile_step`` profiles a file's brick settings as the file states
    them; only the options given on the command line change."""
    from xslam_tpu_torch.io.config import SlamConfig
    from xslam_tpu_torch.io.options import set_options
    from xslam_tpu_torch.profile_step import parser

    config = SlamConfig(fusion_mode="brick", fusion_brick_cap=1234, fusion_overflow="flag")
    set_options(config, parser().parse_args(["configs/synthetic.yaml", *flags]))
    assert (config.fusion_mode, config.fusion_brick_cap, config.fusion_overflow) == want
    assert (config.icp_fixed_assoc, config.model_map_level) == (SlamConfig().icp_fixed_assoc,
                                                                 SlamConfig().model_map_level)


def test_compare_trees_profiles_benchs_brick_fusion():
    from xslam_tpu_torch.apps.compare_trees import COMMANDS

    assert COMMANDS["profile_brick"][-6:] == ["--fusion-mode", "brick", "--fusion-brick-cap", "2816",
                                              "--fusion-overflow", "dense"]


def test_frame_turns_alternate_and_summarise():
    """``apps/frame_turns``: the trees take turns parent, change, change,
    parent, as many of each; the summary's quartiles are numpy's."""
    from xslam_tpu_torch.apps.frame_turns import summary, turn_order

    order = turn_order(3)
    assert order == ["parent", "change", "change", "parent", "parent", "change"]
    assert order.count("parent") == order.count("change") == 3
    out = summary([10.0, 14.0, 11.0, 12.0, 13.0])
    assert out == dict(turns=5, median_ms=12.0, q1_ms=11.0, q3_ms=13.0, min_ms=10.0, max_ms=14.0)


def test_profile_step_names_each_hand_kernel_once():
    """profile_step's hand-kernel times take each device event by its own
    function name: K3's march_kernel is not B4's window_march_kernel, K2's
    fuse_kernel not B3c's fuse_bricks_kernel<true>, K6's instantiation with
    the screen normals not its own, and B5a's two kernels add up."""
    from xslam_tpu_torch.profile_step import hand_kernel_ms

    by_name = {
        "(anonymous namespace)::window_march_kernel(float const*, float const*, float const*)": [0.5, 1],
        "(anonymous namespace)::march_kernel((anonymous namespace)::Volume, float const*, float*)": [0.25, 1],
        "void (anonymous namespace)::fuse_bricks_kernel<true>(float*, float*, float*)": [0.125, 1],
        "(anonymous namespace)::event_mask_kernel(float const*, float const*, unsigned char*, int)": [1.0, 1],
        "(anonymous namespace)::skip_distance_kernel(unsigned char const*, int*, int, int, int)": [2.0, 1],
        "void (anonymous namespace)::model_map_pyramid_kernel<true, false>((anonymous namespace)::ModelPyramid)":
            [16.0, 1],
        "void (anonymous namespace)::model_map_pyramid_kernel<false, true>((anonymous namespace)::ModelPyramid)":
            [32.0, 1],
        "void at::native::vectorized_elementwise_kernel<4>(int)": [8.0, 3],
    }
    ms = hand_kernel_ms(by_name)
    assert ms["window_march"] == 0.5 and ms["march_fixed"] == 0.25
    assert ms["fuse_bricks"] == 0.125 and ms["fuse_volume"] == 0.0
    assert ms["skip_field"] == 3.0 and ms["march_skip"] == 0.0
    assert ms["resize_model_maps"] == 16.0 and ms["model_map_normals"] == 32.0  # K6 alone; K6 with B4n
    assert sum(ms.values()) == 51.875


def test_compare_trees_profiles_the_forced_refresh(monkeypatch):
    """``apps/compare_trees``' refresh profile runs ``profile_step`` in
    bench.py's configuration with ``raycast_temporal_min_coverage`` 2 (every
    frame takes the refresh), set over the options so that a tree whose
    ``profile_step`` has no option for it runs it too."""
    import sys

    from xslam_tpu_torch import profile_step
    from xslam_tpu_torch.apps.compare_trees import COMMANDS, REFRESH
    from xslam_tpu_torch.io.config import load_config
    from xslam_tpu_torch.io.options import BENCH_ARGS

    assert COMMANDS["profile_refresh"] == ["-c", REFRESH, "configs/synthetic.yaml", *BENCH_ARGS]
    seen = {}

    def main(argv):  # profile_step.main up to the configuration it profiles
        config = load_config(argv[0])
        profile_step.set_options(config, profile_step.parser().parse_args(argv))
        seen["config"] = config

    monkeypatch.setattr(profile_step, "main", main)
    monkeypatch.setattr(profile_step, "set_options", profile_step.set_options)  # the command replaces it
    monkeypatch.setattr(sys, "argv", ["-c", *COMMANDS["profile_refresh"][2:]])
    exec(REFRESH, {})
    config = seen["config"]
    assert config.raycast_temporal_min_coverage == 2.0
    assert (config.volume_layout, config.raycast_march, config.model_map_level) == ("brick", "temporal", 1)
