"""Registers, spills and shared memory of every hand-written kernel.

Usage:
    python -m xslam_tpu_torch.apps.kernel_resources [--csrc DIR]

Compiles each ``csrc/*.cu`` (or the same file names under ``--csrc``, to
read another revision's kernels; plain C interface, a few seconds each, all
started together) with the flags of :mod:`xslam_tpu_torch.ops.kernels` plus
``-Xptxas -v`` into ``build/torch_kernels/resources/`` and prints one JSON
object: per kernel its registers per thread, static shared memory, stack
frame and spill bytes, as ``ptxas`` reports them, the global loads (``LDG``)
in its machine code as ``cuobjdump -sass`` lists them (instructions in the
code, not loads executed: a branch's loads count whether it runs or not),
and, for the block size given here, how many blocks and warps an SM of
65,536 registers holds by registers alone. Needs ``nvcc``; loads nothing
onto a card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from ..ops.kernels import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, SOURCES

# threads per block of each kernel (csrc/*.cu), for the occupancy by registers
BLOCK_THREADS = {
    "icp_system_kernel": 256, "icp_associate_kernel": 256, "fuse_kernel": 256, "bilateral_kernel": 256,
    "bilateral_weights_kernel": 256, "march_kernel": 256, "march_chain_kernel": 256, "refine_kernel": 64,
    "model_map_pyramid_kernel": 32, "depth_pyramid_kernel": 128, "vertex_normal_maps_kernel": 256,
    "depth_mips_kernel": 256, "classify_bricks_kernel": 256, "fuse_bricks_kernel": 128,
    "window_march_kernel": 128, "event_mask_kernel": 256, "skip_distance_kernel": 256,
    "march_skip_kernel": 128, "extract_count_kernel": 256, "extract_points_kernel": 256,
    "extract_normals_kernel": 256,
}
SM_REGISTERS = 65_536
SM_MAX_WARPS = 64


def function_name(demangled: str):
    """The function's own name, with its template arguments, out of a
    demangled signature such as ``void (anonymous namespace)::march_kernel<4,
    true>(float*, int)``; ``None`` where there is none."""
    m = re.search(r"(\w+)(<[^<>()]*>)?\(", demangled)
    return m.group(1) + (m.group(2) or "") if m else None


def _demangled(symbol: str) -> str:
    """The function's own name out of a mangled symbol, by the toolkit's
    ``cu++filt`` (or ``c++filt``); the symbol itself where neither runs."""
    for tool in ("cu++filt", "c++filt"):
        try:
            text = subprocess.run([tool, symbol], capture_output=True, text=True, timeout=30).stdout
        except (OSError, subprocess.SubprocessError):
            continue
        name = function_name(text)
        if name:
            return name
    return symbol


def parse_ptxas(text: str) -> dict:
    """``ptxas -v`` output -> {kernel: {registers, shared_bytes, stack_bytes,
    spill_store_bytes, spill_load_bytes}}."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = out.setdefault(_demangled(m.group(1)), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                           spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            current.update(registers=int(m.group(1)), shared_bytes=int(smem.group(1)) if smem else 0)
    return out


def parse_sass(text: str) -> dict:
    """``cuobjdump -sass`` output -> {kernel: number of global load
    instructions (LDG) in its code}."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = _demangled(m.group(1))
            out[current] = 0
        elif current is not None and re.search(r"\bLDG(\.|\s)", line):
            out[current] += 1
    return out


def global_loads(obj: Path) -> dict:
    """:func:`parse_sass` of an object file; empty where ``cuobjdump`` does not run."""
    try:
        proc = subprocess.run(["cuobjdump", "-sass", str(obj)], capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return {}
    return parse_sass(proc.stdout) if proc.returncode == 0 else {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=str(CSRC_DIR), help="directory of the .cu sources")
    args = ap.parse_args(argv)
    out_dir = BUILD_DIR / "resources"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = [src for src in SOURCES if src.endswith(".cu")]
    procs = [
        subprocess.Popen(
            ["nvcc", *NVCC_FLAGS, "-std=c++17", "-Xptxas", "-v", "-c", str(Path(args.csrc) / src),
             "-o", str(out_dir / (src + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sources
    ]
    report, failed = {}, []
    for src, proc in zip(sources, procs):
        text, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            failed.append(src)
            print(text, file=sys.stderr)
            continue
        kernels = parse_ptxas(text)
        for name, n in global_loads(out_dir / (src + ".o")).items():
            kernels.setdefault(name, {})["global_load_instructions"] = n
        for name, k in kernels.items():
            threads = BLOCK_THREADS.get(name.split("<")[0])
            if threads and k.get("registers"):
                # registers are granted to a warp in units of 256
                per_warp = -(-k["registers"] * 32 // 256) * 256
                warps = min(SM_MAX_WARPS, SM_REGISTERS // per_warp)
                k.update(block_threads=threads, blocks_per_sm_by_registers=warps // (threads // 32),
                         warps_per_sm_by_registers=warps // (threads // 32) * (threads // 32))
        report[src] = kernels
    print(json.dumps({"csrc": args.csrc, "flags": list(NVCC_FLAGS), "kernels": report}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
