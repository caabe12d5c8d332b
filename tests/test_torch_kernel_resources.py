"""The reader of ``ptxas -v`` output in
``xslam_tpu_torch.apps.kernel_resources`` (the compiler itself runs only on
the machine with the card): registers, shared memory, stack and spills per
kernel, from the text ``nvcc -Xptxas -v`` prints."""

from xslam_tpu_torch.apps.kernel_resources import parse_ptxas

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
"""


def test_parse_ptxas_reads_registers_and_spills():
    out = parse_ptxas(PTXAS)
    assert out["fuse_kernel"] == dict(stack_bytes=0, spill_store_bytes=0, spill_load_bytes=0, registers=64,
                                      shared_bytes=0)
    assert out["icp_system_kernel"] == dict(stack_bytes=184, spill_store_bytes=208, spill_load_bytes=300,
                                            registers=48, shared_bytes=36729)


def test_parse_ptxas_of_nothing_is_empty():
    assert parse_ptxas("nvcc warning : nothing here\n") == {}
