"""The profiled-frame check of ``chip_smoke.py`` on made-up profiler records
(the smoke itself needs the card): a record whose device events fall short
of the host's launch calls is retaken on the next frame, at most twice, and
the checks on the record it keeps stay as strict: a frame whose own launch
count is wrong, or with other device work between its ICP launches, fails
without a retake."""

import pytest

import chip_smoke

ITERATIONS = 12


def _record(launches: int, device: int = None, interloper: bool = False) -> dict:
    """A frame of ``launches`` host launch calls whose profiler kept
    ``device`` of them (all by default): 3 preprocess launches, the 12 ICP
    launches together, the rest after them."""
    names = ["bilateral_kernel", "depth_pyramid_kernel", "vertex_normal_maps_kernel"]
    names += ["icp_system_kernel"] * ITERATIONS
    if interloper:
        names.insert(5, "elementwise_kernel")
    names += ["elementwise_kernel"] * (launches - len(names))
    names = names[: launches if device is None else device]
    return dict(names=names, icp_at=[j for j, n in enumerate(names) if n == "icp_system_kernel"],
                host_calls=launches, stages={"preprocess": 3.0, "icp": 96.0})


@pytest.mark.parametrize("first, retaken, attempts, fails", [
    (_record(658), [], 1, None),  # consistent: no retake
    (_record(658, device=657), [_record(658)], 2, None),  # one event lost: retaken, then held
    (_record(658, device=657), [_record(658, device=640), _record(658)], 3, None),
    (_record(658, device=657), [_record(658, device=657), _record(658, device=657)], 3, "consistent record"),
    (_record(659), [], 1, "659 launches"),  # the frame's own count is wrong: no retake
    (_record(658, device=657), [_record(659)], 2, "659 launches"),
    (_record(658, interloper=True), [], 1, "other device work"),
])
def test_profiled_frame_record(first, retaken, attempts, fails):
    queue = list(retaken)
    rec, seen = chip_smoke.consistent_record(first, lambda: queue.pop(0))
    assert len(seen) == attempts and not queue
    assert seen[0] == dict(device_launches=len(first["names"]), host_launch_calls=first["host_calls"])
    if fails is None:
        chip_smoke.check_frame_record(rec, seen, ITERATIONS, 658)
    else:
        with pytest.raises(AssertionError, match=fails):
            chip_smoke.check_frame_record(rec, seen, ITERATIONS, 658)


def test_no_icp_event_is_a_garbled_record():
    """The profiler once kept no ICP event of a brick frame: the device count
    then falls short of the host's, and the frame is retaken."""
    lost = _record(660)
    lost["names"] = [n for n in lost["names"] if n != "icp_system_kernel"]
    lost["icp_at"] = []
    rec, seen = chip_smoke.consistent_record(lost, lambda: _record(660))
    assert len(seen) == 2
    chip_smoke.check_frame_record(rec, seen, ITERATIONS, 660)
