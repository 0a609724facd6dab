"""chip_smoke.py's profiled window: the host-side span of the labelled
``record_function``, not the device annotation of the same name (which
spans only the window's device ops and may come first in the event list);
and the kernels of a profiled window counted by the wrapper that launches
each; a graphed step's counted launches are held to the kernels of the
whole profile, which holds that step alone.
"""

from pathlib import Path
from types import SimpleNamespace
import sys

from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval

from diffgfdn_torch.kernels import counted_wrappers

ROOT = Path(__file__).resolve().parents[1]


def test_profile_window_is_the_host_span_of_the_label():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    def event(name, start, end, device):
        return SimpleNamespace(name=name, time_range=Interval(start, end), device_type=device,
                               is_user_annotation=device == DeviceType.CUDA)

    events = [event("step", 40, 45, DeviceType.CUDA), event("other", 0, 200, DeviceType.CPU),
              event("step", 10, 90, DeviceType.CPU)]
    window = chip_smoke.profile_window(events, "step")
    assert (window.start, window.end) == (10, 90)
    assert chip_smoke.profile_window(events[::-1], "step").elapsed_us() == 80


def test_profile_window_takes_in_device_work_placed_before_the_host_span():
    """Device times converted to the host's clock can put a step's first
    kernels before the host span opens: the label's device annotation, which
    spans the step's device ops, widens the window, and those kernels count."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    def event(name, start, end, device, annotation):
        return SimpleNamespace(name=name, time_range=Interval(start, end), device_type=device,
                               is_user_annotation=annotation)

    events = [event("step", 10, 90, DeviceType.CPU, False),
              event("step", 6, 80, DeviceType.CUDA, True),
              event("cinv_kernel<4>", 6, 9, DeviceType.CUDA, False),
              event("lut_apply_kernel<4>", 40, 60, DeviceType.CUDA, False)]
    window = chip_smoke.profile_window(events, "step")
    assert (window.start, window.end) == (6, 90)
    assert chip_smoke.wrapper_launches(chip_smoke.device_kernels(events, window)) == {
        "cinv": 1, "lut_apply": 1}


def test_graphed_step_kernels_placed_before_the_window_count_in_the_whole_profile():
    """A replay's first kernels, placed on the host's clock before both the
    host span and the label's device annotation, fall outside the window;
    the whole profile, which holds only the profiled step, counts them."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    def event(name, start, end, device, annotation):
        return SimpleNamespace(name=name, time_range=Interval(start, end), device_type=device,
                               is_user_annotation=annotation)

    events = [event("step", 10, 90, DeviceType.CPU, False),
              event("step", 8, 80, DeviceType.CUDA, True),
              event("sos_cascade_kernel<11>", 2, 4, DeviceType.CUDA, False),
              event("lu_solve_kernel<4>", 5, 7, DeviceType.CUDA, False),
              event("Memset (Device)", 7, 8, DeviceType.CUDA, False),
              event("cinv_kernel<4>", 20, 30, DeviceType.CUDA, False),
              event("lut_apply_kernel<4>", 40, 60, DeviceType.CUDA, False)]
    window = chip_smoke.profile_window(events, "step")
    assert chip_smoke.wrapper_launches(chip_smoke.device_kernels(events, window)) == {
        "cinv": 1, "lut_apply": 1}
    assert chip_smoke.wrapper_launches(chip_smoke.device_kernels(events)) == {
        "cinv": 1, "sos": 1, "lu": 1, "lut_apply": 1}


def test_profiled_kernels_count_by_the_wrapper_that_launches_them():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    def kernel(name):
        return SimpleNamespace(name=f"void (anonymous namespace)::{name}(float2 const*)",
                               time_range=Interval(20, 30), device_type=DeviceType.CUDA,
                               is_user_annotation=False)

    names = ["cinv_kernel<4>", "cinv_kernel<4>", "neg_ptgpt_kernel<4>",
             "sos_cascade_kernel<11>", "sos_bwd_partial_kernel<11>", "sos_bwd_reduce_kernel",
             "lu_solve_kernel<9>", "lut_apply_kernel<9>", "tdgfdn_lines_kernel<27>",
             "at::native::vectorized_elementwise_kernel<4>"]
    events = [kernel(n) for n in names] + [
        SimpleNamespace(name="Memcpy HtoD", time_range=Interval(20, 25),
                        device_type=DeviceType.CUDA, is_user_annotation=False),
        SimpleNamespace(name="cinv_kernel<9>", time_range=Interval(95, 99),
                        device_type=DeviceType.CUDA, is_user_annotation=False)]
    kernels = chip_smoke.device_kernels(events, Interval(10, 90))
    assert len(kernels) == len(names)
    assert chip_smoke.wrapper_launches(kernels) == {
        "cinv": 2, "neg_ptgpt": 1, "sos": 1, "sos_backward": 1, "lu": 1, "lut_apply": 1,
        "tdgfdn": 1}
    assert set(chip_smoke.WRAPPER_SYMBOLS) == set(counted_wrappers())
