"""chip_smoke.py's profiled window: the host-side span of the labelled
``record_function``, not the device annotation of the same name (which
spans only the window's device ops and may come first in the event list).
"""

from pathlib import Path
from types import SimpleNamespace
import sys

from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval

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
