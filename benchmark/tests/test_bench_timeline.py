"""The trace reduction on a hand-made timeline: ranges by launch, busy
time, idle gaps and their labels, the breakdown, the per-layer readers."""
from types import SimpleNamespace

from benchmark import timeline
from benchmark.metrics import (device_idle_pct, launches_per_frame, pt_glue_ms, pt_textures_ms,
                               trace_ms)

CPU, CUDA = "cpu", "cuda"


def ev(name, s, e, dev=CPU, id=0, ann=False):
    return SimpleNamespace(name=name, device_type=dev, id=id, is_user_annotation=ann,
                           time_range=SimpleNamespace(start=s, end=e))


def events():
    return [
        ev(timeline.FRAME_RANGE, 0, 1000, ann=True),
        ev("pt/textures", 100, 300, ann=True),
        ev("aten::mul", 110, 120), ev("cudaLaunchKernel", 112, 115, id=1),
        ev("pt_closest_pri", 400, 500, ann=True),
        ev("cudaLaunchKernel", 410, 415, id=2),
        ev("aten::item", 600, 900),
        ev("void mul_kernel", 200, 400, CUDA, id=1),
        ev("void trace_kernel<false>", 500, 700, CUDA, id=2),
        ev("pt_closest_pri", 500, 700, CUDA, id=3),  # a range's device span
    ]


def test_timeline():
    tl = timeline.build(events(), CPU, CUDA)
    assert [op.name for op in tl.ops] == ["void mul_kernel", "void trace_kernel<false>"]
    assert tl.ops[0].ranges == {timeline.FRAME_RANGE, "pt/textures"}
    assert tl.ops[1].ranges == {timeline.FRAME_RANGE, "pt_closest_pri"}
    assert tl.frames == 1 and tl.window_s == 1000e-6 and abs(tl.busy_s - 400e-6) < 1e-12
    gaps = sorted(tl.gaps)
    assert [round(g[0] * 1e6) for g in gaps] == [100, 200, 300]
    labels = dict((round(s * 1e6), lab) for s, lab in tl.gaps)
    assert labels[300] == f"{timeline.FRAME_RANGE} > aten::item"
    assert labels[200] == "pt/textures > python"
    b = tl.breakdown()
    assert b["device_ops"][0] == ["void mul_kernel", 200e-6]
    # ten untraced frames of 1 ms in the window
    data = SimpleNamespace(timeline=tl, hand_kernels=("trace_kernel",), frames=10, window_s=0.01)
    assert trace_ms.read(data) == 0.2
    assert pt_textures_ms.read(data) == 0.2
    assert pt_glue_ms.read(data) is None  # every operation is traversal or textures
    # busy 0.4 ms a traced frame, over the untraced frame's 1 ms
    assert abs(device_idle_pct.read(data) - 60.0) < 1e-9
    data.window_s = 0.02
    assert abs(device_idle_pct.read(data) - 80.0) < 1e-9
    assert launches_per_frame.read(data) == 2
