"""host_wait_ms: device idle ms a traced frame in which the program had
blocked: the idle gaps whose label (timeline.py: the innermost host range,
then the innermost host operation) names one of the program's spans and a
copy or a synchronize, such as the camera's blocking uploads. Nothing is
read where no gap's label names a span of the program."""
from benchmark.timeline import FRAME_RANGE

WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "aten::copy_", "aten::_to_copy",
         "aten::to", "aten::_local_scalar_dense")


def is_wait(host: str) -> bool:
    return host.startswith("cudaMemcpy") or host in WAITS


def read(data):
    tl = data.timeline
    if tl is None:
        return None
    waits, spanned = 0.0, False
    for seconds, label in tl.gaps:
        span, _, host = label.rpartition(" > ")
        if not span or span == FRAME_RANGE:
            continue
        spanned = True
        if is_wait(host):
            waits += seconds
    return waits * 1e3 / tl.frames if spanned else None
