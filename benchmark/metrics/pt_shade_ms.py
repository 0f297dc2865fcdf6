"""pt_shade_ms: device ms a traced frame of the path tracer's shading: the
operations launched inside its span pt/shade (render/pathtracer.py: the
attribute gather, the normals, the material, the BSDF sample, the
throughput, roulette), less those inside the texture and alpha ranges and
the hand trace kernels."""
from benchmark.metrics.pt_textures_ms import TEXTURE_RANGES
from benchmark.metrics.trace_ms import hand


def read(data):
    tl = data.timeline
    if tl is None:
        return None
    ops = [op for op in tl.ops if "pt/shade" in op.ranges and not op.ranges & TEXTURE_RANGES
           and not hand(op, data.hand_kernels)]
    return sum(op.ms for op in ops) / tl.frames if ops else None
