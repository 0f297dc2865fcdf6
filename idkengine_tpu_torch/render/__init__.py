from .camera import Camera  # noqa: F401
from .pathtracer import PathTracer, PathTracerSettings  # noqa: F401
from .pipeline import (DeferredPipeline, DeferredSettings2, PathTracerPipeline,  # noqa: F401
                       PtPipelineSettings)
