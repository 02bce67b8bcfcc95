"""Serving (port of future_od_tpu/serve): the per-frame feature cache
(`StreamingSession`), the multi-stream micro-batching server
(`MultiStreamServer`) and the export of sealed serving programs."""
from future_od_tpu_torch.serve.export import (
    export_inference,
    export_serving,
    export_streaming,
    load_serving,
)
from future_od_tpu_torch.serve.server import MultiStreamServer
from future_od_tpu_torch.serve.streaming import StreamingSession, make_streaming_fns

__all__ = [
    "make_streaming_fns",
    "StreamingSession",
    "MultiStreamServer",
    "export_serving",
    "export_inference",
    "export_streaming",
    "load_serving",
]
