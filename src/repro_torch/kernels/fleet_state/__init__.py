"""fleet_state: the trace segment lookup (CUDA kernel, plain PyTorch version,
and the public op the trace layer calls)."""
from repro_torch.kernels.fleet_state.kernel import (
    pack_queries,
    segment_index_cuda,
    segment_index_lookup,
)
from repro_torch.kernels.fleet_state.ops import (
    SegmentTable,
    fleet_state_at,
    segment_index,
    upload_segments,
)
from repro_torch.kernels.fleet_state.ref import segment_index_ref

__all__ = ["segment_index_cuda", "segment_index_lookup", "segment_index_ref",
           "segment_index", "fleet_state_at", "upload_segments", "SegmentTable",
           "pack_queries"]
