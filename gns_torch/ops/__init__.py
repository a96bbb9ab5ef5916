from gns_torch.ops.segment import (  # noqa: F401
    SegmentIndex,
    broadcast_col0_segment_sum,
    gather,
    segment_sum,
)
