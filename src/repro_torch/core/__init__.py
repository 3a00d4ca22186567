"""Core: the paper's reduced softmax unit (single-device part)."""
from repro_torch.core.reduced_softmax import (
    argmax_with_value,
    fused_reduced_head,
    fused_reduced_topk,
    reduced_softmax_predict,
    reduced_topk,
    unit_op_counts,
)
