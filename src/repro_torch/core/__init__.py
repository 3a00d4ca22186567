"""Core: the paper's reduced softmax unit (single-device part), the
hardware-softmax baselines and the approximate-attention catalog."""
from repro_torch.core import attn_approx, softmax_variants
from repro_torch.core.reduced_softmax import (
    argmax_with_value,
    fused_reduced_head,
    fused_reduced_topk,
    reduced_softmax_predict,
    reduced_topk,
    unit_op_counts,
)
from repro_torch.core.softmax_variants import (
    PREDICT_FNS,
    base2_softmax_unit,
    cordic_exp,
    inverse_softmax_unit,
    log_softmax_unit,
    predict_base2_softmax,
    predict_inverse_softmax,
    predict_log_softmax,
    predict_pseudo_softmax,
    predict_softmax,
    pseudo_softmax_unit,
    softmax_unit,
)
