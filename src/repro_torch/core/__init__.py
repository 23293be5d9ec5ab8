"""LAMP core: numerics, selection rules, mixed-precision products, attention."""

from .numerics import (
    round_to_mantissa,
    round_to_mantissa_stochastic,
    quantize_ps,
    unit_roundoff,
    effective_mantissa_bits,
    PS_FORMATS,
    mu_of,
)
from .lamp import (
    masked_softmax,
    select_softmax_strict,
    select_softmax_relaxed,
    select_softmax_relaxed_ln,
    select_rmsnorm,
    select_activation,
    kappa_c_rmsnorm,
    kappa_1_softmax,
    kappa_c_softmax,
    recompute_rate,
)
from .mixed_matmul import dot_ps, matmul_lamp, lamp_matmul_softmax, dot_ps_error_bound
from .attention import (
    attention_reference,
    attention_lamp,
    chunked_attention,
    chunked_attention_lamp,
    decode_attention_lamp,
    AttnAux,
)
from .policy import LampPolicy, LampSite
