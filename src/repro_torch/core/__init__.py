"""LAMP core: numerics, selection rules, mixed-precision products, attention."""

from .numerics import round_to_mantissa
from .lamp import (masked_softmax, select_softmax_relaxed,
                   select_softmax_relaxed_ln, select_softmax_strict)
from .mixed_matmul import dot_ps
from .attention import AttnAux, attention_lamp, attention_reference
from .policy import LampPolicy, LampSite
