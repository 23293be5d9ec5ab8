from . import adamw
from .adamw import AdamWConfig, AdamWState, init_state, apply_updates, cosine_schedule
