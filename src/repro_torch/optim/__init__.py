"""Optimizers of the port: AdamW (device kernel body and host class) and LR
schedules, counterparts of ``repro.optim``."""
from .adamw import AdamW, AdamWConfig, adamw_update
from .schedule import cosine_warmup
