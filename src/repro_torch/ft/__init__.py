"""Failures and recovery (port of ``repro.ft``): seeded fault injection and
the single-region retry.  Stragglers and hedging (ROADMAP item 11b) and
elastic rescale (item 11c) are not ported yet."""
from ..core.device import DeviceFailure, HealthRegistry
from .failures import (FAULT_MODES, FAULT_OPS, FlakyDevice, inject_flaky,
                       with_retry)

__all__ = ["FlakyDevice", "inject_flaky", "with_retry", "FAULT_OPS",
           "FAULT_MODES", "DeviceFailure", "HealthRegistry"]
