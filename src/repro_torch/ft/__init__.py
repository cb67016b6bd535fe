"""Failures, stragglers and recovery (port of ``repro.ft``): seeded fault
injection, the single-region retry, command deadlines
(:class:`StragglerTimeout`) and the straggler detector that drives hedged
re-execution.  Elastic rescale (ROADMAP item 11c) is not ported yet."""
from ..core.device import DeviceFailure, HealthRegistry, StragglerTimeout
from .failures import (FAULT_MODES, FAULT_OPS, FlakyDevice, inject_flaky,
                       with_retry)
from .stragglers import HedgeRecord, StragglerDetector

__all__ = ["FlakyDevice", "inject_flaky", "with_retry", "FAULT_OPS",
           "FAULT_MODES", "DeviceFailure", "HealthRegistry",
           "StragglerTimeout", "StragglerDetector", "HedgeRecord"]
