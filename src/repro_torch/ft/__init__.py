"""Failures, stragglers, recovery and elasticity (port of ``repro.ft``):
seeded fault injection, the single-region retry, command deadlines
(:class:`StragglerTimeout`), the straggler detector that drives hedged
re-execution, and the in-place pool rescale.  The reference's
``elastic_shardings`` (JAX mesh shardings) has no counterpart."""
from ..core.device import DeviceFailure, HealthRegistry, StragglerTimeout
from .failures import (FAULT_MODES, FAULT_OPS, FlakyDevice, inject_flaky,
                       with_retry)
from .elastic import rescale_pool
from .stragglers import HedgeRecord, StragglerDetector

__all__ = ["FlakyDevice", "inject_flaky", "with_retry", "FAULT_OPS",
           "FAULT_MODES", "DeviceFailure", "HealthRegistry",
           "StragglerTimeout", "StragglerDetector", "HedgeRecord",
           "rescale_pool"]
