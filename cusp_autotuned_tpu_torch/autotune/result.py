"""Tuning results and status codes (counterpart of
cusp_autotuned_tpu/autotune/result.py).

Parity: KTT's ResultStatus.  The tuner treats CompilationFailed /
ComputationFailed / ValidationFailed / DeviceLimitsExceeded configurations
as skippable failures (testing/ktt.cu:101-116 relies on this).  The JSON
fields are the JAX package's, so one cache file reads in both."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional


class ResultStatus(enum.Enum):
    Ok = "Ok"
    CompilationFailed = "CompilationFailed"
    ComputationFailed = "ComputationFailed"
    ValidationFailed = "ValidationFailed"
    DeviceLimitsExceeded = "DeviceLimitsExceeded"


@dataclasses.dataclass
class TuningResult:
    """duration_ms is the tuner's one timing channel: milliseconds per call
    from CUDA events around back-to-back launches on the card, from the host
    clock on the CPU (or the single validated run's wall time, build
    included, in a validation-only walk).  Every ranking reads it.
    device_us keeps the JAX package's field, which held a second channel;
    the port has none and leaves it None."""

    configuration: Dict[str, Any]
    status: ResultStatus
    duration_ms: float = float("inf")
    compilation_ms: float = 0.0
    error: Optional[str] = None
    device_us: Optional[float] = None

    def is_valid(self) -> bool:
        return self.status == ResultStatus.Ok

    def to_json(self):
        return {
            "configuration": self.configuration,
            "status": self.status.value,
            "duration_ms": self.duration_ms,
            "compilation_ms": self.compilation_ms,
            "error": self.error,
            "device_us": self.device_us,
        }

    @staticmethod
    def from_json(d):
        dev = d.get("device_us")
        return TuningResult(
            configuration=dict(d["configuration"]),
            status=ResultStatus(d["status"]),
            duration_ms=float(d["duration_ms"]),
            compilation_ms=float(d.get("compilation_ms", 0.0)),
            error=d.get("error"),
            device_us=float(dev) if dev is not None else None,
        )
