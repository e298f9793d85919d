"""Autotuning layer (counterpart of cusp_autotuned_tpu/autotune; the
rebuild of the fork's KTT integration, cusp/ktt/ktt.h:14-124).

Public API parity:
  enable() / disable()          cusp::ktt::enable / disable
  is_enabled()                  the multiply hook's guard
  get_tuner()                   cusp::ktt::get_tuner (lazy global tuner)
  multiply(A, x)                one dynamic tuning step per call
  multiply(A, x, configuration) run a fixed configuration
  tune(A, x, ...)               offline walk with per-configuration
                                validation (ktt.h:90-101)
  reset_tuning(A)               clear accumulated results
  tuned_operator(A)             the best configuration as a solver operator
  choose_format(A)              per-matrix format selection

Configurations are the kernels' launch parameters and the format-selection
moves (kernels/variants.py); validation holds each against the scipy
oracle.  The cost model (cost_model.py) prices each impl on the card before
anything is built: it gives the untuned pick (recommend_config), the
dynamic walk's order and ModelGuidedSearcher's.
"""

from cusp_autotuned_tpu_torch.autotune.tuner import (
    Tuner, get_tuner, enable, disable, is_enabled, matrix_signature,
    multiply, tune, reset_tuning, choose_format, tuned_operator,
    TUNABLE_FORMATS,
)
from cusp_autotuned_tpu_torch.autotune.space import (
    TuningSpace, Parameter, configurations_for,
)
from cusp_autotuned_tpu_torch.autotune.result import ResultStatus, TuningResult
from cusp_autotuned_tpu_torch.autotune.search import (
    DeterministicSearcher, RandomSearcher, ModelGuidedSearcher, StopCondition,
    TuningDuration, ConfigurationCount, ConfigurationFraction,
)
from cusp_autotuned_tpu_torch.autotune.cost_model import (
    DEVICE_MODEL, pattern_stats, predict, recommend_config, model_order_key,
)
