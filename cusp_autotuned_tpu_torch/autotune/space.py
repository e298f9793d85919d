"""Tuning-space machinery: parameters, constraints, enumeration (counterpart
of cusp_autotuned_tpu/autotune/space.py; parity: KTT's AddParameter /
AddConstraint).  The per-format spaces live next to the kernels, in
kernels/variants.py."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Parameter:
    name: str
    values: Tuple[Any, ...]

    def __init__(self, name, values):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "values", tuple(values))


@dataclasses.dataclass
class TuningSpace:
    parameters: List[Parameter]
    constraints: List[Tuple[Sequence[str], Callable[..., bool]]] = \
        dataclasses.field(default_factory=list)

    def add_parameter(self, name, values):
        self.parameters.append(Parameter(name, values))

    def add_constraint(self, names, fn):
        """fn(*values_of_names) -> bool; configurations violating it are
        excluded (parity: KTT AddConstraint)."""
        self.constraints.append((tuple(names), fn))

    def satisfies(self, config: Dict[str, Any]) -> bool:
        return all(fn(*(config[n] for n in names))
                   for names, fn in self.constraints)

    def configurations(self) -> List[Dict[str, Any]]:
        names = [p.name for p in self.parameters]
        out = []
        for combo in itertools.product(*(p.values for p in self.parameters)):
            cfg = dict(zip(names, combo))
            if self.satisfies(cfg):
                out.append(cfg)
        return out

    def __len__(self):
        return len(self.configurations())


def config_key(config: Dict[str, Any]) -> str:
    return ",".join(f"{k}={config[k]}" for k in sorted(config))


def configurations_for(A) -> List[Dict[str, Any]]:
    """All valid configurations for a matrix's format."""
    from cusp_autotuned_tpu_torch.kernels.variants import tuning_space
    return tuning_space(A).configurations()
