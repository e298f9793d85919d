"""The general generator: a traffic mix is a data file (spbench/traffic/
<mix>.json) whose `kind` names its driver, the module spbench/drivers/
<kind>.py, and whose other keys are that driver's parameters.  A new kind
of traffic is a new driver file; a new mix of an existing kind is a new
data file.

A driver module defines `Driver`, a subclass of `Base` below, which makes
the cell's inputs on the device from the seed (the configuration's
matrices, assembled by stencils.py, and the right-hand sides), makes its
own calls into the program (program.py), warms up the shapes it will
time, runs the window, and afterwards holds what the window produced
against the plain reference (spbench/reference/).  The harness calls, in
order:

    setup()            inputs, plan, warm-up, and `product`: the launch
                       counters that one product of the operator alone
                       moves (product_launches)
    step(units)        with --trace 1, the traced work: {counts, units,
                       and iterations where the driver counts them}
    host_us_per_call() optional, with --trace 1
    window(seconds)    the measured window; fills `record`
    release()          drops the program's state before the reference runs
    check(limits)      [Check], and record["failed"]

Every unit whose answer is compared is drawn from the seed: a reservoir of
`check_sample` units over the whole window, and the window's last unit.
The reference computes in float64."""

from __future__ import annotations

import collections
import dataclasses
import importlib
import random
from typing import Dict, List

import torch

from spbench import program, stencils

REFERENCE_DTYPE = torch.float64


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


class Sample:
    """A uniform sample of `size` units of a stream of unknown length (a
    reservoir), drawn with `rng`, and the stream's last unit."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng = size, rng
        self.slots: List[tuple] = []
        self.last = None

    def offer(self, index: int, item) -> None:
        if index < self.size:
            self.slots.append((index, item))
        else:
            j = self.rng.randrange(index + 1)
            if j < self.size:
                self.slots[j] = (index, item)
        self.last = (index, item)

    def items(self) -> List[tuple]:
        out = dict(self.slots)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return sorted(out.items())


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Ahead:
    """Work dispatched ahead: each batch closed by an event on the card's
    stream, and the host held back only while more than `depth` batches
    are unfinished, so the card stays fed through a stall of the host.
    On the CPU the work is done when it returns, and nothing is held."""

    def __init__(self, device, depth: int):
        self.on_card, self.depth = device.type == "cuda", depth
        self.sent = collections.deque()

    def close_batch(self) -> None:
        if not self.on_card:
            return
        event = torch.cuda.Event()
        event.record()
        self.sent.append(event)
        while len(self.sent) > self.depth:
            self.sent.popleft().synchronize()


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (the reference in float64)."""
    return float((got.to(REFERENCE_DTYPE) - want).abs().max() / want.abs().max())


def product_launches(device, product) -> Dict[str, int]:
    """{kernel wrapper: launches} of one call of `product` alone: the
    wrappers that are the operator's product (the per-layer readers bill
    every other kernel to the work around it).  Empty where no counted
    kernel runs (the CPU)."""
    sync(device)
    c0 = program.read_counts()
    product()
    sync(device)
    return delta(program.read_counts(), c0)


class Base:
    """What every driver keeps: the cell's configuration and traffic, the
    seed's generators, the product's launch counters, and the window's
    record (`record`, read by the metric readers through harness.Run)."""

    def __init__(self, config, traffic, seed: int, device):
        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.rng = random.Random(seed)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.info: Dict[str, object] = {}
        self.record: Dict[str, object] = {}
        self.product: Dict[str, int] = {}
        self.matrices: List[dict] = []

    def assemble(self, spec):
        """(the program's container of the spec's matrix, its nnz, its
        rows)."""
        fmt = self.config["format"]
        build = {"dia": stencils.dia_arrays, "csr": stencils.csr_arrays}[fmt]
        arrays = build(spec, self.dtype, self.device)
        return program.matrix(fmt, arrays), arrays[-1], stencils.num_rows(spec["grid"])

    def describe(self, spec, nnz: int, n: int, k: int) -> dict:
        """A matrix as the counts and readers see it."""
        return dict(name=spec["name"], nnz=nnz, n_in=n, n_out=n, k=k,
                    dtype=self.config["dtype"], value_size=self.dtype.itemsize)


def driver(config, traffic, seed, device) -> Base:
    """The driver that traffic["kind"] names, spbench/drivers/<kind>.py."""
    kind = traffic["kind"]
    if not kind.isidentifier():
        raise ValueError(f"traffic kind {kind!r} is not a module name")
    module = importlib.import_module(f"spbench.drivers.{kind}")
    return module.Driver(config, traffic, seed, device)
