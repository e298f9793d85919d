"""multiply_rounds: one caller.  A round is one product of each of the
configuration's matrices with the next of `vectors` inputs drawn from the
seed (x of (n,) at `columns` 1, X of (n, columns) past it), each matrix
planned by autotune.tuned_operator (the tuner's pick, no walk); in the
window, batches of `rounds_per_batch` rounds, `batches_ahead` of them
dispatched ahead of the one the host waits for.

Parameters (spbench/traffic/<mix>.json): columns, vectors,
rounds_per_batch, batches_ahead, warmup_units, check_sample, trace_units,
host_batches."""

from __future__ import annotations

import time

import torch

from spbench import counts, generator, program
from spbench.generator import REFERENCE_DTYPE, Check, Sample, delta, rel_err, sync
from spbench.reference import stencil as ref_stencil


class Driver(generator.Base):

    def setup(self):
        k, v = self.traffic["columns"], self.traffic["vectors"]
        t = time.perf_counter()
        self.specs = self.config["matrices"]
        self.A, self.X = [], []
        for spec in self.specs:
            A, nnz, n = self.assemble(spec)
            shape = (v, n) if k == 1 else (v, n, k)
            self.A.append(A)
            self.X.append(torch.randn(shape, generator=self.gen, dtype=self.dtype,
                                      device=self.device))
            self.matrices.append(self.describe(spec, nnz, n, k))
        # the inputs of every call as views made once: indexing X in the
        # window would add the benchmark's own host time to each product
        self.inputs = [list(X.unbind(0)) for X in self.X]
        sync(self.device)
        self.info["inputs_s"] = time.perf_counter() - t
        t = time.perf_counter()
        tuner = program.port("autotune.tuner")
        self.ops = [tuner.tuned_operator(A) if k == 1 else tuner.tuned_operator(A, x=X[0])
                    for A, X in zip(self.A, self.X)]
        sync(self.device)
        self.info["plan_s"] = time.perf_counter() - t
        self.info["picks"] = [f"{m['name']}:{getattr(op, 'impl', '?')}"
                              for m, op in zip(self.matrices, self.ops)]
        self.next = 0
        t = time.perf_counter()
        for _ in range(self.traffic["warmup_units"]):
            self._round()
        sync(self.device)
        self.info["warmup_s"] = time.perf_counter() - t
        self.product = generator.product_launches(self.device, self._round)

    def _round(self):
        i = self.next
        self.next += 1
        v = i % self.traffic["vectors"]
        return v, [op(xs[v]) for op, xs in zip(self.ops, self.inputs)]

    def step(self, units: int):
        """`units` rounds with no synchronise between them."""
        c0 = program.read_counts()
        for _ in range(units):
            self._round()
        return dict(counts=delta(program.read_counts(), c0), units=units)

    def host_us_per_call(self) -> float:
        """Host µs to enqueue one product: the host clock around batches of
        rounds with no synchronise inside, summed over `host_batches`
        batches, over the calls made."""
        spent, calls = 0.0, 0
        for _ in range(self.traffic["host_batches"]):
            sync(self.device)
            t = time.perf_counter()
            for _ in range(self.traffic["rounds_per_batch"]):
                self._round()
            spent += time.perf_counter() - t
            calls += self.traffic["rounds_per_batch"] * len(self.ops)
        sync(self.device)
        return spent / calls * 1e6

    def window(self, seconds: float):
        """Batches sent while the time lasts; then nothing more is sent,
        every batch sent is waited for, and the clock is read after that
        wait: all of that work, over all of that time."""
        sample = Sample(self.traffic["check_sample"], self.rng)
        ahead = generator.Ahead(self.device, self.traffic["batches_ahead"])
        rounds = 0
        c0 = program.read_counts()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(self.traffic["rounds_per_batch"]):
                sample.offer(rounds, self._round())
                rounds += 1
            ahead.close_batch()
        sync(self.device)
        t_end = time.perf_counter()
        self.sample = sample
        self.record.update(
            window_s=t_end - t0, attempted=rounds * len(self.ops), rounds=rounds,
            counts=delta(program.read_counts(), c0),
            flops=rounds * sum(counts.multiply_flops(m["nnz"], m["k"])
                               for m in self.matrices))

    def release(self):
        del self.ops, self.A

    def check(self, limits):
        """Each product of every sampled round against the reference's
        product of the same input: max |y - y_ref| / max |y_ref|.  Products
        out of the limit count as failed."""
        errs = []
        for _, (v, ys) in self.sample.items():
            for spec, X, y in zip(self.specs, self.X, ys):
                errs.append(rel_err(y, ref_stencil.apply(spec, X[v], REFERENCE_DTYPE)))
        check = Check("y_rel_err", max(errs), limits["y_rel_err"])
        self.info["checked_products"] = len(errs)
        self.record["failed"] = sum(e > check.limit for e in errs)
        return [check]
