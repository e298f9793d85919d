"""cg_solves: one caller in a closed loop.  Each solve is the program's
solvers.cg(A, b, monitor=Monitor(b, iteration_limit, relative_tolerance))
from x0 = 0, the configuration's stopping rule, on the next of
`rhs_count` right-hand sides drawn from the seed (standard normal, scaled
row by row as the matrix's diagonal where its spec scales it).

Parameters (spbench/traffic/<mix>.json): rhs_count, warmup_units,
check_sample, trace_units.  The configuration gives the one matrix,
iteration_limit and relative_tolerance."""

from __future__ import annotations

import time

import torch

from spbench import counts, generator, program, stencils
from spbench.generator import REFERENCE_DTYPE, Check, Sample, delta, sync
from spbench.reference import cg as ref_cg
from spbench.reference import stencil as ref_stencil


class Driver(generator.Base):

    def setup(self):
        (self.spec,) = self.config["matrices"]
        t = time.perf_counter()
        self.A, self.nnz, self.n = self.assemble(self.spec)
        self.B = torch.randn((self.traffic["rhs_count"], self.n), generator=self.gen,
                             dtype=self.dtype, device=self.device)
        scale = stencils.row_scale(self.spec, self.dtype, self.device)
        if scale is not None:
            self.B.mul_(scale)
        sync(self.device)
        self.info["inputs_s"] = time.perf_counter() - t
        self.limit = int(self.config["iteration_limit"])
        self.rtol = float(self.config["relative_tolerance"])
        self.next = 0
        t = time.perf_counter()
        for _ in range(self.traffic["warmup_units"]):
            self._solve()
        self.info["warmup_s"] = time.perf_counter() - t
        self.product = generator.product_launches(
            self.device, lambda: program.port("ops.multiply").multiply(
                program.port("operators").solve_operator(self.A), self.B[0]))
        self.matrices = [self.describe(self.spec, self.nnz, self.n, 1)]

    def _solve(self):
        i = self.next
        self.next += 1
        b = self.B[i % self.B.shape[0]]
        monitor = program.port("solvers.monitor").Monitor(
            b, iteration_limit=self.limit, relative_tolerance=self.rtol)
        x, monitor = program.port("solvers.cg").cg(self.A, b, monitor=monitor)
        sync(self.device)
        return i % self.B.shape[0], x, monitor.iteration_count()

    def step(self, units: int):
        """`units` solves, as the window runs them."""
        c0, its_total = program.read_counts(), 0
        for _ in range(units):
            its_total += self._solve()[2]
        return dict(counts=delta(program.read_counts(), c0), iterations=its_total,
                    units=units)

    def window(self, seconds: float):
        sample = Sample(self.traffic["check_sample"], self.rng)
        times, self.solved = [], []
        its_total = flops = 0
        c0 = program.read_counts()
        t0 = t_end = time.perf_counter()
        while t_end - t0 < seconds:
            start = time.perf_counter()
            ri, x, its = self._solve()
            t_end = time.perf_counter()
            times.append(t_end - start)
            self.solved.append((ri, its))
            its_total += its
            flops += counts.cg_solve_flops(self.nnz, self.n, its)
            sample.offer(len(times) - 1, (ri, x))
        self.sample = sample
        self.record.update(window_s=t_end - t0, attempted=len(times), unit_s=times,
                           iterations=its_total, counts=delta(program.read_counts(), c0),
                           flops=flops)

    def release(self):
        del self.A

    def check(self, limits):
        """The reference's CG under the same stopping rule, from each
        right-hand side the window solved: every solve's iteration count
        against the reference's for its b, and x of each sampled solve
        against the reference's, ||x - x_ref|| / ||x_ref||.  Solves out of
        either limit count as failed."""
        want = {}
        for ri in sorted({ri for ri, _ in self.solved}):
            want[ri] = ref_cg.cg(lambda v: ref_stencil.apply(self.spec, v, REFERENCE_DTYPE),
                                 self.B[ri], self.limit, REFERENCE_DTYPE, self.rtol)
        errs = {}
        for index, (ri, x) in self.sample.items():
            x_ref = want[ri][0]
            errs[index] = float(torch.linalg.vector_norm(x.to(REFERENCE_DTYPE) - x_ref)
                                / torch.linalg.vector_norm(x_ref))
        offs = [abs(its - want[ri][1]) for ri, its in self.solved]
        checks = [Check("x_rel_err", max(errs.values()), limits["x_rel_err"]),
                  Check("iterations_off", float(max(offs)), limits["iterations_off"])]
        self.info["checked_solves"] = len(errs)
        self.info["reference_iterations"] = {ri: w[1] for ri, w in want.items()}
        self.record["failed"] = len({i for i, e in errs.items() if e > checks[0].limit}
                                    | {i for i, o in enumerate(offs) if o > checks[1].limit})
        return checks
