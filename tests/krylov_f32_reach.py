"""How far CR, BiCGstab, BiCGstab-M and BiCG get in f32 on the cg.cu
system, in the JAX package and in its port, on the CPU: poisson5pt N x N
(1000 by default, the reference's cg.cu size), b = RandomState(0).rand,
the via_dia plan's plain slices, rel-tol 1e-5, at most 2000 iterations,
BiCGstab-M with the shifts [0, 0.5, 2].

    JAX_PLATFORMS=cpu python tests/krylov_f32_reach.py [N]

A script, not a test (minutes at N = 1000).  For each solver and package
it prints the iterations, the last and the least monitored relative
residual, and whether x is finite.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cusp_autotuned_tpu import gallery as jgallery, solvers as js  # noqa: E402
from cusp_autotuned_tpu.operators import planned_operator as jplanned  # noqa: E402

from cusp_autotuned_tpu_torch import gallery, solvers  # noqa: E402
from cusp_autotuned_tpu_torch.operators import planned_operator  # noqa: E402

CONFIG = {"impl": "via_dia", "dia_impl": "slices"}
SIGMA = np.array([0.0, 0.5, 2.0], np.float32)


def report(package, name, x, mon):
    r = np.asarray(mon.residuals) / mon.b_norm
    print(f"{package:5s} {name:10s} {mon.iteration_count():5d} iterations, relative "
          f"residual {r[-1]:.4e} (least {np.nanmin(r):.4e}), x finite "
          f"{bool(np.isfinite(np.asarray(x)).all())}", flush=True)


def run(package, name, A, b):
    s = js if package == "jax" else solvers
    extra = {"At": A} if name == "bicg" else {}
    args = (A, b, SIGMA if package == "jax" else torch.from_numpy(SIGMA)) \
        if name == "bicgstab_m" else (A, b)
    x, mon = getattr(s, name)(*args, monitor=s.Monitor(b, 2000, 1e-5), **extra)
    report(package, name, np.asarray(x), mon)


def main(n=1000):
    b = np.random.RandomState(0).rand(n * n).astype(np.float32)
    J = jplanned(jgallery.poisson5pt(n, n, format="csr", dtype=np.float32), CONFIG)
    P = planned_operator(gallery.poisson5pt(n, n, format="csr", device="cpu"), CONFIG)
    for name in ("cr", "bicgstab", "bicgstab_m", "bicg"):
        run("jax", name, J, jnp.asarray(b))
        run("port", name, P, torch.from_numpy(b))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
