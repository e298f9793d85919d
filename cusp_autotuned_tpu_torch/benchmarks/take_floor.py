"""The take probe's shared-memory floor, counted from its index planes.

    python -m cusp_autotuned_tpu_torch.benchmarks.take_floor [SM_MHZ ...]

The probe (`csrc/take_probe.cu`, staged instantiation) has each warp
gather 32 words of one 128-float row of x from shared memory through a row
of a pass's plane (`autotune.calibrate.take_probe_planes(0)`).  The 32
words are distinct and land on banks ix mod 32, so a warp's gather takes as
many shared-memory wavefronts as the most lanes that share one bank.  This
counts them for every (pass, row, warp) of the planes, which every tile
repeats, and prints the mean wavefronts a gather and the time that the
gathers alone need at TAKE_TILES tiles and the larger of TAKE_PASSES, at
one wavefront a clock on each of SMS multiprocessors, for each SM clock
given (MHz; by default 1980, the H100's `clocks.max.sm`).  A count on the
host: no card needed.
"""

from __future__ import annotations

import sys

import numpy as np

from cusp_autotuned_tpu_torch.autotune.calibrate import (
    LANE, TAKE_PASSES, TAKE_TILES, take_probe_planes,
)

SMS = 132                       # an H100 SXM's multiprocessors
WARP = 32


def wavefronts_per_gather(planes=None) -> float:
    """Mean over the planes' warp gathers of the largest number of lanes
    that read one shared-memory bank."""
    planes = (take_probe_planes(0) if planes is None else planes).numpy()
    banks = planes.reshape(-1, WARP) % WARP
    counts = np.stack([(banks == k).sum(axis=1) for k in range(WARP)])
    return float(counts.max(axis=0).mean())


def floor_ms(wavefronts: float, sm_mhz: float, tiles: int = TAKE_TILES,
             passes: int = max(TAKE_PASSES)) -> float:
    gathers = tiles * passes * LANE * (LANE // WARP)
    return gathers * wavefronts / (SMS * sm_mhz * 1e6) * 1e3


def main(argv=()):
    clocks = [float(a) for a in argv] or [1980.0]
    w = wavefronts_per_gather()
    print(f"take probe: {w:.4f} shared-memory wavefronts a warp gather "
          f"(take_probe_planes(0), {max(TAKE_PASSES)} passes); "
          f"{TAKE_TILES * max(TAKE_PASSES) * LANE * LANE:.3e} gathered words")
    for mhz in clocks:
        print(f"  at {mhz:.0f} MHz on {SMS} SMs: the gathers need "
              f"{floor_ms(w, mhz):.4f} ms")


if __name__ == "__main__":
    main(sys.argv[1:])
