"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m spbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints informational lines and, last on standard error, each number that
`correct` compares beside its limit; then, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device (and
with --trace 1 busy_s, window_s and a breakdown), and last the checks.
Exits with a code other than 0 and prints no result where there is no
CUDA card, or fewer than the cell asks for, or where the process has
loaded JAX or the JAX package.

Set-up is timed from this module's first line: CUDA start, the kernel
library's load (its build on a checkout's first run), the inputs, the
plan and the warm-up of the cell's own shapes."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_CACHE = os.path.join(_HERE, ".cache")
# every cache a run writes stays at a fixed path inside the checkout; the
# port's kernels build into its own fixed cusp_autotuned_tpu_torch/_build/
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
os.environ["USE_FLAX"] = "0"
# the port at its defaults: no tuning cache, calibration file or bf16 walk
# from the caller's environment
for _var in ("CUSP_TORCH_TUNING_CACHE", "CUSP_TORCH_CALIBRATION", "CUSP_TORCH_TUNE_BF16"):
    os.environ.pop(_var, None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m spbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    t = time.perf_counter()
    import torch
    from spbench import harness
    t_import = time.perf_counter() - t

    _, cell, _, _, _ = harness.cell_files(args.workload)
    t = time.perf_counter()
    ok = torch.cuda.is_available() and torch.cuda.device_count() >= cell["chips"]
    print(f"spbench: import_s = {t_import}; cuda_check_s = {time.perf_counter() - t}",
          file=sys.stderr)
    if not ok:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"spbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {have}", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace), T_START)
    found = harness.banned_modules()
    if found:
        print(f"spbench: the process loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
