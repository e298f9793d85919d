"""The compress step of the SpGEMM (ops/spgemm.py) on the card.

On the first slice of C = A A for poisson5pt 1000x1000 (16,777,212
products in 8,723,402 segments), the segmented sum of the sorted products
in the two layouts that torch.segment_reduce takes, (E,) and one column
(E, 1), each checked bit for bit against the other and the CPU, timed in
turns (flat, column, column, flat; harness.time_fn), beside the slice's
stable sort and unique_consecutive:

    python -m cusp_autotuned_tpu_torch.benchmarks.spgemm_compress   # one GPU
"""

from __future__ import annotations

import torch


def main(side: int = 1000) -> dict:
    """Print and return {label: ms a call} (raises without a card)."""
    from cusp_autotuned_tpu_torch import gallery
    from cusp_autotuned_tpu_torch.benchmarks import harness
    from cusp_autotuned_tpu_torch.ops import spgemm as SG

    device = harness.card(())
    A = gallery.poisson5pt(side, side, format="csr", device=device)
    p = SG.plan(A, A)
    key, vals = SG.expand(p, p.bounds[0])
    key, order = torch.sort(key, stable=True)
    vals = vals[order]
    _, counts = torch.unique_consecutive(key, return_counts=True)

    def flat():
        return torch.segment_reduce(vals, "sum", lengths=counts, unsafe=True)

    def column():
        return torch.segment_reduce(vals[:, None], "sum", lengths=counts,
                                    unsafe=True)[:, 0]

    cpu = torch.segment_reduce(vals.cpu(), "sum", lengths=counts.cpu(), unsafe=True)
    same = (torch.equal(flat(), column()) and torch.equal(column().cpu(), cpu)
            and torch.equal(column(), column()))
    ms = {}
    for label, fn in (("flat", flat), ("column", column), ("column", column),
                      ("flat", flat)):
        ms.setdefault(label, []).append(harness.time_fn(fn) * 1e3)
    ms = {label: sum(v) / len(v) for label, v in ms.items()}
    ms["sort"] = harness.time_fn(lambda: torch.sort(key, stable=True)) * 1e3
    ms["unique_consecutive"] = harness.time_fn(
        lambda: torch.unique_consecutive(key, return_counts=True)) * 1e3
    print(f"spgemm_compress: poisson5pt {side}x{side}, slice 1: {vals.numel()} "
          f"products in {counts.numel()} segments (at most {int(counts.max())} "
          f"entries); flat, column and CPU sums equal bit for bit {same}; ms a "
          f"call: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    if not same:
        raise RuntimeError("spgemm_compress: the layouts' sums differ")
    return ms


if __name__ == "__main__":
    main()
