"""BFS and connected components as semiring SpMV sweeps (counterpart of
cusp_autotuned_tpu/graph/traversal.py).

Parity: cusp::graph::breadth_first_search (cusp/graph/breadth_first_search.h:
labels are levels, or predecessors with mark_levels=False) and
cusp::graph::connected_components (the count and the labels).

The JAX package runs each fixpoint as one lax.while_loop on the device.
Here a host loop launches the rounds and reads the stop flag back as
solvers/cg.py does: a BFS level is cheap, so the flag is read once per
block of cg.CHECK_EVERY levels (the levels of a block past the fixpoint
change nothing); a round of the other fixpoints costs more than the read,
so they read it every round.  A BFS level is one SpMV of the graph's
pattern (unit values), planned once on a CUDA device through
operators.solve_operator, so that it runs a hand kernel.  Edges are the
stored entries, whatever their values, as in CUSP: the JAX package's level
sweep tests A f > 0, which a negative entry such as poisson5pt's -1 hides.
The other sweeps are max-semiring products (generalized_spmv, plain
PyTorch, as in the JAX package).  Vertex ids ride them as int64, where the
JAX package carries f32 below 2^24; the labels are the same.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from cusp_autotuned_tpu_torch.ops.multiply import generalized_spmv, multiply

ID_DTYPE = torch.int64


def _until(step, state, done, every=1):
    """state = step(state) until done(state), a device bool read on the host
    once per `every` rounds; returns (state, rounds run)."""
    rounds = 0
    while not bool(done(state)):
        for _ in range(every):
            state = step(state)
            rounds += 1
    return state, rounds


def _check_every():
    # the module, which solvers/__init__ shadows with the function cg
    return importlib.import_module("cusp_autotuned_tpu_torch.solvers.cg").CHECK_EVERY


def _neighbor_max(A, x):
    """y[i] = max over the neighbours j of i (the stored entries of row i)
    of x[j]; 0 where i has none."""
    return generalized_spmv(A, x, torch.zeros(A.num_rows, dtype=x.dtype,
                                              device=x.device),
                            lambda y: y, lambda a, xj: xj, torch.maximum)


def strip_diagonal(G):
    """The off-diagonal entries of G as CSR on G's device: matrices carry
    self-loops (diagonal entries) that must not count as graph edges in MIS
    and colouring."""
    from cusp_autotuned_tpu_torch.formats.csr import csr_matrix
    from cusp_autotuned_tpu_torch.ops.convert import _indptr, coo_arrays
    row, col, val, shape = coo_arrays(G)
    keep = row != col
    return csr_matrix(_indptr(row[keep], shape[0]), col[keep], val[keep], shape,
                      device=G.device)


def _pattern_operator(G):
    """G's pattern with unit f32 values, as the operator one BFS level
    multiplies the frontier by: planned on a CUDA device, the container
    itself on the CPU (operators.solve_operator)."""
    from cusp_autotuned_tpu_torch.operators import solve_operator
    from cusp_autotuned_tpu_torch.ops.convert import convert
    C = convert(G, "csr")
    ones = (C.row < C.num_rows).to(torch.float32)     # padding keeps 0
    return solve_operator(dataclasses.replace(C, val=ones))


def breadth_first_search(G, src: int, mark_levels: bool = True):
    """labels[v] = the BFS level of v from src (its predecessor with
    mark_levels=False; src its own), -1 where v is unreachable; int32 on
    G's device."""
    n = G.num_rows
    src = int(src)
    frontier = torch.zeros(n, dtype=torch.float32, device=G.device)
    frontier[src] = 1.0
    labels = torch.full((n,), -1, dtype=torch.int32, device=G.device)
    if mark_levels:
        labels[src] = 0
        op = _pattern_operator(G)

        def level(state):
            f, lab, lvl = state
            new = (multiply(op, f, use_autotuning=False) > 0) & (lab < 0)
            return new.to(f.dtype), torch.where(new, lvl + 1, lab), lvl + 1

        (_, labels, _), _ = _until(level, (frontier, labels, 0),
                                   lambda s: ~(s[0] > 0).any(), _check_every())
        return labels
    labels[src] = src
    ids = torch.arange(1, n + 1, dtype=ID_DTYPE, device=G.device)

    def step(state):
        f, pred = state
        best = _neighbor_max(G, torch.where(f > 0, ids, 0))
        new = (best > 0) & (pred < 0)
        return new.to(f.dtype), torch.where(new, (best - 1).to(pred.dtype), pred)

    (_, labels), _ = _until(step, (frontier, labels),
                            lambda s: ~(s[0] > 0).any(), _check_every())
    return labels


def connected_components(G):
    """(number of components, labels renumbered 0..count-1, int32 on G's
    device), by label propagation with pointer jumping: each round a vertex
    takes the largest id among itself and its neighbours, then the label
    of the vertex its label names, which halves the distance a label still
    has to travel, so the fixpoint takes O(log diameter) rounds."""
    labels = torch.arange(G.num_rows, dtype=ID_DTYPE, device=G.device)

    def step(state):
        lab, _ = state
        new = torch.maximum(lab, _neighbor_max(G, lab + 1) - 1)
        new = torch.maximum(new, new[new])
        return new, (new != lab).any()

    (labels, _), _ = _until(step, (labels, torch.tensor(True)), lambda s: ~s[1])
    uniq, out = torch.unique(labels, return_inverse=True)
    return int(uniq.numel()), out.to(torch.int32)
