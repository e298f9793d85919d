"""Graph algorithms (counterpart of cusp_autotuned_tpu/graph; parity:
cusp/graph/).

The traversals (BFS, connected components, MIS, colouring) are rounds of
semiring SpMV sweeps on the graph's device, launched from a host loop: a
BFS level multiplies by the graph's pattern through a planned hand kernel
on the card, and the max-semiring sweeps are plain PyTorch, as the JAX
package computes them outside any Pallas kernel.  The orderings (RCM, the
pseudo-peripheral vertex, Hilbert) are host set-up ops that produce
permutations, RCM and the pseudo-peripheral vertex in native code.
"""

from cusp_autotuned_tpu_torch.graph.traversal import (
    breadth_first_search, connected_components,
)
from cusp_autotuned_tpu_torch.graph.mis import maximal_independent_set
from cusp_autotuned_tpu_torch.graph.coloring import vertex_coloring
from cusp_autotuned_tpu_torch.graph.ordering import (
    pseudo_peripheral_vertex, symmetric_rcm,
)
from cusp_autotuned_tpu_torch.graph.hilbert import hilbert_curve
