"""Graph algorithms and matrix I/O (reference: examples/Graph,
examples/InputOutput)."""

import os
import sys
import tempfile

import numpy as np

from cusp_autotuned_tpu_torch import gallery, graph, io


def main(device=None):
    G = gallery.grid2d(8, 8, format="csr", device=device)

    levels = graph.breadth_first_search(G, src=0)
    print("BFS levels from vertex 0:", levels.cpu().numpy()[:10], "...")

    count, labels = graph.connected_components(G)
    print("connected components:", count)

    ncolors, colors = graph.vertex_coloring(G)
    print("vertex coloring uses", ncolors, "colors")

    P = graph.symmetric_rcm(G)
    print("RCM permutation head:", P.perm.cpu().numpy()[:8])

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "G.mtx")
        io.write_matrix_market_file(G, path)
        H = io.read_matrix_market_file(path, format="csr", device=G.device)
        print("MatrixMarket roundtrip nnz:", H.nnz)
    return {"levels": levels.cpu().numpy()[:10].tolist(), "components": int(count),
            "colors": int(ncolors), "rcm_head": P.perm.cpu().numpy()[:8].tolist(),
            "roundtrip_nnz": int(H.nnz)}


if __name__ == "__main__":
    main(*sys.argv[1:])
