"""Matrix I/O (counterpart of cusp_autotuned_tpu/io; parity target
cusp/io/): MatrixMarket, the binary formats and DIMACS, each writing the
same bytes as the JAX package's writer and reading its files.  A reader
builds its container on `device`, by default the CUDA device."""

from cusp_autotuned_tpu_torch.io.matrix_market import (
    read_matrix_market_file, read_matrix_market_stream,
    write_matrix_market_file, write_matrix_market_stream,
)
from cusp_autotuned_tpu_torch.io.binary import (
    read_binary_file, read_binary_stream,
    write_binary_file, write_binary_stream,
    read_cusp_binary_file, read_cusp_binary_stream,
    write_cusp_binary_file, write_cusp_binary_stream,
)
from cusp_autotuned_tpu_torch.io.dimacs import (
    read_dimacs_file, read_dimacs_stream,
    write_dimacs_file, write_dimacs_stream,
)
