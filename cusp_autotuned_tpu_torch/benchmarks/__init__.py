"""The port's measurement tools (counterpart of the JAX repository's
`benchmarks/` folder): the timer and the launch floor (`harness`), the
useful-byte models (`bytes_per_spmv`) and the probes of the DIA SpMV, DIA
SpMM and routed kernels (`dia_probe`, `dia_spmm_probe`, `routed_probe`).
Every timing function here measures the card and raises for a CPU device.
"""
