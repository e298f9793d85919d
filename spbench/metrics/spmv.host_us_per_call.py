"""spmv.host_us_per_call (us, host clock): host µs to enqueue one product,
around batches of rounds with no synchronise inside."""


def read(run):
    return run.traced and run.traced.get("host_us_per_call")
