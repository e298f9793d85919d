"""One module a kind of traffic, named by the traffic file's `kind`; each
defines `Driver` (spbench/generator.py says what it does)."""
