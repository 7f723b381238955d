"""Entry points of the port's kernel studies, run with ``python -m``:
``microbench_scatter`` (the row-stage scatter microbenchmark) and
``probe_kernels`` (the kernel probes)."""
