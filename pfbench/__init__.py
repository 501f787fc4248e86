"""The benchmark of the PyTorch and CUDA port (``pocketflow_tpu_torch``).

    python3 -m pfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the checkout lists the cells and metrics;
each cell names a configuration (``configs/<config>.json``: sizes, layer
list, the program's flags) and a traffic mix (``traffic/<mix>.json``: the
driver that runs it and its parameters), and its correctness limits sit in
``limits/<cell>.json``.  Each per-layer metric is read by
``metrics/<metric>.py``.  The plain references under ``reference/`` import
nothing of the port.  Nothing here imports JAX or the JAX package.
"""
