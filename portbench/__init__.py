"""The PyTorch and CUDA port's benchmark: the pruning service driven through
its serving front-end, cell by cell, as ``BENCHMARK.json`` lists them.

Everything that measures lives here and is frozen: the table generator
(``gen``), the traffic generator (``traffic``), the plain reference
(``reference``), the need arithmetic and peaks (``need``), and one reader a
per-layer metric family (``metrics``).  From the port the benchmark takes
only the system under test (``repro_torch.serve``), its counters and its
kernel names.
"""
