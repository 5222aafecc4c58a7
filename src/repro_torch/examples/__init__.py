"""Runnable examples of the port, the counterparts of ``examples/*.py``:

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.autotune_demo [--trace]
    python -m repro_torch.examples.cg_solver
    python -m repro_torch.examples.pagerank
    python -m repro_torch.examples.bfs

(with ``src`` on ``PYTHONPATH``).  Each takes ``--policy
{default,autotune,<harness>}`` and ``--device`` (default ``cuda``; pass
``--device cpu`` to run the kernels' plain versions on the CPU).
"""
