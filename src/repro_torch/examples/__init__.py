"""Runnable examples of the port, the counterparts of ``examples/*.py``:

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.autotune_demo [--trace]
    python -m repro_torch.examples.cg_solver
    python -m repro_torch.examples.pagerank
    python -m repro_torch.examples.bfs
    python -m repro_torch.examples.train_sparse_moe
    python -m repro_torch.examples.train_e2e

(with ``src`` on ``PYTHONPATH``).  The SpMV examples take ``--policy
{default,autotune,<harness>}``; every example takes ``--device`` (default
``cuda``; pass ``--device cpu`` to run the kernels' plain versions on the
CPU).
"""
