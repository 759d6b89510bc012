"""The benchmark of the PyTorch/CUDA port: the real-time frame loop of
``soc_real_time_renderer_tpu_torch`` on one card, as data-driven cells.

``run.py`` runs one cell once; ``harness.py`` the run; ``registry.py``
finds a cell's configuration (``configs/``), traffic mix (``traffic/``)
and per-layer readers (``metrics/``) by name; ``reference/`` is the plain
PyTorch frame that decides ``correct``; ``roofline.py`` the card's peaks
and each hand-kernel job's bound; ``assets.py`` the synthetic asset tree.
It imports the port and nothing else of the repository.
"""
