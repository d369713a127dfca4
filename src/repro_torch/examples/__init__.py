"""The reference's ``examples/*.py`` on the port, one module each, the same
flags plus ``--device`` (default: the CUDA device), the same output:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``quickstart``, ``geo_placement``, ``simulate_fleet``, ``serve_fleet``,
``trace_run``, ``serve_batch`` and ``train_e2e``. Each ``main(argv=None)``
drives only ``repro_torch``.
"""
