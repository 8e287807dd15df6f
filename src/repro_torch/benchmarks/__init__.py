"""The paper-table benchmarks of ``benchmarks/`` on the port: the shared
experiment runner (:mod:`repro_torch.benchmarks.common`) and the table
runner (``python -m repro_torch.benchmarks.run``)."""
