"""The benchmark of ``face_crop_plus_tpu_torch`` on NVIDIA GPUs.

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything a cell needs is found by name: its
configuration (``configs/``) and the reference pipeline of its model and
strategy (``reference/pipelines/``), its traffic mix (``traffic/``) and
the entry point that mix drives (``entries/``), its limits (``limits/``)
and its metrics (``end_to_end/``, ``metrics/``).  The plain reference
that decides ``correct`` is in ``reference/``; the operation and byte
counts in ``counts/``.  Nothing here imports JAX or the JAX package.
"""
