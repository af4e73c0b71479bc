"""The benchmark of ``cvmatrix_tpu_torch`` on one NVIDIA H100: total
cross-validation time with every fold's output checked against a plain
reference. Run a cell with ``python cvbench/run.py`` (see README.md)."""
