"""Benchmark scripts of the PyTorch port, each run as a module
(``python -m cvmatrix_tpu_torch.benchmarks.<name>``):

- :mod:`~cvmatrix_tpu_torch.benchmarks.grid`: the reference grid, the
  counterpart of ``benchmarks/benchmark.py``;
- :mod:`~cvmatrix_tpu_torch.benchmarks.widek_genomics`: the wide-K reduce
  sweep (BASELINE.json config 4);
- :mod:`~cvmatrix_tpu_torch.benchmarks.mesh_one_chip` and
  :mod:`~cvmatrix_tpu_torch.benchmarks.mesh_scaling`: the mesh layer on one
  card and its CPU scaling proxy;
- :mod:`~cvmatrix_tpu_torch.benchmarks.plot`: the grid's figures, on a host
  with pandas and matplotlib.
"""
