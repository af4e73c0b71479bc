"""The JAX package's six examples on the PyTorch port, each run as a
module: ``python -m cvmatrix_tpu_torch.examples.<name> [--device cpu]``.
Each uses its JAX file's sizes, seeds and printed lines, and runs on the
CUDA card unless ``--device cpu`` is given."""
