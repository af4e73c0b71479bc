"""Headline benchmark of the PyTorch port: ``python3 bench_torch.py``.

The counterpart of ``bench.py``; the code is
:mod:`cvmatrix_tpu_torch.bench`, whose docstring lists the knobs.
"""

from cvmatrix_tpu_torch.bench import main

if __name__ == "__main__":
    main()
