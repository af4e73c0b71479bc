"""The user reductions of the reduce cells, one module each, found by the
cell's ``reduction``."""
