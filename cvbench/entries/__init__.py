"""The public entries a cell's window drives, one module each, found by the
cell's ``entry``."""
