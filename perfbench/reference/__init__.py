"""Plain PyTorch and NumPy re-implementations of what the benchmark's
cells run, for the comparison that decides ``correct``. Nothing here
imports the program or anything it made: the references take the
benchmark's inputs (``perfbench.inputs``) and work out the rest again."""
