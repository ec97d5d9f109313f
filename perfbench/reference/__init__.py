"""The plain reference that decides ``correct``: NumPy and plain PyTorch
only.  Nothing here imports ``repro_torch``, ``repro`` or JAX, and nothing
here takes a table the program made: adjacency is rebuilt from the graphs
the benchmark generated."""
