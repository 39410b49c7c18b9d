"""Plain PyTorch and Python references of the cells' semantics.  Nothing
here imports the program, JAX or the JAX package."""
