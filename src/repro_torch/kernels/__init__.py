"""Hand-written Hopper kernels of the port, one module per TPU kernel of
the JAX package. Importing this package builds nothing: a kernel is
compiled (``_build``) the first time a CUDA tensor reaches its wrapper."""
