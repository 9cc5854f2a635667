"""Device code of the port: the CUDA kernels' wrappers with their plain
PyTorch versions, and the torch ops around them."""
