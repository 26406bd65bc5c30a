"""Tile kernels of the PyTorch port: each package holds a plain PyTorch
version (``ref``), the launch wrapper of a hand-written CUDA kernel
(``kernel``) and the ``impl=`` dispatch (``ops``); ``hd`` turns them
into HDArray device kernels."""
