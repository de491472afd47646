"""Attention kernels: CUDA C++ for Hopper (``csrc/``), their ctypes
wrappers and plain PyTorch versions (``flash_attention``), dispatch
(``ops``) and oracles (``ref``).  Importing builds nothing: the kernels
compile at first launch (``build``)."""
