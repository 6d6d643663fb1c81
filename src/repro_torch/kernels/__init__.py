"""Hand-written CUDA kernels of the port (Hopper, ``sm_90a``), each with
its plain PyTorch version beside it; :mod:`.ops` dispatches between them
by the device the tensors lie on."""
