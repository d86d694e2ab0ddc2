"""Device side of the port: transport ops, CUDA kernels, file drivers."""
