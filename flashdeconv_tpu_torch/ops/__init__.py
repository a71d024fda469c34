"""Device layer of the port: plain PyTorch math and the CUDA kernels."""
