"""Graph-core ops: plain PyTorch versions and the kernel wrappers."""
