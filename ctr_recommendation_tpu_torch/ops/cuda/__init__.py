"""Hand-written CUDA kernels for Hopper (sources in ../../csrc/), one module
per TPU kernel of the JAX package's ops/pallas/ and one per kernel of the
port's own (table_grad, tower), each with its plain PyTorch version and a
launch counter."""
