"""The plain reference that decides `correct`: plain PyTorch and NumPy
only. It imports neither JAX, nor the JAX package, nor anything of the
program (raytracinggrff_tpu_torch); it takes the inputs the benchmark
generated and works out again what the program derived from them."""
