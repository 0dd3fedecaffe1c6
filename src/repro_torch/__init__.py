"""PyTorch/CUDA port of the FloatSD8 LSTM system, held against the JAX
package ``repro``. It imports neither JAX nor ``repro``; the kernels on its
path are hand-written CUDA for Hopper (``kernels/<op>/<op>.cu``)."""
