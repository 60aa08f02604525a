"""PyTorch/CUDA port of the `repro` serving system for NVIDIA Hopper.

Imports torch and numpy only: nothing of JAX and nothing of the `repro`
package, which stays the reference the port is tested against.
"""
