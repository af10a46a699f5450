"""swarm_tpu_torch: the PyTorch and CUDA port of swarm_tpu.

Same CLI and output streams as swarm_tpu; the device engines run on
PyTorch, with hand-written CUDA kernels (csrc/) on an NVIDIA card.
Layers that do not use JAX (CLI, database, native host library,
writers) are imported from swarm_tpu.
"""
