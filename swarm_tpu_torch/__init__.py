"""swarm_tpu_torch: the PyTorch and CUDA port of swarm_tpu.

Same CLI and output streams as swarm_tpu; the device engines run on
PyTorch, with hand-written CUDA kernels (csrc/) on an NVIDIA card.
The package stands alone: it imports torch and numpy, never jax and
nothing of swarm_tpu. The host layers (CLI, database, native host
library, writers, host engines) are its own copies, under the same
module names as their counterparts in swarm_tpu.
"""

__version__ = "0.1.0"

SWARM_VERSION = "3.1.6"  # CLI/behaviour-compatibility version
