"""Checkpoints of the port: `CheckpointManager` writes and reads the JAX
package's on-disk format (``step_<N>/arrays.npz`` + ``manifest.json``)."""
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: F401
