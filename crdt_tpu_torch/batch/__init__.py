"""Dense CRDT batches on the device, and the loops that feed them."""

from .orswot_batch import OrswotBatch
from .wireloop import PipelinedOpLoop, PipelinedWireLoop

__all__ = ["OrswotBatch", "PipelinedOpLoop", "PipelinedWireLoop"]
