"""Dense CRDT batches on the device, and the wire loop that feeds them."""

from .orswot_batch import OrswotBatch
from .wireloop import PipelinedWireLoop

__all__ = ["OrswotBatch", "PipelinedWireLoop"]
