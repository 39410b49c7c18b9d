"""Dense CRDT batches on the device, and the loops that feed them."""

from .gcounter_batch import GCounterBatch
from .gset_batch import GSetBatch
from .lwwreg_batch import LWWRegBatch
from .map_batch import MapBatch
from .mvreg_batch import MVRegBatch
from .orswot_batch import OrswotBatch
from .pncounter_batch import PNCounterBatch
from .val_kernels import MapKernel, MVRegKernel, OrswotKernel
from .vclock_batch import VClockBatch
from .wireloop import PipelinedOpLoop, PipelinedWireLoop

__all__ = ["GCounterBatch", "GSetBatch", "LWWRegBatch", "MapBatch", "MapKernel", "MVRegBatch",
           "MVRegKernel", "OrswotBatch", "OrswotKernel", "PNCounterBatch", "PipelinedOpLoop",
           "PipelinedWireLoop", "VClockBatch"]
