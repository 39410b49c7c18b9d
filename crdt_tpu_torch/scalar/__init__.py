"""The scalar engine: bit-exact reference semantics on the host.

The port's own copy of the JAX package's scalar engine (plain Python, no
array library).  It is the oracle of the port's batch engine
(``crdt_tpu_torch.batch``): both implement the same ``merge`` / ``apply``
/ ``value`` contracts (`src/traits.rs:9-41` of the reference crate,
rust-crdt), and the wire codec (:mod:`crdt_tpu_torch.utils.serde`)
encodes these objects.  Paths such as `src/orswot.rs` in this package
name the reference crate's sources.
"""

from .ctx import AddCtx, ReadCtx, RmCtx
from .gcounter import GCounter
from .gset import GSet
from .lwwreg import LWWReg
from .map import Entry, Map
from .map import Nop as MapNop
from .map import Rm as MapRm
from .map import Up as MapUp
from .mvreg import MVReg, Put
from .orswot import Add, Orswot
from .orswot import Rm as OrswotRm
from .pncounter import Dir, Op as PNOp, PNCounter
from .vclock import Actor, ClockKey, Counter, Dot, VClock

__all__ = [
    "Actor",
    "Add",
    "AddCtx",
    "ClockKey",
    "Counter",
    "Dir",
    "Dot",
    "Entry",
    "GCounter",
    "GSet",
    "LWWReg",
    "Map",
    "MapNop",
    "MapRm",
    "MapUp",
    "MVReg",
    "Orswot",
    "OrswotRm",
    "PNCounter",
    "PNOp",
    "Put",
    "ReadCtx",
    "RmCtx",
    "VClock",
]
