"""Op-based write front-end: batched ``CmRDT::apply`` on the device.

The port of the JAX package's ``oplog``:

* :mod:`~crdt_tpu_torch.oplog.records` — columnar :class:`OpBatch`,
  bounded :class:`OpLog`, the batched :func:`derive_add_ctx` and
  :func:`derive_rm_ctx`;
* :mod:`~crdt_tpu_torch.oplog.apply` — :class:`OpApplier`, the
  scatter-fold of op batches into the ORSWOT planes (duplicate dots
  idempotent, causal gaps parked), and the counter and LWW folds
  (:func:`apply_gcounter_ops`, :func:`apply_pncounter_ops`,
  :func:`apply_lww_ops`);
* :mod:`~crdt_tpu_torch.oplog.wire` — the versioned, CRC-checked op
  frame (``Op::Add`` ships a 23-byte row, not a state blob).

:class:`crdt_tpu_torch.batch.wireloop.PipelinedOpLoop` overlaps frame
decode with the fold.
"""

from .apply import (  # noqa: F401
    ApplyReport, OpApplier, apply_gcounter_ops, apply_lww_ops, apply_pncounter_ops,
)
from .records import (  # noqa: F401
    NO_MEMBER, OP_ADD, OP_DEC, OP_INC, OP_KINDS, OP_RM, OP_SET, OpBatch, OpLog, derive_add_ctx,
    derive_rm_ctx, intern_ops,
)
from .wire import (  # noqa: F401
    FRAME_OPS, OPLOG_PROTOCOL_VERSION, decode_ops_frame, encode_ops_frame, frame_bytes_per_op,
)

__all__ = [
    "ApplyReport", "FRAME_OPS", "apply_gcounter_ops", "apply_lww_ops", "apply_pncounter_ops", "NO_MEMBER", "OPLOG_PROTOCOL_VERSION", "OP_ADD", "OP_DEC",
    "OP_INC", "OP_KINDS", "OP_RM", "OP_SET", "OpApplier", "OpBatch", "OpLog",
    "decode_ops_frame", "derive_add_ctx", "derive_rm_ctx", "encode_ops_frame",
    "frame_bytes_per_op", "intern_ops",
]
