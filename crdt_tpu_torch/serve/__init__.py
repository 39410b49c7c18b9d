"""The batched read front-end: ``ReadCtx`` gathers from the dense planes
(:mod:`~crdt_tpu_torch.serve.query`), session-consistency admission
(:mod:`~crdt_tpu_torch.serve.consistency`), the versioned, CRC-checked
read frames (:mod:`~crdt_tpu_torch.serve.wire`) and the serve loop a
:class:`~crdt_tpu_torch.cluster.ClusterNode` answers reads through
(:mod:`~crdt_tpu_torch.serve.loop`)."""

from .consistency import (
    MODE_EVENTUAL, MODE_FRONTIER, MODE_MONOTONIC, MODE_RYW, MODES, Admission, admit, covers,
    stability_statuses,
)
from .loop import ServeLoop, visible_vv
from .query import (
    K_GCOUNTER, K_LWW, K_MAP, K_MVREG, K_ORSWOT, K_PNCOUNTER, KIND_NAMES, NO_MEMBER,
    ST_NOT_STABLE, ST_OK, QueryEngine, ReadRequest, ResultFrame, gather, infer_kind, read_counts,
    row_to_vclock,
)
from .wire import (
    FRAME_READ, FRAME_RESULT, SERVE_PROTOCOL_VERSION, decode_read_request, decode_result_frame,
    encode_read_request, encode_result_frame,
)

__all__ = [
    "MODE_EVENTUAL", "MODE_FRONTIER", "MODE_MONOTONIC", "MODE_RYW", "MODES", "Admission",
    "admit", "covers", "stability_statuses",
    "K_GCOUNTER", "K_LWW", "K_MAP", "K_MVREG", "K_ORSWOT", "K_PNCOUNTER", "KIND_NAMES",
    "NO_MEMBER", "ST_NOT_STABLE", "ST_OK", "QueryEngine", "ReadRequest", "ResultFrame", "gather",
    "infer_kind", "read_counts", "row_to_vclock", "ServeLoop", "visible_vv", "FRAME_READ",
    "FRAME_RESULT", "SERVE_PROTOCOL_VERSION", "decode_read_request", "decode_result_frame",
    "encode_read_request", "encode_result_frame",
]
