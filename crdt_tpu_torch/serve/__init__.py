"""The batched read front-end: ``ReadCtx`` gathers from the dense planes
(:mod:`~crdt_tpu_torch.serve.query`) and session-consistency admission
(:mod:`~crdt_tpu_torch.serve.consistency`)."""

from .consistency import (
    MODE_EVENTUAL, MODE_FRONTIER, MODE_MONOTONIC, MODE_RYW, MODES, Admission, admit, covers,
    stability_statuses,
)
from .query import (
    K_GCOUNTER, K_LWW, K_MAP, K_MVREG, K_ORSWOT, K_PNCOUNTER, KIND_NAMES, NO_MEMBER,
    ST_NOT_STABLE, ST_OK, QueryEngine, ReadRequest, ResultFrame, gather, infer_kind, read_counts,
    row_to_vclock,
)

__all__ = [
    "MODE_EVENTUAL", "MODE_FRONTIER", "MODE_MONOTONIC", "MODE_RYW", "MODES", "Admission",
    "admit", "covers", "stability_statuses",
    "K_GCOUNTER", "K_LWW", "K_MAP", "K_MVREG", "K_ORSWOT", "K_PNCOUNTER", "KIND_NAMES",
    "NO_MEMBER", "ST_NOT_STABLE", "ST_OK", "QueryEngine", "ReadRequest", "ResultFrame", "gather",
    "infer_kind", "read_counts", "row_to_vclock",
]
