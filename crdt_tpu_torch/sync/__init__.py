"""Digest-driven delta anti-entropy (the port of the JAX package's
``sync`` package): per-object digests and the version-vector summary
(:mod:`~crdt_tpu_torch.sync.digest`), digest trees and their descent
(:mod:`~crdt_tpu_torch.sync.tree`), the frame codec with the
diverged-row gather and apply (:mod:`~crdt_tpu_torch.sync.delta`), and
the session that runs the protocol between two replicas
(:mod:`~crdt_tpu_torch.sync.session`: hello → digests or tree descent →
delta frames → scatter-merge, the merge kernel on a CUDA device →
verify → piggybacks)."""

from .delta import (  # noqa: F401
    BASELINE_VERSION, COMPAT_VERSIONS, PROTOCOL_VERSION, HelloInfo, OrswotDeltaApplier,
    apply_delta_rows, decode_frame, decode_hello_payload, diverged_indices,
    encode_delta_chunk_frame, encode_delta_frame, encode_digest_frame, encode_fleet_frame, encode_full_frame, encode_hello_frame,
    encode_lag_frame, encode_ops_sync_frame, encode_tree_level_frame, encode_tree_root_frame,
    gather_blobs,
)
from .digest import (  # noqa: F401
    actor_salt_table, counter_digest, digest_of, digest_tree_of, fleet_summary, lww_digest,
    member_salt_table, orswot_digest, stable_name_salt, version_vector,
)
from .session import (  # noqa: F401
    SyncReport, SyncSession, queue_transport, session_counts, sync_pair,
)
from .tree import TREE_K, DigestTree, build_tree, simulate_descent  # noqa: F401
