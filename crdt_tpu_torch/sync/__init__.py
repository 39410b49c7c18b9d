"""Digest-driven delta anti-entropy (the port of the JAX package's
``sync`` package, less the session): per-object digests and the
version-vector summary (:mod:`~crdt_tpu_torch.sync.digest`), digest
trees and their descent (:mod:`~crdt_tpu_torch.sync.tree`), and the
frame codec with the diverged-row gather and apply
(:mod:`~crdt_tpu_torch.sync.delta`).  One round between two replicas:
digests → tree descent → gather the diverged rows → delta frame →
decode → scatter-merge (the merge kernel on a CUDA device) → verify
digests."""

from .delta import (  # noqa: F401
    BASELINE_VERSION, COMPAT_VERSIONS, PROTOCOL_VERSION, OrswotDeltaApplier, apply_delta_rows,
    decode_frame, diverged_indices, encode_delta_chunk_frame, encode_delta_frame,
    encode_digest_frame, encode_full_frame, encode_tree_level_frame, encode_tree_root_frame,
    gather_blobs,
)
from .digest import (  # noqa: F401
    actor_salt_table, counter_digest, digest_of, digest_tree_of, fleet_summary, lww_digest,
    member_salt_table, orswot_digest, stable_name_salt, version_vector,
)
from .tree import TREE_K, DigestTree, build_tree, simulate_descent  # noqa: F401
