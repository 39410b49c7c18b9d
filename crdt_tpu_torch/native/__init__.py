"""The host wire codec: ``wire_ingest.cpp`` (ORSWOT blobs ⇄ dense
planes, C++ on a team of threads) and its ``ctypes`` bindings in :mod:`.engine`."""
