"""Command-line tools of the port: the gloo multihost join (``multihost``)."""
