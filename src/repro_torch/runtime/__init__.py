"""Cluster runtime of the port: failure detection, elastic rescale,
straggler mitigation and the page-table restart drill."""
