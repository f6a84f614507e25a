"""Mesh-axis helpers of the port (``sharding``)."""
