"""Sharded execution and training over a ``launch.mesh.DeviceMesh``: the
mesh-axis helpers, logical-axis rules and sharded storage (``sharding``),
the constraint API for model code (``api``), int8 cross-pod gradient
compression (``compression``) and GPipe stages (``pipeline``)."""
