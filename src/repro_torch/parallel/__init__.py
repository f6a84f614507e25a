"""Sharded execution and training over a ``launch.mesh.DeviceMesh``: the
mesh-axis helpers, logical-axis rules and sharded storage (``sharding``),
the constraint API for model code (``api``), int8 cross-pod gradient
compression (``compression``), GPipe stages (``pipeline``) and the
serving steps' tensor parallelism over the model axis
(``tensor_parallel``)."""
