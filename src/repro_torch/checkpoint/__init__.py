"""Atomic, versioned training checkpoints in the reference's layout
(``manager``)."""
