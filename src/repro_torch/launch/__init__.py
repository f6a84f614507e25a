"""Serving entry points of the port: the continuous-batching scheduler
(``scheduler``) and the one-shot / continuous driver (``serve``)."""
