"""Training data of the port: the reference's synthetic token stream
(``pipeline``)."""
