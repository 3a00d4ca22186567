"""Training data (``pipeline``)."""
