"""Host-side fault tolerance around the train step (``fault_tolerance``)."""
