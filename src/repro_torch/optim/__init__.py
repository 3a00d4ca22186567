"""Training's optimizer (AdamW) and gradient compression."""
