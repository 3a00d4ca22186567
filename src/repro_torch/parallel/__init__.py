"""Tensor parallelism for serving: process groups (``comm``) and the
Megatron split of the param tree (``sharding``)."""
