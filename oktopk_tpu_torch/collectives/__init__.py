"""Sparse allreduce algorithms of the port."""
