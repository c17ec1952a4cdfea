"""Evaluation metrics of the port (JAX counterpart: etude_tpu/evaluation)."""
