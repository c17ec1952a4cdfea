"""Part of etude_tpu_torch; see the package docstring."""
