"""Tensor ops of the port (counterparts of gps_jamming_tpu.ops)."""
