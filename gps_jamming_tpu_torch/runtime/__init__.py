"""Host runtime of the port: telemetry records and the analysis pipeline
(counterparts of gps_jamming_tpu.runtime)."""
