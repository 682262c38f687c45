"""Host runtime of the port: telemetry records, the analysis pipeline,
the streaming receiver, the live dashboard and the capture orchestration
(counterparts of gps_jamming_tpu.runtime)."""
