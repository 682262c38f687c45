"""Multi-device analysis of the port: the ('antenna', 'time') mesh of
torch devices, the halo exchange and the sharded fusion pipelines
(counterparts of gps_jamming_tpu.parallel)."""
