"""The batched multi-tile engine on one device (port of nemo_tpu.parallel)."""
