"""The benchmark of nemo_tpu_torch (see PERF.md and run.py)."""
