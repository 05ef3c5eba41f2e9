"""nemo_tpu_torch: the PyTorch/CUDA port of nemo_tpu's SZ cluster search.

The cluster search (config -> preprocess -> matched filter build and apply
-> grid RMS, S/N and edge trim -> detection -> photometry -> optimal
catalog) runs on torch tensors, on an NVIDIA GPU or on the CPU, per tile
or batched over chunks of tiles with detection on the device
(:mod:`nemo_tpu_torch.parallel`); the grid sigma-clip RMS runs through a
hand-written CUDA kernel (``csrc/rms_cells.cu``).  The host-only numpy
modules are copies of nemo_tpu's (kept identical by
``tests/test_torch_isolation.py``); this package imports neither jax nor
nemo_tpu.

Device and dtype policy: :mod:`nemo_tpu_torch.device`.
"""

__version__ = "0.1.0"
