"""Functional ops of the port (PyTorch), mirroring `dolomite_engine_tpu/ops/`."""
