"""no_time_to_train_tpu_torch — the PyTorch / CUDA port of
`no_time_to_train_tpu`, for one NVIDIA Hopper GPU.

The JAX package stays the reference. This package mirrors its layout
(`ops/`, `models/sam2/`, `models/matching/`, `data/`, `config/`, `utils/`,
`runner.py`, and `cli.py` in place of `run_lightning.py`; the repository's
front ends that drive the model under `scripts/`, `examples/` and
`tools/`), keeps NHWC at
the public functions, and replaces each Pallas kernel on its main path with
a hand-written CUDA kernel (`csrc/*.cu`) that has a plain PyTorch version
beside it. Importing it needs neither JAX, flax, PyYAML nor PIL; the
kernels are compiled at first use.
"""

__version__ = "0.1.0"
