"""flowtron_tpu_torch — the PyTorch/CUDA port of flowtron_tpu.

The layout mirrors the JAX package module for module
(``models/ar_step.py`` <-> ``flowtron_tpu/models/ar_step.py``), so each
part is found at the same path as its reference. The JAX package stays the
reference: every ported part loads the same weights and is tested against
its JAX counterpart on the CPU.

The inference path (text ids -> mel -> audio) runs on an NVIDIA H100
through two hand-written CUDA kernels, built with ``nvcc`` at first use
(``ops/_build.py``):

- ``ops/decoder.py`` + ``csrc/decoder.cu``: one flow's whole inverse AR
  scan (replaces ``flowtron_tpu/ops/decoder_pallas.py``).
- ``ops/wavenet.py`` + ``csrc/wavenet.cu``: one WaveGlow WN layer
  (replaces ``flowtron_tpu/ops/wavenet_pallas.py``).

On CPU tensors each kernel wrapper runs its plain PyTorch version instead.
The package imports ``torch`` and never ``jax``; the host text frontend
(``flowtron_tpu.text``) and ``flowtron_tpu.config`` are shared, because
neither imports jax.
"""

__version__ = "0.1.0"
