"""flowtron_tpu_torch — the PyTorch/CUDA port of flowtron_tpu.

The layout mirrors the JAX package module for module
(``models/ar_step.py`` <-> ``flowtron_tpu/models/ar_step.py``), so each
part is found at the same path as its reference. The JAX package stays the
reference: every ported part loads the same weights and is tested against
its JAX counterpart on the CPU.

Inference, batch serving (``serve/``, with the quantized modes of
``infer/quantize.py``) and training run on an NVIDIA H100 through four
hand-written CUDA kernels, built with ``nvcc`` at first use
(``ops/_build.py``):

- ``ops/decoder.py`` + ``csrc/decoder.cu``: one flow's whole inverse AR
  scan (replaces ``flowtron_tpu/ops/decoder_pallas.py``).
- ``ops/wavenet.py`` + ``csrc/wavenet.cu``: one WaveGlow WN layer
  (replaces ``flowtron_tpu/ops/wavenet_pallas.py``).
- ``ops/attention.py`` + ``csrc/attention.cu``: the attention scores,
  forward and backward (replaces ``flowtron_tpu/ops/attention_pallas.py``).
- ``ops/qmm.py`` + ``csrc/qmm.cu``: the int8 matmul of the quantized
  modes (replaces ``flowtron_tpu/ops/qmm_pallas.py``).

The TPU probes of ``scripts/exp_*.py`` have ports in ``scripts/`` (same
file names) with kernels of their own: ``ops/w4.py`` + ``csrc/w4.cu``
(int4 dequant matmuls), ``ops/resident.py`` + ``csrc/resident.cu``
(scans with weights kept on chip) and ``ops/fused_cost.py`` +
``csrc/fused_cost.cu`` (K1 stripped for cost attribution).

On CPU tensors each kernel wrapper runs its plain PyTorch version instead.
The package imports ``torch`` and nothing of ``jax`` or ``flowtron_tpu``:
it carries its own copies of the text frontend (``text/``) and the config
loader (``config.py``). Its entry points run on ``cuda:0`` unless
``FLOWTRON_PLATFORM=cpu`` or ``device="cpu"`` asks for the CPU.
"""

__version__ = "0.1.0"
