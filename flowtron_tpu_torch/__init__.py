"""flowtron_tpu_torch — the PyTorch/CUDA port of flowtron_tpu.

The layout mirrors the JAX package module for module
(``models/ar_step.py`` <-> ``flowtron_tpu/models/ar_step.py``), so each
part is found at the same path as its reference. The JAX package stays the
reference: every ported part loads the same weights and is tested against
its JAX counterpart on the CPU.

Inference, batch and streaming serving (``serve/``, with the quantized
modes of ``infer/quantize.py``, streaming from ``infer/streaming.py``),
the audio tail (``audio/`` STFT and Griffin-Lim, ``vocoder/denoiser.py``)
and training (with TensorBoard, ``train/logger.py``) run on an NVIDIA
H100 through four hand-written CUDA kernels, built with ``nvcc`` at
first use (``ops/_build.py``):

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

Training and vocoder training also run data-parallel over
``torch.distributed`` (``parallel/``), and the server keeps one replica a
card (``--replicas``).

On CPU tensors each kernel wrapper runs its plain PyTorch version instead.
The package imports ``torch`` and nothing of ``jax`` or ``flowtron_tpu``:
it carries its own copies of the text frontend (``text/``) and the config
loader (``config.py``). Its entry points run on ``cuda:0`` unless
``FLOWTRON_PLATFORM=cpu`` or ``device="cpu"`` asks for the CPU.
"""

__version__ = "0.1.0"


def _warm_vector_math():
    """Call torch's CPU float ``tanh`` once, on one thread. torch runs it
    through MKL's vector math over its intra-op threads in chunks of 2048
    elements, and the first such call in a process now and then computes
    one chunk at lower accuracy (up to 5.6e-5 off float64 on normal
    inputs, in about one fresh process of 60; the next call is exact to
    rounding). A call on a few elements stays on the calling thread and
    sets the function up before any chunk runs in parallel: then none of
    600 did."""
    import torch

    torch.tanh(torch.full((8,), 0.5))


_warm_vector_math()
