"""Kernel K2's roofline share over the batch chain's WaveGlow passes
(``wn_layer_kernel`` fp32, ``wn16_kernel`` bf16, launched in the batch's
``vocode`` span), their work counted from the pass's shapes."""

import re

from benchmark.metrics._layers import k2_roofline

KERNELS = re.compile(r"\b(wn_layer_kernel|wn16_kernel)\b")
SPANS = ("vocode",)


def read(run):
    return k2_roofline(run, KERNELS, SPANS)
