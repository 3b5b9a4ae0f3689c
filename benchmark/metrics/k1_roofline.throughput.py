"""Kernel K1's roofline share: the flows inverted by the decoder kernel
(``k1_kernel`` fp32, ``k1_bf16_kernel`` bf16, launched in the batch's
``synth_mel`` span), their work counted from the batch's shapes."""

import re

from benchmark.metrics._layers import k1_roofline

KERNELS = re.compile(r"\bk1_(bf16_)?kernel\b")
SPANS = ("synth_mel",)


def read(run):
    return k1_roofline(run, KERNELS, SPANS)
