"""Beta-binomial attention prior (port of flowtron_tpu/data/prior.py;
reference:data.py:31-41).

Row i (1-indexed mel frame) of the (M, P) prior is the pmf of
BetaBinom(P-1, a=s*i, b=s*(M+1-i)) over text positions 0..P-1 — a soft
diagonal alignment prior. Implemented as one vectorized log-gamma formula
instead of the reference's per-row scipy loop (identical values, ~50x
faster for long utterances).
"""

import numpy as np
from scipy.special import gammaln


def beta_binomial_log_pmf(n, k, a, b):
    """log BetaBinom(n, a, b).pmf(k), broadcasting over k/a/b arrays."""
    return (
        gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
        + gammaln(k + a) + gammaln(n - k + b) - gammaln(n + a + b)
        - (gammaln(a) + gammaln(b) - gammaln(a + b))
    )


def beta_binomial_prior(text_length, mel_length, scaling_factor=1.0,
                        dtype=np.float32):
    """(mel_length, text_length) prior matrix, rows ~sum to 1."""
    P, M = text_length, mel_length
    n = P - 1
    k = np.arange(P, dtype=np.float64)[None, :]
    i = np.arange(1, M + 1, dtype=np.float64)[:, None]
    a = scaling_factor * i
    b = scaling_factor * (M + 1 - i)
    return np.exp(beta_binomial_log_pmf(n, k, a, b)).astype(dtype)
