"""Length-mask helpers (port of flowtron_tpu/utils/masks.py)."""

import torch


def sequence_mask(lengths, max_len):
    """(B,) lengths -> (B, max_len) bool mask, True at valid steps."""
    ids = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return ids[None, :] < lengths[:, None]


def flip_within_length_indices(lengths, max_len):
    """Per-row time indices that reverse the valid prefix, keep padding last.

    ``out[b, t] = x[b, idx[b, t]]`` gives ``x[b, L_b-1-t]`` for ``t < L_b``;
    the padding region ``[L_b, max_len)`` maps onto itself reversed.
    """
    t = torch.arange(max_len, device=lengths.device)[None, :]
    lengths = lengths.to(t.dtype)[:, None]
    idx = torch.where(t < lengths, lengths - 1 - t,
                      max_len - 1 - t + lengths)
    return idx.clamp(0, max_len - 1)


def flip_time(x_tbf, lengths):
    """Flip (T, B, ...) within per-sample lengths (padding stays last)."""
    T = x_tbf.shape[0]
    idx = flip_within_length_indices(lengths, T).t()      # (T, B)
    idx = idx.reshape(idx.shape + (1,) * (x_tbf.ndim - 2)).expand_as(x_tbf)
    return torch.gather(x_tbf, 0, idx)


def flip_time_batch_major(x_btf, lengths):
    """Flip (B, T, ...) along T within per-sample lengths: the prior flip
    of the back step and the CTC loss's un-flip (``_flip_prior`` and
    flowtron_tpu/train/loss.py:111-116)."""
    return flip_time(x_btf.transpose(0, 1), lengths).transpose(0, 1)
