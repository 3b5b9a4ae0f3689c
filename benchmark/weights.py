"""Seeded random weights in the published layouts, made on the device in a
few large draws, and handed to the server as ``.pt`` paths.

The server loads weights only from a path. Each state dict is written
into an anonymous in-memory file (``os.memfd_create``) reached through a
symlink ``<name>.pt`` in a directory under ``TMPDIR``, so a run writes no
weights to disk; the symlink resolves in this process, which builds the
server in-process.
"""

import os
import tempfile

import torch

from benchmark.reference.layout import flowtron_layout, waveglow_layout


def make(layout, seed, device):
    """{name: fp32 tensor on ``device``} drawn from a generator on the
    device seeded from ``seed``: one uniform and one normal draw for the
    whole layout, sliced and scaled leaf by leaf."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    n_u = sum(_numel(shape) for _n, shape, init, _f in layout
              if init == "uniform")
    n_n = sum(_numel(shape) for _n, shape, init, _f in layout
              if init in ("normal", "head", "orthogonal"))
    uni = torch.rand(n_u, generator=g, device=device) * 2 - 1
    nor = torch.randn(n_n, generator=g, device=device)
    out, iu, i_n = {}, 0, 0
    for name, shape, init, fan_in in layout:
        n = _numel(shape)
        if init == "uniform":
            t = uni[iu:iu + n].view(shape) / fan_in ** 0.5
            iu += n
        elif init in ("normal", "head", "orthogonal"):
            t = nor[i_n:i_n + n].view(shape)
            i_n += n
            if init == "head":
                t = 0.05 * t
            elif init == "orthogonal":
                q = torch.linalg.qr(t[:, :, 0])[0]
                if torch.det(q) < 0:
                    q[:, 0] = -q[:, 0]
                t = q[:, :, None]
        elif init == "ones":
            t = torch.ones(shape, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, device=device)
        elif init == "gate_off":
            t = torch.full(shape, -20.0, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
        out[name] = t.contiguous()
    return out


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def model_weights(config, seed, device):
    """(flowtron state dict, waveglow state dict) of a configuration file,
    from ``seed``."""
    return (make(flowtron_layout(config["model_config"]), 2 * int(seed),
                 device),
            make(waveglow_layout(config["waveglow_config"]),
                 2 * int(seed) + 1, device))


class MemoryFiles:
    """``.pt`` paths whose bytes live in memory; ``close()`` frees them."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="bench-weights-")
        self._fds = []

    def save(self, name, state, config=None):
        """A ``.pt`` path holding ``state`` (under ``model``, with
        ``config`` beside it where given: the vocoder's width)."""
        fd = os.memfd_create(name)
        self._fds.append(fd)
        state = {k: v.cpu() for k, v in state.items()}
        with os.fdopen(os.dup(fd), "wb") as f:
            torch.save(state if config is None
                       else {"model": state, "config": config}, f)
        path = os.path.join(self.dir, f"{name}.pt")
        os.symlink(f"/proc/{os.getpid()}/fd/{fd}", path)
        return path

    def close(self):
        for fd in self._fds:
            os.close(fd)
        self._fds = []
        for name in os.listdir(self.dir):
            os.unlink(os.path.join(self.dir, name))
        os.rmdir(self.dir)
