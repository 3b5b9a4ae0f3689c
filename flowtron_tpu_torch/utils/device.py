"""Where the port's entry points run.

``run_inference``, ``train``, the CLIs and the serving engine run on
``cuda:0``; under several processes rank r runs on ``cuda:{LOCAL_RANK %
device_count}`` (``LOCAL_RANK`` as torchrun sets it, else the rank of the
process group). The caller asks for the CPU with an explicit ``device="cpu"``
or with ``FLOWTRON_PLATFORM=cpu``, the variable the JAX package's CLI
reads to pick its platform (flowtron_tpu/cli.py:14-20). Without CUDA and
without that request they raise: nothing falls back to the CPU quietly.
"""

import os

import torch

PLATFORM_VAR = "FLOWTRON_PLATFORM"


def resolve_device(device=None):
    """``device`` as a ``torch.device`` when given, else the CPU under
    ``FLOWTRON_PLATFORM=cpu``, else this rank's card (``cuda:0`` for one
    process); raises when that is asked for and absent."""
    if device is not None:
        return torch.device(device)
    platform = os.environ.get(PLATFORM_VAR, "").lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "cuda", "gpu"):
        raise ValueError(f"{PLATFORM_VAR}={platform!r}: the PyTorch port "
                         "runs on 'cuda' (the default) or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the PyTorch port runs on cuda:0; set "
            f"{PLATFORM_VAR}=cpu (or pass device='cpu') to run on the CPU")
    from flowtron_tpu_torch.parallel.mesh import local_rank
    return torch.device("cuda", local_rank() % torch.cuda.device_count())
