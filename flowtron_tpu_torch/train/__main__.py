"""``python -m flowtron_tpu_torch.train -c config.json [-p a.b=c ...]``:
the training CLI (``flowtron-torch-train``), for launchers that take a
module, as ``torchrun --nproc_per_node N -m flowtron_tpu_torch.train ...
-p dist_config.multiprocess=true``."""

from flowtron_tpu_torch.cli import train_main

if __name__ == "__main__":
    train_main()
