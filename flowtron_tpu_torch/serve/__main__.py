"""`python -m flowtron_tpu_torch.serve` entry point."""

from flowtron_tpu_torch.serve.cli import main

if __name__ == "__main__":
    main()
