"""The complete-lines trainer's command line:

    python -m plankassembly_tpu_torch.trainer_complete fit --config <yaml> [--device cpu] [--dot.path value ...]

(`plankassembly_tpu_torch/cli.py` for the subcommands and options.)
"""
from plankassembly_tpu_torch.cli import main_complete

if __name__ == "__main__":
    main_complete()
