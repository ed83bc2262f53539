"""The sideface trainer's command line:

    python -m plankassembly_tpu_torch.trainer_sideface fit --config <yaml> [--device cpu] [--dot.path value ...]

(`plankassembly_tpu_torch/cli.py` for the subcommands and options.)
"""
from plankassembly_tpu_torch.cli import main_sideface

if __name__ == "__main__":
    main_sideface()
