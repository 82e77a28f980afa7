"""python -m aspire_tpu_torch <subcommand> ... (see cli.py)."""
from .cli import main

if __name__ == "__main__":
    main()
