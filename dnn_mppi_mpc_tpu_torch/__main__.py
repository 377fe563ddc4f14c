"""``python -m dnn_mppi_mpc_tpu_torch <command>`` — see cli.py."""

from .cli import main

if __name__ == "__main__":
    main()
