"""The reference's six examples on the port (``examples/*/main.py`` and
``examples/PremadeMatrix/generate.py`` of the repository), each a
module run as

    python -m ntpoly_tpu_torch.examples.<name> [arguments]

with the reference example's arguments and one more, ``--device``
(the CUDA card by default; ``--device cpu`` runs the plain versions of
the kernels).  The process-grid arguments are the reference's: run
in a world of rows x columns x slices ranks, for example

    torchrun --nproc-per-node 4 -m ntpoly_tpu_torch.examples.<name> \
        ... --process_rows 2 --process_columns 2

(the backend is ``dist.initialize``'s choice: ``gloo`` on the CPU and
for ranks sharing a card, ``cpu:gloo,cuda:nccl`` with a card a rank);
without a world any value but 1 raises the grid's error.
``main(argv)`` runs an example in-process.
"""
import argparse


def grid_arguments(p: argparse.ArgumentParser) -> None:
    """The process-grid arguments every example takes, and --device."""
    p.add_argument("--process_rows", type=int, default=1)
    p.add_argument("--process_columns", type=int, default=1)
    p.add_argument("--process_slices", type=int, default=1)
    p.add_argument("--device", default="cuda")
