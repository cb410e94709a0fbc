"""The README's Quickstart on the port (counterparts of ``examples/*.py``).

Each module runs as ``python -m repro_torch.examples.<name>``: on the card by
default, on the CPU with ``--device cpu``. Steps, printed lines, asserts and
sizes are the reference examples'.
"""
