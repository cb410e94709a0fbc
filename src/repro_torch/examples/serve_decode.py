"""Batched-request serving example: continuous batching with slot recycling
against a prefill + lock-step decode loop (reduced smollm config) (port of
``examples/serve_decode.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.launch import serve as serve_cli


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises without a card")
    dev = resolve_device(ap.parse_args(argv).device)

    finished = serve_cli.main([
        "--arch", "smollm-360m", "--reduced",
        "--requests", "8", "--batch", "4",
        "--prompt-len", "16", "--gen", "24",
        "--device", str(dev),
    ])
    assert len(finished) == 8
    assert all(len(r.generated) >= 24 for r in finished)
    print("OK: all requests served")


if __name__ == "__main__":
    main()
