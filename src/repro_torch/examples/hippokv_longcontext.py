"""HippoKV (beyond-paper): the paper's bitmap machinery pruning KV-cache
pages for long-context decode (port of ``examples/hippokv_longcontext.py``).

    PYTHONPATH=src python -m repro_torch.examples.hippokv_longcontext [--device cpu]

Builds Hippo-style page summaries over a synthetic clustered key cache and
shows the accuracy/pages-touched trade-off as the query-side bucket selection
widens — the exact analogue of the paper's density knob, applied to
attention. Exact attention stays the default in the framework; this is the
opt-in approximate mode.

The cache has the reference's shapes and structure; it is drawn from a
seeded CPU ``torch.Generator`` and then moved, so the card and the CPU see
the same cache. Runs on the card unless ``--device cpu`` is given.
"""
import argparse

import torch

from repro_torch.core.kvindex import (KVIndexConfig, build_kv_index,
                                      hippo_kv_attention, query_page_mask)
from repro_torch.device import resolve_device

B, S, H, HD = 1, 4096, 8, 64
PAGE = 64
VOTES = (1, 2, 3, 4, 5)
CFG = KVIndexConfig(page_size=PAGE, num_channels=8, resolution=16,
                    keep_buckets=4)


def make_cache(seed: int, device) -> tuple:
    """(keys, values, q): a key cache clustered in pages of 64 positions
    (topic centroids plus 0.3 noise), values and one decode query."""
    gen = torch.Generator().manual_seed(seed)
    centers = torch.randn((S // PAGE, 1, H, HD), generator=gen)
    keys = centers.repeat_interleave(PAGE, dim=0).reshape(S, 1, H, HD)
    keys = keys.permute(1, 0, 2, 3) + 0.3 * torch.randn((1, S, H, HD),
                                                        generator=gen)
    values = torch.randn((1, S, H, HD), generator=gen)
    q = torch.randn((B, H, HD), generator=gen)
    dev = resolve_device(device)
    return keys.contiguous().to(dev), values.to(dev), q.to(dev)


def sweep(keys, values, q) -> tuple:
    """The index over ``keys`` and, at each vote, the kept page mask, the
    kept softmax mass and the output's error relative to full attention."""
    idx = build_kv_index(CFG, keys)
    full_pages = torch.ones((B, H, S // PAGE), dtype=torch.bool,
                            device=keys.device)
    ref, _ = hippo_kv_attention(q, keys, values, full_pages, PAGE)
    rows = []
    for vote in VOTES:
        mask = query_page_mask(idx, q, min_channels=vote)
        out, mass = hippo_kv_attention(q, keys, values, mask, PAGE)
        rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        rows.append({"vote": vote, "mask": mask, "mass": mass, "rel": rel})
    return idx, rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises without a card")
    dev = resolve_device(ap.parse_args(argv).device)

    keys, values, q = make_cache(0, dev)
    idx, rows = sweep(keys, values, q)
    cache_mb = keys.numel() * 2 / 2**20
    print(f"cache: {S} positions, {cache_mb:.1f} MiB (bf16); "
          f"index: {idx.nbytes()/2**10:.1f} KiB "
          f"({idx.nbytes()/(keys.numel()*2):.1%} of cache)")

    print(f"\n{'vote':>4} {'pages kept':>10} {'softmax mass':>12} {'rel err':>8}")
    for r in rows:
        print(f"{r['vote']:4d} {float(r['mask'].float().mean()):10.1%} "
              f"{float(r['mass'].mean()):12.3f} {r['rel']:8.3f}")
    print("\nexact attention remains the default; HippoKV is the opt-in "
          "approximate mode for attention-bearing archs.")


if __name__ == "__main__":
    main()
