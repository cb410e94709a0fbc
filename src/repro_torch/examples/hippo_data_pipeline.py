"""Hippo as the training data plane: predicate-filtered corpus selection
(port of ``examples/hippo_data_pipeline.py``).

    PYTHONPATH=src python -m repro_torch.examples.hippo_data_pipeline [--device cpu]

Shows the paper's index doing real work inside an LM input pipeline: the
quality-range predicate runs Algorithm 1 over page summaries of the corpus
metadata, prunes most pages, and returns the exact qualifying sequence set;
batches then stream deterministically (restart-safe step->batch mapping).
The index lives on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.core.predicate import Predicate
from repro_torch.data import HippoDataPipeline, synthesize_corpus
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises without a card")
    dev = resolve_device(ap.parse_args(argv).device)

    corpus = synthesize_corpus(num_seqs=20_000, seq_len=65, vocab_size=1024,
                               page_card=64, seed=0)
    for lo, hi in [(0.0, 1.0), (0.5, 1.0), (0.75, 1.0), (0.9, 1.0)]:
        pipe = HippoDataPipeline.create(corpus, Predicate.between(lo, hi),
                                        device=dev)
        sel = pipe.selected_ids.size
        print(f"quality in [{lo:.2f}, {hi:.2f}]: {sel:6d}/{corpus.num_seqs} seqs, "
              f"inspected {pipe.pages_inspected}/{corpus.table.num_pages} pages "
              f"({pipe.pages_inspected/corpus.table.num_pages:.0%})")
        want = np.flatnonzero((corpus.quality >= lo) & (corpus.quality <= hi))
        assert np.array_equal(np.sort(pipe.selected_ids), want), "must be exact"

    pipe = HippoDataPipeline.create(corpus, Predicate.between(0.75, 1.0), seed=3,
                                    device=dev)
    a = pipe.get_batch(42, 8)
    b = pipe.get_batch(42, 8)
    assert np.array_equal(a["inputs"], b["inputs"])
    print("\ndeterministic step->batch mapping: OK (restart-safe)")
    doms = corpus.domain[pipe.batch_ids(42, 256)]
    print(f"batch domain mix under quality>=0.75 predicate: "
          f"{np.bincount(doms, minlength=4).tolist()} (only domain 3 qualifies)")


if __name__ == "__main__":
    main()
