"""Quickstart of the PyTorch port: the MIREX loop end to end on a synthetic web collection.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain versions

1. build a corpus + anchor-text representation (the paper's prep jobs),
2. run the collection-statistics job,
3. sequential-scan 16 queries with the paper's QL language model,
4. cross-check the top-10 against the inverted-index baseline,
5. swap in BM25: the whole experiment change is one scorer.

The same five steps as ``examples/quickstart.py`` on `repro_torch`: on a
CUDA device the anchor job runs on the card and each scan launches the
CUDA lexical-scan kernel; the index is the host numpy job it is in the
paper's comparison.
"""

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import anchors, invindex, scan, scoring
from repro_torch.data import synthetic
from repro_torch.device import resolve_device

VOCAB = 4096


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the jobs and the scan run (default: cuda; cpu runs the "
                         "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"== corpus + links (device {dev}) ==")
    corpus = synthetic.make_corpus(n_docs=2048, vocab=VOCAB, max_len=48, seed=0, device=dev)
    dst, anchor_toks = synthetic.make_links(
        n_docs=2048, n_links=8192, vocab=VOCAB, seed=1, device=dev
    )

    print("== job 1: anchor-text extraction (paper §3.2) ==")
    anchor_repr, anchor_lens = anchors.extract_anchors(
        torch.as_tensor(dst, device=dev), torch.as_tensor(anchor_toks, device=dev),
        n_docs=2048, max_anchor_len=64,
    )
    print(f"   anchor docs: {int((anchor_lens > 0).sum())} non-empty")

    print("== job 2: collection statistics ==")
    docs = (torch.as_tensor(corpus.tokens, device=dev),
            torch.as_tensor(corpus.lengths, device=dev))
    stats = anchors.collection_stats(*docs, vocab=VOCAB, chunk_size=256)
    print(f"   |C| = {int(stats.total_terms)} terms, avg doc len {float(stats.avg_doc_len):.1f}")

    print("== job 3: sequential-scan search (QL language model, k=10) ==")
    queries = synthetic.make_queries(corpus, n_queries=16, seed=2)
    q = torch.as_tensor(queries, device=dev)
    state = scan.search_local(q, docs, scoring.get_scorer("ql_lm"), k=10, chunk_size=256,
                              stats=stats)
    print(f"   top-1 ids: {state.ids[:, 0].cpu().numpy()}")

    print("== cross-check vs the inverted-index baseline ==")
    idx = invindex.build_index(corpus.tokens, corpus.lengths, vocab=VOCAB)
    ref_scores, ref_ids = invindex.search(idx, queries, invindex.stats_from_index(idx), k=10)
    np.testing.assert_allclose(state.scores.cpu().numpy(), ref_scores, rtol=3e-5, atol=3e-5)
    print("   scan == index scores ✓ (same model, no index needed)")

    print("== swapping in a 'radical new approach' is one function ==")
    bm25_state = scan.search_local(
        q, docs, scoring.get_scorer("bm25"),  # <- the whole experiment change
        k=10, chunk_size=256, stats=stats,
    )
    overlap = np.mean([
        len(set(a.tolist()) & set(b.tolist())) / 10
        for a, b in zip(state.ids.cpu().numpy(), bm25_state.ids.cpu().numpy())
    ])
    print(f"   QL vs BM25 top-10 overlap: {overlap:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
