"""The training data plane (port of ``repro.data``): a paged corpus and the
Hippo-indexed pipeline that selects its sequences."""
from repro_torch.data.corpus import PagedCorpus, synthesize_corpus  # noqa: F401
from repro_torch.data.pipeline import HippoDataPipeline  # noqa: F401
